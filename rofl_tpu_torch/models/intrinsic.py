"""Intrinsic-dimension training — counterpart of ``rofl_tpu.models.intrinsic``:
the network's parameters are θ = θ0 + P·z for a fixed random projection P
(D × d), and the FL parameter vector is z (Li et al. '18, as in
pps-lab/fl-analysis; the ``models/*_intrinsic_*.txt`` files).

P is never stored: block b of 2^16 rows is ``jax.random.normal(fold_in(
PRNGKey(seed), b), (BLOCK, d)) / sqrt(d)``, made again on every call, as the
JAX package does. Here a block is made a tile of rows at a time
(``TILE_LANES`` values a tile, the counters offset by the tile's first row),
and only the rows below D: P·z drops the rows above D and Pᵀ·g meets zeros
there, so they change no value. The products are ``torch.matmul`` and the
normals plain torch (``jax_random``): in the JAX package all of this is XLA,
no Pallas kernel.

``project`` is a ``torch.autograd.Function`` whose backward is
``project_transpose``, the gradient the JAX step takes through θ(z).
"""

from __future__ import annotations

import numpy as np
import torch

from . import jax_random as R

BLOCK = 1 << 16
TILE_LANES = 1 << 25  # values of P made at once: 256 MiB of int64 words a temporary


def projection_scale(d: int) -> float:
    """1 / sqrt(float32(d)) in float32, as the JAX package computes it."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d)))


def projection_tiles(d: int, D: int, seed: int, device="cuda"):
    """(first row, P[rows]) for the tiles of P's rows below D, in order."""
    scale = projection_scale(d)
    tile_rows = max(1, TILE_LANES // d)
    for b in range(-(-D // BLOCK)):
        key = R.fold_in(R.PRNGKey(seed), b)
        rows = min(BLOCK, D - b * BLOCK)
        for r0 in range(0, rows, tile_rows):
            r1 = min(rows, r0 + tile_rows)
            yield b * BLOCK + r0, R.normal(key, (r1 - r0, d), device, start=r0 * d) * scale


def project_forward(z: torch.Tensor, D: int, seed: int) -> torch.Tensor:
    """P·z, the offset of θ from θ0 (length D)."""
    d = z.shape[0]
    out = torch.empty(D, dtype=torch.float32, device=z.device)
    for row, p in projection_tiles(d, D, seed, z.device):
        out[row:row + p.shape[0]] = p @ z
    return out


def project_transpose(g: torch.Tensor, d: int, seed: int) -> torch.Tensor:
    """Pᵀ·g — the backward pass of ``project`` (length d)."""
    D = g.shape[0]
    acc = torch.zeros(d, dtype=torch.float32, device=g.device)
    for row, p in projection_tiles(d, D, seed, g.device):
        acc += p.T @ g[row:row + p.shape[0]]
    return acc


class _Project(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z, D, seed):
        ctx.d, ctx.seed = z.shape[0], seed
        return project_forward(z, D, seed)

    @staticmethod
    def backward(ctx, g):
        return project_transpose(g.contiguous(), ctx.d, ctx.seed), None, None


def project(z: torch.Tensor, D: int, seed: int) -> torch.Tensor:
    """P·z, differentiable in z (its backward is ``project_transpose``)."""
    return _Project.apply(z, D, seed)


class IntrinsicWrapper:
    """The d-dimensional z-space as the FL parameter vector, the network's
    D-dimensional θ-space on the device."""

    def __init__(self, theta0_flat: torch.Tensor, intrinsic_dim: int, seed: int = 0):
        self.theta0 = theta0_flat
        self.D = int(theta0_flat.shape[0])
        self.d = intrinsic_dim
        self.seed = seed

    def theta(self, z: torch.Tensor) -> torch.Tensor:
        return self.theta0 + project(z, self.D, self.seed)

    def grad_z(self, grad_theta: torch.Tensor) -> torch.Tensor:
        return project_transpose(grad_theta, self.d, self.seed)
