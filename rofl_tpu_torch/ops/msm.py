"""Multi-scalar multiplication. Counterpart of ``rofl_tpu.ops.msm``.

A tensor on the card goes to the MSM kernel (``kernels.msm_flat`` /
``kernels.msm_groups``, ``csrc/msm.cu``) at every group size; a tensor on
the CPU to its plain version (a ``scalar_mul`` ladder per lane and the
halving sums). The JAX package's restriction of its TPU kernel to
power-of-two groups of at least 128 lanes is not carried.
"""

from __future__ import annotations

import torch

from . import fe, kernels
from .curve import PointArray


def _flat(p: PointArray, k: torch.Tensor):
    coords = tuple(c.reshape(fe.NLIMB, -1).contiguous() for c in p)
    k = k.reshape(fe.NLIMB, 1).contiguous() if k.numel() == fe.NLIMB else (
        k.reshape(fe.NLIMB, -1).contiguous())
    return coords, k


def msm(points: PointArray, scalars: torch.Tensor) -> PointArray:
    """Σ scalars_i · points_i over the last batch axis → one point (16, 1)."""
    coords, k = _flat(points, scalars)
    return PointArray(*kernels.msm_flat(k, coords))


def msm_grouped(points: PointArray, scalars: torch.Tensor, group: int) -> PointArray:
    """Per-group MSMs over contiguous groups of `group` lanes:
    (16, G·group) → (16, G). The chunk-batched prover's primitive (all
    chunks' A/S and L/R sums in one launch)."""
    coords, k = _flat(points, scalars)
    return PointArray(*kernels.msm_groups(k, coords, group))

