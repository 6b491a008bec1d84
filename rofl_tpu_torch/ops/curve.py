"""Batched Ristretto255 point ops on torch tensors (extended twisted-Edwards
coordinates). Counterpart of ``rofl_tpu.ops.curve``.

A point batch is a NamedTuple of four limb tensors (``ops/fe.py`` layout:
(16, *batch) int32). The a=-1 unified addition law is complete (works for
identity and doubling), so every op is branch-free and batchable.

``add``, ``double``, ``scalar_mul``, ``compress`` and ``decompress`` go through the wrappers
in ``ops/kernels.py``: the CUDA kernel for tensors on the card, the plain
version for tensors on the CPU. ``neg``, ``select`` and ``eq`` are plain
tensor code on both. The JAX package's lane bucketing (padding lane counts
to share XLA compiles) has no counterpart: nothing is compiled per shape.

Bit-exact with ``rofl_tpu_torch.spec.ristretto`` (== curve25519-dalek-ng).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import fe, kernels
from ..spec import ristretto as SR


class PointArray(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    t: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[1:])

    @property
    def device(self):
        return self.x.device


def pack_points(points, device="cuda") -> PointArray:
    """List of spec RistrettoPoints → PointArray on `device`."""
    return PointArray(*[
        fe.to_tensor(fe.pack_scalars([getattr(p, c) for p in points]), device)
        for c in ("X", "Y", "Z", "T")
    ])


def unpack_points(pa: PointArray) -> list:
    """PointArray → list of spec RistrettoPoints (host-side)."""
    return [SR.RistrettoPoint(*c) for c in zip(*[fe.unpack_scalars(c) for c in pa])]


def identity(batch_shape=(), device="cuda") -> PointArray:
    return PointArray(
        fe.zeros(batch_shape, device), fe.ones(batch_shape, device),
        fe.ones(batch_shape, device), fe.zeros(batch_shape, device),
    )


def basepoint(batch_shape=(), device="cuda") -> PointArray:
    """The basepoint as broadcastable (16, 1, ...) coordinates."""
    b = SR.BASEPOINT
    return PointArray(*[fe.constant(v, batch_shape, device) for v in (b.X, b.Y, b.Z, b.T)])


def _lanes(p: PointArray, shape) -> tuple:
    """Coordinates as contiguous (16, N) for the kernel wrappers; a point
    with one lane stays (16, 1) and is broadcast by the kernel."""
    if p.x.numel() == fe.NLIMB:
        return tuple(c.reshape(fe.NLIMB, 1).contiguous() for c in p)
    return tuple(c.expand(shape).reshape(fe.NLIMB, -1).contiguous() for c in p)


def add(p: PointArray, q: PointArray) -> PointArray:
    """Unified extended addition (add-2008-hwcd-3, a=-1): 9 field muls."""
    # numpy's: torch.broadcast_shapes imports torch's symbolic-shape machinery
    # (and sympy) at its first call, seconds of import for a tuple of ints
    shape = np.broadcast_shapes(tuple(p.x.shape), tuple(q.x.shape))
    out = kernels.point_add(_lanes(p, shape), _lanes(q, shape))
    return PointArray(*[c.reshape(shape) for c in out])


def double(p: PointArray) -> PointArray:
    out = kernels.point_double(_lanes(p, p.x.shape))
    return PointArray(*[c.reshape(p.x.shape) for c in out])


def neg(p: PointArray) -> PointArray:
    return PointArray(fe.neg(p.x), p.y, p.z, fe.neg(p.t))


def select(cond: torch.Tensor, p_true: PointArray, p_false: PointArray) -> PointArray:
    return PointArray(*[fe.select(cond, a, b) for a, b in zip(p_true, p_false)])


def eq(p: PointArray, q: PointArray) -> torch.Tensor:
    """Batched ristretto equality (dalek ct_eq): X1Y2==Y1X2 | X1X2==Y1Y2."""
    return fe.eq(fe.mul(p.x, q.y), fe.mul(p.y, q.x)) | fe.eq(
        fe.mul(p.x, q.x), fe.mul(p.y, q.y)
    )


def scalar_mul(p: PointArray, k: torch.Tensor) -> PointArray:
    """Per-element variable-base scalar mul: k (16, *batch) limbs of canonical
    scalars, or one scalar (16, 1, ...) for every point. One launch of the
    ``scalar_mul`` kernel on the card (a 256-step ladder per lane)."""
    k = k.reshape(fe.NLIMB, 1).contiguous() if k.numel() == fe.NLIMB else (
        k.expand(p.x.shape).reshape(fe.NLIMB, -1).contiguous())
    out = kernels.scalar_mul(k, tuple(c.reshape(fe.NLIMB, -1).contiguous() for c in p))
    return PointArray(*[c.reshape(p.x.shape) for c in out])


def compress(p: PointArray) -> torch.Tensor:
    """Batched ristretto encode → canonical field limbs (16, *batch)."""
    return kernels.compress(_lanes(p, p.x.shape)).reshape(p.x.shape)


def decompress(s: torch.Tensor) -> tuple[PointArray, torch.Tensor]:
    """Batched ristretto decode from field limbs s (16, *batch).

    Returns (points, valid_mask). Canonicality of the byte encoding
    (s < p, non-negative) must be checked by the caller on the raw bytes;
    this checks the on-curve/torsion-free conditions.
    """
    pt, valid = kernels.decompress(s.reshape(fe.NLIMB, -1).contiguous())
    return PointArray(*[c.reshape(s.shape) for c in pt]), valid.reshape(s.shape[1:])


def compress_to_bytes(p: PointArray) -> np.ndarray:
    """Host helper: batched encode → (N, 32) uint8."""
    return fe.to_bytes_array(compress(p))


def tree_sum(p: PointArray, axis: int = 0) -> PointArray:
    """Sum a batch of points along a batch axis, which is kept with size 1.

    Log-depth halving: pad the axis to a power of two with the identity,
    then add the upper half onto the lower until one lane is left: log2(N)
    launches of ``point_add`` (the pairing of the JAX package's reduction).
    """
    ax = axis + 1  # skip limb dim
    coords = [c.movedim(ax, 1) for c in p]
    n = coords[0].shape[1]
    m = 1 if n == 0 else 1 << (n - 1).bit_length()
    if m != n:
        ident = identity((m - n,) + tuple(coords[0].shape[2:]), p.device)
        coords = [torch.cat([a, b], dim=1) for a, b in zip(coords, ident)]
    acc = PointArray(*coords)
    for _ in range(int(math.log2(m))):
        w = acc.x.shape[1] // 2
        acc = add(PointArray(*[c[:, :w] for c in acc]),
                  PointArray(*[c[:, w:] for c in acc]))
    return PointArray(*[c.movedim(1, ax) for c in acc])
