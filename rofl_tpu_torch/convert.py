"""Carry state from the JAX package into the port, as numpy.

Everything here takes and returns numpy arrays, so this module needs nothing
of the JAX package: a caller that holds ``rofl_tpu`` state hands it over with
``np.asarray``. Layouts are the same on both sides ((16, N) radix-2^16 limbs,
limb-major); what differs is the dtype (uint32 there, int32 tensors here) and
the BSGS key words, which the port stores biased so that they sort as
unsigned under a signed dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import fe
from .ops.curve import PointArray

# numpy (16, N) uint32 limbs → int32 tensor on a device, and back.
limbs_to_tensor = fe.to_tensor
tensor_to_limbs = fe.to_numpy


def point_from_numpy(x, y, z, t, device="cuda") -> PointArray:
    """A ``rofl_tpu`` PointArray given as its four numpy coordinate arrays →
    the port's PointArray on `device`."""
    return PointArray(*[fe.to_tensor(c, device) for c in (x, y, z, t)])


def point_to_numpy(p: PointArray) -> tuple:
    """The port's PointArray → four numpy uint32 coordinate arrays."""
    return tuple(fe.to_numpy(c) for c in p)


def fixed_base_table_from_numpy(x, y, z, t, device="cuda") -> PointArray:
    """A ``rofl_tpu`` ``FixedBase.table`` ((16, 32, 256) per coordinate,
    numpy) → the table ``rofl_tpu_torch.ops.fixed_base.mul`` takes."""
    for c in (x, y, z, t):
        if tuple(np.shape(c)) != (16, 32, 256):
            raise ValueError(f"fixed-base table coordinate has shape {np.shape(c)}")
    return point_from_numpy(x, y, z, t, device)


def bsgs_table_from_numpy(keys, values, device="cuda"):
    """``rofl_tpu.ops.bsgs.build_table(m)``'s sorted (keys (m+1, 8) uint32,
    values (m+1,) uint32) → the (keys, values) tensors
    ``rofl_tpu_torch.ops.bsgs.solve_with_table`` takes. Unsigned order of the
    words is signed order of the biased words, so the rows stay sorted."""
    keys = np.asarray(keys).astype(np.int64) - (1 << 31)
    values = np.asarray(values).astype(np.int64)
    return (torch.from_numpy(keys.astype(np.int32)).to(device),
            torch.from_numpy(values.astype(np.int32)).to(device))
