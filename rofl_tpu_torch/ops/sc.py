"""Scalar-field (mod l) helpers for the aggregation round, 16x16-bit limbs.

l = 2^252 + 27742317777372353535851937790883648493. Counterpart of the part
of ``rofl_tpu.ops.sc`` that the round calls: the host codecs, ``neg`` and the
wide reduction ``reduce_wide_bytes`` (a CUDA kernel on the card, see
``ops/kernels.py``; its plain version is ``reduce_512`` here). Batched
add/sub/mul and the sums arrive together with their kernels. Canonical (< l)
values at API boundaries; same (16, *batch) int32 layout as ``ops/fe.py``.
Bit-exact with ``rofl_tpu_torch.spec.scalar``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spec import scalar as SS
from . import fe

NLIMB = 16
MASK16 = 0xFFFF
L_INT = SS.L

DELTA = L_INT - (1 << 252)  # 2^252 ≡ -DELTA (mod l), DELTA < 2^125

_L_LIMBS = [(L_INT >> (16 * k)) & 0xFFFF for k in range(NLIMB)]
_DELTA_LIMBS = [(DELTA >> (16 * k)) & 0xFFFF for k in range(8)]


def pack_scalars(values) -> np.ndarray:
    """Python ints → canonical uint32 limb array (16, N)."""
    return fe.pack_scalars([int(v) % L_INT for v in values])


unpack_scalars = fe.unpack_scalars


def _cond_sub_l(limbs: list) -> list:
    """One conditional subtract of l from a 16-limb value (< 2^256)."""
    diff = []
    borrow = torch.zeros_like(limbs[0])
    for k in range(NLIMB):
        v = limbs[k] + (0x10000 - _L_LIMBS[k]) - borrow
        diff.append(v & MASK16)
        borrow = 1 - (v >> 16)
    ge = borrow == 0
    return [torch.where(ge, diff[k], limbs[k]) for k in range(NLIMB)]


def neg(a: torch.Tensor) -> torch.Tensor:
    """l - a for canonical a; 0 maps to l, which one conditional subtract
    brings back to 0."""
    out = []
    borrow = torch.zeros_like(a[0])
    for k in range(NLIMB):
        v = (_L_LIMBS[k] + 0x10000) - a[k] - borrow
        out.append(v & MASK16)
        borrow = 1 - (v >> 16)
    return torch.stack(_cond_sub_l(out))


# -- wide reduction, plain version (lists of (batch,)-shaped int64 rows) ------


def _carry(limbs: list) -> list:
    """Full carry propagation; appends two overflow limbs."""
    out = []
    carry = torch.zeros_like(limbs[0])
    for v in limbs:
        v = v + carry
        out.append(v & MASK16)
        carry = v >> 16
    out.append(carry & MASK16)
    out.append(carry >> 16)
    return out


def _mul_delta(a: list) -> list:
    """Product of a limb list with DELTA, fully carried."""
    cols = [torch.zeros_like(a[0]) for _ in range(len(a) + len(_DELTA_LIMBS))]
    for j, c in enumerate(_DELTA_LIMBS):
        for i, limb in enumerate(a):
            p = limb * c  # < 2^32: the rows are int64
            cols[i + j] = cols[i + j] + (p & MASK16)
            cols[i + j + 1] = cols[i + j + 1] + (p >> 16)
    return _carry(cols)


def _const_minus(limbs: list, big: int) -> list:
    """big - value(limbs) for big >= value, fully carried. big is written
    with every limb under the subtrahend saturated to at least 0xFFFF, so no
    limbwise difference underflows."""
    n_sub = len(limbs)
    rem = big - ((1 << (16 * n_sub)) - 1)
    assert rem >= 0, "constant too small for saturated subtraction"
    n_out = max(n_sub, (rem.bit_length() + 15) // 16)
    out = []
    for k in range(n_out):
        sat = (0xFFFF if k < n_sub else 0) + ((rem >> (16 * k)) & 0xFFFF)
        out.append(sat - limbs[k] if k < n_sub else torch.full_like(limbs[0], sat))
    return _carry(out)


def _fold_once(limbs: list, hi_bits: int, k_mult: int) -> list:
    """One 2^252 ≡ -DELTA fold: low + (k_mult*l - hi*DELTA)."""
    low = list(limbs[:15]) + [limbs[15] & 0x0FFF]
    n = len(limbs)
    hi = []
    for k in range(min(n - 15, (hi_bits + 15) // 16)):
        v = limbs[15 + k] >> 12
        if 16 + k < n:
            v = v | ((limbs[16 + k] & 0x0FFF) << 4)
        hi.append(v)
    prod = _mul_delta(hi)[:(hi_bits + 125 + 15) // 16]
    t = _const_minus(prod, k_mult * L_INT)
    zero = torch.zeros_like(low[0])
    return _carry([(low[k] if k < len(low) else zero) + (t[k] if k < len(t) else zero)
                   for k in range(max(len(low), len(t)))])


def reduce_512(limbs: list) -> torch.Tensor:
    """32 fully carried 16-bit limbs (a value < 2^512) → canonical scalar
    (16, *batch) int32. Three folds; the multiples of l keep every
    intermediate non-negative:
      v  < 2^512: hi < 2^260, hi*DELTA < 2^385 <= 2^149*l, v1 < 2^402
      v1 < 2^402: hi < 2^150, hi*DELTA < 2^275 <= 2^36*l,  v2 < 2^290
      v2 < 2^290: hi < 2^38,  hi*DELTA < 2^163 <= l,       v3 < 2^254
    """
    limbs = [v.to(torch.int64) for v in limbs]
    v1 = _fold_once(limbs, hi_bits=260, k_mult=1 << 149)[:(402 + 15) // 16]
    v2 = _fold_once(v1, hi_bits=150, k_mult=1 << 36)[:(290 + 15) // 16]
    v3 = _fold_once(v2, hi_bits=38, k_mult=1)[:NLIMB]
    for _ in range(3):
        v3 = _cond_sub_l(v3)
    return torch.stack(v3).to(fe.DTYPE)


def reduce_wide_bytes(byte_cols: torch.Tensor) -> torch.Tensor:
    """(64, N) int32 byte columns (LE) → canonical scalars (16, N), on the
    device of the bytes (Scalar::from_bytes_mod_order_wide)."""
    from . import kernels

    return kernels.sc_reduce_wide(byte_cols)


def from_bytes_wide_array(data: np.ndarray) -> np.ndarray:
    """(N, 64) uint8 → canonical scalars (host-side, exact wide reduction)."""
    data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8).reshape(-1, 64))
    raw = data.tobytes()
    return fe.pack_scalars(
        int.from_bytes(raw[i:i + 64], "little") % L_INT for i in range(0, len(raw), 64))


def to_bytes_array(limbs) -> np.ndarray:
    """(16, N) canonical scalar limbs → (N, 32) uint8 (host-side)."""
    limbs = fe.to_numpy(limbs).reshape(NLIMB, -1)
    out = np.zeros((limbs.shape[1], 32), dtype=np.uint8)
    out[:, 0::2] = (limbs & 0xFF).T
    out[:, 1::2] = (limbs >> 8).T
    return out
