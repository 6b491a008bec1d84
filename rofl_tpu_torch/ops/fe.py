"""Batched GF(2^255-19) arithmetic on torch tensors — 16x16-bit limbs.

Counterpart of ``rofl_tpu.ops.fe``; the plain version of everything the
CUDA field header (``csrc/fe25519_32.cuh``, on 8 limbs of 32 bits) does.

  * A field element batch is a tensor of shape (16, *batch): limb-major, so
    adjacent lanes are adjacent in memory (the coalesced layout for one lane
    per CUDA thread).
  * Limb dtype is ``torch.int32`` on both devices (``torch.uint32`` has no
    add, shift or compare on the CPU). Limbs hold 16-bit digits, so sums,
    differences and the fold by 38 stay far below 2^31. Only ``mul`` has
    products that reach 2^32: it widens to int64 for the products and their
    column sums and narrows again after carrying.
  * Values are kept weakly reduced in [0, 2^256); 2^256 ≡ 38 (mod p) folds
    keep everything in range. Canonical form is only forced at
    encode/compare boundaries, exactly like curve25519-dalek.

The algorithms (carry passes, fold constants, addition chains) are the JAX
package's, so weakly reduced limbs agree bit for bit, not only canonical
ones. Bit-exactness oracle: ``rofl_tpu_torch.spec.field``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..spec import field as SF
from ..utils import profiling

NLIMB = 16
MASK16 = 0xFFFF
DTYPE = torch.int32

P_INT = SF.P


# -- host codecs (numpy; ``to_tensor`` moves limbs onto a device) -------------


def _to_limbs_int(v: int) -> np.ndarray:
    return np.array([(v >> (16 * k)) & 0xFFFF for k in range(NLIMB)], dtype=np.uint32)


def pack_scalars(values) -> np.ndarray:
    """Python ints (< 2^256) → uint32 limb array (16, N)."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, NLIMB).T.astype(np.uint32)


def unpack_scalars(limbs) -> list[int]:
    """Limb array or tensor (16, N) → list of Python ints."""
    raw = to_numpy(limbs).reshape(NLIMB, -1).T.astype("<u2").tobytes()
    return [int.from_bytes(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def canonical_device(device) -> torch.device:
    """`device` with its index filled in, so that "cuda" and the device of a
    tensor on the current card name the same cache entry."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def to_tensor(limbs, device) -> torch.Tensor:
    """numpy (16, ...) limbs of any integer dtype → int32 tensor on `device`."""
    arr = np.ascontiguousarray(np.asarray(limbs).astype(np.int32))
    return torch.from_numpy(arr).to(device)


def to_numpy(limbs) -> np.ndarray:
    """Limb tensor (or array) → numpy uint32 on the host. Reading a tensor
    counts as one ``host_reads`` (on the card each read drains the stream)."""
    if isinstance(limbs, torch.Tensor):
        profiling.count("host_reads")
        limbs = limbs.cpu().numpy()
    return np.asarray(limbs).astype(np.uint32)


def to_bool(t: torch.Tensor) -> bool:
    """A one-element bool tensor's value on the host, counted as one
    ``host_reads``."""
    profiling.count("host_reads")
    return bool(t)


def from_bytes_array(data: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 LE encodings → (16, N) uint32 limbs, top bit masked
    (dalek from_bytes semantics; NOT reduced)."""
    data = np.asarray(data, dtype=np.uint8).reshape(-1, 32).astype(np.uint32)
    limbs = (data[:, 0::2] | (data[:, 1::2] << 8)).T.copy()  # (16, N)
    limbs[15] &= 0x7FFF
    return limbs


def to_bytes_array(limbs) -> np.ndarray:
    """Canonical encodings: (16, N) limbs → (N, 32) uint8 on the host."""
    if not isinstance(limbs, torch.Tensor):
        limbs = to_tensor(limbs, "cpu")
    limbs = to_numpy(canonicalize(limbs)).reshape(NLIMB, -1)
    out = np.zeros((limbs.shape[1], 32), dtype=np.uint8)
    out[:, 0::2] = (limbs & 0xFF).T
    out[:, 1::2] = (limbs >> 8).T
    return out


# -- constants ----------------------------------------------------------------


def constant(v: int, batch_shape=(), device="cuda") -> torch.Tensor:
    """Broadcastable constant field element of shape (16,) + (1,)*len(batch)."""
    limbs = _to_limbs_int(v % P_INT).reshape((NLIMB,) + (1,) * len(batch_shape))
    return to_tensor(limbs, device)


def zeros(batch_shape, device="cuda") -> torch.Tensor:
    return torch.zeros((NLIMB,) + tuple(batch_shape), dtype=DTYPE, device=device)


def ones(batch_shape, device="cuda") -> torch.Tensor:
    one = zeros(batch_shape, device)
    one[0] = 1
    return one


# 4p = 2^257 - 76, saturated limbwise so (a + FOUR_P - b) never underflows
# for any fully-carried a, b: limb0 = 0x1FFB4, limbs 1..15 = 0x1FFFE.
_FOUR_P_SAT = np.full(NLIMB, 0x1FFFE, dtype=np.uint32)
_FOUR_P_SAT[0] = 0x1FFB4
assert sum(int(x) << (16 * k) for k, x in enumerate(_FOUR_P_SAT)) == 4 * P_INT

_P_LIMBS = [int(x) for x in _to_limbs_int(P_INT)]


def _four_p(like: torch.Tensor) -> torch.Tensor:
    shape = (NLIMB,) + (1,) * (like.dim() - 1)
    return to_tensor(_FOUR_P_SAT.reshape(shape), like.device)


# -- arithmetic ---------------------------------------------------------------


_LIMB_INDEX = torch.arange(NLIMB)


def _carry_pass(t: torch.Tensor, rounds: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One full carry pass over non-negative int64 limbs (16, *batch) →
    (carried limbs < 2^16, carry-out): the same value as a sequential ripple,
    computed in a fixed number of whole-tensor steps.

    `rounds` parallel rounds move each limb's excess one limb up; the caller
    gives enough of them to leave every limb in [0, 0x10001]. Then the carry
    into limb k is 1 exactly where the last limb below k that is not 0xFFFF
    is at least 0x10000 (it generates, the 0xFFFF limbs between propagate),
    found with a running maximum."""
    out = torch.zeros_like(t[0])
    for _ in range(rounds):
        c = t >> 16
        out = out + c[-1]
        t = (t & MASK16) + torch.cat([torch.zeros_like(c[:1]), c[:-1]])
    index = _LIMB_INDEX.to(t.device).reshape((NLIMB,) + (1,) * (t.dim() - 1)).expand_as(t)
    last = torch.cummax(torch.where(t != MASK16, index, -1), dim=0).values  # last non-0xFFFF <= k
    gen = (t > MASK16).to(torch.int64)
    carry_in = torch.where(last >= 0, torch.gather(gen, 0, last.clamp(min=0)), 0)  # out of limb k
    shifted = torch.cat([torch.zeros_like(carry_in[:1]), carry_in[:-1]])
    return (t + shifted) & MASK16, out + carry_in[-1]


def _normalize(t: torch.Tensor) -> torch.Tensor:
    """Carry-propagate limbs (< 2^27 each, any integer dtype) to the
    fully-carried int32 form < 2^256.

    Three passes with 2^256 ≡ 38 folds; branch-free and always sufficient:
    after pass1 the fold adds < 2^17 to limb0, after pass2 the fold adds at
    most 38, whose ripple pass3 absorbs. Rounds a pass: limbs < 2^27 take
    two to reach [0, 0x10001] (≤ 0xFFFF + 2^11, then ≤ 0x10000), the folded
    limb0 of passes 2 and 3 one.
    """
    t = t.to(torch.int64)
    t, carry = _carry_pass(t, 2)
    t[0] += carry * 38
    t, carry = _carry_pass(t, 1)
    t[0] += carry * 38
    t, _ = _carry_pass(t, 1)
    return t.to(DTYPE)


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _normalize(a + b)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p via a + (4p - b), never negative."""
    a, b = torch.broadcast_tensors(a, b)
    return _normalize(a + _four_p(a) - b)


def neg(a: torch.Tensor) -> torch.Tensor:
    return _normalize(_four_p(a) - a)


def mul_small(a: torch.Tensor, c: int) -> torch.Tensor:
    """Multiply by a small constant c < 2^11."""
    return _normalize(a * c)


_COL_LO = (torch.arange(NLIMB).unsqueeze(1) + torch.arange(NLIMB).unsqueeze(0)).reshape(-1)
_COL_HI = _COL_LO + 1


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Schoolbook 16x16-limb product with carry-save column accumulation.

    Products a_i*b_j reach 2^32, so they and their column sums are int64;
    the folded columns (< 2^27) are carried and narrowed to int32.
    """
    a, b = torch.broadcast_tensors(a, b)
    batch = a.shape[1:]
    # all 256 partial products a_i*b_j at once, row i*16 + j
    p = (a.to(torch.int64).unsqueeze(1) * b.to(torch.int64).unsqueeze(0)).reshape(
        (NLIMB * NLIMB,) + batch)
    cols = torch.zeros((2 * NLIMB,) + batch, dtype=torch.int64, device=a.device)
    cols.index_add_(0, _COL_LO.to(a.device), p & MASK16)
    cols.index_add_(0, _COL_HI.to(a.device), p >> 16)  # high halves are worth one column more
    # Fold columns 16..31 with 2^256 ≡ 38.
    return _normalize(cols[:NLIMB] + 38 * cols[NLIMB:])


def sqr(a: torch.Tensor) -> torch.Tensor:
    return mul(a, a)


def _sqr_n(a: torch.Tensor, n: int) -> torch.Tensor:
    for _ in range(n):
        a = sqr(a)
    return a


def _pow22501(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x^(2^250-1), x^11) — the shared prefix of inversion and sqrt chains
    (classic ref10 addition chain, as in dalek)."""
    t0 = sqr(x)                      # 2
    t1 = _sqr_n(t0, 2)               # 8
    t2 = mul(x, t1)                  # 9
    t3 = mul(t0, t2)                 # 11
    t4 = sqr(t3)                     # 22
    t5 = mul(t2, t4)                 # 31 = 2^5 - 1
    t6 = mul(_sqr_n(t5, 5), t5)      # 2^10 - 1
    t7 = mul(_sqr_n(t6, 10), t6)     # 2^20 - 1
    t8 = mul(_sqr_n(t7, 20), t7)     # 2^40 - 1
    t9 = mul(_sqr_n(t8, 10), t6)     # 2^50 - 1
    t10 = mul(_sqr_n(t9, 50), t9)    # 2^100 - 1
    t11 = mul(_sqr_n(t10, 100), t10)  # 2^200 - 1
    t12 = mul(_sqr_n(t11, 50), t9)   # 2^250 - 1
    return t12, t3


def inv(a: torch.Tensor) -> torch.Tensor:
    """a^(p-2) = a^(2^255 - 21); inv(0) == 0."""
    t12, t3 = _pow22501(a)
    return mul(_sqr_n(t12, 5), t3)


def pow_p58(a: torch.Tensor) -> torch.Tensor:
    """a^((p-5)/8) = a^(2^252 - 3)."""
    t12, _ = _pow22501(a)
    return mul(_sqr_n(t12, 2), a)


def canonicalize(a: torch.Tensor) -> torch.Tensor:
    """Reduce to the canonical representative in [0, p)."""
    for _ in range(2):  # value < 2^256 < 3p, so two conditional subtracts
        diff = []
        borrow = torch.zeros_like(a[0])
        for k in range(NLIMB):
            v = a[k] + (0x10000 - _P_LIMBS[k]) - borrow
            diff.append(v & MASK16)
            borrow = 1 - (v >> 16)
        ge = borrow == 0  # a >= p
        a = torch.where(ge.unsqueeze(0), torch.stack(diff), a)
    return a


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise field equality → bool over the batch."""
    return torch.all(canonicalize(a) == canonicalize(b), dim=0)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return torch.all(canonicalize(a) == 0, dim=0)


def is_negative(a: torch.Tensor) -> torch.Tensor:
    """dalek IS_NEGATIVE: canonical encoding is odd."""
    return (canonicalize(a)[0] & 1).to(torch.bool)


def cabs(a: torch.Tensor) -> torch.Tensor:
    """CT_ABS: negate iff negative."""
    return select(is_negative(a), neg(a), a)


def select(cond: torch.Tensor, a_true: torch.Tensor, a_false: torch.Tensor) -> torch.Tensor:
    """Per-batch-element select; cond has batch shape (no limb dim)."""
    return torch.where(cond.unsqueeze(0), a_true, a_false)


def sqrt_ratio_m1(u: torch.Tensor, v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched FieldElement::sqrt_ratio_i (see spec.field.sqrt_ratio_m1)."""
    v3 = mul(sqr(v), v)
    v7 = mul(sqr(v3), v)
    r = mul(mul(u, v3), pow_p58(mul(u, v7)))
    check = mul(v, sqr(r))

    u_neg = neg(u)
    correct_sign = eq(check, u)
    flipped_sign = eq(check, u_neg)
    sqrt_m1 = constant(SF.SQRT_M1, v.shape[1:], v.device)
    flipped_sign_i = eq(check, mul(u_neg, sqrt_m1))

    r = select(flipped_sign | flipped_sign_i, mul(r, sqrt_m1), r)
    r = cabs(r)
    return correct_sign | flipped_sign, r
