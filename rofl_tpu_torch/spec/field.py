"""GF(2^255 - 19) arithmetic on Python ints — the bit-exact ground truth.

This module is the host-side "spec" implementation of the curve25519 base
field. It defines the exact semantics (canonical encodings, sign convention,
inverse-square-root selection) that the batched torch ops and CUDA kernels
in ``rofl_tpu_torch.ops`` must reproduce bit-for-bit, and that match
curve25519-dalek-ng as used by the reference (rofl_crypto/Cargo.toml:21).

All functions operate on ints in [0, P). Encodings are 32-byte little-endian
canonical representations, matching dalek's ``FieldElement::to_bytes``.
"""

from __future__ import annotations

P = 2**255 - 19

# Edwards curve constant d = -121665/121666 mod p.
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = (2 * D) % P

# sqrt(-1) mod p: the even (non-negative, per IS_NEGATIVE) square root.
SQRT_M1 = pow(2, (P - 1) // 4, P)
if SQRT_M1 % 2 == 1:
    SQRT_M1 = P - SQRT_M1
# Known value from curve25519-dalek (constants.rs SQRT_M1).
assert SQRT_M1 == 19681161376707505956807079304988542015446066515923890162744021073123829784752

A = P - 1  # twisted Edwards a = -1


def fadd(a: int, b: int) -> int:
    return (a + b) % P


def fsub(a: int, b: int) -> int:
    return (a - b) % P


def fmul(a: int, b: int) -> int:
    return (a * b) % P


def fsq(a: int) -> int:
    return (a * a) % P


def fneg(a: int) -> int:
    return (-a) % P


def finv(a: int) -> int:
    """Multiplicative inverse via Fermat (a^(p-2)); inv(0) == 0 like dalek."""
    return pow(a, P - 2, P)


def fpow_p58(a: int) -> int:
    """a^((p-5)/8), the core exponent of the combined sqrt/invsqrt."""
    return pow(a, (P - 5) // 8, P)


def is_negative(a: int) -> bool:
    """dalek/RFC-9496 IS_NEGATIVE: true iff the canonical encoding is odd."""
    return (a % P) & 1 == 1


def fabs(a: int) -> int:
    """CT_ABS: negate iff negative (odd canonical representative)."""
    a %= P
    return P - a if a & 1 else a


def sqrt_ratio_m1(u: int, v: int) -> tuple[bool, int]:
    """(was_square, r) with r = CT_ABS(sqrt(u/v)) or sqrt(i*u/v).

    Mirrors curve25519-dalek ``FieldElement::sqrt_ratio_i`` / RFC 9496
    SQRT_RATIO_M1. Returns (True, sqrt(u/v)) when u/v is square,
    (False, sqrt(i*u/v)) otherwise; r is always non-negative. For u=0
    returns (True, 0); for v=0 (u!=0) returns (False, 0).
    """
    u %= P
    v %= P
    v3 = (v * v % P) * v % P
    v7 = (v3 * v3 % P) * v % P
    r = (u * v3 % P) * fpow_p58(u * v7 % P) % P
    check = v * (r * r % P) % P

    u_neg = (-u) % P
    correct_sign = check == u
    flipped_sign = check == u_neg
    flipped_sign_i = check == (u_neg * SQRT_M1 % P)

    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    r = fabs(r)
    return (correct_sign or flipped_sign, r)


def invsqrt(a: int) -> tuple[bool, int]:
    """(was_square, 1/sqrt(a)); non-negative root (sqrt_ratio_m1(1, a))."""
    return sqrt_ratio_m1(1, a)


def to_bytes(a: int) -> bytes:
    """Canonical 32-byte little-endian encoding."""
    return (a % P).to_bytes(32, "little")


def from_bytes(b: bytes) -> int:
    """dalek FieldElement::from_bytes — LE, top bit (255) masked, NOT reduced.

    Returns the masked integer (may be >= P for 8 exceptional encodings);
    arithmetic mod P makes that equivalent.
    """
    assert len(b) == 32
    return int.from_bytes(b, "little") & ((1 << 255) - 1)


# Derived ristretto constants (RFC 9496 §4.1 / dalek constants.rs).
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = ((D - 1) * (D - 1)) % P
# invsqrt(a - d) with a = -1: non-negative root.
INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (A - D) % P)[1]
# sqrt(a*d - 1) = sqrt(-d - 1): dalek picks the NEGATIVE (odd) root here
# (validated against the RFC 9496 / dalek hash-to-group vectors).
SQRT_AD_MINUS_ONE = (P - sqrt_ratio_m1((A * D - 1) % P, 1)[1]) % P
