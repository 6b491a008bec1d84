"""Scalar field mod l = 2^252 + 27742317777372353535851937790883648493.

Bit-exact spec of curve25519-dalek's ``Scalar`` as used by the reference
(rofl_crypto uses Scalar for values, blindings, challenges, responses).
Scalars are plain Python ints in [0, L); encodings are canonical 32-byte LE.
"""

from __future__ import annotations

L = 2**252 + 27742317777372353535851937790883648493


def sadd(a: int, b: int) -> int:
    return (a + b) % L


def ssub(a: int, b: int) -> int:
    return (a - b) % L


def smul(a: int, b: int) -> int:
    return (a * b) % L


def sneg(a: int) -> int:
    return (-a) % L


def sinv(a: int) -> int:
    return pow(a, L - 2, L)


def to_bytes(a: int) -> bytes:
    return (a % L).to_bytes(32, "little")


def from_bytes_mod_order(b: bytes) -> int:
    """Scalar::from_bytes_mod_order: 32 LE bytes reduced mod l."""
    assert len(b) == 32
    return int.from_bytes(b, "little") % L


def from_bytes_mod_order_wide(b: bytes) -> int:
    """Scalar::from_bytes_mod_order_wide: 64 LE bytes reduced mod l.

    This is how Merlin challenge bytes become challenge scalars
    (rofl_crypto/src/rand_proof/transcript.rs:40-44).
    """
    assert len(b) == 64
    return int.from_bytes(b, "little") % L


def from_canonical_bytes(b: bytes) -> int | None:
    """Scalar::from_canonical_bytes: None unless canonical (< l, bit 255 clear)."""
    assert len(b) == 32
    if b[31] & 0x80:
        return None
    v = int.from_bytes(b, "little")
    return v if v < L else None


def is_canonical(b: bytes) -> bool:
    return from_canonical_bytes(b) is not None
