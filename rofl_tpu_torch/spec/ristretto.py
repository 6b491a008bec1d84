"""Ristretto255 group — bit-exact spec (RFC 9496 / curve25519-dalek-ng).

Host-side ground truth for the batched device kernels in
``rofl_tpu_torch.ops.curve``. Encodings, the one-way map (Elligator), and
hash-to-group reproduce curve25519-dalek-ng exactly, which is what the
reference's commitments/proofs are made of (SURVEY.md §2.1, L0).

Points are held in extended twisted-Edwards coordinates (X:Y:Z:T) with
a = -1, x*y = T/Z.
"""

from __future__ import annotations

import hashlib

from . import field as F
from .field import P

_D = F.D
_2D = F.D2


class RistrettoPoint:
    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X: int, Y: int, Z: int, T: int):
        self.X, self.Y, self.Z, self.T = X % P, Y % P, Z % P, T % P

    # -- group ops ---------------------------------------------------------

    def __add__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        # Unified addition, add-2008-hwcd-3 (a = -1), as in dalek.
        X1, Y1, Z1, T1 = self.X, self.Y, self.Z, self.T
        X2, Y2, Z2, T2 = other.X, other.Y, other.Z, other.T
        A = (Y1 - X1) * (Y2 - X2) % P
        B = (Y1 + X1) * (Y2 + X2) % P
        C = T1 * _2D % P * T2 % P
        Dv = 2 * Z1 * Z2 % P
        E = (B - A) % P
        Fv = (Dv - C) % P
        G = (Dv + C) % P
        H = (B + A) % P
        return RistrettoPoint(E * Fv, G * H, Fv * G, E * H)

    def double(self) -> "RistrettoPoint":
        X1, Y1, Z1 = self.X, self.Y, self.Z
        A = X1 * X1 % P
        B = Y1 * Y1 % P
        C = 2 * Z1 * Z1 % P
        Dv = (-A) % P
        E = ((X1 + Y1) * (X1 + Y1) - A - B) % P
        G = (Dv + B) % P
        Fv = (G - C) % P
        H = (Dv - B) % P
        return RistrettoPoint(E * Fv, G * H, Fv * G, E * H)

    def __neg__(self) -> "RistrettoPoint":
        return RistrettoPoint((-self.X) % P, self.Y, self.Z, (-self.T) % P)

    def __sub__(self, other: "RistrettoPoint") -> "RistrettoPoint":
        return self + (-other)

    def __rmul__(self, n: int) -> "RistrettoPoint":
        return self.scalar_mul(n)

    def scalar_mul(self, n: int) -> "RistrettoPoint":
        n = int(n)
        acc = identity()
        add = self
        while n:
            if n & 1:
                acc = acc + add
            add = add.double()
            n >>= 1
        return acc

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, RistrettoPoint):
            return NotImplemented
        # Ristretto equality: X1*Y2 == Y1*X2 or X1*X2 == Y1*Y2 (dalek ct_eq).
        return (
            self.X * other.Y % P == self.Y * other.X % P
            or self.X * other.X % P == self.Y * other.Y % P
        )

    def __hash__(self):
        return hash(self.compress())

    # -- encodings ---------------------------------------------------------

    def compress(self) -> bytes:
        """Ristretto encoding (RFC 9496 §4.3.2), 32 bytes."""
        return F.to_bytes(self._encode()[0])

    def encode_selects(self) -> tuple[bool, bool]:
        """The encoding's two selects on this representative: (rotate,
        negate y). The batched encoders compute both sides of each."""
        return self._encode()[1:]

    def _encode(self) -> tuple[int, bool, bool]:
        X, Y, Z, T = self.X, self.Y, self.Z, self.T
        u1 = (Z + Y) * (Z - Y) % P
        u2 = X * Y % P
        _, inv_sqrt = F.sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
        den1 = inv_sqrt * u1 % P
        den2 = inv_sqrt * u2 % P
        z_inv = den1 * den2 % P * T % P
        ix0 = X * F.SQRT_M1 % P
        iy0 = Y * F.SQRT_M1 % P
        enchanted_denominator = den1 * F.INVSQRT_A_MINUS_D % P
        rotate = F.is_negative(T * z_inv % P)
        if rotate:
            x, y, den_inv = iy0, ix0, enchanted_denominator
        else:
            x, y, den_inv = X, Y, den2
        negate = F.is_negative(x * z_inv % P)
        if negate:
            y = (-y) % P
        return F.fabs(den_inv * ((Z - y) % P) % P), rotate, negate

    def is_identity(self) -> bool:
        return self.X == 0 and self.Y % P == self.Z % P


def identity() -> RistrettoPoint:
    return RistrettoPoint(0, 1, 1, 0)


def decompress(b: bytes) -> RistrettoPoint | None:
    """Ristretto decoding (RFC 9496 §4.3.1); None on invalid encoding."""
    if len(b) != 32:
        return None
    s_int = int.from_bytes(b, "little")
    if s_int >= P:  # non-canonical
        return None
    s = s_int
    if F.is_negative(s):
        return None
    ss = s * s % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = ((-_D * u1 % P * u1) - u2_sqr) % P
    was_square, inv_sqrt = F.sqrt_ratio_m1(1, v * u2_sqr % P)
    den_x = inv_sqrt * u2 % P
    den_y = inv_sqrt * den_x % P * v % P
    x = F.fabs(2 * s * den_x % P)
    y = u1 * den_y % P
    t = x * y % P
    if (not was_square) or F.is_negative(t) or y == 0:
        return None
    return RistrettoPoint(x, y, 1, t)


def elligator_map(t: int) -> RistrettoPoint:
    """One-way MAP (RFC 9496 §4.3.4 / dalek elligator_ristretto_flavor)."""
    r = F.SQRT_M1 * t % P * t % P
    u = (r + 1) * F.ONE_MINUS_D_SQ % P
    v = ((-1 - r * _D) % P) * ((r + _D) % P) % P
    was_square, s = F.sqrt_ratio_m1(u, v)
    s_prime = (-F.fabs(s * t % P)) % P
    if not was_square:
        s = s_prime
        c = r
    else:
        c = (-1) % P
    N = (c * ((r - 1) % P) % P * F.D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = N * F.SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return RistrettoPoint(w0 * w3, w2 * w1, w1 * w3, w0 * w2)


def from_uniform_bytes(b: bytes) -> RistrettoPoint:
    """RistrettoPoint::from_uniform_bytes: two Elligator maps, summed."""
    assert len(b) == 64
    r1 = F.from_bytes(b[:32]) % P
    r2 = F.from_bytes(b[32:]) % P
    return elligator_map(r1) + elligator_map(r2)


def hash_from_bytes_sha512(data: bytes) -> RistrettoPoint:
    """RistrettoPoint::hash_from_bytes::<Sha512> (standard hash-to-group)."""
    return from_uniform_bytes(hashlib.sha512(data).digest())


def hash_from_bytes_sha3_512(data: bytes) -> RistrettoPoint:
    """RistrettoPoint::hash_from_bytes::<Sha3_512>.

    Used for the Pedersen blinding base B_blinding
    (rofl_crypto/src/rand_proof/el_gamal.rs:31-40; bulletproofs PedersenGens).
    """
    return from_uniform_bytes(hashlib.sha3_512(data).digest())


# Ed25519 / Ristretto basepoint.
BASEPOINT = RistrettoPoint(
    15112221349535400772501151409588531511454012693041857206046113283949847762202,
    46316835694926478169428394003475163141307993866256225615783033603165251855960,
    1,
    15112221349535400772501151409588531511454012693041857206046113283949847762202
    * 46316835694926478169428394003475163141307993866256225615783033603165251855960
    % P,
)

BASEPOINT_COMPRESSED = bytes.fromhex(
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76"
)
