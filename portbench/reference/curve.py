"""Ristretto255 in plain torch: the benchmark's own field and group code.

Written for the check of a run's output and nothing else: it imports no
module of the system under test. A field element is a (16, N) int64 tensor
of 16-bit limbs, value = sum(limb_i * 2^(16 i)), kept loosely reduced (every
limb below 2^18) between operations and made canonical only where an
encoding, a sign or an equality needs it. A product is the outer product of
the limbs, summed along its anti-diagonals by one float64 matrix product
(every partial sum stays below 2^53, so the sum is exact), folded with
2^256 = 38 (mod p) and carried. Points are (X, Y, Z, T) tuples in extended
twisted Edwards coordinates, a = -1. Encodings follow RFC 9496.
"""

from __future__ import annotations

import numpy as np
import torch

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
MASK = 0xFFFF
D = (-121665 * pow(121666, P - 2, P)) % P


def _sqrt_m1() -> int:
    r = pow(2, (P - 1) // 4, P)
    return P - r if r & 1 else r


SQRT_M1 = _sqrt_m1()


def _int_sqrt_ratio(u: int, v: int) -> tuple[bool, int]:
    """RFC 9496 SQRT_RATIO_M1 on Python ints (used for the constants)."""
    r = (u * pow(v, 3, P)) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    check = v * r * r % P
    correct, flipped = check == u % P, check == (-u) % P
    flipped_i = check == (-u) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    if r & 1:
        r = P - r
    return correct or flipped, r


ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P
INVSQRT_A_MINUS_D = _int_sqrt_ratio(1, (-1 - D) % P)[1]
SQRT_AD_MINUS_ONE = (P - _int_sqrt_ratio((-D - 1) % P, 1)[1]) % P
# 16 p with every limb at least 2^19: added before a subtraction so that no
# limb goes negative.
_P16 = [16 * ((P >> (16 * i)) & MASK) for i in range(16)]

BASEPOINT_BYTES = bytes.fromhex(
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76")

_consts: dict = {}


def const(x: int, device) -> torch.Tensor:
    """The field element x as a (16, 1) tensor on `device` (cached)."""
    key = (x, str(device))
    if key not in _consts:
        _consts[key] = torch.tensor([[(x >> (16 * i)) & MASK] for i in range(16)],
                                    dtype=torch.int64, device=device)
    return _consts[key]


def _p16(device) -> torch.Tensor:
    key = ("p16", str(device))
    if key not in _consts:
        _consts[key] = torch.tensor(_P16, dtype=torch.int64, device=device).reshape(16, 1)
    return _consts[key]


def _diagonals(device) -> torch.Tensor:
    key = ("diag", str(device))
    if key not in _consts:
        m = torch.zeros(31, 256, dtype=torch.float64)
        for i in range(16):
            for j in range(16):
                m[i + j, 16 * i + j] = 1.0
        _consts[key] = m.to(device)
    return _consts[key]


# -- field -------------------------------------------------------------------


def carry(x: torch.Tensor) -> torch.Tensor:
    """One parallel carry round: each limb keeps its low 16 bits and passes
    the rest up; what leaves the top limb comes back times 38."""
    hi = x >> 16
    return (x & MASK) + torch.cat([38 * hi[15:16], hi[:15]], dim=0)


def add(a, b):
    return carry(a + b)


def sub(a, b):
    return carry(a + _p16(a.device) - b)


def neg(a):
    return carry(_p16(a.device) - a)


def mul(a, b):
    prod = a.double().unsqueeze(1) * b.double().unsqueeze(0)  # (16, 16, N)
    n = prod.shape[2]
    c = (_diagonals(a.device) @ prod.reshape(256, n)).to(torch.int64)  # (31, N)
    lo = c[:16].clone()
    lo[:15] += 38 * c[16:]
    return carry(carry(carry(lo)))


def sq(a):
    return mul(a, a)


def sq_n(a, n: int):
    for _ in range(n):
        a = mul(a, a)
    return a


def canonical(a: torch.Tensor) -> torch.Tensor:
    """The canonical representative in [0, p), limbs below 2^16."""
    x = carry(a).clone()
    for _ in range(2):
        for i in range(15):
            x[i + 1] += x[i] >> 16
            x[i] &= MASK
        top = x[15] >> 15
        x[15] &= 0x7FFF
        x[0] += 19 * top
    t = x.clone()
    t[0] += 19
    for i in range(15):
        t[i + 1] += t[i] >> 16
        t[i] &= MASK
    ge = (t[15] >> 15) == 1
    t[15] &= 0x7FFF
    return torch.where(ge.unsqueeze(0), t, x)


def eq(a, b) -> torch.Tensor:
    return (canonical(a) == canonical(b)).all(dim=0)


def is_zero(a) -> torch.Tensor:
    return (canonical(a) == 0).all(dim=0)


def is_negative(a) -> torch.Tensor:
    return (canonical(a)[0] & 1) == 1


def select(mask, a, b):
    """a where mask, else b (mask: (N,) bool)."""
    return torch.where(mask.unsqueeze(0), a, b)


def fabs(a):
    return select(is_negative(a), neg(a), a)


def pow22523(z):
    """z^((p - 5) / 8) = z^(2^252 - 3)."""
    z2 = sq(z)
    z9 = mul(sq_n(z2, 2), z)
    z11 = mul(z9, z2)
    z_5_0 = mul(sq(z11), z9)                      # 2^5 - 1
    z_10_0 = mul(sq_n(z_5_0, 5), z_5_0)
    z_20_0 = mul(sq_n(z_10_0, 10), z_10_0)
    z_40_0 = mul(sq_n(z_20_0, 20), z_20_0)
    z_50_0 = mul(sq_n(z_40_0, 10), z_10_0)
    z_100_0 = mul(sq_n(z_50_0, 50), z_50_0)
    z_200_0 = mul(sq_n(z_100_0, 100), z_100_0)
    z_250_0 = mul(sq_n(z_200_0, 50), z_50_0)
    return mul(sq_n(z_250_0, 2), z)


def sqrt_ratio_m1(u, v):
    """RFC 9496 SQRT_RATIO_M1, lane by lane → (was_square (N,), r)."""
    dev = u.device
    v3 = mul(sq(v), v)
    v7 = mul(sq(v3), v)
    r = mul(mul(u, v3), pow22523(mul(u, v7)))
    check = mul(v, sq(r))
    u_neg = neg(u)
    correct = eq(check, u)
    flipped = eq(check, u_neg)
    flipped_i = eq(check, mul(u_neg, const(SQRT_M1, dev)))
    r = select(flipped | flipped_i, mul(r, const(SQRT_M1, dev)), r)
    return correct | flipped, fabs(r)


def from_bytes(b: np.ndarray, device) -> torch.Tensor:
    """(N, 32) little-endian bytes → (16, N) limbs, the value as given."""
    b = np.ascontiguousarray(b, dtype=np.uint8)
    limbs = b[:, 0::2].astype(np.int64) | (b[:, 1::2].astype(np.int64) << 8)
    return torch.from_numpy(np.ascontiguousarray(limbs.T)).to(device)


def to_bytes(a: torch.Tensor) -> np.ndarray:
    """Canonical (N, 32) little-endian bytes."""
    c = canonical(a).cpu().numpy().T
    out = np.empty((c.shape[0], 32), np.uint8)
    out[:, 0::2] = c & 0xFF
    out[:, 1::2] = c >> 8
    return out






# -- group -------------------------------------------------------------------


def identity(n: int, device):
    z = torch.zeros(16, n, dtype=torch.int64, device=device)
    o = z.clone()
    o[0] = 1
    return (z, o, o.clone(), z.clone())


def point_add(p, q):
    """Unified addition, add-2008-hwcd-3 (a = -1)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    dev = X1.device
    A = mul(sub(Y1, X1), sub(Y2, X2))
    B = mul(add(Y1, X1), add(Y2, X2))
    C = mul(mul(T1, const(2 * D % P, dev)), T2)
    Dd = mul(add(Z1, Z1), Z2)
    E, F, G, H = sub(B, A), sub(Dd, C), add(Dd, C), add(B, A)
    return (mul(E, F), mul(G, H), mul(F, G), mul(E, H))


def point_double(p):
    """dbl-2008-hwcd (a = -1)."""
    X1, Y1, Z1, _ = p
    A, B, Z2 = sq(X1), sq(Y1), sq(Z1)
    C = add(Z2, Z2)
    Dd = neg(A)
    E = sub(sub(sq(add(X1, Y1)), A), B)
    G = add(Dd, B)
    F = sub(G, C)
    H = sub(Dd, B)
    return (mul(E, F), mul(G, H), mul(F, G), mul(E, H))






def point_cat(*ps):
    return tuple(torch.cat(cs, dim=1) for cs in zip(*ps))


def point_slice(p, sl):
    return tuple(c[:, sl] for c in p)




def is_identity(p) -> torch.Tensor:
    return is_zero(p[0]) | is_zero(p[1])


def decode(b: np.ndarray, device):
    """Ristretto decoding of (N, 32) bytes → (points, valid (N,))."""
    s = from_bytes(b, device)
    canon = (canonical(s) == s).all(dim=0) & ((s[0] & 1) == 0)
    one = const(1, device)
    ss = sq(s)
    u1 = sub(one, ss)
    u2 = add(one, ss)
    u2_sqr = sq(u2)
    v = sub(neg(mul(const(D, device), sq(u1))), u2_sqr)
    was_square, inv_sqrt = sqrt_ratio_m1(one.expand_as(v), mul(v, u2_sqr))
    den_x = mul(inv_sqrt, u2)
    den_y = mul(mul(inv_sqrt, den_x), v)
    x = fabs(mul(add(s, s), den_x))
    y = mul(u1, den_y)
    t = mul(x, y)
    valid = canon & was_square & ~is_negative(t) & ~is_zero(y)
    return (x, y, one.expand_as(x).clone(), t), valid


def encode(p) -> np.ndarray:
    """Ristretto encoding → (N, 32) bytes."""
    X, Y, Z, T = p
    dev = X.device
    u1 = mul(add(Z, Y), sub(Z, Y))
    u2 = mul(X, Y)
    _, inv_sqrt = sqrt_ratio_m1(const(1, dev).expand_as(u1), mul(u1, sq(u2)))
    den1 = mul(inv_sqrt, u1)
    den2 = mul(inv_sqrt, u2)
    z_inv = mul(mul(den1, den2), T)
    ix0 = mul(X, const(SQRT_M1, dev))
    iy0 = mul(Y, const(SQRT_M1, dev))
    enchanted = mul(den1, const(INVSQRT_A_MINUS_D, dev))
    rotate = is_negative(mul(T, z_inv))
    x = select(rotate, iy0, X)
    y = select(rotate, ix0, Y)
    den_inv = select(rotate, enchanted, den2)
    y = select(is_negative(mul(x, z_inv)), neg(y), y)
    return to_bytes(fabs(mul(den_inv, sub(Z, y))))


def elligator(t):
    """RFC 9496 MAP, lane by lane."""
    dev = t.device
    one = const(1, dev)
    d = const(D, dev)
    r = mul(const(SQRT_M1, dev), sq(t))
    u = mul(add(r, one), const(ONE_MINUS_D_SQ, dev))
    v = mul(sub(neg(one), mul(r, d)), add(r, d))
    was_square, s = sqrt_ratio_m1(u, v)
    s_prime = neg(fabs(mul(s, t)))
    s = select(was_square, s, s_prime)
    c = select(was_square, neg(one).expand_as(r), r)
    n = sub(mul(mul(c, sub(r, one)), const(D_MINUS_ONE_SQ, dev)), v)
    w0 = mul(add(s, s), v)
    w1 = mul(n, const(SQRT_AD_MINUS_ONE, dev))
    ss = sq(s)
    w2 = sub(one, ss)
    w3 = add(one, ss)
    return (mul(w0, w3), mul(w2, w1), mul(w1, w3), mul(w0, w2))


def from_uniform_bytes(b: np.ndarray, device):
    """RistrettoPoint::from_uniform_bytes of (N, 64) bytes: two maps, summed
    (each half with its bit 255 cleared)."""
    b = np.array(b, dtype=np.uint8)
    b[:, 31] &= 0x7F
    b[:, 63] &= 0x7F
    return point_add(elligator(from_bytes(b[:, :32], device)),
                     elligator(from_bytes(b[:, 32:], device)))


# -- sums and multi-scalar multiplication ------------------------------------


def point_sum(p):
    """The sum of all N points → one point (16, 1)."""
    n = p[0].shape[1]
    if n == 0:
        return identity(1, p[0].device)
    while n > 1:
        if n & 1:
            p = point_cat(p, identity(1, p[0].device))
            n += 1
        half = n // 2
        p = point_add(point_slice(p, slice(0, half)), point_slice(p, slice(half, n)))
        n = half
    return p


def scalars_to_bytes(xs) -> np.ndarray:
    """Python ints (reduced mod l) → (N, 32) little-endian bytes."""
    raw = b"".join((int(x) % L).to_bytes(32, "little") for x in xs)
    return np.frombuffer(raw, np.uint8).reshape(-1, 32)


def msm(points, scalar_bytes: np.ndarray, chunk: int = 1 << 17):
    """sum_i k_i P_i for (N, 32) little-endian scalars below 2^256: a 4-bit
    fixed-window ladder on every lane at once (a table of 0..15 P_i a lane),
    then the sum over the lanes; in chunks of `chunk` lanes."""
    dev = points[0].device
    n = points[0].shape[1]
    total = identity(1, dev)
    for lo in range(0, n, chunk):
        hi = min(n, lo + chunk)
        p = point_slice(points, slice(lo, hi))
        kb = scalar_bytes[lo:hi]
        nib = np.empty((hi - lo, 64), np.int64)
        nib[:, 0::2] = kb & 0x0F
        nib[:, 1::2] = kb >> 4
        digits = torch.from_numpy(np.ascontiguousarray(nib.T)).to(dev)  # (64, n)
        table = [identity(hi - lo, dev), p]
        for _ in range(14):
            table.append(point_add(table[-1], p))
        tab = torch.stack([torch.stack(t) for t in table])  # (16, 4, 16, n)

        def pick(w):
            idx = digits[w].view(1, 1, 1, -1).expand(1, 4, 16, -1)
            return tuple(tab.gather(0, idx)[0])

        acc = pick(63)
        for w in range(62, -1, -1):
            for _ in range(4):
                acc = point_double(acc)
            acc = point_add(acc, pick(w))
        del tab
        total = point_add(total, point_sum(acc))
    return total
