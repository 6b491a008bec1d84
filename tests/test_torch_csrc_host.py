"""The CUDA kernels' field and point arithmetic, compiled for the host.

``csrc/fe25519_32.cuh`` and ``csrc/sc25519.cuh`` also compile as plain
C++.
``csrc/host_check.cpp`` wraps them in a C interface; this test builds it with
g++ and holds it against the spec and the plain torch versions: canonical
values bit-equal. It says nothing about the CUDA build or launch, which
only a run on the card can show."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rofl_tpu_torch.ops import curve, fe, kernels
from rofl_tpu_torch.spec import field as SF
from rofl_tpu_torch.spec import ristretto as SR
from torch_port_edges import DECOMPRESS_EDGE_CASES, decompress_edges, spec_decompress

P = SF.P
torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(2025)
EDGES = [0, 1, 19, 38, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2**255 - 1, 2**256 - 39,
         2**256 - 38, 2**256 - 1]


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host to build csrc/host_check.cpp")
    out = tmp_path_factory.mktemp("host_check") / "libhost_check.so"
    subprocess.run([gxx, "-O1", "-shared", "-fPIC", "-x", "c++", "-o", str(out),
                    str(kernels.CSRC_DIR / "host_check.cpp")], check=True)
    return ctypes.CDLL(str(out))


def ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def limbs_i32(values):
    return np.ascontiguousarray(fe.pack_scalars(values).astype(np.int32))


def coords_i32(point):
    return [np.ascontiguousarray(fe.to_numpy(c).astype(np.int32)) for c in point]


def canon(arr):
    return fe.to_numpy(fe.canonicalize(torch.from_numpy(np.ascontiguousarray(arr))))


def fe_inputs():
    a = [x for x in EDGES for _ in EDGES] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(64)]
    b = [y for _ in EDGES for y in EDGES] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(64)]
    return a, b


def points():
    p = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(20)]
    q = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(20)]
    p += [SR.identity(), SR.BASEPOINT, -SR.BASEPOINT, p[0], p[1]]
    q += [SR.BASEPOINT, SR.identity(), SR.BASEPOINT, p[0], -p[1]]
    return p, q


def test_point_add_and_double_on_host(lib):
    p, q = points()
    n = len(p)
    pa, qa = coords_i32(curve.pack_points(p, "cpu")), coords_i32(curve.pack_points(q, "cpu"))
    tp = tuple(torch.from_numpy(c) for c in pa)
    for q_lanes, q_coords in ((n, qa), (1, [np.ascontiguousarray(c[:, :1]) for c in qa])):
        out = [np.zeros((16, n), np.int32) for _ in range(4)]
        lib.host_point_add(*map(ptr, pa), n, *map(ptr, q_coords), q_lanes, *map(ptr, out), n)
        ref = kernels.point_add_ref(tp, tuple(torch.from_numpy(c) for c in q_coords))
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(canon(o), fe.to_numpy(fe.canonicalize(r)))
    # csrc/point_double.cu's lane, on the points as packed and on their
    # coordinates raised into [p, 2^256), as point_add's 32-bit output leaves them
    for coords in (pa, weakly_reduced(pa)):
        out = [np.zeros((16, n), np.int32) for _ in range(4)]
        lib.host_point_double(*map(ptr, coords), *map(ptr, out), n)
        assert 0 <= min(o.min() for o in out) and max(o.max() for o in out) <= 0xFFFF
        ref = kernels.point_double_ref(tuple(torch.from_numpy(c) for c in coords))
        for o, r in zip(out, ref):
            np.testing.assert_array_equal(canon(o), fe.to_numpy(fe.canonicalize(r)))
        got = curve.unpack_points(curve.PointArray(*[torch.from_numpy(o) for o in out]))
        assert [g.compress() for g in got] == [a.double().compress() for a in p]


def weakly_reduced(coords):
    """Each value v of (16, n) limbs as v + k p for the largest k that keeps
    it below 2^256: the limbs the 32-bit kernels may leave."""
    return [limbs_i32([v + (2**256 - 1 - v) // P * P for v in fe.unpack_scalars(c)])
            for c in coords]


def host_encodings(lib, coords):
    """csrc/compress.cu's lane on (16, n) int32 coordinates, as uint32 limbs."""
    n = coords[0].shape[1]
    enc = np.full((16, n), -1, np.int32)
    lib.host_compress(*map(ptr, coords), ptr(enc), n)
    return enc.astype(np.uint32)


def test_compress_on_host(lib):
    p, q = points()
    # sums have Z != 1; P + (-P) is the identity in a non-trivial representation
    s = kernels.point_add_ref(tuple(curve.pack_points(p, "cpu")),
                              tuple(curve.pack_points(q, "cpu")))
    want = [(a + b).compress() for a, b in zip(p, q)]
    for sa in (coords_i32(s), weakly_reduced(coords_i32(s))):
        enc = host_encodings(lib, sa)
        np.testing.assert_array_equal(
            enc, fe.to_numpy(kernels.compress_ref(tuple(torch.from_numpy(c) for c in sa))))
        assert [bytes(r) for r in fe.to_bytes_array(enc)] == want


# The 4-torsion point (i, 0) and the 2-torsion point (0, -1): adding them
# gives the four representatives of a Ristretto element, which between them
# take both sides of the encoding's rotate and negate-y selects.
TORSION = [SR.identity(), SR.RistrettoPoint(0, P - 1, 1, 0), SR.RistrettoPoint(SF.SQRT_M1, 0, 1, 0),
           SR.RistrettoPoint(-SF.SQRT_M1, 0, 1, 0)]


def compress_edge_points(lib, case):
    """(16, n) int32 coordinates and the spec's encodings of one edge case
    of csrc/compress.cu."""
    from rofl_tpu_torch.spec import scalar as SS

    p, q = points()
    if case == "representatives":  # each side of both selects, in scaled representations
        pts = [a + t for a in p[:8] + [SR.BASEPOINT] for t in TORSION]
        assert {a.encode_selects() for a in pts} == {
            (r, g) for r in (False, True) for g in (False, True)}
        scale = [int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1 for _ in pts]
        coords = [limbs_i32([getattr(a, c) * k % P for a, k in zip(pts, scale)])
                  for c in "XYZT"]
        return coords, [a.compress() for a in pts]
    if case == "identity_forms":  # (0 : s : s : 0), s = 2^256 - 1 among them, and the torsion
        s = [1, 2**256 - 1, P + 1, 2**255] + [
            int.from_bytes(rng.bytes(32), "little") % P or 1 for _ in range(4)]
        coords = [limbs_i32(v) for v in ([0] * len(s), s, s, [0] * len(s))]
        tors = coords_i32(curve.pack_points(TORSION, "cpu"))
        coords = [np.concatenate([c, t], axis=1) for c, t in zip(coords, tors)]
        return coords, [bytes(32)] * coords[0].shape[1]
    if case == "weakly_reduced":  # limbs up to 2^16 - 1: values in [p, 2^256)
        pts = p + [SR.BASEPOINT, -SR.BASEPOINT]
        return weakly_reduced(coords_i32(curve.pack_points(pts, "cpu"))), [
            a.compress() for a in pts]
    if case == "point_add_outputs":  # csrc/point_add.cu's lane, P + (-P) among them
        pa = coords_i32(curve.pack_points(p, "cpu"))
        qs = q[:-1] + [-p[-1]]
        qa = coords_i32(curve.pack_points(qs, "cpu"))
        out = [np.zeros_like(c) for c in pa]
        lib.host_point_add(*map(ptr, pa), len(p), *map(ptr, qa), len(p), *map(ptr, out), len(p))
        return out, [(a + b).compress() for a, b in zip(p, qs)]
    if case == "ladder_outputs":  # csrc/scalar_mul.cu's lane at 4 threads a block
        ks = [0, 1, SS.L - 1, 2**256 - 1] + [
            int.from_bytes(rng.bytes(32), "little") % SS.L for _ in range(len(p) - 4)]
        pa = coords_i32(curve.pack_points(p, "cpu"))
        out = [np.zeros_like(c) for c in pa]
        lib.host_scalar_mul(ptr(limbs_i32(ks)), len(p), *map(ptr, pa), *map(ptr, out),
                            len(p), 4)
        return out, [a.scalar_mul(k % SS.L).compress() for a, k in zip(p, ks)]
    # msm_outputs: csrc/msm.cu's three launches, 13 groups of 2 terms
    pts = (p + q)[:26]
    ks = [int.from_bytes(rng.bytes(32), "little") % SS.L for _ in pts]
    pa = coords_i32(curve.pack_points(pts, "cpu"))
    out = [np.zeros((16, 13), np.int32) for _ in range(4)]
    lib.host_msm(ptr(limbs_i32(ks)), len(pts), *map(ptr, pa), len(pts), 2, 1, 4, *map(ptr, out))
    return out, [(pts[2 * g].scalar_mul(ks[2 * g]) + pts[2 * g + 1].scalar_mul(ks[2 * g + 1]))
                 .compress() for g in range(13)]


@pytest.mark.parametrize("case", ["representatives", "identity_forms", "weakly_reduced",
                                  "point_add_outputs", "ladder_outputs", "msm_outputs"])
def test_compress_edges_on_host(lib, case):
    """rofl32::ristretto_compress (csrc/compress.cu) against the plain
    version and the spec, canonical and bit-equal: each side of the rotate
    and negate-y selects, the identity as (0 : s : s : 0) and as the
    torsion points, coordinates in [p, 2^256), and the limbs that the 32-bit
    point_add, ladder and MSM leave."""
    coords, want = compress_edge_points(lib, case)
    enc = host_encodings(lib, coords)
    np.testing.assert_array_equal(
        enc, fe.to_numpy(kernels.compress_ref(tuple(torch.from_numpy(c) for c in coords))))
    assert [bytes(r) for r in fe.to_bytes_array(enc)] == want


def test_decompress_on_host(lib):
    p, _ = points()
    good = np.stack([np.frombuffer(x.compress(), np.uint8) for x in p])
    odd = good.copy()
    odd[:, 0] ^= 1
    rand = np.frombuffer(rng.bytes(32 * 40), np.uint8).reshape(40, 32).copy()
    rand[:, 31] &= 0x7F
    special = np.stack([np.frombuffer(SF.to_bytes(v), np.uint8) for v in (0, 1, P - 1)])
    s = np.ascontiguousarray(
        fe.from_bytes_array(np.concatenate([good, odd, rand, special])).astype(np.int32))
    n = s.shape[1]
    out = [np.zeros((16, n), np.int32) for _ in range(4)]
    valid = np.zeros(n, np.uint8)
    lib.host_decompress(ptr(s), *map(ptr, out), ptr(valid), n)
    ref_pt, ref_valid = kernels.decompress_ref(torch.from_numpy(s))
    np.testing.assert_array_equal(valid.astype(bool), ref_valid.numpy())
    assert valid[: len(p)].all() and not valid[len(p): 2 * len(p)].any()
    assert 0 < valid.sum() < n
    for o, r in zip(out, ref_pt):
        np.testing.assert_array_equal(canon(o), fe.to_numpy(fe.canonicalize(r.expand(16, n))))


@pytest.mark.parametrize("case", DECOMPRESS_EDGE_CASES)
def test_decompress_edges_on_host(lib, case):
    """rofl32::ristretto_decompress (csrc/decompress.cu) on edge values of
    s below 2^256, against the plain version and the spec's decoding of
    s mod p: the mask, the canonical coordinates, z stored as canonical 1
    and every limb fully carried. The cases are those of
    torch_port_edges.decompress_edges: s = 0, 1, p - 1; every s in
    [p, 2^255); s with bit 255 set; odd s; non-squares; encodings whose y is
    0; and valid encodings."""
    values = decompress_edges(case, rng)
    s = limbs_i32(values)
    n = s.shape[1]
    out = [np.full((16, n), -1, np.int32) for _ in range(4)]
    valid = np.full(n, 7, np.uint8)
    lib.host_decompress(ptr(s), *map(ptr, out), ptr(valid), n)
    assert set(valid.tolist()) <= {0, 1}
    assert 0 <= min(o.min() for o in out) and max(o.max() for o in out) <= 0xFFFF
    np.testing.assert_array_equal(out[2], limbs_i32([1] * n))
    ref_pt, ref_valid = kernels.decompress_ref(torch.from_numpy(s))
    np.testing.assert_array_equal(valid.astype(bool), ref_valid.numpy())
    for o, r in zip(out, ref_pt):
        np.testing.assert_array_equal(canon(o), fe.to_numpy(fe.canonicalize(r.expand(16, n))))
    want = [spec_decompress(v) for v in values]
    assert valid.astype(bool).tolist() == [w is not None for w in want]
    got = [fe.unpack_scalars(canon(o)) for o in out]
    for lane, w in enumerate(want):
        if w is not None:
            assert [c[lane] for c in got] == [w.X, w.Y, 1, w.T]
    expected = {"special": [True, False, False], "y_zero": [False] * n,
                "odd": [False] * n, "non_squares": [False] * n, "valid": [True] * n}
    if case in expected:
        assert valid.astype(bool).tolist() == expected[case]
    if case in ("above_p", "bit_255"):  # the mask is that of s mod p
        assert 0 < valid.sum() < n


def test_sc_reduce_wide_on_host(lib):
    from rofl_tpu_torch.spec import scalar as SS

    L = SS.L
    wide = [0, 1, L - 1, L, L + 1, 2 * L, 2**252 - 1, 2**252, 2**256 - 1, 2**512 - 1,
            2**512 - 2**252, (2**260 - 1) << 252, L * (2**512 // L), L * (2**512 // L) - 1]
    wide += [int.from_bytes(rng.bytes(64), "little") for _ in range(300)]
    wide += [L * int.from_bytes(rng.bytes(31), "little") + d
             for d in (0, 1, L - 1) for _ in range(20)]
    cols = np.array([list(v.to_bytes(64, "little")) for v in wide], np.int32).T.copy()
    out = np.zeros((16, len(wide)), np.int32)
    lib.host_sc_reduce_wide(ptr(cols), ptr(out), len(wide))
    assert out.min() >= 0 and out.max() <= 0xFFFF
    assert fe.unpack_scalars(out) == [v % L for v in wide]
    np.testing.assert_array_equal(
        out, kernels.sc_reduce_wide_ref(torch.from_numpy(cols)).numpy())


SC_OPS = {
    "sc_mul": (0, lambda a, b, L: a * b % L),
    "sc_add": (1, lambda a, b, L: (a + b) % L),
    "sc_sub": (2, lambda a, b, L: (a - b) % L),
}


@pytest.mark.parametrize("name", sorted(SC_OPS))
def test_scalar_op_on_host(lib, name):
    """sc_mul, sc_add, sc_sub of csrc/sc25519.cuh against Python's % and the
    plain versions: 0, 1, l-1, 2^252 in every pairing (for sc_sub that has
    a < b and a = b), random pairs, and each operand as one broadcast lane."""
    from rofl_tpu_torch.spec import scalar as SS

    L = SS.L
    op, want = SC_OPS[name]
    edges = [0, 1, L - 1, 2**252, 2, L - 2]
    a = [x for x in edges for _ in edges] + [
        int.from_bytes(rng.bytes(32), "little") % L for _ in range(200)]
    b = [y for _ in edges for y in edges] + [
        int.from_bytes(rng.bytes(32), "little") % L for _ in range(200)]
    b[-1] = a[-1]
    n = len(a)
    a_np, b_np = limbs_i32(a), limbs_i32(b)
    plain = getattr(kernels, name + "_ref")
    for a_lanes, b_lanes in ((n, n), (n, 1), (1, n)):
        x = a_np if a_lanes == n else np.ascontiguousarray(a_np[:, 40:41])
        y = b_np if b_lanes == n else np.ascontiguousarray(b_np[:, 41:42])
        out = np.full((16, n), -1, np.int32)
        lib.host_sc_op(op, ptr(x), a_lanes, ptr(y), b_lanes, ptr(out), n)
        assert out.min() >= 0 and out.max() <= 0xFFFF
        xs = a if a_lanes == n else [a[40]] * n
        ys = b if b_lanes == n else [b[41]] * n
        assert fe.unpack_scalars(out) == [want(p, q, L) for p, q in zip(xs, ys)]
        np.testing.assert_array_equal(
            out, plain(torch.from_numpy(x), torch.from_numpy(y)).numpy())


def test_sc_mul_on_host_takes_any_16_bit_limbs(lib):
    from rofl_tpu_torch.spec import scalar as SS

    values = [2**256 - 1, 2**256 - 2**252, SS.L, SS.L + 1, 2**255] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(40)]
    n = len(values)
    a_np, b_np = limbs_i32(values), limbs_i32(values[::-1])
    out = np.zeros((16, n), np.int32)
    lib.host_sc_op(0, ptr(a_np), n, ptr(b_np), n, ptr(out), n)
    assert fe.unpack_scalars(out) == [x * y % SS.L for x, y in zip(values, values[::-1])]
    np.testing.assert_array_equal(
        out, kernels.sc_mul_ref(torch.from_numpy(a_np), torch.from_numpy(b_np)).numpy())



def lowest_digits(c):
    """The scalar whose signed c-bit digits below the top one are all
    -2^(c-1): 2^256 less the recoding's offset, so that k + offset = 2^256
    (at c = 4 every radix-16 digit is -8 and the top one 1)."""
    return 2**256 - sum((1 << (c - 1)) << (c * i) for i in range(-(-257 // c) - 1))


ALL_MINUS_8 = lowest_digits(4)


def test_scalar_mul_ladder_on_host(lib):
    """The ladder of csrc/scalar_mul.cu (ladder_scalar_mul: the table of
    P..8P in the block's shared memory, 65 signed radix-16 digits from the
    top) at 4 threads a block, against the spec: k = 0, 1, l-1, 2^256-1 and
    a scalar whose digits are all -8, the identity and the basepoint as P,
    random pairs, and k as one broadcast lane."""
    from rofl_tpu_torch.spec import scalar as SS

    L = SS.L
    p, _ = points()
    n = len(p)
    ks = [0, 1, L - 1, 2**256 - 1, ALL_MINUS_8] + [
        int.from_bytes(rng.bytes(32), "little") % L for _ in range(n - 5)]
    pa = coords_i32(curve.pack_points(p, "cpu"))
    k_np = limbs_i32(ks)
    for k_lanes, k_arr, k_list in ((n, k_np, ks),
                                   (1, np.ascontiguousarray(k_np[:, 5:6]), [ks[5]] * n),
                                   (1, np.ascontiguousarray(k_np[:, 4:5]), [ks[4]] * n)):
        out = [np.zeros((16, n), np.int32) for _ in range(4)]
        lib.host_scalar_mul(ptr(k_arr), k_lanes, *map(ptr, pa), *map(ptr, out), n, 4)
        got = curve.PointArray(*[torch.from_numpy(o) for o in out])
        assert [bytes(r) for r in curve.compress_to_bytes(got)] == [
            q.scalar_mul(k % L).compress() for q, k in zip(p, k_list)]
        assert 0 <= min(o.min() for o in out) and max(o.max() for o in out) <= 0xFFFF


FIELD32_OPS = {
    "add": (0, lambda a, b: (a + b) % P),
    "sub": (1, lambda a, b: (a - b) % P),
    "mul": (2, lambda a, b: a * b % P),
    "sqr": (3, lambda a, b: a * a % P),
    "neg": (4, lambda a, b: (-a) % P),
    "pack": (5, lambda a, b: a % P),
    "canon": (6, lambda a, b: a % P),
    "is_negative": (7, lambda a, b: int(SF.is_negative(a))),
    "cabs": (8, lambda a, b: SF.fabs(a)),
    "sqrt_ratio_m1": (9, lambda a, b: SF.sqrt_ratio_m1(1, a)[1]),
    "pow_p58": (10, lambda a, b: SF.fpow_p58(a % P)),
}


@pytest.mark.parametrize("name", sorted(FIELD32_OPS))
def test_field32_op_on_host(lib, name):
    """The 8 x 32-bit field of csrc/fe25519_32.cuh against Python's % and
    spec/field.py on every pairing of 0, 1, 19, 38, p-1, p, p+1, 2p-1, 2p,
    2^255-1, 2^256-39, 2^256-38 and 2^256-1 and random values, read from and
    written to the (16, n) storage of 16-bit limbs: outputs fully carried and
    below 2^256, the input itself for pack, the canonical value for canon,
    0 or 1 for is_negative, was_square beside the root for sqrt_ratio_m1,
    taken at u = 1 (fe_invsqrt, the only form the kernels run), and for
    pow_p58 the exponent chain x^((p-5)/8) that fe_invsqrt runs."""
    op, want = FIELD32_OPS[name]
    a, b = fe_inputs()
    a_np, b_np = limbs_i32(a), limbs_i32(b)
    out, flag = np.full_like(a_np, -1), np.full(len(a), -1, np.int32)
    lib.host_fe32_op(op, ptr(a_np), ptr(b_np), ptr(out), ptr(flag), len(a))
    assert out.min() >= 0 and out.max() <= 0xFFFF
    got = fe.unpack_scalars(out)
    assert [g % P for g in got] == [want(x, y) for x, y in zip(a, b)]
    if name == "pack":
        assert got == a
    if name in ("canon", "is_negative"):
        assert got == [want(x, y) for x, y in zip(a, b)]
    if name == "sqrt_ratio_m1":
        assert [bool(f) for f in flag] == [SF.sqrt_ratio_m1(1, x)[0] for x in a]
    else:
        assert not flag.any()


def recoding_scalars(name):
    from rofl_tpu_torch.spec import scalar as SS

    c = kernels.MSM_WINDOW
    if name == "edges":
        return [0, 1, SS.L - 1, 2**256 - 1, 2**255, lowest_digits(c), lowest_digits(c) - 1,
                lowest_digits(c) + 1, lowest_digits(4)]
    if name == "random_256_bit":
        return [int.from_bytes(rng.bytes(32), "little") for _ in range(200)]
    return [int.from_bytes(rng.bytes(32), "little") % SS.L for _ in range(200)]


@pytest.mark.parametrize("name", ["edges", "random_256_bit", "random_below_l"])
def test_signed_recoding_on_host(lib, name):
    """csrc/msm.cu's recoding (recode_signed at c = MSM_C = 3): ceil(257 / c)
    digits, those below the top in [-2^(c-1), 2^(c-1)), the top one in
    [0, 2^(c-1)], and sum d_i 2^(c i) = k, for k = 0, 1, l-1, 2^256-1,
    2^255, the scalar whose digits are all the lowest and its neighbours,
    the all -8 one of the ladder, and random values below 2^256 and below
    l."""
    ks = recoding_scalars(name)
    window = kernels.MSM_WINDOW
    n, count, half = len(ks), kernels.MSM_DIGITS, 1 << (window - 1)
    out = np.full((count, n), 99, np.int8)
    lib.host_recode(ptr(limbs_i32(ks)), ptr(out), n)
    assert out[:-1].min() >= -half and out[:-1].max() < half
    assert out[-1].min() >= 0 and out[-1].max() <= half
    assert [sum(int(d) << (window * i) for i, d in enumerate(out[:, j])) for j in range(n)] == ks
    if name == "edges":
        lowest = out[:, 5]
        assert (lowest[:-1] == -half).all() and lowest[-1] > 0


@pytest.mark.parametrize("group,slices,k_lanes", [
    (2, 1, None), (5, 1, None), (13, 3, None), (26, 2, None), (26, 4, 1), (26, 9, None),
    (13, 2, None), (26, 3, 1)])
def test_msm_grid_on_host(lib, group, slices, k_lanes):
    """The three launches of csrc/msm.cu (recoding, the bucket blocks with
    their private buckets, tree and running sum, the combine's Horner) at
    c = MSM_C, run block by block and thread by thread at 4 threads a
    block, against the spec: each group's sum of k_i * P_i. Groups shorter
    than a block, several slices, slices that do not divide the group and
    empty ones (9 slices of 26 terms); k = 0, 1, l-1, 2^256-1 and the scalar
    whose digits are all the lowest with the identity among the terms; k as
    one broadcast lane."""
    from rofl_tpu_torch.spec import scalar as SS

    L = SS.L
    p, q = points()
    pts = (p + q)[:26]
    n = len(pts)
    ks = [0, 1, L - 1, 2**256 - 1, lowest_digits(kernels.MSM_WINDOW)] + [
        int.from_bytes(rng.bytes(32), "little") % L for _ in range(n - 5)]
    pa = coords_i32(curve.pack_points(pts, "cpu"))
    k_np = limbs_i32(ks)
    if k_lanes == 1:
        k_np, ks = np.ascontiguousarray(k_np[:, 7:8]), [ks[7]] * n
    out = [np.zeros((16, n // group), np.int32) for _ in range(4)]
    lib.host_msm(ptr(k_np), k_lanes or n, *map(ptr, pa), n, group, slices, 4, *map(ptr, out))
    got = curve.unpack_points(curve.PointArray(*[torch.from_numpy(o) for o in out]))
    for g in range(n // group):
        want = SR.identity()
        for i in range(g * group, (g + 1) * group):
            want = want + pts[i].scalar_mul(ks[i] % L)
        assert got[g].compress() == want.compress()


SHARED_SCALARS = {"zero": 0, "one": 1, "two": 2, "l_minus_1": None, "two_255": 2**255,
                  "all_ones": 2**256 - 1, "low_weight": (1 << 200) | 5,
                  "high_weight": 2**253 - 1, "alternating_55": int("55" * 32, 16),
                  "alternating_aa": int("aa" * 32, 16), "random": None}


def shared_scalar(kind):
    from rofl_tpu_torch.spec import scalar as SS

    return {"l_minus_1": SS.L - 1,
            "random": int.from_bytes(rng.bytes(32), "little") % SS.L}.get(kind,
                                                                           SHARED_SCALARS[kind])


@pytest.mark.parametrize("kind", sorted(SHARED_SCALARS))
def test_shared_scalar_mul_ladder_on_host(lib, kind):
    """The body of csrc/shared_scalar_mul.cu (naf_scalar_mul: the table of
    P, 3P, ..., 15P in the block's shared memory, the width-5 NAF digits of
    kernels.naf_digits from the top, an add only on a nonzero digit) at 4
    threads a block against the spec: k = 0, 1, 2, l-1, 2^255, 2^256-1
    (whose NAF runs to digit 256), scalars of low and high weight, the
    alternating 0x55... and 0xAA... patterns and a random one, on random
    points with the identity and the basepoint among them. A digit count
    above 257 is refused."""
    from rofl_tpu_torch.spec import scalar as SS

    p, _ = points()
    n = len(p)
    k = shared_scalar(kind)
    digits = np.ascontiguousarray(kernels.naf_digits(k))
    pa = coords_i32(curve.pack_points(p, "cpu"))
    out = [np.zeros((16, n), np.int32) for _ in range(4)]
    assert lib.host_shared_scalar_mul(ptr(digits), len(digits), *map(ptr, pa),
                                      *map(ptr, out), n, 4) == 0
    got = curve.PointArray(*[torch.from_numpy(o) for o in out])
    assert [bytes(r) for r in curve.compress_to_bytes(got)] == [
        q.scalar_mul(k % SS.L).compress() for q in p]
    assert 0 <= min(o.min() for o in out) and max(o.max() for o in out) <= 0xFFFF
    assert lib.host_shared_scalar_mul(ptr(digits), 258, *map(ptr, pa), *map(ptr, out), n, 4) == 1


@pytest.mark.parametrize("window", [2, 4])
@pytest.mark.parametrize("k_mode", ["per_lane", "broadcast"])
def test_scalar_mul_window_on_host(lib, k_mode, window):
    """The body of csrc/scalar_mul_window.cu (ladder_scalar_mul<W>: the
    table of P .. 2^(W-1) P in the block's shared memory, the signed W-bit
    digits from the top, every entry read and selected) at 4 threads a
    block against the spec: k = 0, 1, 2, l-1, 2^255, 2^256-1, scalars of low
    and high weight, the alternating patterns, the scalar whose signed
    digits are all -2^(W-1), and random ones, the identity and the
    basepoint as P; per lane, and as one broadcast lane. W = 3 is refused."""
    from rofl_tpu_torch.spec import scalar as SS

    L = SS.L
    p, _ = points()
    n = len(p)
    edges = [0, 1, 2, L - 1, 2**255, 2**256 - 1, (1 << 200) | 5, 2**253 - 1,
             int("55" * 32, 16), int("aa" * 32, 16), lowest_digits(window)]
    ks = edges + [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n - len(edges))]
    pa = coords_i32(curve.pack_points(p, "cpu"))
    k_np = limbs_i32(ks)
    if k_mode == "per_lane":
        k_arr, k_lanes, k_list = k_np, n, ks
    else:
        k_arr, k_lanes, k_list = np.ascontiguousarray(k_np[:, 12:13]), 1, [ks[12]] * n
    out = [np.zeros((16, n), np.int32) for _ in range(4)]
    assert lib.host_scalar_mul_window(window, ptr(k_arr), k_lanes, *map(ptr, pa),
                                      *map(ptr, out), n, 4) == 0
    got = curve.PointArray(*[torch.from_numpy(o) for o in out])
    assert [bytes(r) for r in curve.compress_to_bytes(got)] == [
        q.scalar_mul(k % L).compress() for q, k in zip(p, k_list)]
    assert 0 <= min(o.min() for o in out) and max(o.max() for o in out) <= 0xFFFF
    assert lib.host_scalar_mul_window(3, ptr(k_arr), k_lanes, *map(ptr, pa),
                                      *map(ptr, out), n, 4) == 1


def exact_sum_terms(case):
    """The terms of one exact-sum case and whether they are canonical."""
    from rofl_tpu_torch.spec import scalar as SS

    L = SS.L
    if case == "zero_terms":
        return [], True
    if case == "one_term":
        return [L - 1], True
    if case == "l_minus_1_2^17_times":
        return [L - 1] * (1 << 17), True
    if case == "every_word_2^32_minus_1":  # any 256-bit term: every column carries
        return [2**256 - 1] * 70001 + [2**256 - 2**224, 2**255], False
    return [int.from_bytes(rng.bytes(32), "little") % L for _ in range(3000)], True


@pytest.mark.parametrize("case", ["zero_terms", "one_term", "l_minus_1_2^17_times",
                                  "every_word_2^32_minus_1", "random"])
def test_exact_scalar_sum_on_host(lib, case):
    """sc25519.cuh's exact sum (the column sums of sc_columns_add, then
    sc_reduce_columns: what csrc/sc_sum.cu runs) against Python's
    sum(...) % l, and on canonical terms against the plain chain of sc_add
    (kernels.sc_sum_ref), bit-equal: no term, one term, 2^17 terms of
    l - 1, terms with every word 2^32 - 1, random canonical terms."""
    from rofl_tpu_torch.spec import scalar as SS

    values, canonical = exact_sum_terms(case)
    a = limbs_i32(values) if values else np.zeros((16, 0), np.int32)
    out = np.full((16, 1), -1, np.int32)
    lib.host_sc_sum_columns(ptr(a), len(values), ptr(out))
    assert out.min() >= 0 and out.max() <= 0xFFFF
    assert fe.unpack_scalars(out) == [sum(values) % SS.L]
    if canonical:
        np.testing.assert_array_equal(
            out, kernels.sc_sum_ref(torch.from_numpy(a), 1, len(values), 1).numpy())


@pytest.mark.parametrize("layout,wave", [((1, 1000, 1), 528), ((3, 77, 1), 4),
                                         ((1, 64, 40), 528), ((32, 3, 1), 528),
                                         ((3, 300, 1), 8)])
def test_sum_grids_on_host(lib, layout, wave):
    """csrc/sc_sum.cu's and csrc/point_sum.cu's grids run block by block at
    their 128 threads, with the plan (threads a lane, slices, threads a lane
    of the second launch) that kernels.sum_plan makes for the layout on a
    card of `wave` blocks at once: one thread a lane and several, with and
    without slices and the second launch, lanes that do not fill a block.
    Scalars against Python's sum mod l and the plain chain, bit-equal;
    points against the spec and the plain chain as encodings."""
    from rofl_tpu_torch.spec import scalar as SS

    outer, r, inner = layout
    tpl, slices, tpl2 = kernels.sum_plan(outer, r, inner, wave)
    n, m = outer * r * inner, outer * inner
    terms = lambda vals: [[vals[(o * r + t) * inner + i] for t in range(r)]  # noqa: E731
                          for o in range(outer) for i in range(inner)]
    vals = [int.from_bytes(rng.bytes(32), "little") % SS.L for _ in range(n)]
    a = limbs_i32(vals)
    scratch, out = np.zeros((16, max(1, slices * m)), np.int32), np.full((16, m), -1, np.int32)
    lib.host_sc_sum(ptr(a), outer, r, inner, tpl, slices, tpl2, kernels.SUM_THREADS,
                    ptr(scratch), ptr(out))
    assert fe.unpack_scalars(out) == [sum(t) % SS.L for t in terms(vals)]
    np.testing.assert_array_equal(out, kernels.sc_sum_ref(torch.from_numpy(a), *layout).numpy())

    pool = points()[0][:12] + [SR.identity()]
    pts = [pool[k] for k in rng.integers(0, len(pool), size=n)]
    pa = coords_i32(curve.pack_points(pts, "cpu"))
    scratch = [np.zeros((16, max(1, slices * m)), np.int32) for _ in range(4)]
    out = [np.full((16, m), -1, np.int32) for _ in range(4)]
    lib.host_point_sum(*map(ptr, pa), outer, r, inner, tpl, slices, tpl2, kernels.SUM_THREADS,
                       *map(ptr, scratch), *map(ptr, out))
    got = [bytes(e) for e in fe.to_bytes_array(host_encodings(lib, out))]
    want = []
    for t in terms(pts):
        acc = SR.identity()
        for q in t:
            acc = acc + q
        want.append(acc.compress())
    assert got == want
    plain = kernels.point_sum_ref(tuple(torch.from_numpy(c) for c in pa), *layout)
    assert [bytes(e) for e in curve.compress_to_bytes(curve.PointArray(*plain))] == want
