"""The CUDA kernels' field and point arithmetic, compiled for the host.

``csrc/fe25519.cuh``, ``csrc/ge25519.cuh`` and ``csrc/sc25519.cuh`` also
compile as plain C++.
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


FE_OPS = {
    "add": (0, lambda a, b: (a + b) % P),
    "sub": (1, lambda a, b: (a - b) % P),
    "mul": (2, lambda a, b: a * b % P),
    "sqr": (3, lambda a, b: a * a % P),
    "neg": (4, lambda a, b: (-a) % P),
    "mul_small_2": (5, lambda a, b: 2 * a % P),
    "canon": (6, lambda a, b: a % P),
    "inv": (7, lambda a, b: SF.finv(a % P)),
    "pow_p58": (8, lambda a, b: SF.fpow_p58(a % P)),
    "cabs": (9, lambda a, b: SF.fabs(a)),
}


def fe_inputs():
    a = [x for x in EDGES for _ in EDGES] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(64)]
    b = [y for _ in EDGES for y in EDGES] + [
        int.from_bytes(rng.bytes(32), "little") for _ in range(64)]
    return a, b


@pytest.mark.parametrize("name", sorted(FE_OPS))
def test_field_op_on_host(lib, name):
    op, want = FE_OPS[name]
    a, b = fe_inputs()
    a_np, b_np = limbs_i32(a), limbs_i32(b)
    out, flag = np.zeros_like(a_np), np.zeros(len(a), np.int32)
    lib.host_fe_op(op, ptr(a_np), ptr(b_np), ptr(out), ptr(flag), len(a))
    assert out.min() >= 0 and out.max() <= 0xFFFF  # fully carried
    got = fe.unpack_scalars(out)
    assert [g % P for g in got] == [want(x, y) for x, y in zip(a, b)]
    if name == "canon":
        assert got == [x % P for x in a]


def test_sqrt_ratio_m1_on_host(lib):
    a, b = fe_inputs()
    a_np, b_np = limbs_i32(a), limbs_i32(b)
    out, flag = np.zeros_like(a_np), np.zeros(len(a), np.int32)
    lib.host_fe_op(10, ptr(a_np), ptr(b_np), ptr(out), ptr(flag), len(a))
    want = [SF.sqrt_ratio_m1(x, y) for x, y in zip(a, b)]
    assert [bool(f) for f in flag] == [w[0] for w in want]
    assert [g % P for g in fe.unpack_scalars(out)] == [w[1] for w in want]


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
    out = [np.zeros((16, n), np.int32) for _ in range(4)]
    lib.host_point_double(*map(ptr, pa), *map(ptr, out), n)
    for o, r in zip(out, kernels.point_double_ref(tp)):
        np.testing.assert_array_equal(canon(o), fe.to_numpy(fe.canonicalize(r)))


def test_compress_on_host(lib):
    p, q = points()
    n = len(p)
    # sums have Z != 1; P + (-P) is the identity in a non-trivial representation
    s = kernels.point_add_ref(tuple(curve.pack_points(p, "cpu")),
                              tuple(curve.pack_points(q, "cpu")))
    sa = coords_i32(s)
    enc = np.zeros((16, n), np.int32)
    lib.host_compress(*map(ptr, sa), ptr(enc), n)
    np.testing.assert_array_equal(enc.astype(np.uint32), fe.to_numpy(kernels.compress_ref(s)))
    assert [bytes(r) for r in fe.to_bytes_array(enc)] == [
        (a + b).compress() for a, b in zip(p, q)]


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


def test_scalar_mul_ladder_on_host(lib):
    """The ladder of csrc/scalar_mul.cu (ge_ladder_step from bit 255 down)
    against the spec: k = 0, 1, l-1 and 2^256-1, the identity and the
    basepoint as P, random pairs, and k as one broadcast lane."""
    from rofl_tpu_torch.spec import scalar as SS

    L = SS.L
    p, _ = points()
    n = len(p)
    ks = [0, 1, L - 1, 2**256 - 1] + [
        int.from_bytes(rng.bytes(32), "little") % L for _ in range(n - 4)]
    pa = coords_i32(curve.pack_points(p, "cpu"))
    k_np = limbs_i32(ks)
    for k_lanes, k_arr, k_list in ((n, k_np, ks),
                                   (1, np.ascontiguousarray(k_np[:, 5:6]), [ks[5]] * n)):
        out = [np.zeros((16, n), np.int32) for _ in range(4)]
        lib.host_scalar_mul(ptr(k_arr), k_lanes, *map(ptr, pa), *map(ptr, out), n)
        got = curve.PointArray(*[torch.from_numpy(o) for o in out])
        assert [bytes(r) for r in curve.compress_to_bytes(got)] == [
            q.scalar_mul(k % L).compress() for q, k in zip(p, k_list)]


@pytest.mark.parametrize("group,per_thread,k_lanes", [
    (2, 2, None), (5, 1, None), (13, 2, None), (26, 8, None), (26, 2, 1)])
def test_msm_grid_on_host(lib, group, per_thread, k_lanes):
    """The grid of csrc/msm.cu (msm_thread_lanes, ge_msm_lanes, the block's
    halving tree) at 4 threads a block, against the spec: the partial sums of
    each group add up to that group's sum of k_i * P_i. Groups shorter than a
    block, one block, several blocks with a short last run; k = 0, 1, l-1 and
    the identity among the terms; k as one broadcast lane."""
    from rofl_tpu_torch.spec import scalar as SS

    L = SS.L
    p, q = points()
    pts = (p + q)[:26]
    n = len(pts)
    ks = [0, 1, L - 1] + [int.from_bytes(rng.bytes(32), "little") % L for _ in range(n - 3)]
    pa = coords_i32(curve.pack_points(pts, "cpu"))
    k_np = limbs_i32(ks)
    if k_lanes == 1:
        k_np, ks = np.ascontiguousarray(k_np[:, 7:8]), [ks[7]] * n
    threads = 4
    per_group = -(-group // (threads * per_thread))
    n_out = n // group * per_group
    out = [np.zeros((16, n_out), np.int32) for _ in range(4)]
    lib.host_msm(ptr(k_np), k_lanes or n, *map(ptr, pa), n, group, per_thread, threads,
                 *map(ptr, out))
    partials = curve.unpack_points(curve.PointArray(*[torch.from_numpy(o) for o in out]))
    for g in range(n // group):
        got = SR.identity()
        for part in partials[g * per_group:(g + 1) * per_group]:
            got = got + part
        want = SR.identity()
        for i in range(g * group, (g + 1) * group):
            want = want + pts[i].scalar_mul(ks[i])
        assert got.compress() == want.compress()


SHARED_SCALARS = {"zero": 0, "one": 1, "l_minus_1": None, "low_weight": (1 << 200) | 5,
                  "high_weight": 2**253 - 1, "random": None}


@pytest.mark.parametrize("kind", sorted(SHARED_SCALARS))
def test_shared_scalar_mul_ladder_on_host(lib, kind):
    """The loop of csrc/shared_scalar_mul.cu (one scalar for every lane, the
    add only on a set bit) against the spec: k = 0, 1, l-1, scalars of low
    and high Hamming weight and a random one, on random points with the
    identity and the basepoint among them."""
    from rofl_tpu_torch.spec import scalar as SS

    p, _ = points()
    n = len(p)
    k = {"l_minus_1": SS.L - 1,
         "random": int.from_bytes(rng.bytes(32), "little") % SS.L}.get(kind,
                                                                        SHARED_SCALARS[kind])
    pa = coords_i32(curve.pack_points(p, "cpu"))
    k_np = np.ascontiguousarray(fe.pack_scalars([k])[:, 0].astype(np.uint32))
    out = [np.zeros((16, n), np.int32) for _ in range(4)]
    lib.host_shared_scalar_mul(ptr(k_np), *map(ptr, pa), *map(ptr, out), n)
    got = curve.PointArray(*[torch.from_numpy(o) for o in out])
    assert [bytes(r) for r in curve.compress_to_bytes(got)] == [
        q.scalar_mul(k).compress() for q in p]


@pytest.mark.parametrize("window", [2, 4])
def test_scalar_mul_window_on_host(lib, window):
    """The body of csrc/scalar_mul_window.cu (the table of 2^W multiples in
    its [entry][word][lane] scratch, the lookup that reads every entry, the
    windows from the top) against the spec: k = 0, 1, l-1 and 2^256-1, the
    identity and the basepoint as P, random pairs, and k as one broadcast
    lane."""
    from rofl_tpu_torch.spec import scalar as SS

    L = SS.L
    p, _ = points()
    n = len(p)
    ks = [0, 1, L - 1, 2**256 - 1] + [
        int.from_bytes(rng.bytes(32), "little") % L for _ in range(n - 4)]
    pa = coords_i32(curve.pack_points(p, "cpu"))
    k_np = limbs_i32(ks)
    for k_lanes, k_arr, k_list in ((n, k_np, ks),
                                   (1, np.ascontiguousarray(k_np[:, 5:6]), [ks[5]] * n)):
        out = [np.zeros((16, n), np.int32) for _ in range(4)]
        table = np.zeros((1 << window) * 64 * n, np.int32)
        assert lib.host_scalar_mul_window(window, ptr(k_arr), k_lanes, *map(ptr, pa),
                                          ptr(table), *map(ptr, out), n) == 0
        got = curve.PointArray(*[torch.from_numpy(o) for o in out])
        assert [bytes(r) for r in curve.compress_to_bytes(got)] == [
            q.scalar_mul(k % L).compress() for q, k in zip(p, k_list)]
    assert lib.host_scalar_mul_window(3, ptr(k_np), n, *map(ptr, pa), ptr(table),
                                      *map(ptr, out), n) == 1
