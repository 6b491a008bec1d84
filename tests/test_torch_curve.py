"""rofl_tpu_torch.ops.curve (and the plain versions of the four kernels in
ops.kernels) against rofl_tpu.ops.curve on the JAX CPU path and against the
spec. Same inputs from a numpy seed; tolerance: exact equality of limbs,
masks and bytes. Lane counts stay <= 256 so the JAX side shares one compile
per op."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.ops import curve as jcurve
from rofl_tpu_torch.ops import curve as tcurve
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import kernels as tkernels
from rofl_tpu_torch.spec import field as SF
from rofl_tpu_torch.spec import ristretto as SR

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(77)
N = 77  # not a power of two


def spec_points(n):
    return [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(n)]


# identity, basepoint, P and -P up front, then random points
PTS_A = [SR.identity(), SR.BASEPOINT, SR.BASEPOINT, SR.identity()] + spec_points(N - 4)
PTS_B = [SR.BASEPOINT, SR.identity(), -SR.BASEPOINT, SR.identity()] + spec_points(N - 4)
PTS_B[10] = PTS_A[10]      # P + P through the unified add
PTS_B[11] = -PTS_A[11]     # P + (-P)


def both(points):
    """The same spec points packed for the port and for the JAX package."""
    t = tcurve.pack_points(points, "cpu")
    j = jcurve.PointArray(*[jnp.asarray(tfe.to_numpy(c)) for c in t])
    return t, j


TA, JA = both(PTS_A)
TB, JB = both(PTS_B)


def same(t_out, j_out):
    t_np, j_np = t_out.numpy(), np.asarray(j_out)
    assert t_np.shape == j_np.shape
    np.testing.assert_array_equal(t_np.astype(np.int64), j_np.astype(np.int64))


def same_point(t_pt, j_pt):
    for t_c, j_c in zip(t_pt, j_pt):
        same(t_c, j_c)


def encodings(t_pt):
    return [bytes(r) for r in tcurve.compress_to_bytes(t_pt)]


def test_pack_matches_jax_pack_and_roundtrips():
    same_point(TA, jcurve.pack_points(PTS_A))
    assert TA.x.dtype == tfe.DTYPE and TA.batch_shape == (N,)
    back = tcurve.unpack_points(TA)
    assert all(a == b for a, b in zip(back, PTS_A))


def test_identity_and_basepoint():
    same_point(tcurve.identity((5,), "cpu"), jcurve.identity((5,)))
    same_point(tcurve.basepoint((5,), "cpu"), jcurve.basepoint((5,)))
    assert encodings(tcurve.identity((1,), "cpu")) == [bytes(32)]
    assert encodings(tcurve.basepoint((1,), "cpu")) == [SR.BASEPOINT_COMPRESSED]


def test_add():
    got = tcurve.add(TA, TB)
    same_point(got, jcurve.add(JA, JB))
    assert encodings(got) == [(a + b).compress() for a, b in zip(PTS_A, PTS_B)]
    assert encodings(got)[10] == PTS_A[10].double().compress()
    assert encodings(got)[11] == bytes(32)


def test_add_broadcasts_one_lane():
    t1, j1 = both([PTS_B[5]])
    same_point(tcurve.add(TA, t1), jcurve.add(JA, j1))
    same_point(tcurve.add(t1, TA), jcurve.add(j1, JA))


def test_double():
    got = tcurve.double(TA)
    same_point(got, jcurve.double(JA))
    assert encodings(got) == [a.double().compress() for a in PTS_A]


def test_neg_and_select():
    same_point(tcurve.neg(TA), jcurve.neg(JA))
    cond = np.arange(N) % 2 == 0
    same_point(tcurve.select(torch.from_numpy(cond), TA, TB),
               jcurve.select(jnp.asarray(cond), JA, JB))


def test_compress():
    # a projective representation with Z != 1: the sum of two points
    t_sum, j_sum = tcurve.add(TA, TB), jcurve.add(JA, JB)
    for t_pt, j_pt, pts in ((TA, JA, PTS_A), (t_sum, j_sum, None)):
        got = tcurve.compress(t_pt)
        same(got, jcurve.compress(j_pt))
        np.testing.assert_array_equal(tcurve.compress_to_bytes(t_pt),
                                      jcurve.compress_to_bytes(j_pt))
        if pts is not None:
            assert encodings(t_pt) == [p.compress() for p in pts]


def invalid_encodings():
    """(32-byte strings, why each is no point). All are canonical field
    encodings, so only decompress itself can refuse them."""
    bad = []
    s = 2
    while len(bad) < 3:  # non-squares: even s the spec refuses
        if SR.decompress(s.to_bytes(32, "little")) is None:
            bad.append((s.to_bytes(32, "little"), "not a square"))
        s += 2
    enc = bytearray(PTS_A[20].compress())
    enc[0] |= 1
    bad.append((bytes(enc), "negative s"))
    bad.append((SF.to_bytes(SF.P - 1), "y = 0"))
    return bad


def test_decompress_valid_and_invalid():
    bad = invalid_encodings()
    rows = [p.compress() for p in PTS_A[: N - len(bad)]] + [b for b, _ in bad]
    raw = np.frombuffer(b"".join(rows), np.uint8).reshape(N, 32)
    limbs = tfe.from_bytes_array(raw)
    t_pt, t_valid = tcurve.decompress(tfe.to_tensor(limbs, "cpu"))
    j_pt, j_valid = jcurve.decompress(jnp.asarray(limbs))
    same(t_valid, j_valid)
    same_point(t_pt, j_pt)
    assert t_valid.dtype == torch.bool and t_valid.shape == (N,)
    assert t_valid.tolist() == [True] * (N - len(bad)) + [False] * len(bad)
    assert t_valid.tolist() == [SR.decompress(r) is not None for r in rows]
    assert tfe.unpack_scalars(t_pt.z) == [1] * N
    ok = PTS_A[: N - len(bad)]
    assert tcurve.eq(PointArray_head(t_pt, len(ok)), tcurve.pack_points(ok, "cpu")).all()


def PointArray_head(p, k):
    return tcurve.PointArray(*[c[:, :k] for c in p])


def test_eq():
    shuffled = list(PTS_A)
    shuffled[5], shuffled[6] = shuffled[6], shuffled[5]
    t_s, j_s = both(shuffled)
    got = tcurve.eq(TA, t_s)
    same(got, jcurve.eq(JA, j_s))
    assert got.tolist() == [i not in (5, 6) for i in range(N)]
    # equality is of group elements, not of coordinates
    assert tcurve.eq(tcurve.double(TA), tcurve.add(TA, TA)).all()


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, N])
def test_tree_sum(n):
    t_pt, j_pt = PointArray_head(TA, n), jcurve.PointArray(*[c[:, :n] for c in JA])
    got = tcurve.tree_sum(t_pt)
    assert got.x.shape == (16, 1)
    want = PTS_A[0]
    for p in PTS_A[1:n]:
        want = want + p
    assert encodings(got) == [want.compress()]
    if n in (3, N):
        same_point(got, jcurve.tree_sum(j_pt))


def test_tree_sum_over_an_inner_axis():
    """(16, 3, 25): sum over axis 0 of the batch, as add_commitments does."""
    t_pt = tcurve.PointArray(*[c[:, :75].reshape(16, 3, 25) for c in TA])
    j_pt = jcurve.PointArray(*[c[:, :75].reshape(16, 3, 25) for c in JA])
    got = tcurve.tree_sum(t_pt, axis=0)
    assert got.x.shape == (16, 1, 25)
    same_point(got, jcurve.tree_sum(j_pt, axis=0))
    want = [(PTS_A[i] + PTS_A[25 + i] + PTS_A[50 + i]).compress() for i in range(25)]
    assert encodings(got) == want


def test_single_lane():
    """One lane through the port ((16, 1) coordinates, as a one-lane slice
    gives them) against the JAX package's result for the same point, lane 7
    of the N-lane calls that the tests above compile: a JAX lane does not
    depend on the others, and one-lane JAX calls would compile every op
    again."""
    t1 = tcurve.pack_points([PTS_A[7]], "cpu")

    def lane7(coords):
        return tuple(np.asarray(c)[..., 7:8] for c in coords)

    same_point(tcurve.add(t1, t1), lane7(jcurve.add(JA, JA)))
    same_point(tcurve.double(t1), lane7(jcurve.double(JA)))
    j_enc = jcurve.compress(JA)
    same(tcurve.compress(t1), np.asarray(j_enc)[:, 7:8])
    t_pt, t_valid = tcurve.decompress(tcurve.compress(t1))
    j_pt, j_valid = jcurve.decompress(j_enc)
    same_point(t_pt, lane7(j_pt))
    same(t_valid, np.asarray(j_valid)[7:8])


def test_kernel_wrappers_use_the_plain_version_on_the_cpu():
    """On a CPU tensor a wrapper is its *_ref, and counts no launch."""
    before = dict(tkernels.LAUNCHES)
    p, q = tuple(TA), tuple(TB)
    for got, want in (
        (tkernels.point_add(p, q), tkernels.point_add_ref(p, q)),
        (tkernels.point_double(p), tkernels.point_double_ref(p)),
        ((tkernels.compress(p),), (tkernels.compress_ref(p),)),
        (tkernels.decompress(p[0])[0], tkernels.decompress_ref(p[0])[0]),
    ):
        for a, b in zip(got, want):
            assert torch.equal(a, b.expand_as(a))
    assert tkernels.LAUNCHES == before


def test_lane_counts_beside_the_launch_counts():
    """kernels.LANES counts the lanes of the same launches as LAUNCHES, one
    entry a kernel; CPU calls run the plain versions and leave both at 0."""
    assert set(tkernels.LANES) == set(tkernels.LAUNCHES) == set(tkernels.KERNEL_SOURCES)
    p, q = tuple(TA), tuple(TB)
    tkernels.point_add(p, q)
    tkernels.point_add(p, tuple(c[:, :1].contiguous() for c in q))
    tkernels.compress(p)
    assert all(v == 0 for v in tkernels.LAUNCHES.values())
    assert all(v == 0 for v in tkernels.LANES.values())
