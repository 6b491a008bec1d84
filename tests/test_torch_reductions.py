"""The sums' layout: ``curve.tree_sum(axis=...)``, ``sc.sum_reduce(axis=...)``
and the ``_groups`` forms mapped onto (outer, R, inner)
(``kernels.reduction_layout``) and summed by ``kernels.point_sum`` /
``kernels.sc_sum``, on the CPU their plain versions, against
``rofl_tpu.ops.curve.tree_sum`` and ``rofl_tpu.ops.sc.sum_reduce(_groups)``
on JAX CPU and against the spec, at R = 1, 3 and 77, with outer and inner
axes around the summed one and non-contiguous operands. Inputs from a numpy
seed; scalars equal exactly, points as compressed encodings. One JAX point
sum is compiled here (about 6 s)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.ops import curve as jcurve
from rofl_tpu.ops import sc as jsc
from rofl_tpu_torch.ops import curve as tcurve
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import kernels as tkernels
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import ristretto as SR
from rofl_tpu_torch.spec import scalar as SS

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(1313)
L = SS.L


def encodings(pt):
    return [bytes(r) for r in tcurve.compress_to_bytes(pt)]


def jax_encodings(pt):
    return encodings(tcurve.PointArray(*[torch.from_numpy(np.asarray(c).astype(np.int32))
                                         for c in pt]))


def test_layout_of_an_axis_and_the_plan():
    """reduction_layout on a few shapes; sum_plan's threads a lane and
    slices on an H100's 132 SMs for the paths' layouts."""
    assert tkernels.reduction_layout((2, 77, 3), 1) == (2, 77, 3)
    assert tkernels.reduction_layout((2, 77, 3), 0) == (1, 2, 231)
    assert tkernels.reduction_layout((2, 77, 3), 2) == (154, 3, 1)
    assert tkernels.reduction_layout((50000,), 0) == (1, 50000, 1)
    assert tkernels.reduction_layout((4, 0, 5), 1) == (4, 0, 5)
    for axis in (-1, 3):
        with pytest.raises(ValueError):
            tkernels.reduction_layout((2, 77, 3), axis)
    wave = 132 * tkernels.SUM_BLOCKS_PER_SM
    # clients' sums and the verifier's chunk sums: one thread a lane
    assert tkernels.sum_plan(1, 4, 50000, wave)[0] == 1
    assert tkernels.sum_plan(1, 16, 32768, wave)[0] == 1
    # tree_sum of d and the provers' groups: several threads a lane, and slices
    for outer, r in ((1, 50000), (16, 32768), (32, 16384)):
        tpl, slices, _ = tkernels.sum_plan(outer, r, 1, wave)
        assert tpl > 1 and slices > 1
    # the IPA's last rounds: one thread a group
    assert tkernels.sum_plan(32, 2, 1, wave) == (1, 1, 1)
    for args in ((1, 50000, 1), (16, 32768, 1), (1, 3, 33), (5, 77, 1), (1, 100001, 1)):
        tpl, slices, tpl2 = tkernels.sum_plan(*args, wave)
        assert tpl & (tpl - 1) == 0 and tpl2 & (tpl2 - 1) == 0
        assert 1 <= slices <= max(1, -(-args[1] // tpl))


POOL = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(9)] + [
    SR.identity(), SR.BASEPOINT, -SR.BASEPOINT]


def points(n):
    return [POOL[i] for i in rng.integers(0, len(POOL), size=n)]


def spec_sum(pts):
    acc = SR.identity()
    for p in pts:
        acc = acc + p
    return acc.compress()


def test_point_sums_over_a_middle_axis_and_in_groups():
    """For R = 77 and 3: points (16, 2, R, 3) held as a non-contiguous view,
    summed over axis 1 (outer 2, inner 3), and the same terms as groups of
    R lanes. The JAX package's tree_sum over axis 1 of one (16, 12, 77)
    array (one compile) holds the 6 sums of each case, the R = 3 terms
    padded with the identity; so does the spec. Axis 0 of (16, 1, 6·R) is
    R = 1: the operand itself."""
    cases = {r: points(6 * r) for r in (77, 3)}
    jax_lanes = cases[77] + [q for g in range(6)
                             for q in cases[3][3 * g:3 * g + 3] + [SR.identity()] * 74]
    jax_in = jcurve.PointArray(*[jnp.asarray(tfe.to_numpy(c).reshape(16, 12, 77))
                                 for c in tcurve.pack_points(jax_lanes, "cpu")])
    jax_sums = jax_encodings([np.asarray(c).reshape(16, 12)
                              for c in jcurve.tree_sum(jax_in, axis=1)])
    for k, (r, pts) in enumerate(cases.items()):
        want = [spec_sum(pts[g * r:(g + 1) * r]) for g in range(6)]
        assert jax_sums[6 * k:6 * k + 6] == want
        packed = tcurve.pack_points(pts, "cpu")  # lane g·r + t: term t of group g = o·3 + i
        view = tcurve.PointArray(*[c.reshape(16, 2, 3, r).transpose(2, 3) for c in packed])
        assert view.x.shape == (16, 2, r, 3) and not view.x.is_contiguous()
        got = tcurve.tree_sum(view, axis=1)
        assert got.x.shape == (16, 2, 1, 3)
        assert encodings(tcurve.PointArray(*[c.reshape(16, 6) for c in got])) == want
        groups = tcurve.tree_sum_groups(packed, r)
        assert groups.x.shape == (16, 6) and encodings(groups) == want
        same = tcurve.tree_sum(tcurve.PointArray(*[c.reshape(16, 1, 6 * r) for c in packed]))
        assert same.x.shape == (16, 1, 6 * r)
        assert all(torch.equal(a.reshape(16, -1), b) for a, b in zip(same, packed))


def scalars(n):
    edges = [0, 1, L - 1, 2**252]
    return [edges[i] if i < len(edges) else int.from_bytes(rng.bytes(32), "little") % L
            for i in range(n)]


def test_scalar_sums_over_every_axis_and_in_groups():
    """Every axis of (16, 2, 77, 3) (R = 2, 77 and 3) and the middle one of
    (16, 3, 1, 5) (R = 1), contiguous and as a non-contiguous view, and
    groups of 1, 3 and 77 lanes, against the JAX package's sum_reduce and
    sum_reduce_groups (its jnp path: any group size; its kernel path asserts
    a power of two) and Python's sum mod l."""
    for shape, axes in (((2, 77, 3), (0, 1, 2)), ((3, 1, 5), (1,))):
        vals = scalars(int(np.prod(shape)))
        limbs = tsc.pack_scalars(vals)
        t = tfe.to_tensor(limbs, "cpu").reshape((16,) + shape)
        view = t.transpose(1, -1).contiguous().transpose(1, -1)
        assert torch.equal(view, t) and not view.is_contiguous()
        grid = np.array(vals, dtype=object).reshape(shape)
        for axis in axes:
            want = jsc.sum_reduce(jnp.asarray(limbs).reshape((16,) + shape), axis=axis)
            for operand in (t, view):
                got = tsc.sum_reduce(operand, axis=axis)
                assert got.shape == tuple(want.shape)
                np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(want))
            assert tsc.unpack_scalars(got.reshape(16, -1)) == [
                int(v) % L for v in grid.sum(axis=axis).reshape(-1)]
    for group in (1, 3, 77):
        vals = scalars(4 * group)
        limbs = tsc.pack_scalars(vals)
        got = tsc.sum_reduce_groups(tfe.to_tensor(limbs, "cpu"), group)
        np.testing.assert_array_equal(
            tfe.to_numpy(got), np.asarray(jsc.sum_reduce_groups(jnp.asarray(limbs), group)))
        assert tsc.unpack_scalars(got) == [
            sum(vals[g * group:(g + 1) * group]) % L for g in range(4)]


def test_empty_axes_and_groups_that_do_not_divide():
    """An empty axis sums to the identity and to zero; a group that does
    not divide the lanes is refused."""
    pt = tcurve.PointArray(*[c.reshape(16, 2, 0, 3) for c in tcurve.identity((0,), "cpu")])
    got = tcurve.tree_sum(pt, axis=1)
    assert got.x.shape == (16, 2, 1, 3)
    assert encodings(tcurve.PointArray(*[c.reshape(16, 6) for c in got])) == [
        SR.identity().compress()] * 6
    empty = torch.zeros((16, 4, 0), dtype=torch.int32)
    assert torch.equal(tsc.sum_reduce(empty, axis=1), torch.zeros((16, 4, 1), dtype=torch.int32))
    limbs = tfe.to_tensor(tsc.pack_scalars(scalars(12)), "cpu")
    for group in (0, 5, 13):
        with pytest.raises(ValueError):
            tsc.sum_reduce_groups(limbs, group)
        with pytest.raises(ValueError):
            tcurve.tree_sum_groups(tcurve.PointArray(limbs, limbs, limbs, limbs), group)
