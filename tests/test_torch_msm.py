"""The port's multi-scalar multiplication, generator map and grouped point
sums against the JAX package and the spec, on the CPU (plain versions).

``rofl_tpu_torch.ops.msm.msm`` / ``msm_grouped`` against
``rofl_tpu.ops.msm`` (a group size of 2, a lane count that is no power of
two) and ``msm`` with one scalar for every point against the spec, ``curve.elligator_map`` / ``from_uniform_bytes`` against
``rofl_tpu.ops.curve`` and ``spec.ristretto``, ``curve.tree_sum_groups``
against the JAX one, and ``range_proof.device_bp_gens(8, 4)`` against
``spec.generators.bp_gens_spec`` and the JAX package's generators carried
across by ``convert.bp_gens_from_numpy``. Tolerance: none; every result is compared
as canonical compressed encodings, byte for byte.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.crypto import range_proof as JRP
from rofl_tpu.ops import curve as jcurve
from rofl_tpu.ops import msm as jmsm
from rofl_tpu_torch import convert
from rofl_tpu_torch.crypto import range_proof as TRP
from rofl_tpu_torch.ops import curve, fe, msm, sc
from rofl_tpu_torch.spec import generators as G
from rofl_tpu_torch.spec import ristretto as SR
from rofl_tpu_torch.spec import scalar as SS

torch.set_num_threads(2)
rng = np.random.default_rng(4096)


def spec_points(n):
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(6)]
    pool += [SR.identity(), SR.BASEPOINT]
    return [pool[i % len(pool)] for i in range(n)]


def scalars(n):
    edges = [0, 1, SS.L - 1]
    return edges[:n] + [int.from_bytes(rng.bytes(32), "little") % SS.L for _ in range(n - 3)]


def jax_points(pts):
    packed = curve.pack_points(pts, "cpu")
    return jcurve.PointArray(*[jnp.asarray(fe.to_numpy(c)) for c in packed])


def encodings(p) -> list[bytes]:
    if isinstance(p, curve.PointArray):
        return [bytes(r) for r in curve.compress_to_bytes(p)]
    return [bytes(r) for r in jcurve.compress_to_bytes(p)]


def spec_sums(pts, ks, group):
    out = []
    for g in range(0, len(pts), group):
        acc = SR.identity()
        for p, k in zip(pts[g:g + group], ks[g:g + group]):
            acc = acc + p.scalar_mul(k)
        out.append(acc.compress())
    return out


@pytest.mark.parametrize("group", [2, 16])
def test_msm_grouped_matches_the_jax_package(group):
    pts, ks = spec_points(64), scalars(64)
    k_np = sc.pack_scalars(ks)
    got = msm.msm_grouped(curve.pack_points(pts, "cpu"), fe.to_tensor(k_np, "cpu"), group)
    want = jmsm.msm_grouped(jax_points(pts), jnp.asarray(k_np), group)
    assert encodings(got) == encodings(want) == spec_sums(pts, ks, group)


def test_msm_matches_the_jax_package_at_a_lane_count_that_is_no_power_of_two():
    pts, ks = spec_points(37), scalars(37)
    k_np = sc.pack_scalars(ks)
    got = msm.msm(curve.pack_points(pts, "cpu"), fe.to_tensor(k_np, "cpu"))
    want = jmsm.msm(jax_points(pts), jnp.asarray(k_np))
    assert encodings(got) == encodings(want) == spec_sums(pts, ks, 37)


def test_msm_takes_one_scalar_for_every_point():
    pts, ks = spec_points(5), [int.from_bytes(rng.bytes(32), "little") % SS.L]
    got = msm.msm(curve.pack_points(pts, "cpu"), fe.to_tensor(sc.pack_scalars(ks), "cpu"))
    assert encodings(got) == spec_sums(pts, ks * 5, 5)


def test_elligator_map_and_from_uniform_bytes_match_the_jax_package_and_the_spec():
    data = np.frombuffer(rng.bytes(64 * 32), np.uint8).reshape(32, 64).copy()  # as 8 x 4 gens
    data[0] = 0  # both halves zero
    data[1, :32] = 0xFF  # a non-canonical field element
    got = curve.from_uniform_bytes(data, "cpu")
    want = jcurve.from_uniform_bytes(data)
    spec = [SR.from_uniform_bytes(bytes(row)).compress() for row in data]
    assert encodings(got) == encodings(want) == spec
    half = fe.to_tensor(fe.from_bytes_array(np.ascontiguousarray(data[:, :32])), "cpu")
    j_half = jnp.asarray(fe.from_bytes_array(np.ascontiguousarray(data[:, :32])))
    assert encodings(curve.elligator_map(half)) == encodings(jcurve.elligator_map(j_half))


@pytest.mark.parametrize("group", [3, 4])
def test_tree_sum_groups_matches_the_jax_package(group):
    pts = spec_points(4 * group)
    got = curve.tree_sum_groups(curve.pack_points(pts, "cpu"), group)
    want = jcurve.tree_sum_groups(jax_points(pts), group)
    assert got.x.shape == (16, 4)
    assert encodings(got) == encodings(want) == spec_sums(pts, [1] * len(pts), group)


def test_device_bp_gens_match_the_spec_and_the_jax_package():
    gens_G, gens_H = TRP.device_bp_gens(8, 4, "cpu")
    spec_G, spec_H = G.bp_gens_spec(8, 4)
    assert encodings(gens_G) == [p.compress() for p in spec_G]
    assert encodings(gens_H) == [p.compress() for p in spec_H]
    assert TRP.device_bp_gens(8, 4, "cpu") is TRP.device_bp_gens(8, 4, torch.device("cpu"))
    j_G, j_H = JRP.device_bp_gens(8, 4)
    c_G, c_H = convert.bp_gens_from_numpy([np.asarray(c) for c in j_G],
                                          [np.asarray(c) for c in j_H], device="cpu")
    assert encodings(c_G) == encodings(gens_G) and encodings(c_H) == encodings(gens_H)
