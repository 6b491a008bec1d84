"""The port's device mesh (``rofl_tpu_torch/parallel/mesh.py``) against the
JAX package's, on a virtual mesh of the CPU.

The JAX side is ``tests/data/torch_port_mesh_kat.json`` (made by
tests/test_torch_mesh_kat.py on 8 virtual XLA:CPU devices; its shard_map
programs compile for minutes). The port's mesh here is
``[torch.device("cpu")] * 8`` and ``* 3``: the same shards, one after another
on the CPU. The tolerance is exact equality: every point is compared as its
32-byte encodings, every scalar as its 32 bytes. Each sharded result is also
held against the port's own unsharded call on the same inputs.

The mesh-routed provers and the dry run are in tests/test_torch_mesh_sigma.py,
tests/test_torch_mesh_rangeproof.py and tests/test_torch_mesh_dryrun.py: a
plain ladder costs about a second a call on the CPU whatever its lane count,
and a mesh makes a call a shard. The inputs and the unsharded results that
several cases share are made once (``functools.cache``).
"""

import functools

import numpy as np
import pytest
import torch

from rofl_tpu_torch.crypto import pedersen
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.ops import curve, fe, msm
from rofl_tpu_torch.parallel import mesh as pmesh
from test_torch_mesh_kat import (COMMIT_D, GROUP, GROUPED, MSM_D, PAIR_D, PAIR_FP, PAIR_TABLE,
                                 SEEDS, load_kat, pair_values, scalar_hex)

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side

CPU = torch.device("cpu")
KAT = load_kat()


def cpu_mesh(shards: int) -> pmesh.Mesh:
    return pmesh.param_mesh(shards, [CPU] * shards)


def scalars(n: int, seed: int) -> torch.Tensor:
    return pedersen.rnd_scalar_tensor(n, np.random.default_rng(seed), "cpu")


@functools.cache
def base_points(n: int, seed: int) -> curve.PointArray:
    """n multiples of B (one ladder); the cases that share them do not write
    to them."""
    return pedersen.base_B().mul(scalars(n, seed))


@functools.cache
def unsharded_msm_hex() -> str:
    return pts_hex(msm.msm(base_points(MSM_D, SEEDS["msm_points"]),
                           scalars(MSM_D, SEEDS["msm_scalars"])))


def pts_hex(p) -> str:
    return curve.compress_to_bytes(p).tobytes().hex()


def first(p, n: int):
    return curve.PointArray(*[c[:, :n].contiguous() for c in p])


def test_meshes_are_grids_of_devices_and_pad_with_inert_lanes():
    mesh = pmesh.make_mesh(2, 4, [CPU] * 8)
    assert mesh.shape == {"client": 2, "param": 4}
    assert mesh.axis_names == ("client", "param") and mesh.first == CPU
    assert mesh.client_row(1).shape == {"client": 1, "param": 4}
    assert pmesh.param_mesh(devices=[CPU] * 3).shape == {"client": 1, "param": 3}
    with pytest.raises(AssertionError, match="not enough devices"):
        pmesh.make_mesh(2, 4, [CPU] * 7)
    if not torch.cuda.is_available():  # no silent CPU default: None means every card
        with pytest.raises(ValueError):
            pmesh.param_mesh()
    # 10 lanes over 4 shards: 3 a shard, two identity points / zero scalars
    k = scalars(10, 1)
    p = pedersen.base_B().mul(k)
    sp, sk = pmesh.shard_points(mesh, p), pmesh.shard_vector(mesh, k)
    assert sp.n == sk.n == 10 and [s.x.shape[1] for s in sp.shards] == [3] * 4
    assert torch.equal(sk.shards[3][:, 1:], torch.zeros((16, 2), dtype=torch.int32))
    padding = curve.PointArray(*[c[:, 1:] for c in sp.shards[3]])
    assert bool(curve.eq(padding, curve.identity((2,), "cpu")).all())
    assert torch.equal(torch.cat(sk.shards, dim=1)[:, :10], k)
    assert pts_hex(first(curve.PointArray(*[torch.cat(c, dim=1) for c in zip(*sp.shards)]),
                         10)) == pts_hex(p)
    assert all(c is pmesh.replicate(mesh, k)[0] for c in pmesh.replicate(mesh, k))


@pytest.mark.parametrize("shards", [8, 3])
def test_sharded_msm_equals_the_jax_mesh(shards):
    """64 terms: 8 a shard, or 22 a shard with two inert terms."""
    pts = base_points(MSM_D, SEEDS["msm_points"])
    k = scalars(MSM_D, SEEDS["msm_scalars"])
    got = pmesh.sharded_msm(cpu_mesh(shards), pts, k)
    assert got.x.shape == (16, 1)
    assert pts_hex(got) == KAT["msm"][str(shards)] == unsharded_msm_hex()


@pytest.mark.parametrize("case", KAT["grouped"], ids=lambda c: f"{c['shards']}x{c['groups']}")
def test_sharded_grouped_msm_and_sums_equal_the_jax_mesh(case):
    """G groups of 4 lanes: whole groups a shard where G divides the axis, the
    local call where it does not (the JAX rule)."""
    shards, groups = case["shards"], case["groups"]
    assert (shards, groups) in GROUPED
    n = groups * GROUP
    n_all = max(g for _, g in GROUPED) * GROUP
    pts = first(base_points(n_all, SEEDS["grouped_points"]), n)
    k = scalars(n_all, SEEDS["grouped_scalars"])[:, :n].contiguous()
    mesh = cpu_mesh(shards)
    assert pts_hex(pmesh.sharded_msm_grouped(mesh, pts, k, GROUP)) == case["msm"] == pts_hex(
        msm.msm_grouped(pts, k, GROUP))
    assert pts_hex(pmesh.sharded_tree_sum_groups(mesh, pts, GROUP)) == case["tree_sum"] == (
        pts_hex(curve.tree_sum_groups(pts, GROUP)))


def test_sharded_commit_pair_add_and_bsgs_equal_the_jax_mesh():
    """B's table on each shard's device; two clients' ElGamal pairs added
    lane by lane; the sum extracted by a BSGS walk a shard (FpConfig(8, 3),
    a table of 128), at 8 shards and at 3 (64 pads to 66)."""
    k = scalars(COMMIT_D, SEEDS["commit"])
    fp = FpConfig(*PAIR_FP)
    units = pair_values(np.random.default_rng(SEEDS["pair_values"]))
    blinds = pedersen.cancelling_scalar_limbs(2, PAIR_D, np.random.default_rng(
        SEEDS["pair_blind"]), "cpu")
    pairs = [pedersen.elgamal_commit(fe.to_tensor(fp.f32_to_scalar_limbs(u / fp.scale), "cpu"),
                                     fe.to_tensor(b, "cpu")) for u, b in zip(units, blinds)]
    want = KAT["pair_bsgs"]
    assert pts_hex(pedersen.base_B().mul(k)) == KAT["commit"]
    for shards in (8, 3):
        mesh = cpu_mesh(shards)
        assert pts_hex(pmesh.sharded_commit(mesh, pedersen.base_B(), k)) == KAT["commit"]
        acc = pmesh.sharded_pair_add(mesh, pairs[0], pairs[1])
        assert (pts_hex(acc.L), pts_hex(acc.R)) == (want["L"], want["R"])
        values, ok = pmesh.sharded_bsgs(mesh, acc.L, PAIR_TABLE, fp.bsgs_n_bits)
        assert values.shape == (16, PAIR_D) and ok.shape == (PAIR_D,)
        assert scalar_hex(fe.to_numpy(values)) == want["values"]
        assert [bool(x) for x in ok] == want["ok"]
    assert np.array_equal(fp.scalar_limbs_to_f32(fe.to_numpy(values)),
                          (units.sum(axis=0) / fp.scale).astype(np.float32))
