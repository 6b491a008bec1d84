"""The port's multi-device dry run (``rofl_tpu_torch/parallel/dryrun.py``), the
mesh-routed square proofs and the server's mesh, on a virtual mesh of the CPU.

Stage 1 is held against the JAX package's (``tests/data/torch_port_mesh_kat.json``,
``dryrun``: its clients' fixed-point updates on a 2 × 4 mesh and the SHA-256
of the sum of their sharded commitments): the port commits the JAX updates
and must give the same encodings, exactly; its own SGD step must give each
update within one fixed-point unit of the JAX one (float32 gradients summed
in another order) and the same L1 norm within a relative 1e-5. Stages 2-5
run at 1 lane a client with FpConfig(8, 3) and a BSGS table of 128 (the
defaults, d = 256 and 2^16, are for the card: the plain BSGS table of 2^16
alone takes about 45 s on the CPU); their checks are the dry run's own.
"""

import hashlib

import numpy as np
import torch

from rofl_tpu_torch.crypto import pedersen, sigma
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl.server import ServerConfig, TrainingState
from rofl_tpu_torch.ops import curve, fe
from rofl_tpu_torch.parallel import dryrun
from rofl_tpu_torch.parallel import mesh as pmesh
from test_torch_mesh_kat import RANGE_FP, load_kat

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side

CPU = torch.device("cpu")
KAT = load_kat()["dryrun"]
FP = FpConfig(*RANGE_FP)


def kat_mesh() -> pmesh.Mesh:
    return pmesh.make_mesh(KAT["clients"], KAT["param"], [CPU] * (KAT["clients"] * KAT["param"]))


def test_stage1_commits_the_jax_updates_as_the_jax_mesh_does():
    mesh = kat_mesh()
    encs = [fe.to_tensor(FP.f32_to_scalar_limbs(np.asarray(u, np.float64) / FP.scale), "cpu")
            for u in KAT["units"]]
    assert encs[0].shape == (16, KAT["d_pad"])
    agg, ok = dryrun.commit_stage(mesh, encs)
    assert ok.shape == (KAT["d_pad"],) and bool(ok.all())
    assert hashlib.sha256(curve.compress_to_bytes(agg).tobytes()).hexdigest() == KAT["agg_sha256"]


def test_stage1_updates_are_the_jax_updates():
    updates, n_weights = dryrun.client_updates(kat_mesh())
    assert n_weights == KAT["D"] and [u.shape[0] for u in updates] == [KAT["d_pad"]] * 2
    for u, units, l1 in zip(updates, KAT["units"], KAT["update_l1"]):
        got = np.rint(u.double().numpy() * FP.scale).astype(np.int64)
        assert np.abs(got - np.asarray(units)).max() <= 1
        assert abs(float(u.double().abs().sum()) - l1) <= 1e-5 * l1


def test_encrange_round_on_a_virtual_cpu_mesh():
    """Stages 2-5 on 2 clients × 2 param shards: 1 lane a client (padded to
    2) with FpConfig(8, 3), a range proof of one chunk verified over the
    shards (tests/test_torch_mesh_rangeproof.py holds the prover's groups
    over a mesh), a BSGS table of 128; the stages' own checks raise on a
    failure. ``dryrun_multichip`` runs them after stage 1 on the card at
    d = 50000 with 16 chunks (chip_smoke.py, phase mesh)."""
    lines = []
    mesh = pmesh.make_mesh(*dryrun.mesh_axes(4), [CPU] * 4)
    assert mesh.shape == {"client": 2, "param": 2} and dryrun.mesh_axes(3) == (1, 3)
    seconds = dryrun.encrange_round(mesh, 1, FpConfig(8, 3), 128, 1, log=lines.append)
    assert list(seconds) == ["randproof prove", "randproof verify",
                             "rangeproof mesh prove + mesh-sharded verify MSM",
                             "sharded accumulate", "sharded BSGS extract"]
    assert lines[-1].startswith("dryrun_multichip ok")


def test_square_proofs_with_the_mesh_equal_unsharded_ones():
    """The Pedersen-only square proofs (no JAX mesh case is recorded: the
    JAX package routes them the same way) over 3 shards, 7 lanes padded to
    9, with `existing` commitments, and a tampered lane refused there."""
    m, r, r2 = (pedersen.rnd_scalar_tensor(7, np.random.default_rng(seed), "cpu")
                for seed in (1, 2, 3))
    existing = pedersen.pedersen_commit(m, r)
    mesh = pmesh.param_mesh(3, [CPU] * 3)
    p, c = sigma.square_proof_prove(m, r, r2, np.random.default_rng(5), existing=existing,
                                    mesh=mesh)
    p0, c0 = sigma.square_proof_prove(m, r, r2, np.random.default_rng(5), existing=existing)
    for a, b in zip((c.c_l, c.c_sq, p.c_l_prime, p.c_sq_prime),
                    (c0.c_l, c0.c_sq, p0.c_l_prime, p0.c_sq_prime)):
        assert (curve.compress_to_bytes(a) == curve.compress_to_bytes(b)).all()
    for a, b in ((p.z_m, p0.z_m), (p.z_r1, p0.z_r1), (p.z_r2, p0.z_r2)):
        assert torch.equal(a, b)
    z_r1 = p.z_r1.clone()
    z_r1[0, 4] ^= 1
    bad = sigma.SquareProofVec(p.c_l_prime, p.c_sq_prime, p.z_m, z_r1, p.z_r2)
    assert [bool(x) for x in sigma.square_proof_verify(bad, c, mesh=mesh)] == [
        i != 4 for i in range(7)]


def test_the_server_builds_no_mesh_off_a_set_of_cards_and_passes_it_to_verify():
    state = TrainingState(ServerConfig(device="cpu", bench_dir=None))
    assert state.mesh is None
    state.close()
    seen = []

    class Params:
        def verify(self, rng, mesh=None):
            seen.append(mesh)
            return True

    mesh = pmesh.param_mesh(2, [CPU] * 2)
    assert P.verify(Params(), np.random.default_rng(0), mesh) and seen == [mesh]
    assert P.verify(P.PlainParams(np.zeros(3, np.float32)), np.random.default_rng(0), mesh)
