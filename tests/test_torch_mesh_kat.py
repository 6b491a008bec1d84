"""Known answers of the JAX package's device mesh, kept honest.

The JAX mesh (``rofl_tpu/parallel/mesh.py``) runs its shard_map programs on
a virtual mesh of 8 CPU devices, and they compile for minutes on XLA:CPU
(``tests/test_parallel_mesh.py`` is marked ``slow``). So the tier-1 tests of
the port's mesh (tests/test_torch_mesh.py) do not rerun them: they read the
results from ``tests/data/torch_port_mesh_kat.json``. ``make_kat`` computes
them from fixed numpy seeds, at the smallest shapes that exercise the
padding of odd lane counts and the fallback of groups that do not divide
the axis:

  msm           sharded_msm of 64 terms over 8 and over 3 shards (64 pads
                to 66)
  grouped       sharded_msm_grouped and sharded_tree_sum_groups, G groups of
                4 lanes: G = 8 over 8 shards and G = 6 over 3 (sharded),
                G = 4 over 8 and over 3 (the local fallback)
  commit        sharded_commit of 64 scalars with B's table, 8 shards
  pair_bsgs     FpConfig(8, 3), 2 clients of 64 values with cancelling
                blindings: sharded_pair_add of their ElGamal pairs, then
                sharded_bsgs of the sum with a table of 128 (8 shards)
  sigma         the rand and square-rand proofs of 50 lanes over 8 shards
                (50 pads to 56), with their mesh verdicts
  rangeproof    create_rangeproof of 16 values in 8 chunks with the mesh,
                verify_rangeproof with the mesh, and its verdict on a proof
                with one flipped bit
  dryrun        the first stage of ``__graft_entry__.dryrun_multichip`` on
                a 2 x 4 (client x param) mesh: one SGD step of
                MnistMLP(hidden=4) per client, the fixed-point update (padded
                to a multiple of 8 x 4 lanes), its sharded commit and the sum
                of the clients' commitments (SHA-256 of the encodings)

Every point is kept as its 32-byte encodings, every scalar as its 32 bytes,
in hex. Regenerate the file with

    JAX_PLATFORMS=cpu python tests/test_torch_mesh_kat.py

(it sets the 8 virtual devices itself before it imports jax). The one test
here, marked ``slow``, recomputes it and asserts that the committed file
still equals what the JAX package gives, byte for byte.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

KAT_PATH = Path(__file__).resolve().parent / "data" / "torch_port_mesh_kat.json"

N_DEVICES = 8
SHARDS = (8, 3)
MSM_D = 64
GROUP = 4
GROUPED = ((8, 8), (8, 4), (3, 6), (3, 4))  # (shards, G): divides, falls back
COMMIT_D = 64
PAIR_FP = (8, 3)
PAIR_D = 64
PAIR_TABLE = 128
SIGMA_D = 50
RANGE_D = 16
RANGE_CHUNKS = 8
RANGE_FP = (16, 7)
RANGE_BITS = 8
FLIP_PROOF, FLIP_BYTE = 3, 5 * 32  # the lowest bit of chunk 3's t_x_blinding
DRYRUN_CLIENTS, DRYRUN_PARAM = 2, 4
DRYRUN_HIDDEN = 4
DRYRUN_BATCH = 4
DRYRUN_LR = 0.1
SEEDS = {
    "msm_points": 1, "msm_scalars": 2, "grouped_points": 3, "grouped_scalars": 4,
    "commit": 5, "pair_values": 6, "pair_blind": 7, "sigma_m": 8, "sigma_r": 9,
    "sigma_r2": 10, "rand_prove": 11, "square_rand_prove": 12, "range_values": 13,
    "range_blind": 14, "range_prove": 15, "range_verify": 16,
}


def scalar_hex(limbs) -> str:
    """(16, N) limbs of canonical scalars → the lanes' 32-byte encodings."""
    arr = np.asarray(limbs).astype(np.uint64)
    return b"".join(
        sum(int(arr[k, i]) << (16 * k) for k in range(16)).to_bytes(32, "little")
        for i in range(arr.shape[1])).hex()


def pair_values(rng: np.random.Generator) -> np.ndarray:
    """(2, PAIR_D) fixed-point units whose column sums stay inside the 8-bit
    walk of FpConfig(8, 3)."""
    return rng.integers(-60, 61, size=(2, PAIR_D))


def make_kat() -> dict:
    """Run the JAX package's mesh on 8 virtual CPU devices from the fixed
    seeds → the KAT dict."""
    import jax
    import jax.numpy as jnp
    from jax.flatten_util import ravel_pytree

    from rofl_tpu.crypto import pedersen, sigma
    from rofl_tpu.crypto import range_proof as RP
    from rofl_tpu.crypto import range_proof_vec as rpv
    from rofl_tpu.crypto.fp_codec import FpConfig
    from rofl_tpu.models.networks import MnistMLP
    from rofl_tpu.models.trainer import cross_entropy
    from rofl_tpu.ops import curve
    from rofl_tpu.parallel import mesh as pmesh

    assert len(jax.devices()) >= N_DEVICES, "needs 8 virtual CPU devices"

    def pts_hex(p) -> str:
        return np.asarray(curve.compress_to_bytes(p)).tobytes().hex()

    def scalars(n, seed):
        return jnp.asarray(pedersen.rnd_scalar_limbs(n, np.random.default_rng(seed)))

    meshes = {k: pmesh.param_mesh(k) for k in SHARDS}
    kat: dict = {"seeds": SEEDS}

    pts = pedersen.base_B().mul(scalars(MSM_D, SEEDS["msm_points"]))
    scal = scalars(MSM_D, SEEDS["msm_scalars"])
    kat["msm"] = {str(k): pts_hex(pmesh.sharded_msm(meshes[k], pts, scal)) for k in SHARDS}
    print("msm", flush=True)

    n_grouped = max(g for _, g in GROUPED) * GROUP
    gpts = pedersen.base_B().mul(scalars(n_grouped, SEEDS["grouped_points"]))
    gscal = scalars(n_grouped, SEEDS["grouped_scalars"])
    kat["grouped"] = []
    for k, g in GROUPED:
        n = g * GROUP
        p = curve.PointArray(*[c[:, :n] for c in gpts])
        kat["grouped"].append({
            "shards": k, "groups": g,
            "msm": pts_hex(pmesh.sharded_msm_grouped(meshes[k], p, gscal[:, :n], GROUP)),
            "tree_sum": pts_hex(pmesh.sharded_tree_sum_groups(meshes[k], p, GROUP))})

    print("grouped", flush=True)
    kat["commit"] = pts_hex(pmesh.sharded_commit(
        meshes[8], pedersen.base_B().table, scalars(COMMIT_D, SEEDS["commit"])))

    fp8 = FpConfig(*PAIR_FP)
    units = pair_values(np.random.default_rng(SEEDS["pair_values"]))
    blinds = pedersen.cancelling_scalar_limbs(2, PAIR_D, np.random.default_rng(
        SEEDS["pair_blind"]))
    pairs = [pedersen.elgamal_commit(jnp.asarray(fp8.f32_to_scalar_limbs(u / fp8.scale)),
                                     jnp.asarray(b)) for u, b in zip(units, blinds)]
    acc = pmesh.sharded_pair_add(meshes[8], pairs[0], pairs[1])
    out, ok = pmesh.sharded_bsgs(meshes[8], acc.L, PAIR_TABLE, fp8.bsgs_n_bits)
    kat["pair_bsgs"] = {"L": pts_hex(acc.L), "R": pts_hex(acc.R),
                        "values": scalar_hex(np.asarray(out)),
                        "ok": [bool(x) for x in np.asarray(ok)]}

    print("commit, pair_add, bsgs", flush=True)
    m = scalars(SIGMA_D, SEEDS["sigma_m"])
    r = scalars(SIGMA_D, SEEDS["sigma_r"])
    r2 = scalars(SIGMA_D, SEEDS["sigma_r2"])
    mesh = meshes[8]
    with mesh:
        rp, rc = sigma.rand_proof_prove(m, r, np.random.default_rng(SEEDS["rand_prove"]),
                                        mesh=mesh)
        r_ok = np.asarray(sigma.rand_proof_verify(rp, rc, mesh=mesh))
        sp, scm = sigma.square_rand_proof_prove(
            m, r, r2, np.random.default_rng(SEEDS["square_rand_prove"]), mesh=mesh)
        s_ok = np.asarray(sigma.square_rand_proof_verify(sp, scm, mesh=mesh))
    kat["sigma"] = {
        "rand": {"c_L": pts_hex(rc.L), "c_R": pts_hex(rc.R),
                 "c_prime_L": pts_hex(rp.c_prime.L), "c_prime_R": pts_hex(rp.c_prime.R),
                 "z_m": scalar_hex(rp.z_m), "z_r": scalar_hex(rp.z_r),
                 "ok": [bool(x) for x in r_ok]},
        "square_rand": {"c_L": pts_hex(scm.c.L), "c_R": pts_hex(scm.c.R),
                        "c_sq": pts_hex(scm.c_sq), "c_prime_L": pts_hex(sp.c_prime.L),
                        "c_prime_R": pts_hex(sp.c_prime.R),
                        "c_sq_prime": pts_hex(sp.c_sq_prime), "z_m": scalar_hex(sp.z_m),
                        "z_r1": scalar_hex(sp.z_r1), "z_r2": scalar_hex(sp.z_r2),
                        "ok": [bool(x) for x in s_ok]}}

    print("sigma", flush=True)
    fp16 = FpConfig(*RANGE_FP)
    vals = np.random.default_rng(SEEDS["range_values"]).uniform(-0.5, 0.5, RANGE_D).astype(
        np.float32)
    with mesh:
        proofs, commits = rpv.create_rangeproof(
            vals, scalars(RANGE_D, SEEDS["range_blind"]), fp16, RANGE_BITS, RANGE_CHUNKS,
            np.random.default_rng(SEEDS["range_prove"]), mesh=mesh)
        ok = rpv.verify_rangeproof(proofs, commits, fp16, RANGE_BITS,
                                   np.random.default_rng(SEEDS["range_verify"]), mesh=mesh)
        raw = bytearray(proofs[FLIP_PROOF].to_bytes())
        raw[FLIP_BYTE] ^= 1
        bad = proofs[:FLIP_PROOF] + [RP.RangeProof.from_bytes(bytes(raw))] + proofs[
            FLIP_PROOF + 1:]
        bad_ok = rpv.verify_rangeproof(bad, commits, fp16, RANGE_BITS,
                                       np.random.default_rng(SEEDS["range_verify"]),
                                       mesh=mesh)
    kat["rangeproof"] = {"values": [float(v) for v in vals],
                         "proofs": [p.to_bytes().hex() for p in proofs],
                         "commits": pts_hex(commits), "ok": bool(ok),
                         "flipped_ok": bool(bad_ok)}

    print("rangeproof", flush=True)
    # the first stage of dryrun_multichip (__graft_entry__.py:61-129): the
    # clients' SGD step, the fixed-point update, the sharded commits and
    # their sum (the JAX dry run jits the whole step under the mesh; the
    # results are those of its parts)
    dmesh = pmesh.make_mesh(DRYRUN_CLIENTS, DRYRUN_PARAM)
    module = MnistMLP(hidden=DRYRUN_HIDDEN)
    params0 = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 28, 28, 1)))
    flat0, unravel = ravel_pytree(params0)
    D = flat0.shape[0]
    step = 8 * DRYRUN_PARAM
    d_pad = -(-D // step) * step
    xs = jax.random.normal(jax.random.PRNGKey(1), (DRYRUN_CLIENTS, DRYRUN_BATCH, 28, 28, 1))
    ys = jnp.zeros((DRYRUN_CLIENTS, DRYRUN_BATCH), jnp.int32)

    @jax.jit
    def update(x, y):
        return -DRYRUN_LR * jax.grad(
            lambda f: cross_entropy(module.apply(unravel(f), x), y))(flat0)

    ups = [jnp.pad(update(xs[c], ys[c]), (0, d_pad - D)) for c in range(DRYRUN_CLIENTS)]
    encs = [fp16.encode_device(u) for u in ups]
    with dmesh:
        client_commits = [pmesh.sharded_commit(dmesh, pedersen.base_B().table, e)
                          for e in encs]
    agg = client_commits[0]
    for c in client_commits[1:]:
        agg = curve.add(agg, c)
    units = [np.round(np.asarray(u, np.float64) * fp16.scale).astype(np.int64) for u in ups]
    kat["dryrun"] = {
        "clients": DRYRUN_CLIENTS, "param": DRYRUN_PARAM, "D": int(D), "d_pad": int(d_pad),
        "update_l1": [float(np.abs(np.asarray(u, np.float64)).sum()) for u in ups],
        "units": [[int(x) for x in u] for u in units],
        "agg_sha256": hashlib.sha256(np.asarray(curve.compress_to_bytes(agg)).tobytes())
        .hexdigest()}
    return kat


def load_kat() -> dict:
    with open(KAT_PATH) as f:
        return json.load(f)


@pytest.mark.slow
def test_kat_file_matches_jax_package(tmp_path):
    """In a process of its own: the 8 virtual devices and the collectives'
    time limits are set before JAX starts its backend."""
    out = tmp_path / "kat.json"
    subprocess.run([sys.executable, __file__, str(out)], check=True,
                   env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert json.loads(out.read_text()) == load_kat()


def main(path: Path = KAT_PATH) -> None:
    # XLA:CPU aborts a collective whose first device waited 40 s for the
    # others; a virtual device's local ladder can take longer than that.
    # And with asynchronous dispatch, two eager sharded ops in flight can
    # hold the device threads between them, each waiting at a rendezvous
    # for a device the other holds: dispatch one op at a time.
    os.environ["XLA_FLAGS"] = " ".join([
        os.environ.get("XLA_FLAGS", ""),
        f"--xla_force_host_platform_device_count={N_DEVICES}",
        "--xla_cpu_collective_timeout_seconds=7200",
        "--xla_cpu_collective_call_terminate_timeout_seconds=7200"])
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_enable_async_dispatch", False)
    from rofl_tpu.utils.cache import setup_cache

    setup_cache()
    kat = make_kat()
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(kat, f, indent=1)
        f.write("\n")
    print(f"wrote {path}")


if __name__ == "__main__":
    main(Path(sys.argv[1]) if len(sys.argv) > 1 else KAT_PATH)
