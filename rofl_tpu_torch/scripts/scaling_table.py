"""Prove-path scaling table over a device mesh.

Counterpart of the JAX package's ``scripts/scaling_table.py``, with its
flags and its three tables:

  1. the chunk-batched range-proof prover (``create_rangeproof``), without a
     mesh and with its A/S and IPA L-R MSMs routed over 2, 4 and 8 shards;
  2. the verifier's combined MSM (``verify_rangeproof`` with the mesh);
  3. the Σ rand proof's prove and verify with the lanes over the shards.

Every size must give the unsharded proofs byte for byte (and the same z_m /
z_r responses); the script asserts it. Each row is the second of two runs
(the first warms the caches). A mesh of n shards takes the first n cards
where the machine has them and repeats the first card otherwise (a virtual
mesh); the table says which. On a virtual mesh the shards of one card run
one after another on its stream, so wall time cannot fall with n: the table
shows that the distribution is right and how the work a device does falls
with n, not a speed-up.

    python -m rofl_tpu_torch.scripts.scaling_table --d 50000 --parts 16
    python -m rofl_tpu_torch.scripts.scaling_table --d 64 --parts 8 --device cpu

writes ``build/scaling/SCALING.md`` (``--out``) and prints it.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..crypto import pedersen, sigma
from ..crypto import range_proof_vec as rpv
from ..crypto.fp_codec import FpConfig
from ..ops import fe
from ..parallel import mesh as pmesh

FP = FpConfig(16, 7)
RANGE_BITS = 8


def mesh_of(n: int, device: str) -> pmesh.Mesh:
    """n shards: the first n cards if there are that many, else the first
    device n times."""
    if torch.device(device).type == "cuda" and torch.cuda.device_count() >= n:
        return pmesh.param_mesh(n)
    return pmesh.param_mesh(n, [torch.device(device)] * n)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timed(fn, device: str):
    """(fn(), seconds) of a second run; the first warms the caches."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--d", type=int, default=4096)
    ap.add_argument("--parts", type=int, default=8)
    ap.add_argument("--out", default="build/scaling/SCALING.md")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--shards", type=int, nargs="+", default=[2, 4, 8])
    args = ap.parse_args(argv)

    device, d, parts = args.device, args.d, args.parts
    rng = np.random.default_rng(9)
    lo, hi = FP.clip_bounds(RANGE_BITS)
    vals = (rng.uniform(lo, hi, d) * 0.5).astype(np.float32)
    blind = pedersen.rnd_scalar_tensor(d, np.random.default_rng(3), device)
    meshes = {n: mesh_of(n, device) for n in args.shards}

    def run(mesh):
        return rpv.create_rangeproof(vals, blind, FP, RANGE_BITS, parts,
                                     np.random.default_rng(7), device, mesh)

    (ref_proofs, commits), dt = timed(lambda: run(None), device)
    ref_bytes = [p.to_bytes() for p in ref_proofs]
    rows = [("1 (no mesh)", "-", d * RANGE_BITS, dt)]
    for n, mesh in meshes.items():
        (proofs, _), dt = timed(lambda: run(mesh), device)
        assert [p.to_bytes() for p in proofs] == ref_bytes, f"proofs diverged at {n} shards"
        rows.append((str(n), _devices(mesh), d * RANGE_BITS // n, dt))

    def vrun(mesh):
        ok = rpv.verify_rangeproof(ref_proofs, commits, FP, RANGE_BITS,
                                   np.random.default_rng(21), mesh)
        assert ok, "verify refused an honest proof"
        return ok

    _, dt = timed(lambda: vrun(None), device)
    vrows = [("1 (no mesh)", "-", 2 * d * RANGE_BITS, dt)]
    for n, mesh in meshes.items():
        _, dt = timed(lambda: vrun(mesh), device)
        vrows.append((str(n), _devices(mesh), 2 * d * RANGE_BITS // n, dt))

    m_limbs = fe.to_tensor(FP.f32_to_scalar_limbs(vals), device)

    def srun(mesh):
        p, c = sigma.rand_proof_prove(m_limbs, blind, np.random.default_rng(13), mesh=mesh)
        ok = sigma.rand_proof_verify(p, c, mesh=mesh)
        assert bool(ok.all()), "rand proof refused"
        return p

    ref_sp, dt = timed(lambda: srun(None), device)
    srows = [("1 (no mesh)", "-", d, dt)]
    for n, mesh in meshes.items():
        sp, dt = timed(lambda: srun(mesh), device)
        assert torch.equal(ref_sp.z_m, sp.z_m) and torch.equal(ref_sp.z_r, sp.z_r), (
            f"responses diverged at {n} shards")
        srows.append((str(n), _devices(mesh), -(-d // n), dt))

    name = torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else device
    lines = [
        f"# Prove-path scaling ({name})",
        "",
        f"Chunk-batched range-proof prover, d={d}, n_partition={parts}, "
        "A/S + IPA L/R MSMs mesh-routed over 'param' "
        "(crypto/range_proof.py: _msm_grouped, _tree_sum_groups).",
        "",
        "Proofs verified BYTE-IDENTICAL to the unsharded prover at every mesh size.",
        "",
        "| shards | devices | MSM term-lanes per device | prove wall s |",
        "|---|---|---|---|",
        *[f"| {a} | {b} | {c} | {t:.4f} |" for a, b, c, t in rows],
        "",
        "## Verify combined MSM (server side)",
        "",
        f"All {parts} chunks verify as one random-linear-combination MSM; its "
        "terms shard over 'param' (parallel/mesh.py sharded_msm: a local MSM a "
        "shard, the single-point partials summed on the first device).",
        "",
        "| shards | devices | MSM term-lanes per device | verify wall s |",
        "|---|---|---|---|",
        *[f"| {a} | {b} | {c} | {t:.4f} |" for a, b, c, t in vrows],
        "",
        "## Σ-plane (batched RandProof prove+verify)",
        "",
        "Per-lane elementwise cores run shard by shard (crypto/sigma.py mesh "
        "routing), with no collective; z_m / z_r responses asserted equal at "
        "every mesh size.",
        "",
        "| shards | devices | Σ lanes per device | prove+verify wall s |",
        "|---|---|---|---|",
        *[f"| {a} | {b} | {c} | {t:.4f} |" for a, b, c, t in srows],
        "",
        "Caveat: where the devices column repeats one card, the shards share it",
        "and run one after another on its stream, so wall time cannot fall with",
        "the shard count; the table shows the distribution is right and the",
        "work each device holds, not a speed-up. On several real cards the MSM",
        "shards are expected to overlap (launches only), but the Σ shards would",
        "still serialise on each shard's host transcript; neither is measured.",
        "",
    ]
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines))
    print("\n".join(lines))
    return {"prove": rows, "verify": vrows, "sigma": srows, "out": str(out)}


def _devices(mesh: pmesh.Mesh) -> str:
    devs = [str(d) for d in mesh.param_devices()]
    return f"{devs[0]} x {len(devs)}" if len(set(devs)) == 1 else ", ".join(devs)


if __name__ == "__main__":
    main()
