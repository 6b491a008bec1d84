"""A whole FL round over a client × param mesh: the multi-device dry run.

Counterpart of ``dryrun_multichip`` and ``_dryrun_encrange_round`` in the JAX
package's ``__graft_entry__.py``, the one user of a mesh with both axes:

1) per client, on its 'client' row: one SGD step of ``MnistMLP(hidden=4)``
   on a batch of 4 normal images (θ0 from ``PRNGKey(0)``, the images from
   ``PRNGKey(1)``, as the JAX dry run makes them), the fixed-point encoding
   of the update (padded to a multiple of 8 × n_param lanes), and its
   ``sharded_commit`` over the row's 'param' devices; then the homomorphism
   check: the sum of the clients' commitments equals the commitment of the
   scalar sum of their encodings, on every lane;
2) EncRange prove per client: cancelling blindings, ElGamal commitments and
   batched rand proofs with the lanes sharded over the client's row, and a
   range proof of client 0's update, proved with its chunks over the mesh;
3) verify: the rand proofs over the rows, the range proof with its combined
   MSM through ``sharded_msm``;
4) accumulate: ``sharded_pair_add`` across clients, blinding-cancellation
   check;
5) extract: ``sharded_bsgs`` of the summed update, equal to the plain
   fixed-point sum.

The JAX dry run runs stages 2-5 at d = 256 and its Σ-proofs unsharded, for
XLA:CPU's compile time; here nothing is compiled, so d and the BSGS table are
arguments and the Σ-proofs go through the rows. Every failed check raises.

    python -m rofl_tpu_torch.parallel.dryrun                  # every card
    python -m rofl_tpu_torch.parallel.dryrun --virtual 4      # cuda:0 four times
    python -m rofl_tpu_torch.parallel.dryrun --virtual 8 --device cpu \\
        --d 16 --table-m 128 --fp 8 3                         # CPU, seconds a stage
"""

from __future__ import annotations

import argparse
import hashlib
import time

import numpy as np
import torch
from torch.func import functional_call

from ..crypto import pedersen, sigma
from ..crypto import range_proof_vec as RPV
from ..crypto.fp_codec import FpConfig
from ..models import jax_random
from ..models.networks import MnistMLP, init_flat, unflatten
from ..models.trainer import cross_entropy, float32_products
from ..ops import curve, fe, sc
from . import mesh as pmesh

FP = FpConfig(16, 7)
HIDDEN = 4
BATCH = 4
LR = 0.1
VALUE_RANGE = 8
N_PARTITION = 16  # range-proof chunks of stages 2-5: the d lanes as a client proves them


class DryRunError(RuntimeError):
    """A check of the dry run failed."""


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise DryRunError(what)


def mesh_axes(n_devices: int) -> tuple[int, int]:
    """(n_client, n_param) as the JAX dry run splits its devices."""
    n_client = 2 if n_devices % 2 == 0 else 1
    return n_client, n_devices // n_client


def client_updates(mesh: pmesh.Mesh) -> tuple[list, int]:
    """Each client's update -LR · ∇loss of one SGD step, on its row's first
    device, padded to a multiple of 8 × n_param lanes → (updates, D)."""
    n_client, n_param = mesh.shape["client"], mesh.shape["param"]
    module = MnistMLP(hidden=HIDDEN)
    step = 8 * n_param
    updates = []
    for c in range(n_client):
        device = mesh.devices[c][0]
        module.to(device)
        flat0 = init_flat(module, 0, device)
        xs = jax_random.normal(jax_random.PRNGKey(1), (n_client, BATCH, 28, 28, 1), device)
        w = flat0.clone().requires_grad_(True)
        with float32_products(device):
            loss = cross_entropy(functional_call(module, unflatten(module, w), (xs[c],)),
                                 torch.zeros(BATCH, dtype=torch.int64, device=device))
            (g,) = torch.autograd.grad(loss, w)
        update = (-LR * g).detach()
        d_pad = -(-update.shape[0] // step) * step
        updates.append(torch.cat([update, update.new_zeros(d_pad - update.shape[0])]))
    return updates, int(flat0.shape[0])


def commit_stage(mesh: pmesh.Mesh, encs: list) -> tuple[curve.PointArray, torch.Tensor]:
    """Stage 1's commitments: each client's (16, d) encoding committed over
    its row, the commitments summed on the mesh's first device, and the
    lanes where the sum equals the commitment of the scalar sum."""
    commits = [pmesh.sharded_commit(mesh.client_row(c), pedersen.base_B(), e)
               for c, e in enumerate(encs)]
    first = mesh.first
    agg = _sum_points(commits, first)
    enc_sum = encs[0].to(first)
    for e in encs[1:]:
        enc_sum = sc.add(enc_sum, e.to(first))
    direct = pmesh.sharded_commit(mesh.client_row(0), pedersen.base_B(), enc_sum)
    return agg, curve.eq(agg, direct)


def _sum_points(points: list, device: torch.device) -> curve.PointArray:
    """Σ of point batches of one shape, one add at a time on `device`."""
    acc = curve.PointArray(*[c.to(device) for c in points[0]])
    for p in points[1:]:
        acc = curve.add(acc, curve.PointArray(*[c.to(device) for c in p]))
    return acc


def encrange_round(mesh: pmesh.Mesh, d: int, fp: FpConfig, table_m: int, n_partition: int,
                   seed: int = 5, log=print) -> dict:
    """Stages 2-5 on d lanes a client: prove → verify → accumulate →
    extract. Returns the seconds of each stage."""
    n_client = mesh.shape["client"]
    first = mesh.first
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    seconds = {}

    def tick(label: str) -> None:
        if first.type == "cuda":
            torch.cuda.synchronize(first)
        seconds[label] = time.perf_counter() - t0 - sum(seconds.values())
        log(f"  dryrun stage: {label} (+{time.perf_counter() - t0:.1f}s)")

    lo, hi = fp.clip_bounds(VALUE_RANGE)
    updates = [(rng.uniform(lo, hi, d) * 0.1).astype(np.float32) for _ in range(n_client)]
    blinds = pedersen.cancelling_scalar_limbs(n_client, d, rng, first)

    pairs, proofs = [], []
    for c, (vals, b) in enumerate(zip(updates, blinds)):
        row = mesh.client_row(c)
        device = row.first
        proof, pair = sigma.rand_proof_prove(fe.to_tensor(fp.f32_to_scalar_limbs(vals), device),
                                             fe.to_tensor(b, device), rng, mesh=row)
        proofs.append(proof)
        pairs.append(pair)
    tick("randproof prove")

    for c, (proof, pair) in enumerate(zip(proofs, pairs)):
        ok = sigma.rand_proof_verify(proof, pair, mesh=mesh.client_row(c))
        _check(bool(ok.all()), f"randproof verify failed for client {c}")
    tick("randproof verify")

    rps, commits = RPV.create_rangeproof(updates[0], blinds[0], fp, VALUE_RANGE, n_partition,
                                         rng, first, mesh)
    _check(bool(RPV.verify_rangeproof(rps, commits, fp, VALUE_RANGE, rng, mesh)),
           "rangeproof failed")
    tick("rangeproof mesh prove + mesh-sharded verify MSM")

    acc = pairs[0]
    for p in pairs[1:]:
        acc = pmesh.sharded_pair_add(mesh, acc, p)
    _check(bool(pedersen.right_elem_is_identity(acc).all()), "blindings did not cancel")
    tick("sharded accumulate")

    out, ok = pmesh.sharded_bsgs(mesh, acc.L, table_m, fp.bsgs_n_bits)
    _check(bool(ok.all()), "BSGS extraction failed")
    got = fp.scalar_limbs_to_f32(fe.to_numpy(out))
    tick("sharded BSGS extract")

    units = sum(fp.f32_to_bits(u).astype(np.int64) * np.where(u < 0, -1, 1) for u in updates)
    _check(np.array_equal(got, (units / fp.scale).astype(np.float32)),
           "extracted sum != plain sum")
    log(f"dryrun_multichip ok: mesh={mesh.shape}, d={d}: EncRange round "
        f"(prove→verify→accumulate→extract) passed; sharded MSM/BSGS ok")
    return seconds


def dryrun_multichip(n_devices: int | None = None, devices=None, *, d: int = 256,
                     table_m: int = 1 << 16, fp: FpConfig = FP, log=print) -> dict:
    """Full FL round over an n-device mesh (client × param axes): stage 1 at
    the JAX dry run's shapes, then an EncRange round of d lanes a client
    (``encrange_round``). `devices` defaults to every card; a device may
    repeat (a virtual mesh). Returns what a report line needs."""
    devices = pmesh.resolve_devices(devices)
    n_devices = n_devices or len(devices)
    mesh = pmesh.make_mesh(*mesh_axes(n_devices), devices)
    t0 = time.perf_counter()
    updates, n_weights = client_updates(mesh)
    encs = [FP.encode_device(u) for u in updates]
    agg, ok = commit_stage(mesh, encs)
    d_pad = encs[0].shape[1]
    _check(ok.shape[0] == d_pad, "homomorphism check has the wrong number of lanes")
    _check(bool(ok.all()), "commitment-sum homomorphism check failed")
    stage1_s = time.perf_counter() - t0
    log(f"dryrun_multichip stage1 ok: mesh={mesh.shape}, d={d_pad}, "
        f"homomorphism check passed on all lanes")
    seconds = encrange_round(mesh, d, fp, table_m, N_PARTITION, log=log)
    return {"mesh": pmesh.describe(mesh), "weights": n_weights, "stage1_lanes": d_pad,
            "stage1_agg_sha256": hashlib.sha256(curve.compress_to_bytes(agg).tobytes())
            .hexdigest(), "stage1_s": stage1_s, "d": d, "table_m": table_m,
            "fp": [fp.n_bits, fp.n_frac], "n_partition": N_PARTITION, "seconds": seconds}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (every card) or cpu")
    ap.add_argument("--virtual", type=int, default=0,
                    help="repeat the first device this many times (a virtual mesh)")
    ap.add_argument("--d", type=int, default=256, help="lanes a client in stages 2-5")
    ap.add_argument("--table-m", type=int, default=1 << 16)
    ap.add_argument("--fp", type=int, nargs=2, default=[FP.n_bits, FP.n_frac])
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda":
        devices = pmesh.resolve_devices(None)
        if not devices:
            raise SystemExit("no CUDA device: pass --device cpu")
    else:
        devices = [torch.device(args.device)]
    if args.virtual:
        devices = [devices[0]] * args.virtual
    return dryrun_multichip(len(devices), devices, d=args.d, table_m=args.table_m,
                            fp=FpConfig(*args.fp))


if __name__ == "__main__":
    main()
