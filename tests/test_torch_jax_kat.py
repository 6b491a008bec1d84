"""Known answers of the JAX package's BSGS walk, aggregation round and
verifiers, kept honest.

Each of these compiles for minutes on JAX:CPU, so the tier-1 tests that hold
the port against them read the JAX side from
``tests/data/torch_port_jax_kat.json``, which ``make_kat`` computes:

- ``bsgs``: ``rofl_tpu.ops.bsgs.solve_discrete_log`` on the commitments of
  tests/test_torch_bsgs.py's known logs (m = 128, n_bits = 8, 77 lanes), its
  value limbs and found mask (read by ``test_solve_equals_jax_solve``);
- ``slice``: the whole aggregation round of tests/test_torch_slice.py through
  ``rofl_tpu.bindings`` (3 clients, d = 77, FpConfig(8, 3), the JAX package's
  own fixed-base tables): blinding, commitment and sum blobs, the extracted
  sums, and the sum of all clients but the last with the error its
  extraction raises;
- ``verdicts``: the JAX verifiers' verdicts on the byte strings that
  tests/test_torch_range_proof_jax.py, tests/test_torch_l2_range_proof.py
  and tests/test_torch_l2_params.py give them, each beside the SHA-256 of
  those bytes, so that a tier-1 test shows that its bytes are the ones the
  verdict was taken on;
- ``ladders``: the Pallas kernel bodies of ``rofl_tpu.ops.kernels.
  shared_scalar_mul`` and ``scalar_mul``, the latter at its default one-bit
  body and at ROFL_SMUL_W = 2 and 4, run op by op on the CPU
  (``run_pallas_body``), each in a process of its own, on N = 8 points and
  scalars made from a numpy seed (``ladder_inputs``), inputs and results
  stored as encodings and hex (read by tests/test_torch_shared_scalar_mul.py,
  tests/test_torch_scalar_mul.py and tests/test_torch_scalar_mul_window.py).

Regenerate the file with

    JAX_PLATFORMS=cpu python tests/test_torch_jax_kat.py

(about ten minutes on eight CPUs, and as long again for the ladders' seven
processes). The one test here, marked
``slow``, recomputes it and asserts that the committed file still equals what
the JAX package gives.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from unittest import mock
from pathlib import Path

import numpy as np
import pytest

KAT_PATH = Path(__file__).resolve().parent / "data" / "torch_port_jax_kat.json"


def digest(*blobs: bytes) -> str:
    """SHA-256 of the byte strings one after another, as hex."""
    h = hashlib.sha256()
    for b in blobs:
        h.update(b)
    return h.hexdigest()


def bsgs_answers() -> dict:
    import jax.numpy as jnp

    from rofl_tpu.crypto import pedersen as jpedersen
    from rofl_tpu.ops import bsgs as jbsgs
    from test_torch_bsgs import K_NP, LOGS, M, N_BITS
    from torch_port_helpers import share_tables_with_jax

    share_tables_with_jax("base_B")
    j_pts = jpedersen.pedersen_commit_no_blinding(jnp.asarray(K_NP))
    j_val, j_ok = jbsgs.solve_discrete_log(j_pts, M, N_BITS)
    return {"logs": LOGS, "m": M, "n_bits": N_BITS,
            "values": np.asarray(j_val).astype(np.int64).tolist(),
            "found": np.asarray(j_ok).tolist()}


def slice_answers() -> dict:
    import rofl_tpu.bindings as JB
    from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig
    from test_torch_slice import BLINDING_SEED, D, N_CLIENTS, UPDATES

    fp = JFpConfig(8, 3)
    blindings = JB.generate_cancelling_blindings(N_CLIENTS, D,
                                                 np.random.default_rng(BLINDING_SEED))
    commits = [JB.commit(UPDATES[c], blindings[c], fp) for c in range(N_CLIENTS)]
    total = JB.add_commitments(commits)
    partial = JB.add_commitments(commits[:-1])
    try:
        JB.extract_values(partial, fp)
        partial_error = None
    except ValueError as e:
        partial_error = str(e)
    return {"blindings": [b.hex() for b in blindings], "commits": [c.hex() for c in commits],
            "sum": total.hex(), "extracted": JB.extract_values(total, fp).tolist(),
            "partial_sum": partial.hex(), "partial_error": partial_error}


def verdict_answers() -> dict:
    from rofl_tpu import bindings as JB
    from rofl_tpu.crypto import l2_range_proof as JL2
    from rofl_tpu.crypto import range_proof as JRP
    from rofl_tpu.crypto import range_proof_vec as JRPV
    from rofl_tpu.crypto import sigma as JS
    from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig
    from rofl_tpu.fl import params as JP
    from rofl_tpu.spec import ristretto as JSR
    from test_torch_l2_kat import load_kat
    from test_torch_l2_range_proof import round_sum_square
    from test_torch_range_proof import KAT_COMMITS, KAT_PROOFS, TAMPERS, tampered
    from torch_port_helpers import share_tables_with_jax

    share_tables_with_jax("base_B", "base_H")
    kat = load_kat()
    fp = JFpConfig(*kat["fp"])
    rng = np.random.default_rng
    round_bytes = bytes.fromhex(kat["params"]["serialized"])
    enc = JP.EncParamsL2.deserialize(round_bytes, fp)
    out = {}

    def verify_range(commits, proofs):
        return JB.verify_rangeproof(commits, proofs, kat["value_range"], fp, rng(5))

    out["range_proof_of_the_port"] = {"sha256": digest(KAT_COMMITS, KAT_PROOFS),
                                      "verdict": verify_range(KAT_COMMITS, KAT_PROOFS)}
    out["range_proofs_of_the_port_round"] = {
        "sha256": digest(round_bytes),
        "verdict": JRPV.verify_rangeproof(enc.range_proofs, enc.enc_values.c.L, fp,
                                          kat["value_range"], rng(6))}
    for kind in TAMPERS:
        commits, proofs = tampered(kind)
        out[f"tampered_range_proof_{kind}"] = {"sha256": digest(commits, proofs),
                                               "verdict": verify_range(commits, proofs)}
    l2_proof, l2_commit = bytes.fromhex(kat["l2"]["proof"]), bytes.fromhex(kat["l2"]["commit"])
    out["l2_sum_proof_of_the_port"] = {
        "sha256": digest(l2_proof, l2_commit),
        "verdict": JL2.verify_rangeproof_l2(JRP.RangeProof.from_bytes(l2_proof),
                                            JSR.decompress(l2_commit), kat["l2_value_range"],
                                            rng(4))}
    sum_sq = round_sum_square(round_bytes)
    square_proof = enc.square_range_proof.to_bytes()
    out["l2_sum_proof_of_the_port_round"] = {
        "sha256": digest(square_proof, sum_sq),
        "verdict": JL2.verify_rangeproof_l2(JRP.RangeProof.from_bytes(square_proof),
                                            JSR.decompress(sum_sq), kat["l2_value_range"],
                                            rng(5))}
    out["square_rand_proofs_of_the_port_round"] = {
        "sha256": digest(round_bytes), "reserialized": enc.serialize() == round_bytes,
        "verdict": JS.square_rand_proof_verify_batched(enc.square_proofs, enc.enc_values,
                                                       rng(3))}
    return {name: {k: bool(v) if k != "sha256" else v for k, v in entry.items()}
            for name, entry in out.items()}


LADDER_SEED = 909
LADDER_WINDOWS = (1, 2, 4)  # ROFL_SMUL_W: 1 is the default one-bit body
# one scalar for every lane: a random one, 2 (whose NAF is one digit up),
# 2^256 - 1 (whose width-5 NAF runs to digit 256) and one of low weight
SHARED_KAT_SCALARS = ("random", "two", "all_ones", "low_weight")


def ladder_inputs() -> dict:
    """N = 8 points (the identity and the basepoint among them) as
    encodings, per-lane scalars (0, 1, 2, l - 1, 2^256 - 1 and random ones)
    and the shared scalars as hex, from LADDER_SEED."""
    from rofl_tpu_torch.spec import ristretto as SR
    from rofl_tpu_torch.spec import scalar as SS

    rng = np.random.default_rng(LADDER_SEED)
    points = [SR.identity(), SR.BASEPOINT] + [
        SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(6)]
    scalars = [0, 1, 2, SS.L - 1, 2**256 - 1] + [
        int.from_bytes(rng.bytes(32), "little") % SS.L for _ in range(3)]
    shared = {"random": int.from_bytes(rng.bytes(32), "little") % SS.L, "two": 2,
              "all_ones": 2**256 - 1, "low_weight": (1 << 200) | 5}
    return {"points": [q.compress().hex() for q in points],
            "scalars": [f"{k:064x}" for k in scalars],
            "shared_scalars": {name: f"{shared[name]:064x}" for name in SHARED_KAT_SCALARS}}


class _EagerRef:
    """A Pallas Ref over a whole jnp array: reads and writes by index, a
    ``pl.ds`` window taken as the slice it names."""

    def __init__(self, value):
        self.value = value

    @staticmethod
    def _index(idx):
        from jax.experimental import pallas as pl

        idx = idx if isinstance(idx, tuple) else (idx,)
        ds = type(pl.ds(0, 1))
        return tuple(slice(int(i.start), int(i.start) + i.size) if isinstance(i, ds) else i
                     for i in idx)

    def __getitem__(self, idx):
        return self.value[self._index(idx)]

    def __setitem__(self, idx, v):
        self.value = self.value.at[self._index(idx)].set(v)


def run_pallas_body(kernel, inputs: list, n_out: int) -> list:
    """Run a Pallas kernel body of the JAX package on the CPU, op by op: one
    block holding every lane, each Ref an array, ``lax.fori_loop`` a Python
    loop over int32 indices, ``lax.cond`` a Python branch (jax.disable_jit).
    The body computes what it computes under ``pallas_call``; its interpret
    mode (ROFL_PALLAS=interp) compiles the whole body with XLA:CPU instead,
    which took 28 minutes for the one-bit ladder alone on 8 shared CPUs and
    makes the windowed bodies impractical."""
    import jax
    import jax.numpy as jnp

    def fori_loop(lower, upper, body, val, **_):
        for i in range(lower, upper):
            val = body(jnp.int32(i), val)
        return val

    refs = [_EagerRef(jnp.asarray(x)) for x in inputs]
    outs = [_EagerRef(jnp.zeros_like(refs[-1].value)) for _ in range(n_out)]
    with jax.disable_jit(), mock.patch.object(jax.lax, "fori_loop", fori_loop):
        kernel(*refs, *outs)
    return [o.value for o in outs]


def jax_ladder(kind: str, arg: str) -> list:
    """One ladder of the JAX package on ladder_inputs, as encodings:
    ``scalar_mul``'s body at ROFL_SMUL_W = arg (chosen as its wrapper
    chooses it, ``_smul_kernel_and_tile``) on the per-lane scalars, or
    ``shared_scalar_mul``'s ``_shared_mul_kernel`` on the shared scalar named
    arg, through run_pallas_body."""
    from rofl_tpu.ops import fe as jfe
    from rofl_tpu.ops import kernels as jkernels
    from rofl_tpu.spec import ristretto as JSR

    inputs = ladder_inputs()
    points = [JSR.decompress(bytes.fromhex(h)) for h in inputs["points"]]
    p = [jfe.pack_scalars([getattr(q, c) for q in points]) for c in "XYZT"]
    if kind == "scalar_mul":
        with mock.patch.dict(os.environ, {"ROFL_SMUL_W": arg}):
            kernel, _ = jkernels._smul_kernel_and_tile()
        k = jfe.pack_scalars([int(h, 16) for h in inputs["scalars"]])
    else:
        kernel = jkernels._shared_mul_kernel
        k = jfe.pack_scalars([int(inputs["shared_scalars"][arg], 16)])
    coords = [jfe.unpack_scalars(np.asarray(c)) for c in run_pallas_body(kernel, [k, *p], 4)]
    return [JSR.RistrettoPoint(*c).compress().hex() for c in zip(*coords)]


LADDER_JOBS = [("scalar_mul", str(w)) for w in LADDER_WINDOWS] + [
    ("shared_scalar_mul", name) for name in SHARED_KAT_SCALARS]


def start_ladders() -> list:
    """One process for each of LADDER_JOBS running jax_ladder (several
    minutes of op-by-op dispatch apiece), all started together."""
    return [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--ladder", *job],
                             env={**os.environ, "JAX_PLATFORMS": "cpu"},
                             stdout=subprocess.PIPE, text=True) for job in LADDER_JOBS]


def ladder_answers(procs: list) -> dict:
    """ladder_inputs and what the processes of start_ladders found."""
    out = {"scalar_mul": {}, "shared_scalar_mul": {}}
    for (kind, arg), proc in zip(LADDER_JOBS, procs):
        stdout = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"jax_ladder({kind}, {arg}) exited with {proc.returncode}")
        out[kind][arg] = json.loads(stdout.strip().splitlines()[-1])
    return {**ladder_inputs(), **out}


def make_kat() -> dict:
    """Run the JAX package on JAX:CPU → the KAT dict (byte strings as hex).
    The ladders' processes start first and run beside the rest. The round
    runs first of the rest, on the fixed-base tables the JAX package builds
    itself; the others are given the port's (torch_port_helpers)."""
    ladders = start_ladders()
    round_answers = slice_answers()
    return {"bsgs": bsgs_answers(), "slice": round_answers, "verdicts": verdict_answers(),
            "ladders": ladder_answers(ladders)}


def load_kat() -> dict:
    with open(KAT_PATH) as f:
        return json.load(f)


def ladder_kat() -> tuple:
    """The KAT's ``ladders`` section, and its points packed for the port on
    the CPU, an (x, y, z, t) tuple of (16, 8)."""
    from rofl_tpu_torch.ops import curve
    from rofl_tpu_torch.spec import ristretto as SR

    ladders = load_kat()["ladders"]
    points = [SR.decompress(bytes.fromhex(h)) for h in ladders["points"]]
    return ladders, tuple(curve.pack_points(points, "cpu"))


def verdict(name: str, *blobs: bytes) -> bool:
    """The JAX verifier's verdict `name` of the KAT, after checking that it
    was taken on these bytes (their SHA-256)."""
    entry = load_kat()["verdicts"][name]
    assert entry["sha256"] == digest(*blobs)
    return entry["verdict"]


@pytest.mark.slow
def test_kat_file_matches_jax_package():
    assert make_kat() == load_kat()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    from rofl_tpu.utils.cache import setup_cache

    setup_cache()
    if sys.argv[1:2] == ["--ladder"]:
        print(json.dumps(jax_ladder(*sys.argv[2:4])))
        sys.exit(0)
    kat = make_kat()
    KAT_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(KAT_PATH, "w") as f:
        json.dump(kat, f, indent=1)
        f.write("\n")
    print(f"wrote {KAT_PATH}")
