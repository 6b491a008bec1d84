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
  verdict was taken on.

Regenerate the file with

    JAX_PLATFORMS=cpu python tests/test_torch_jax_kat.py

(about ten minutes on eight CPUs). The one test here, marked
``slow``, recomputes it and asserts that the committed file still equals what
the JAX package gives.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
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


def make_kat() -> dict:
    """Run the JAX package on JAX:CPU → the KAT dict (byte strings as hex).
    The round runs first, on the fixed-base tables the JAX package builds
    itself; the others are given the port's (torch_port_helpers)."""
    round_answers = slice_answers()
    return {"bsgs": bsgs_answers(), "slice": round_answers, "verdicts": verdict_answers()}


def load_kat() -> dict:
    with open(KAT_PATH) as f:
        return json.load(f)


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
    kat = make_kat()
    KAT_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(KAT_PATH, "w") as f:
        json.dump(kat, f, indent=1)
        f.write("\n")
    print(f"wrote {KAT_PATH}")
