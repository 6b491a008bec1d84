"""Known answers of the JAX package for the L2-norm client round, kept
honest.

The JAX range prover compiles for minutes on JAX:CPU, so the tier-1 tests of
the port (tests/test_torch_range_proof.py, tests/test_torch_l2_params.py) do
not rerun it: they read its output from ``tests/data/torch_port_l2_kat.json``.
``make_kat`` computes that output at the smallest shape that exercises the
padding (d = 7 values, extended to 8, in 2 chunks of 4 at 8 bits; the L2 sum
proof at 16 bits) from fixed numpy seeds. Regenerate the file with

    JAX_PLATFORMS=cpu python tests/test_torch_l2_kat.py

(about ten minutes with an empty JAX cache). The one test here, marked
``slow``, recomputes it and asserts that the committed file still equals what
the JAX package gives, byte for byte.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

KAT_PATH = Path(__file__).resolve().parent / "data" / "torch_port_l2_kat.json"

# d = 7: pads to 8 (one identity V), two chunks of four. -1.0 lies outside
# the 8-bit range and is clipped by EncParamsL2.encrypt.
VALUES = [0.5, -0.25, 0.125, -0.75, 0.0, 0.984375, -1.0]
FP_BITS = (16, 7)
VALUE_RANGE = 8
L2_VALUE_RANGE = 16
N_PARTITION = 2
SEEDS = {
    "range_blinding": 101, "range_prove": 102,
    "l2_blinding": 201, "l2_prove": 202,
    "params_blinding": 301, "params_encrypt": 302,
}


def make_kat() -> dict:
    """Run the JAX package on JAX:CPU from the fixed seeds → the KAT dict
    (byte strings as hex)."""
    from rofl_tpu import bindings as B
    from rofl_tpu.crypto import l2_range_proof as L2RP
    from rofl_tpu.crypto import pedersen
    from rofl_tpu.crypto import serde_vec as sv
    from rofl_tpu.crypto.fp_codec import FpConfig
    from rofl_tpu.fl import params as P
    from rofl_tpu.ops import sc

    fp = FpConfig(*FP_BITS)
    values = np.asarray(VALUES, np.float32)
    clipped = B.clip_to_range(values, VALUE_RANGE, fp)
    d = len(VALUES)

    blind_blob = B.create_random_blinding_vector(
        d, np.random.default_rng(SEEDS["range_blinding"]))
    proofs_blob, commits_blob = B.create_rangeproof(
        clipped, blind_blob, VALUE_RANGE, N_PARTITION, fp,
        np.random.default_rng(SEEDS["range_prove"]))

    l2_blind = pedersen.rnd_scalar_limbs(d, np.random.default_rng(SEEDS["l2_blinding"]))
    l2_proof, l2_commit = L2RP.create_rangeproof_l2(
        clipped, [int(x) for x in sc.unpack_scalars(l2_blind)], fp, L2_VALUE_RANGE,
        np.random.default_rng(SEEDS["l2_prove"]))

    import jax.numpy as jnp

    cfg = P.CryptoConfig(value_range=VALUE_RANGE, n_partition=N_PARTITION,
                         l2_value_range=L2_VALUE_RANGE, enc_type=P.ENC_L2_TYPE, fp=fp)
    blind = pedersen.rnd_scalar_limbs(d, np.random.default_rng(SEEDS["params_blinding"]))
    enc = P.EncParamsL2.encrypt(values, jnp.asarray(blind), cfg,
                                np.random.default_rng(SEEDS["params_encrypt"]))
    return {
        "values": VALUES, "fp": list(FP_BITS), "value_range": VALUE_RANGE,
        "l2_value_range": L2_VALUE_RANGE, "n_partition": N_PARTITION, "seeds": SEEDS,
        "range": {"blinding": blind_blob.hex(), "proofs": proofs_blob.hex(),
                  "commits": commits_blob.hex()},
        "l2": {"blinding": sv.serialize_scalar_vec(np.asarray(l2_blind)).hex(),
               "proof": l2_proof.to_bytes().hex(), "commit": l2_commit.compress().hex()},
        "params": {"blinding": sv.serialize_scalar_vec(np.asarray(blind)).hex(),
                   "serialized": enc.serialize().hex()},
    }


def load_kat() -> dict:
    with open(KAT_PATH) as f:
        return json.load(f)


@pytest.mark.slow
def test_kat_file_matches_jax_package():
    assert make_kat() == load_kat()


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
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
