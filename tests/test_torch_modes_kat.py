"""Known answers of the JAX package for the server round in the remaining
encrypted modes, kept honest.

The JAX provers, verifiers and BSGS walks compile for minutes on JAX:CPU, so
the tier-1 tests of the port (tests/test_torch_modes_params.py,
test_torch_modes_verdicts.py, test_torch_compressed_rand_proof.py,
test_torch_accumulator.py) do not rerun them: they read their output from
``tests/data/torch_port_modes_kat.json``. ``make_kat`` computes that output at
the smallest shape that exercises the padding (d = 7 values, extended to 8, in
2 chunks of 4 at 8 bits; the L2 sum proof at 16 bits) from fixed numpy seeds:

  modes        the ``serialize()`` bytes of EncRange, EncRangeCompressed and
               EncL2Compressed at check_percentage 1.0, and of EncRange and
               EncRangeCompressed at 0.5, each with the JAX verdict
  out_of_range the same with one value outside the 8-bit range (-1.0 in
               lane 6), whose verdict depends on the mode (the rand proofs of
               the Range modes are made on the unclipped values)
  crp          one CompressedRandProof on fresh commitments
  cuts         each frame of ``modes`` cut before its last field and inside
               it, with what the JAX package makes of the cut frame: its
               reader parses the bytes that are there as the whole message
               (``rofl_tpu/fl/proto`` ``decode_length_delimited``), so a cut
               before the last field reads that field as its default
  accumulator  3 EncRangeCompressed clients with cancelling blindings, and
               ``Accumulator.extract`` of their sum with the server's table,
               bsgs_m = 2^16 (the JAX walk unrolls its 2^16 / bsgs_m giant
               steps: at 2^12 its compile outgrows 60 GB of memory). The
               port's tests extract the same values with a table of 2^12,
               which the port builds on the CPU in seconds, not minutes.

Regenerate the file with

    JAX_PLATFORMS=cpu python tests/test_torch_modes_kat.py

(about half an hour with an empty JAX cache). The one test here, marked
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

KAT_PATH = Path(__file__).resolve().parent / "data" / "torch_port_modes_kat.json"

# d = 7: pads to 8 (one identity V), two chunks of four; every value inside
# the 8-bit range (|v| <= 127/128).
VALUES = [0.5, -0.25, 0.125, -0.75, 0.0, 0.984375, -0.5]
OUT_OF_RANGE_LANE = 6
OUT_OF_RANGE_VALUE = -1.0
FP_BITS = (16, 7)
VALUE_RANGE = 8
L2_VALUE_RANGE = 16
N_PARTITION = 2
ENC_RANGE, ENC_RANGE_COMPRESSED, ENC_L2_COMPRESSED = 2, 4, 5
# (name, mode tag, check_percentage)
CASES = (
    ("range", ENC_RANGE, 1.0),
    ("range_compressed", ENC_RANGE_COMPRESSED, 1.0),
    ("l2_compressed", ENC_L2_COMPRESSED, 1.0),
    ("range_half", ENC_RANGE, 0.5),
    ("range_compressed_half", ENC_RANGE_COMPRESSED, 0.5),
)
OUT_OF_RANGE_CASES = (
    ("range", ENC_RANGE, 1.0),
    ("range_compressed", ENC_RANGE_COMPRESSED, 1.0),
    ("l2_compressed", ENC_L2_COMPRESSED, 1.0),
    ("range_half", ENC_RANGE, 0.5),
)
ACC_CLIENTS = 3
ACC_BSGS_M = 1 << 16
SEEDS = {"blinding": 401, "encrypt": 402, "verify": 403, "crp_m": 501, "crp_prove": 502,
         "acc_values": 601, "acc_blindings": 602, "acc_encrypt": 603}


def out_of_range_values() -> list:
    values = list(VALUES)
    values[OUT_OF_RANGE_LANE] = OUT_OF_RANGE_VALUE
    return values


def accumulator_values() -> np.ndarray:
    """(3, 7) client updates: whole multiples of 2^-7, none 0, inside the
    8-bit range."""
    rng = np.random.default_rng(SEEDS["acc_values"])
    units = rng.integers(1, 128, size=(ACC_CLIENTS, len(VALUES))) * rng.choice(
        [-1, 1], size=(ACC_CLIENTS, len(VALUES)))
    return (units / 128.0).astype(np.float32)


def crypto_config(P, enc_type: int, check_percentage: float, fp):
    return P.CryptoConfig(value_range=VALUE_RANGE, n_partition=N_PARTITION,
                          l2_value_range=L2_VALUE_RANGE, check_percentage=check_percentage,
                          enc_type=enc_type, fp=fp)


CUTS = ("before_last_field", "inside_last_field")


def _varint(data: bytes, i: int) -> tuple[int, int]:
    n = shift = 0
    while True:
        b = data[i]
        n |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return n, i
        shift += 7


def cut_lengths(frame: bytes) -> dict:
    """Byte counts that cut a length-delimited frame before its last field
    and inside it (one byte short). The envelopes hold varint, fixed32 and
    length-delimited fields only."""
    _, i = _varint(frame, 0)
    last = i
    while i < len(frame):
        last = i
        key, i = _varint(frame, i)
        wire_type = key & 7
        if wire_type == 0:
            _, i = _varint(frame, i)
        elif wire_type == 5:
            i += 4
        else:
            length, i = _varint(frame, i)
            i += length
    return {"before_last_field": last, "inside_last_field": len(frame) - 1}


def cut_verdicts(P, fp, modes: dict) -> dict:
    """The JAX package's verdict on each frame of ``modes`` cut as
    ``cut_lengths`` says: "raises <error>" where its reader or verifier
    raises, else "accepts" or "refuses"."""
    out = {}
    for name, case in modes.items():
        frame = bytes.fromhex(case["serialized"])
        out[name] = {}
        for cut, length in cut_lengths(frame).items():
            try:
                params = P.deserialize(case["enc_type"], frame[:length], fp)
                verdict = "accepts" if P.verify(
                    params, np.random.default_rng(SEEDS["verify"])) else "refuses"
            except Exception as e:  # noqa: BLE001 - the verdict is what JAX raises
                verdict = f"raises {type(e).__name__}"
            _progress(f"cut {name} {cut}: {verdict}")
            out[name][cut] = {"length": length, "jax": verdict}
    return out


def _progress(step: str) -> None:
    """One line on stderr a step of ``make_kat``, with the process's peak
    resident memory so far."""
    import resource
    import time

    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    print(f"{time.strftime('%H:%M:%S')} {step} (peak {peak:.1f} GiB)", file=sys.stderr,
          flush=True)


def make_kat() -> dict:
    """Run the JAX package on JAX:CPU from the fixed seeds → the KAT dict
    (byte strings as hex)."""
    import jax.numpy as jnp

    from rofl_tpu.crypto import compressed_rand_proof as CRP
    from rofl_tpu.crypto import pedersen
    from rofl_tpu.crypto import serde_vec as sv
    from rofl_tpu.crypto.fp_codec import FpConfig
    from rofl_tpu.fl import params as P
    from rofl_tpu.spec.merlin import Transcript

    fp = FpConfig(*FP_BITS)
    d = len(VALUES)
    blind = pedersen.rnd_scalar_limbs(d, np.random.default_rng(SEEDS["blinding"]))

    def round_trip(values, enc_type, check_percentage):
        cfg = crypto_config(P, enc_type, check_percentage, fp)
        enc = P.encrypt(enc_type, np.asarray(values, np.float32), jnp.asarray(blind), cfg,
                        np.random.default_rng(SEEDS["encrypt"]))
        data = enc.serialize()
        _progress(f"encrypted mode {enc_type} at {check_percentage}")
        verdict = P.verify(P.deserialize(enc_type, data, fp),
                           np.random.default_rng(SEEDS["verify"]))
        _progress(f"verified mode {enc_type} at {check_percentage}: {verdict}")
        return {"enc_type": enc_type, "check_percentage": check_percentage,
                "serialized": data.hex(), "verifies": bool(verdict)}

    modes = {name: round_trip(VALUES, t, cp) for name, t, cp in CASES}
    out_of_range = {name: round_trip(out_of_range_values(), t, cp)
                    for name, t, cp in OUT_OF_RANGE_CASES}
    cuts = cut_verdicts(P, fp, modes)

    m = jnp.asarray(fp.f32_to_scalar_limbs(np.asarray(VALUES, np.float32)))
    crp_blind = pedersen.rnd_scalar_limbs(d, np.random.default_rng(SEEDS["crp_m"]))
    proof, pairs = CRP.prove(Transcript(b"CompressedRandProof"), m, jnp.asarray(crp_blind),
                             np.random.default_rng(SEEDS["crp_prove"]))
    _progress("compressed rand proof")

    acc_values = accumulator_values()
    blindings = pedersen.cancelling_scalar_limbs(
        ACC_CLIENTS, d, np.random.default_rng(SEEDS["acc_blindings"]))
    cfg = crypto_config(P, ENC_RANGE_COMPRESSED, 1.0, fp)
    acc = P.Accumulator(ENC_RANGE_COMPRESSED, d, fp, bsgs_m=ACC_BSGS_M)
    clients = []
    for c in range(ACC_CLIENTS):
        enc = P.encrypt(ENC_RANGE_COMPRESSED, acc_values[c], jnp.asarray(blindings[c]), cfg,
                        np.random.default_rng(SEEDS["acc_encrypt"] + c))
        data = enc.serialize()
        assert acc.accumulate(P.deserialize(ENC_RANGE_COMPRESSED, data, fp))
        clients.append(data.hex())
    _progress("accumulated")
    extracted = acc.extract()
    _progress("extracted")
    return {
        "values": VALUES, "fp": list(FP_BITS), "value_range": VALUE_RANGE,
        "l2_value_range": L2_VALUE_RANGE, "n_partition": N_PARTITION, "seeds": SEEDS,
        "blinding": sv.serialize_scalar_vec(np.asarray(blind)).hex(),
        "modes": modes,
        "cuts": cuts,
        "out_of_range": {"lane": OUT_OF_RANGE_LANE, "value": OUT_OF_RANGE_VALUE,
                         "cases": out_of_range},
        "crp": {"blinding": sv.serialize_scalar_vec(np.asarray(crp_blind)).hex(),
                "proof": proof.to_bytes().hex(),
                "pairs": sv.serialize_eg_pair_vec(pairs).hex()},
        "accumulator": {"enc_type": ENC_RANGE_COMPRESSED, "bsgs_m": ACC_BSGS_M,
                        "values": acc_values.tolist(),
                        "blindings": [sv.serialize_scalar_vec(np.asarray(b)).hex()
                                      for b in blindings],
                        "clients": clients,
                        "extracted": None if extracted is None else extracted.tolist()},
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
