"""The port's encrypted modes (``fl/params.py`` EncParamsRange,
EncParamsRangeCompressed, EncParamsL2Compressed, the dispatch, PlainParams,
``convert.py``) against the JAX package, on the CPU (plain versions).

The KAT (tests/data/torch_port_modes_kat.json, made by the JAX package:
d = 7, 2 partitions, value range 8, L2 range 16) holds each mode's
``serialize()`` bytes at check_percentage 1.0 and, for the Range modes, 0.5.
Here every KAT frame deserializes and serializes back to itself, and the JAX
package's deserialized objects carry across through ``convert``. The port's
``encrypt`` (defined here) gives the KAT's bytes in
tests/test_torch_modes_encrypt.py, which also holds the hand-written
protobuf envelopes to the protobuf runtime's; the verdicts are in
tests/test_torch_modes_verdicts.py and the encrypts with a value out of
range in tests/test_torch_modes_out_of_range.py (each port encrypt is 15-50 s
of plain torch on the CPU, so they are spread over files that run side by
side). Tolerance: none (bytes equal)."""

import numpy as np
import pytest
import torch

from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig
from rofl_tpu.fl import params as JP
from rofl_tpu_torch import convert
from rofl_tpu_torch.crypto import pedersen
from rofl_tpu_torch.crypto import serde_vec as sv
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.fl import params as P
from test_torch_modes_kat import load_kat

torch.set_num_threads(2)
KAT = load_kat()
FP = FpConfig(*KAT["fp"])
JFP = JFpConfig(*KAT["fp"])
D = len(KAT["values"])
CLASSES = {P.ENC_RANGE_TYPE: P.EncParamsRange,
           P.ENC_RANGE_COMPRESSED_TYPE: P.EncParamsRangeCompressed,
           P.ENC_L2_COMPRESSED_TYPE: P.EncParamsL2Compressed}


@pytest.fixture(autouse=True)
def without_autograd():
    """The protocol takes no gradients: without autograd's bookkeeping the
    plain versions' many small torch calls run about a fifth faster on the
    CPU. The values are the same. test_torch_modes_verdicts.py and
    test_torch_accumulator.py import this fixture too."""
    with torch.inference_mode():
        yield


def blinding() -> torch.Tensor:
    return pedersen.rnd_scalar_tensor(D, np.random.default_rng(KAT["seeds"]["blinding"]), "cpu")


def encrypt(values, case) -> bytes:
    cfg = P.CryptoConfig(value_range=KAT["value_range"], n_partition=KAT["n_partition"],
                         l2_value_range=KAT["l2_value_range"],
                         check_percentage=case["check_percentage"], enc_type=case["enc_type"],
                         fp=FP)
    enc = P.encrypt(case["enc_type"], np.asarray(values, np.float32), blinding(), cfg,
                    np.random.default_rng(KAT["seeds"]["encrypt"]), "cpu")
    assert type(enc) is CLASSES[case["enc_type"]]
    return enc.serialize()


def test_the_blinding_is_the_kats():
    assert sv.serialize_scalar_vec(blinding()).hex() == KAT["blinding"]


def all_frames():
    frames = [(f"modes.{k}", v) for k, v in KAT["modes"].items()]
    frames += [(f"out_of_range.{k}", v) for k, v in KAT["out_of_range"]["cases"].items()]
    return frames


@pytest.mark.parametrize("name,case", all_frames(), ids=[n for n, _ in all_frames()])
def test_every_kat_frame_reads_and_writes_back(name, case):
    data = bytes.fromhex(case["serialized"])
    enc = P.deserialize(case["enc_type"], data, FP, "cpu")
    assert type(enc) is CLASSES[case["enc_type"]]
    assert enc.serialize() == data
    pairs = P.enc_pairs_of(enc)
    assert pairs.L.x.shape == (16, D) and pairs.R.x.shape == (16, D)
    if case["enc_type"] != P.ENC_L2_COMPRESSED_TYPE:
        assert enc.check_percentage == case["check_percentage"]


def test_plain_params_are_the_jax_packages():
    values = np.asarray(KAT["values"], np.float32)
    data = P.PlainParams(values).serialize()
    assert data == JP.PlainParams(values).serialize()
    plain = P.deserialize(P.PLAIN_TYPE, data, FP, "cpu")
    np.testing.assert_array_equal(plain.content, values)
    assert P.enc_pairs_of(plain) is None
    assert P.verify(plain, np.random.default_rng(0))
    assert type(P.encrypt(P.PLAIN_TYPE, values, None, P.CryptoConfig(), None, "cpu")) is (
        P.PlainParams)


def point(p):
    return tuple(np.asarray(c) for c in p)


def pair(p):
    return point(p.L), point(p.R)


@pytest.mark.parametrize("name", ["range", "range_compressed", "l2_compressed"])
def test_convert_carries_the_jax_modes_across(name):
    case = KAT["modes"][name]
    data = bytes.fromhex(case["serialized"])
    jenc = JP.deserialize(case["enc_type"], data, JFP)
    ranges = [p.to_bytes() for p in jenc.range_proofs]
    if name == "range":
        r = jenc.rand_proofs
        fields = (pair(jenc.enc_values), (pair(r.c_prime), np.asarray(r.z_m), np.asarray(r.z_r)),
                  ranges, jenc.prove_range, jenc.check_percentage, jenc.fp)
        enc = convert.enc_params_range_from_numpy(*fields, device="cpu")
        back = convert.enc_params_range_to_numpy(enc)
        np.testing.assert_array_equal(back[1][1], fields[1][1])
    elif name == "range_compressed":
        fields = (pair(jenc.enc_values), jenc.rand_proof.to_bytes(), ranges, jenc.prove_range,
                  jenc.check_percentage, jenc.fp)
        enc = convert.enc_params_range_compressed_from_numpy(*fields, device="cpu")
        back = convert.enc_params_range_compressed_to_numpy(enc)
        assert back[1] == fields[1]
    else:
        s = jenc.square_proofs
        fields = ((pair(jenc.enc_values.c), point(jenc.enc_values.c_sq)),
                  (point(s.c_l_prime), point(s.c_sq_prime), np.asarray(s.z_m),
                   np.asarray(s.z_r1), np.asarray(s.z_r2)),
                  jenc.rand_proof.to_bytes(), ranges, jenc.square_range_proof.to_bytes(),
                  jenc.prove_range, jenc.l2_prove_range, jenc.fp)
        enc = convert.enc_params_l2_compressed_from_numpy(*fields, device="cpu")
        back = convert.enc_params_l2_compressed_to_numpy(enc)
        assert back[2:7] == fields[2:7]
        np.testing.assert_array_equal(back[1][4], fields[1][4])
    assert enc.serialize() == data
