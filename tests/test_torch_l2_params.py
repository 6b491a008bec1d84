"""The port's L2-norm client round (``fl/params.py`` ``EncParamsL2``,
``fl/wire.py``, ``crypto/l2_range_proof.py``, the batched square-rand
verifier of ``crypto/sigma.py``, ``convert.py``) against the JAX package, on
the CPU (plain versions).

With the KAT's seeds (tests/data/torch_port_l2_kat.json, made by the JAX
package: d = 7, 2 partitions, value range 8, L2 range 16) ``encrypt`` gives
the KAT's ``serialize()`` bytes, which also holds the hand-written protobuf
to the protobuf runtime's; the KAT round deserializes and verifies in the
port; the JAX package deserializes the port's bytes and its batched
square-rand verifier accepts them (its range-proof and L2 verifiers run on the
same round in tests/test_torch_range_proof_jax.py and
tests/test_torch_l2_range_proof.py; the JAX verifiers compile for minutes on
JAX:CPU, so their verdicts are read from tests/data/torch_port_jax_kat.json,
made and kept honest by tests/test_torch_jax_kat.py, beside the SHA-256 of
the bytes they were taken on); the port's batched square-rand verifier
accepts an honest proof and refuses a tampered lane; ``EncNormData`` encodes
as ``rofl_tpu.fl.proto`` does for empty fields and lengths above 127 and
16 383; ``check_l2`` raises what the JAX one raises. One prove in this file. Tolerance: none (bytes, verdicts
and exception types equal).
"""

import numpy as np
import pytest
import torch

from rofl_tpu.crypto import l2_range_proof as JL2
from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig
from rofl_tpu.fl import params as JP
from rofl_tpu.fl import proto as pb
from rofl_tpu_torch import bindings as B
from rofl_tpu_torch import convert
from rofl_tpu_torch.crypto import l2_range_proof as L2
from rofl_tpu_torch.crypto import pedersen, sigma
from rofl_tpu_torch.crypto import serde_vec as sv
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl import wire
from rofl_tpu_torch.ops import fe, sc
from test_torch_jax_kat import digest, load_kat as load_jax_kat
from test_torch_l2_kat import load_kat

torch.set_num_threads(2)
KAT = load_kat()
FP = FpConfig(*KAT["fp"])
JFP = JFpConfig(*KAT["fp"])
KAT_BYTES = bytes.fromhex(KAT["params"]["serialized"])
CFG = P.CryptoConfig(value_range=KAT["value_range"], n_partition=KAT["n_partition"],
                     l2_value_range=KAT["l2_value_range"], enc_type=P.ENC_L2_TYPE, fp=FP)


@pytest.fixture(scope="module")
def port_bytes():
    blind = pedersen.rnd_scalar_limbs(len(KAT["values"]),
                                      np.random.default_rng(KAT["seeds"]["params_blinding"]),
                                      "cpu")
    assert sv.serialize_scalar_vec(blind).hex() == KAT["params"]["blinding"]
    enc = P.EncParamsL2.encrypt(np.asarray(KAT["values"], np.float32), blind, CFG,
                                np.random.default_rng(KAT["seeds"]["params_encrypt"]), "cpu")
    return enc.serialize()


def test_encrypt_gives_the_kat_bytes(port_bytes):
    assert port_bytes == KAT_BYTES


def test_the_kat_round_verifies_in_the_port():
    enc = P.EncParamsL2.deserialize(KAT_BYTES, FP, "cpu")
    assert enc.serialize() == KAT_BYTES
    assert enc.verify(np.random.default_rng(3))


def test_the_jax_package_deserializes_the_port_bytes_and_verifies_their_square_rand_proofs(
        port_bytes):
    """The first of the three verifiers of the JAX package's
    EncParamsL2.verify, on the port's round (the KAT's verdict, taken on
    bytes of the same digest, and whether the JAX package's serialize gave
    them back); the range proofs and the L2 sum proof are verified by the
    JAX package in tests/test_torch_range_proof_jax.py and
    tests/test_torch_l2_range_proof.py."""
    entry = load_jax_kat()["verdicts"]["square_rand_proofs_of_the_port_round"]
    assert entry["sha256"] == digest(port_bytes)
    assert entry["reserialized"] and entry["verdict"]


def test_batched_square_rand_verify_accepts_honest_and_refuses_a_tampered_lane():
    enc = P.EncParamsL2.deserialize(KAT_BYTES, FP, "cpu")
    proofs, commits = enc.square_proofs, enc.enc_values
    assert sigma.square_rand_proof_verify_batched(proofs, commits, np.random.default_rng(5))
    z_r2 = proofs.z_r2.clone()
    z_r2[:, 3:4] = sc.add(z_r2[:, 3:4].contiguous(), fe.to_tensor(sc.pack_scalars([1]), "cpu"))
    bad = sigma.SquareRandProofVec(proofs.c_prime, proofs.c_sq_prime, proofs.z_m, proofs.z_r1,
                                   z_r2)
    assert not sigma.square_rand_proof_verify_batched(bad, commits, np.random.default_rng(5))
    assert sigma.square_rand_proof_verify(bad, commits).tolist() == [
        lane != 3 for lane in range(len(KAT["values"]))]


def test_convert_carries_the_jax_round_across():
    jenc = JP.EncParamsL2.deserialize(KAT_BYTES, JFP)

    def point(p):
        return tuple(np.asarray(c) for c in p)

    fields = (
        ((point(jenc.enc_values.c.L), point(jenc.enc_values.c.R)), point(jenc.enc_values.c_sq)),
        ((point(jenc.square_proofs.c_prime.L), point(jenc.square_proofs.c_prime.R)),
         point(jenc.square_proofs.c_sq_prime), np.asarray(jenc.square_proofs.z_m),
         np.asarray(jenc.square_proofs.z_r1), np.asarray(jenc.square_proofs.z_r2)),
        [p.to_bytes() for p in jenc.range_proofs], jenc.square_range_proof.to_bytes(),
        jenc.prove_range, jenc.l2_prove_range, jenc.fp)
    enc = convert.enc_params_l2_from_numpy(*fields, device="cpu")
    assert enc.serialize() == KAT_BYTES
    back = convert.enc_params_l2_to_numpy(enc)
    assert back[2:6] == fields[2:6]
    np.testing.assert_array_equal(back[1][2], fields[1][2])


WIRE_CASES = {
    "empty": {},
    "ints_only": dict(range_bits=8, l2_range_bits=16),
    "negative_int": dict(range_bits=-3),
    "len_127": dict(enc_values=b"\x01" * 127, range_proof=[b""]),
    "len_128": dict(enc_values=b"\x02" * 128, square_proof=b"\x03"),
    "len_16383": dict(square_proof=b"\x04" * 16383, range_proof=[b"a", b"", b"bc"]),
    "len_16384": dict(square_range_proof=b"\x05" * 16384, l2_range_bits=2 ** 31 - 1),
    "all": dict(enc_values=b"\x06" * 300, square_proof=b"\x07" * 20000, range_proof=[b"x" * 129],
                square_range_proof=b"\x08" * 5, range_bits=300, l2_range_bits=1),
}


@pytest.mark.parametrize("case", sorted(WIRE_CASES))
def test_enc_norm_data_encodes_as_the_protobuf_runtime(case):
    fields = WIRE_CASES[case]
    ref = pb.EncNormData(**{k: v for k, v in fields.items() if k != "range_proof"})
    ref.range_proof.extend(fields.get("range_proof", []))
    want = pb.encode_length_delimited(ref)
    got = wire.encode_length_delimited(wire.EncNormData(**fields).to_bytes())
    assert got == want
    assert wire.EncNormData.from_bytes(wire.decode_length_delimited(want)) == wire.EncNormData(
        **fields)


L2_CASES = {
    # (values, fp bits, L2 range)
    "kat": (KAT["values"], (16, 7), 16),
    "overflow_at_d50000": ([0.99] * 50000, (16, 7), 16),
    "overflow_small": ([0.99] * 5, (16, 7), 16),
    "norm_error": ([0.99] * 3, (16, 7), 12),
    "fp8": ([0.5, -0.25, 1.5], (8, 3), 8),
}


@pytest.mark.parametrize("case", sorted(L2_CASES))
def test_check_l2_raises_what_the_jax_package_raises(case):
    values, bits, l2_range = L2_CASES[case]
    values = B.clip_to_range(np.asarray(values, np.float32), 8, FpConfig(*bits))

    def outcome(check, fp):
        try:
            return check(values, fp, l2_range)
        except ValueError as e:
            return type(e).__name__

    got = outcome(L2.check_l2, FpConfig(*bits))
    assert got == outcome(JL2.check_l2, JFpConfig(*bits))
    if case.startswith("overflow"):
        assert got == "L2OverflowError"
    if case == "norm_error":
        assert got == "L2NormError"


def test_encrypt_raises_before_proving_when_out_of_bounds():
    cfg = P.CryptoConfig(value_range=8, n_partition=2, l2_value_range=16, fp=FP,
                         enc_type=P.ENC_L2_TYPE)
    blind = np.zeros((16, 5), np.uint32)
    rng = np.random.default_rng(0)
    state = rng.bit_generator.state
    with pytest.raises(L2.L2OverflowError):
        P.EncParamsL2.encrypt(np.full(5, 0.99, np.float32), blind, cfg, rng, "cpu")
    assert rng.bit_generator.state == state  # nothing drawn, nothing proved
