"""The port's L2 sum proof (``crypto/l2_range_proof.py``) against the JAX
package's output, on the CPU (plain versions).

With the KAT's seeds (tests/data/torch_port_l2_kat.json, made by
``rofl_tpu.crypto.l2_range_proof.create_rangeproof_l2``: the 7 clipped KAT
values, 16 bits) the port's ``create_rangeproof_l2`` gives the KAT's proof
bytes and sum-square commitment; the port verifies it against that
commitment and refuses it against another one, and the JAX verifier accepts
the port's proof and the L2 sum proof of the port's L2 round (the KAT round,
which tests/test_torch_l2_params.py holds byte-equal to the port's
``EncParamsL2.encrypt``) against Σ c_sq. The JAX verifier compiles for
minutes on JAX:CPU, so its verdicts are read from
tests/data/torch_port_jax_kat.json (``verdicts``: made and kept honest by
tests/test_torch_jax_kat.py), each beside the SHA-256 of the bytes it was
taken on, which the tests here hold equal to the port's. One prove in this
file. Tolerance: none (bytes and verdicts equal).
"""

import numpy as np
import pytest
import torch

from rofl_tpu_torch import bindings as B
from rofl_tpu_torch.crypto import l2_range_proof as L2
from rofl_tpu_torch.crypto import pedersen
from rofl_tpu_torch.crypto import serde_vec as sv
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.ops import curve, sc
from rofl_tpu_torch.spec import ristretto as SR
from test_torch_jax_kat import verdict as jax_verdict
from test_torch_l2_kat import load_kat

torch.set_num_threads(2)
KAT = load_kat()
FP = FpConfig(*KAT["fp"])
L2_RANGE = KAT["l2_value_range"]


def round_sum_square(round_bytes: bytes) -> bytes:
    """The compressed sum of the square commitments c_sq of an EncParamsL2
    round, made by the port: what the round's L2 sum proof is verified
    against."""
    enc = P.EncParamsL2.deserialize(round_bytes, FP, "cpu")
    return curve.compress_to_bytes(curve.tree_sum(enc.enc_values.c_sq))[0].tobytes()


@pytest.fixture(scope="module")
def port_proof():
    blind = pedersen.rnd_scalar_limbs(len(KAT["values"]),
                                      np.random.default_rng(KAT["seeds"]["l2_blinding"]), "cpu")
    assert sv.serialize_scalar_vec(blind).hex() == KAT["l2"]["blinding"]
    return L2.create_rangeproof_l2(
        B.clip_to_range(np.asarray(KAT["values"], np.float32), KAT["value_range"], FP),
        sc.unpack_scalars(blind), FP, L2_RANGE, np.random.default_rng(KAT["seeds"]["l2_prove"]),
        "cpu")


def test_the_port_proves_the_kat_bytes(port_proof):
    proof, commit = port_proof
    assert proof.to_bytes().hex() == KAT["l2"]["proof"]
    assert commit.compress().hex() == KAT["l2"]["commit"]


def test_the_port_verifies_against_the_commitment_only(port_proof):
    proof, commit = port_proof
    assert L2.verify_rangeproof_l2(proof, commit, L2_RANGE, np.random.default_rng(4), "cpu")
    other = SR.decompress(bytes.fromhex(KAT["range"]["commits"])[16:48])
    assert not L2.verify_rangeproof_l2(proof, other, L2_RANGE, np.random.default_rng(4), "cpu")


def test_the_jax_package_verifies_the_port_proof(port_proof):
    proof, commit = port_proof
    assert jax_verdict("l2_sum_proof_of_the_port", proof.to_bytes(), commit.compress())


def test_the_jax_package_verifies_the_l2_sum_proof_of_the_port_round():
    round_bytes = bytes.fromhex(KAT["params"]["serialized"])
    enc = P.EncParamsL2.deserialize(round_bytes, FP, "cpu")
    assert jax_verdict("l2_sum_proof_of_the_port_round", enc.square_range_proof.to_bytes(),
                       round_sum_square(round_bytes))
