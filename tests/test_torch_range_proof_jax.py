"""The JAX package's range-proof verifier on the port's proofs, on the CPU.

``rofl_tpu.bindings.verify_rangeproof`` accepts the port's proof: the KAT
blob of tests/data/torch_port_l2_kat.json, which
tests/test_torch_range_proof.py holds byte-equal to the port's
``create_rangeproof`` output for the KAT's seeds, and the range proofs of the
port's L2 round (the KAT round, which tests/test_torch_l2_params.py holds
byte-equal to the port's ``EncParamsL2.encrypt``), against their
commitments. It refuses the tampered proofs the port refuses. Apart from the
port's own tests because the JAX verifier compiles for minutes on JAX:CPU.
Tolerance: none (verdicts equal).
"""

import numpy as np
import pytest

from rofl_tpu import bindings as JB
from rofl_tpu.crypto import range_proof_vec as JRPV
from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig
from rofl_tpu.fl import params as JP
from test_torch_l2_kat import load_kat
from test_torch_range_proof import KAT_COMMITS, KAT_PROOFS, TAMPERS, tampered

KAT = load_kat()
JFP = JFpConfig(*KAT["fp"])
RANGE = KAT["value_range"]


def jax_verify(commits, proofs, seed=5):
    return JB.verify_rangeproof(commits, proofs, RANGE, JFP, np.random.default_rng(seed))


def test_the_jax_package_verifies_the_port_proof():
    assert jax_verify(KAT_COMMITS, KAT_PROOFS)


def test_the_jax_package_verifies_the_range_proofs_of_the_port_round():
    enc = JP.EncParamsL2.deserialize(bytes.fromhex(KAT["params"]["serialized"]), JFP)
    assert JRPV.verify_rangeproof(enc.range_proofs, enc.enc_values.c.L, JFP, RANGE,
                                  np.random.default_rng(6))


@pytest.mark.parametrize("kind", TAMPERS)
def test_the_jax_package_refuses_a_tampered_proof(kind):
    assert not jax_verify(*tampered(kind))
