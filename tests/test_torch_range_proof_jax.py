"""The JAX package's range-proof verifier on the port's proofs.

``rofl_tpu.bindings.verify_rangeproof`` accepts the port's proof: the KAT
blob of tests/data/torch_port_l2_kat.json, which
tests/test_torch_range_proof.py holds byte-equal to the port's
``create_rangeproof`` output for the KAT's seeds, and the range proofs of the
port's L2 round (the KAT round, which tests/test_torch_l2_params.py holds
byte-equal to the port's ``EncParamsL2.encrypt``), against their
commitments. It refuses the tampered proofs the port refuses. The JAX
verifier compiles for minutes on JAX:CPU, so its verdicts are read from
tests/data/torch_port_jax_kat.json (``verdicts``: made and kept honest by
tests/test_torch_jax_kat.py, which runs it on the same bytes), each beside
the SHA-256 of the bytes it was taken on; each test here makes those bytes
and holds their digest equal. Tolerance: none (verdicts equal).
"""

import pytest

from test_torch_jax_kat import verdict as jax_verdict
from test_torch_l2_kat import load_kat
from test_torch_range_proof import KAT_COMMITS, KAT_PROOFS, TAMPERS, tampered

KAT = load_kat()


def test_the_jax_package_verifies_the_port_proof():
    assert jax_verdict("range_proof_of_the_port", KAT_COMMITS, KAT_PROOFS)


def test_the_jax_package_verifies_the_range_proofs_of_the_port_round():
    assert jax_verdict("range_proofs_of_the_port_round",
                       bytes.fromhex(KAT["params"]["serialized"]))


@pytest.mark.parametrize("kind", TAMPERS)
def test_the_jax_package_refuses_a_tampered_proof(kind):
    assert not jax_verdict(f"tampered_range_proof_{kind}", *tampered(kind))
