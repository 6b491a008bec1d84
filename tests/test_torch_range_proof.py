"""The port's L∞ range proofs (``crypto/range_proof.py``,
``range_proof_vec.py`` through ``bindings``) against the JAX package's output,
on the CPU (plain versions).

The JAX prover compiles for minutes on JAX:CPU, so its output is read from
``tests/data/torch_port_l2_kat.json`` (made and kept honest by
tests/test_torch_l2_kat.py): d = 7 values padded to 8, 2 chunks of 4, 8 bits.
With the KAT's seeds the port's ``create_rangeproof`` gives the KAT's proof
and commitment blobs byte for byte; the port verifies the KAT proof and
refuses a tampered t_x, swapped commitments and an identity A; values out of
range raise in both packages; ``RangeProof`` bytes round-trip. The JAX
verifier's side, which compiles for minutes, is
tests/test_torch_range_proof_jax.py. One prove in this file. Tolerance: none
(bytes and verdicts equal).
"""

import numpy as np
import pytest
import torch

from rofl_tpu import bindings as JB
from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig
from rofl_tpu_torch import bindings as B
from rofl_tpu_torch.crypto import range_proof as RP
from rofl_tpu_torch.crypto import serde_vec as sv
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from test_torch_l2_kat import load_kat

torch.set_num_threads(2)
KAT = load_kat()
FP = FpConfig(*KAT["fp"])
JFP = JFpConfig(*KAT["fp"])
RANGE = KAT["value_range"]
CLIPPED = B.clip_to_range(np.asarray(KAT["values"], np.float32), RANGE, FP)
KAT_PROOFS = bytes.fromhex(KAT["range"]["proofs"])
KAT_COMMITS = bytes.fromhex(KAT["range"]["commits"])
TAMPERS = ["t_x", "swapped_commitments", "identity_A"]


@pytest.fixture(scope="module")
def port_round():
    """The port's create_rangeproof from the KAT's blinding and prove seed."""
    blinding = B.create_random_blinding_vector(
        len(CLIPPED), np.random.default_rng(KAT["seeds"]["range_blinding"]), device="cpu")
    proofs, commits = B.create_rangeproof(
        CLIPPED, blinding, RANGE, KAT["n_partition"], FP,
        np.random.default_rng(KAT["seeds"]["range_prove"]), device="cpu")
    return blinding, proofs, commits


def port_verify(commits, proofs, seed=5):
    return B.verify_rangeproof(commits, proofs, RANGE, FP, np.random.default_rng(seed),
                               device="cpu")


def tampered(kind):
    """The KAT (commitments, proofs) blobs with one fault."""
    proofs = sv.deserialize_range_proof_vec(KAT_PROOFS)
    commits = KAT_COMMITS
    if kind == "t_x":
        p = proofs[0]
        proofs[0] = RP.RangeProof(p.A, p.S, p.T_1, p.T_2, (p.t_x + 1) % RP.SS.L, p.t_x_blinding,
                                  p.e_blinding, p.ipp)
    elif kind == "swapped_commitments":
        head, items = commits[:8], [commits[8 + 40 * i: 8 + 40 * (i + 1)] for i in range(7)]
        items[0], items[1] = items[1], items[0]
        commits = head + b"".join(items)
    elif kind == "identity_A":
        p = proofs[1]
        proofs[1] = RP.RangeProof(bytes(32), p.S, p.T_1, p.T_2, p.t_x, p.t_x_blinding,
                                  p.e_blinding, p.ipp)
    return commits, sv.serialize_range_proof_vec(proofs)


def test_the_blinding_sampler_gives_the_kat_blinding(port_round):
    assert port_round[0].hex() == KAT["range"]["blinding"]
    assert CLIPPED.tolist() == JB.clip_to_range(
        np.asarray(KAT["values"], np.float32), RANGE, JFP).tolist()


def test_the_port_proves_the_kat_bytes(port_round):
    _, proofs, commits = port_round
    assert proofs == KAT_PROOFS
    assert commits == KAT_COMMITS


def test_the_port_verifies_the_kat_proof():
    assert port_verify(KAT_COMMITS, KAT_PROOFS)


@pytest.mark.parametrize("kind", TAMPERS)
def test_the_port_refuses_a_tampered_proof(kind):
    assert not port_verify(*tampered(kind))


def test_unclipped_values_raise():
    values = np.asarray(KAT["values"], np.float32)  # -1.0 lies outside 8 bits
    blinding = B.create_random_blinding_vector(len(values), np.random.default_rng(1),
                                               device="cpu")
    for create in (lambda: B.create_rangeproof(values, blinding, RANGE, 2, FP,
                                               np.random.default_rng(2), device="cpu"),
                   lambda: JB.create_rangeproof(values, blinding, RANGE, 2, JFP,
                                                np.random.default_rng(2))):
        with pytest.raises(ValueError, match="out of range"):
            create()


def test_range_proof_bytes_round_trip():
    for raw in sv._iter_bytes_vec(KAT_PROOFS):
        proof = RP.RangeProof.from_bytes(raw)
        assert proof.to_bytes() == raw
        assert len(proof.ipp.L) == 5  # lg(8 bits * 4 values)
    assert sv.serialize_range_proof_vec(sv.deserialize_range_proof_vec(KAT_PROOFS)) == KAT_PROOFS
    with pytest.raises(ValueError):
        RP.RangeProof.from_bytes(sv._iter_bytes_vec(KAT_PROOFS)[0][:-32])
