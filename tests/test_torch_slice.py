"""The whole secure-aggregation round through ``bindings`` on both packages:
3 clients, d = 77, cancelling blindings -> commit -> add_commitments ->
extract_values. Every blob is byte-identical, the extracted sums are equal
(tolerance 0.0), and a round whose blindings do not cancel fails extraction
on both sides. Each package runs on the fixed-base tables it built itself.

The JAX round compiles for minutes on JAX:CPU, so its blobs, sums and the
error of its failed extraction are read from tests/data/torch_port_jax_kat.json
(``slice``: made and kept honest by tests/test_torch_jax_kat.py, which runs
the round below through ``rofl_tpu.bindings``). FpConfig(8, 3) keeps the
default BSGS table small (m = 128, two giant steps)."""

import numpy as np
import pytest
import torch

import rofl_tpu_torch.bindings as TB
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.crypto import serde_vec as tsv
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.ops import bsgs as tbsgs
from rofl_tpu_torch.ops import fe as tfe
from test_torch_jax_kat import load_kat

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
N_CLIENTS, D = 3, 77
T_FP = FpConfig(8, 3)
BLINDING_SEED = 31
rng = np.random.default_rng(2718)
# multiples of 2^-3 in [-10, 10]: the sum of three stays inside 8 bits
BITS = rng.integers(-80, 81, size=(N_CLIENTS, D))
BITS[:, 0] = (80, 80, 80)       # the largest sum
BITS[:, 1] = (-80, -80, -80)    # the smallest
BITS[:, 2] = (5, -5, 0)         # zero
UPDATES = (BITS / T_FP.scale).astype(np.float32)
WANT = (BITS.sum(axis=0) / T_FP.scale).astype(np.float32)


@pytest.fixture(scope="module")
def round_blobs():
    """Blindings, commitments and the sum from the port, and the JAX
    package's from the KAT, same rng seed."""
    kat = load_kat()["slice"]
    t_bl = TB.generate_cancelling_blindings(N_CLIENTS, D, np.random.default_rng(BLINDING_SEED),
                                            "cpu")
    t_commits = [TB.commit(UPDATES[c], t_bl[c], T_FP, device="cpu") for c in range(N_CLIENTS)]
    t_sum = TB.add_commitments(t_commits, device="cpu")
    return dict(t_bl=t_bl, j_bl=[bytes.fromhex(b) for b in kat["blindings"]],
                t_commits=t_commits, j_commits=[bytes.fromhex(c) for c in kat["commits"]],
                t_sum=t_sum, j_sum=bytes.fromhex(kat["sum"]),
                j_out=np.asarray(kat["extracted"], np.float32),
                j_part=bytes.fromhex(kat["partial_sum"]), j_part_error=kat["partial_error"])


def test_blinding_blobs_are_byte_identical(round_blobs):
    assert round_blobs["t_bl"] == round_blobs["j_bl"]
    assert all(len(b) == 8 + 40 * D for b in round_blobs["t_bl"])


def test_commitment_blobs_are_byte_identical(round_blobs):
    assert round_blobs["t_commits"] == round_blobs["j_commits"]
    assert len(set(round_blobs["t_commits"])) == N_CLIENTS


def test_summed_blob_is_byte_identical(round_blobs):
    assert round_blobs["t_sum"] == round_blobs["j_sum"]
    # blindings cancelled: the sum is the unblinded commitment of the sums
    assert round_blobs["t_sum"] == TB.commit_no_blinding(WANT, T_FP, device="cpu")


def test_extracted_sums_are_equal_and_exact(round_blobs):
    t_out = TB.extract_values(round_blobs["t_sum"], T_FP, device="cpu")
    j_out = round_blobs["j_out"]
    assert t_out.dtype == np.float32 and t_out.shape == (D,)
    np.testing.assert_array_equal(t_out, j_out)
    np.testing.assert_array_equal(t_out, WANT)


def test_round_without_cancelling_blindings_fails_on_both_sides(round_blobs):
    t_part = TB.add_commitments(round_blobs["t_commits"][:-1], device="cpu")
    assert t_part == round_blobs["j_part"]
    with pytest.raises(ValueError, match="discrete log not found") as raised:
        TB.extract_values(t_part, T_FP, device="cpu")
    assert "discrete log not found" in round_blobs["j_part_error"]
    assert str(raised.value) == round_blobs["j_part_error"]


def test_elgamal_form_of_the_round(round_blobs):
    """ElGamal pairs through the wire, added pairwise: R cancels to the
    identity and L extracts to the same sums."""
    acc = None
    for c in range(N_CLIENTS):
        m = tfe.to_tensor(T_FP.f32_to_scalar_limbs(UPDATES[c]), "cpu")
        r = tfe.to_tensor(tsv.deserialize_scalar_vec(round_blobs["t_bl"][c]), "cpu")
        wire = tsv.serialize_eg_pair_vec(tpedersen.elgamal_commit(m, r))
        pairs = tsv.deserialize_eg_pair_vec(wire, "cpu")
        acc = pairs if acc is None else tpedersen.add_pairs(acc, pairs)
    assert tpedersen.right_elem_is_identity(acc).all()
    assert not tpedersen.right_elem_is_unity(acc).any()
    assert tsv.serialize_rp_vec(acc.L) == round_blobs["t_sum"]
    limbs, ok = tbsgs.solve_discrete_log(acc.L, T_FP.default_bsgs_table_size, T_FP.bsgs_n_bits)
    assert ok.all()
    np.testing.assert_array_equal(T_FP.scalar_limbs_to_f32(tfe.to_numpy(limbs)), WANT)
