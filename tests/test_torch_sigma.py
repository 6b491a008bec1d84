"""rofl_tpu_torch.crypto.sigma against rofl_tpu.crypto.sigma (JAX CPU path):
the three Σ-protocols and their existing= forms. For the same numpy seed the
serialized proofs and commitments are byte-identical; a proof made by one
package verifies in the other (carried across by rofl_tpu_torch.convert); both
refuse tampered proofs, in the tampered lane only. Tolerance: exact equality
of bytes and masks.

One file and one lane count for all of it, so that the JAX compiles of the
ladder, the transcript and the scalar ops are paid once. Both packages use the
port's fixed-base tables (test_torch_fixed_base.py holds the two builds equal).
"""

from functools import lru_cache

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rofl_tpu.bindings as JB
import rofl_tpu_torch.bindings as TB
from rofl_tpu.crypto import pedersen as jpedersen
from rofl_tpu.crypto import serde_vec as jsv
from rofl_tpu.crypto import sigma as jsigma
from rofl_tpu.ops import curve as jcurve
from rofl_tpu_torch import convert
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.crypto import serde_vec as tsv
from rofl_tpu_torch.crypto import sigma as tsigma
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import scalar as SS
from torch_port_helpers import share_tables_with_jax

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
N = 5
SEED = 4242
TAMPERED = 2
M_NP = tsc.pack_scalars([0, 1, SS.L - 1, 12800, 2**40 + 3])  # m^2 == m in lanes 0 and 1 only
R1_NP = tpedersen.rnd_scalar_limbs(N, np.random.default_rng(1), "cpu")
R2_NP = tpedersen.rnd_scalar_limbs(N, np.random.default_rng(2), "cpu")
M_T, R1_T, R2_T = (tfe.to_tensor(x, "cpu") for x in (M_NP, R1_NP, R2_NP))
M_J, R1_J, R2_J = (jnp.asarray(x) for x in (M_NP, R1_NP, R2_NP))

share_tables_with_jax("base_B", "base_H")


# -- carrying objects across ----------------------------------------------------


def jpoint(coords):
    return jcurve.PointArray(*[jnp.asarray(c) for c in coords])


def jpair(pair):
    return jpedersen.ElGamalPairArray(jpoint(pair[0]), jpoint(pair[1]))


def npoint(p):
    return tuple(np.asarray(c) for c in p)


def npair(pair):
    return npoint(pair.L), npoint(pair.R)


def rand_proof_to_jax(p):
    c_prime, z_m, z_r = convert.rand_proof_to_numpy(p)
    return jsigma.RandProofVec(jpair(c_prime), jnp.asarray(z_m), jnp.asarray(z_r))


def rand_proof_to_torch(p):
    return convert.rand_proof_from_numpy(
        npair(p.c_prime), np.asarray(p.z_m), np.asarray(p.z_r), device="cpu")


def square_rand_proof_to_jax(p):
    c_prime, c_sq_prime, *z = convert.square_rand_proof_to_numpy(p)
    return jsigma.SquareRandProofVec(jpair(c_prime), jpoint(c_sq_prime),
                                     *[jnp.asarray(v) for v in z])


def square_rand_proof_to_torch(p):
    return convert.square_rand_proof_from_numpy(
        npair(p.c_prime), npoint(p.c_sq_prime), np.asarray(p.z_m), np.asarray(p.z_r1),
        np.asarray(p.z_r2), device="cpu")


def square_rand_commit_to_jax(c):
    pair, c_sq = convert.square_rand_commit_to_numpy(c)
    return jsigma.SquareRandCommitVec(jpair(pair), jpoint(c_sq))


def square_rand_commit_to_torch(c):
    return convert.square_rand_commit_from_numpy(npair(c.c), npoint(c.c_sq), device="cpu")


def square_proof_to_jax(p):
    c_l_prime, c_sq_prime, *z = convert.square_proof_to_numpy(p)
    return jsigma.SquareProofVec(jpoint(c_l_prime), jpoint(c_sq_prime),
                                 *[jnp.asarray(v) for v in z])


def square_proof_to_torch(p):
    return convert.square_proof_from_numpy(
        npoint(p.c_l_prime), npoint(p.c_sq_prime), np.asarray(p.z_m), np.asarray(p.z_r1),
        np.asarray(p.z_r2), device="cpu")


def square_commit_to_jax(c):
    c_l, c_sq = convert.square_commit_to_numpy(c)
    return jsigma.SquareCommitVec(jpoint(c_l), jpoint(c_sq))


def square_commit_to_torch(c):
    return convert.square_commit_from_numpy(npoint(c.c_l), npoint(c.c_sq), device="cpu")


def flip(limbs, lane=TAMPERED):
    """A response with one bit of one limb of one lane flipped (stays < l)."""
    out = limbs.clone() if isinstance(limbs, torch.Tensor) else np.array(limbs)
    out[3, lane] ^= 1
    return out if isinstance(limbs, torch.Tensor) else jnp.asarray(out)


ONLY_TAMPERED = [i != TAMPERED for i in range(N)]
M_IS_ITS_SQUARE = [True, True, False, False, False]  # the only lanes that may pass


@lru_cache(maxsize=None)
def existing_commitments():
    """B^m H^r1 for the existing= forms, the same points for both packages."""
    p = tpedersen.pedersen_commit(M_T, R1_T)
    return p, jpoint(convert.point_to_numpy(p))


# -- RandProof ------------------------------------------------------------------


@lru_cache(maxsize=None)
def rand_proofs(existing: bool):
    ex_t, ex_j = existing_commitments() if existing else (None, None)
    t = tsigma.rand_proof_prove(M_T, R1_T, np.random.default_rng(SEED), existing=ex_t)
    j = jsigma.rand_proof_prove(M_J, R1_J, np.random.default_rng(SEED), existing=ex_j)
    return t, j


@pytest.mark.parametrize("existing", [False, True], ids=["fresh", "existing"])
def test_rand_proof_bytes_identical(existing):
    (t_proof, t_c), (j_proof, j_c) = rand_proofs(existing)
    blob = tsv.serialize_rand_proof_vec(t_proof)
    assert blob == jsv.serialize_rand_proof_vec(j_proof) and len(blob) == 8 + 136 * N
    assert tsv.serialize_eg_pair_vec(t_c) == jsv.serialize_eg_pair_vec(j_c)
    if existing:
        assert t_c.L is existing_commitments()[0]
        assert tsv.serialize_eg_pair_vec(t_c) == tsv.serialize_eg_pair_vec(rand_proofs(False)[0][1])
        assert blob == tsv.serialize_rand_proof_vec(rand_proofs(False)[0][0])


def test_rand_proof_of_the_port_verifies_in_jax():
    (t_proof, t_c), _ = rand_proofs(False)
    ok = jsigma.rand_proof_verify(rand_proof_to_jax(t_proof), jpair(convert.pair_to_numpy(t_c)))
    assert np.asarray(ok).tolist() == [True] * N


def test_rand_proof_of_jax_verifies_in_the_port():
    _, (j_proof, j_c) = rand_proofs(True)
    ok = tsigma.rand_proof_verify(
        rand_proof_to_torch(j_proof), convert.pair_from_numpy(*npair(j_c), device="cpu"))
    assert ok.dtype == torch.bool and ok.tolist() == [True] * N


def test_tampered_rand_proof_refused_by_both():
    (t_proof, t_c), (j_proof, j_c) = rand_proofs(False)
    bad_t = tsigma.RandProofVec(t_proof.c_prime, flip(t_proof.z_m), t_proof.z_r)
    assert tsigma.rand_proof_verify(bad_t, t_c).tolist() == ONLY_TAMPERED
    bad_j = jsigma.RandProofVec(j_proof.c_prime, j_proof.z_m, flip(np.asarray(j_proof.z_r)))
    assert np.asarray(jsigma.rand_proof_verify(bad_j, j_c)).tolist() == ONLY_TAMPERED
    # commitments with another blinding: every lane fails
    other = tpedersen.elgamal_commit(M_T, R2_T)
    assert not tsigma.rand_proof_verify(t_proof, other).any()


# -- SquareRandProof ------------------------------------------------------------


@lru_cache(maxsize=None)
def square_rand_proofs(existing: bool):
    ex_t, ex_j = existing_commitments() if existing else (None, None)
    t = tsigma.square_rand_proof_prove(M_T, R1_T, R2_T, np.random.default_rng(SEED),
                                       existing=ex_t)
    j = jsigma.square_rand_proof_prove(M_J, R1_J, R2_J, np.random.default_rng(SEED),
                                       existing=ex_j)
    return t, j


@pytest.mark.parametrize("existing", [False, True], ids=["fresh", "existing"])
def test_square_rand_proof_bytes_identical(existing):
    (t_proof, t_c), (j_proof, j_c) = square_rand_proofs(existing)
    blob = tsv.serialize_square_rand_proof_vec(t_proof)
    assert blob == jsv.serialize_square_rand_proof_vec(j_proof) and len(blob) == 8 + 200 * N
    commits = tsv.serialize_squaretriple_vec(t_c)
    assert commits == jsv.serialize_squaretriple_vec(j_c) and len(commits) == 8 + 104 * N


def test_square_rand_proof_of_the_port_verifies_in_jax():
    (t_proof, t_c), _ = square_rand_proofs(True)
    ok = jsigma.square_rand_proof_verify(square_rand_proof_to_jax(t_proof),
                                         square_rand_commit_to_jax(t_c))
    assert np.asarray(ok).tolist() == [True] * N


def test_square_rand_proof_of_jax_verifies_in_the_port():
    _, (j_proof, j_c) = square_rand_proofs(False)
    ok = tsigma.square_rand_proof_verify(square_rand_proof_to_torch(j_proof),
                                         square_rand_commit_to_torch(j_c))
    assert ok.tolist() == [True] * N


def test_tampered_square_rand_proof_refused_by_both():
    (t_proof, t_c), (j_proof, j_c) = square_rand_proofs(False)
    bad_t = tsigma.SquareRandProofVec(t_proof.c_prime, t_proof.c_sq_prime, t_proof.z_m,
                                      t_proof.z_r1, flip(t_proof.z_r2))
    assert tsigma.square_rand_proof_verify(bad_t, t_c).tolist() == ONLY_TAMPERED
    # a square commitment to m in place of m^2 passes only where m^2 == m
    wrong_t = tsigma.SquareRandCommitVec(t_c.c, tpedersen.pedersen_commit(M_T, R2_T))
    assert tsigma.square_rand_proof_verify(t_proof, wrong_t).tolist() == M_IS_ITS_SQUARE
    wrong_j = jsigma.SquareRandCommitVec(j_c.c, jpedersen.pedersen_commit(M_J, R2_J))
    assert np.asarray(jsigma.square_rand_proof_verify(j_proof, wrong_j)).tolist() == M_IS_ITS_SQUARE


# -- SquareProof ----------------------------------------------------------------


@lru_cache(maxsize=None)
def square_proofs(existing: bool):
    ex_t, ex_j = existing_commitments() if existing else (None, None)
    t = tsigma.square_proof_prove(M_T, R1_T, R2_T, np.random.default_rng(SEED), existing=ex_t)
    j = jsigma.square_proof_prove(M_J, R1_J, R2_J, np.random.default_rng(SEED), existing=ex_j)
    return t, j


@pytest.mark.parametrize("existing", [False, True], ids=["fresh", "existing"])
def test_square_proof_bytes_identical(existing):
    (t_proof, t_c), (j_proof, j_c) = square_proofs(existing)
    blob = tsv.serialize_square_proof_vec(t_proof)
    assert blob == jsv.serialize_square_proof_vec(j_proof) and len(blob) == 8 + 168 * N
    assert tsv.serialize_rp_vec(t_c.c_l) == jsv.serialize_rp_vec(j_c.c_l)
    assert tsv.serialize_rp_vec(t_c.c_sq) == jsv.serialize_rp_vec(j_c.c_sq)
    # existing= takes the same commitments, so the whole proof is the same
    assert blob == tsv.serialize_square_proof_vec(square_proofs(not existing)[0][0])


def test_square_proof_of_the_port_verifies_in_jax():
    (t_proof, t_c), _ = square_proofs(False)
    ok = jsigma.square_proof_verify(square_proof_to_jax(t_proof), square_commit_to_jax(t_c))
    assert np.asarray(ok).tolist() == [True] * N


def test_square_proof_of_jax_verifies_in_the_port():
    _, (j_proof, j_c) = square_proofs(True)
    ok = tsigma.square_proof_verify(square_proof_to_torch(j_proof), square_commit_to_torch(j_c))
    assert ok.tolist() == [True] * N


def test_tampered_square_proof_refused_by_both():
    (t_proof, t_c), (j_proof, j_c) = square_proofs(False)
    bad_t = tsigma.SquareProofVec(t_proof.c_l_prime, t_proof.c_sq_prime, flip(t_proof.z_m),
                                  t_proof.z_r1, t_proof.z_r2)
    assert tsigma.square_proof_verify(bad_t, t_c).tolist() == ONLY_TAMPERED
    wrong_j = jsigma.SquareCommitVec(j_c.c_l, jpedersen.pedersen_commit(M_J, R2_J))
    assert np.asarray(jsigma.square_proof_verify(j_proof, wrong_j)).tolist() == M_IS_ITS_SQUARE


def test_a_transcript_label_binds_the_proof():
    (t_proof, t_c), _ = rand_proofs(False)
    assert not tsigma.rand_proof_verify(t_proof, t_c, transcript_label=b"Other").any()


# -- through the bindings ---------------------------------------------------------

FP = FpConfig(16, 7)
VALUES = np.array([0.25, -1.5, 12.5, 0.0, 1 / 128], np.float32)
B1 = tsv.serialize_scalar_vec(R1_NP)
B2 = tsv.serialize_scalar_vec(R2_NP)


def flip_byte(blob, width, lane, offset):
    out = bytearray(blob)
    out[8 + (8 + width) * lane + 8 + offset] ^= 1
    return bytes(out)


def test_randproof_bindings_give_the_blobs_of_the_jax_bindings():
    proof, pairs = TB.create_randproof(VALUES, B1, FP, np.random.default_rng(SEED), device="cpu")
    assert (proof, pairs) == JB.create_randproof(VALUES, B1, rng=np.random.default_rng(SEED))
    left, right = TB.split_elgamal_pair_vector(pairs, device="cpu")
    assert TB.verify_randproof(left, right, proof, device="cpu") is True
    assert JB.verify_randproof(left, right, proof) is True
    bad = flip_byte(proof, 128, TAMPERED, 64 + 6)
    assert TB.verify_randproof(left, right, bad, device="cpu") is False
    assert JB.verify_randproof(left, right, bad) is False
    assert TB.verify_randproof(right, left, proof, device="cpu") is False


def test_squarerandproof_bindings_give_the_blobs_of_the_jax_bindings():
    proof, commits = TB.create_squarerandproof(VALUES, B1, B2, FP, np.random.default_rng(SEED),
                                               device="cpu")
    assert (proof, commits) == JB.create_squarerandproof(
        VALUES, B1, B2, rng=np.random.default_rng(SEED))
    assert TB.verify_squarerandproof(commits, proof, device="cpu") is True
    assert JB.verify_squarerandproof(commits, proof) is True
    bad = flip_byte(proof, 192, TAMPERED, 96 + 32 + 6)  # z_r1
    assert TB.verify_squarerandproof(commits, bad, device="cpu") is False
    assert JB.verify_squarerandproof(commits, bad) is False
