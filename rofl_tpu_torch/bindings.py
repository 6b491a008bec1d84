"""FFI-parity API, aggregation and Σ-proof sections: the reference's C
bindings for the secure-aggregation round and the rand / square-rand proofs
as one flat Python module.

Counterpart of ``rofl_tpu.bindings``: the same functions taking and returning
the identical bincode wire formats (see crypto/serde_vec.py), so a caller
can switch between the two packages blob for blob. The range-proof and L2
bindings follow with the range proofs. Heavy math runs on `device` (default
the card): points are decoded, added, multiplied, committed and encoded and
scalars multiplied and summed by the CUDA kernels.

Error-returning functions (the PyRes family) raise ValueError with the
reference's error message semantics instead of returning {ret,msg} structs.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto import pedersen, sigma
from .crypto import serde_vec as sv
from .crypto.fp_codec import FpConfig
from .ops import bsgs, curve, fe, sc
from .ops.curve import PointArray

DEFAULT_FP = FpConfig(16, 7)


def say_hello() -> bytes:
    """bindings32.rs:43-58: returns serialize_scalar_vec([x]) smoke blob."""
    return sv.serialize_scalar_vec(sc.pack_scalars([42]))


# -- aggregation --------------------------------------------------------------


def add_commitments(commitment_blobs: list[bytes], device="cuda") -> bytes:
    """Elementwise sum of n Vec<RistrettoPoint> blobs (bindings32.rs:64-86)."""
    pts = [sv.deserialize_rp_vec(b, device) for b in commitment_blobs]
    acc = PointArray(*[torch.stack(cs, dim=1) for cs in zip(*pts)])
    return sv.serialize_rp_vec(curve.tree_sum(acc, axis=0))


def add_commitments_transposed(commitment_blobs: list[bytes], device="cuda") -> list[bytes]:
    """Each blob reduced to its own single-point sum (bindings32.rs:90-114)."""
    out = []
    for b in commitment_blobs:
        total = curve.tree_sum(sv.deserialize_rp_vec(b, device), axis=0)
        out.append(sv._wrap_bytes(curve.compress_to_bytes(total)[0].tobytes()))
    return out


def commit_no_blinding(values: np.ndarray, fp: FpConfig = DEFAULT_FP,
                       device="cuda") -> bytes:
    """f32 → Vec<RistrettoPoint> of unblinded commits (bindings32.rs:118-128)."""
    m = fe.to_tensor(fp.f32_to_scalar_limbs(np.asarray(values, np.float32)), device)
    return sv.serialize_rp_vec(pedersen.pedersen_commit_no_blinding(m))


def commit(values: np.ndarray, blinding_blob: bytes, fp: FpConfig = DEFAULT_FP,
           device="cuda") -> bytes:
    """f32 + Vec<Scalar> blindings → Pedersen commits (bindings32.rs:130-151)."""
    m = fe.to_tensor(fp.f32_to_scalar_limbs(np.asarray(values, np.float32)), device)
    r = fe.to_tensor(sv.deserialize_scalar_vec(blinding_blob), device)
    return sv.serialize_rp_vec(pedersen.pedersen_commit(m, r))


def generate_cancelling_blindings(n_vec: int, n_dim: int,
                                  rng: np.random.Generator | None = None,
                                  device="cuda") -> list[bytes]:
    """n_vec Vec<Scalar> blobs with elementwise sum ≡ 0 (bindings32.rs:154-166)."""
    rng = rng or np.random.default_rng()
    if n_vec == 1:
        return [sv.serialize_scalar_vec(pedersen.rnd_scalar_limbs(n_dim, rng, device))]
    vecs = pedersen.cancelling_scalar_limbs(n_vec, n_dim, rng, device)
    return [sv.serialize_scalar_vec(v) for v in vecs]


def select_blindings(blinding_blob: bytes, indices) -> bytes:
    """Index-select from a Vec<Scalar> blob (bindings32.rs:169-189)."""
    limbs = sv.deserialize_scalar_vec(blinding_blob)
    return sv.serialize_scalar_vec(limbs[:, np.asarray(indices, np.int64)])


def select_commitments(commit_blob: bytes, indices, device="cuda") -> bytes:
    """Index-select from a Vec<RistrettoPoint> blob (bindings32.rs:191-211)."""
    pts = sv.deserialize_rp_vec(commit_blob, device)
    idx = torch.as_tensor(np.asarray(indices, np.int64), device=pts.device)
    return sv.serialize_rp_vec(PointArray(*[torch.index_select(c, 1, idx) for c in pts]))


def extract_values(commit_blob: bytes, fp: FpConfig = DEFAULT_FP,
                   table_size: int | None = None, device="cuda") -> np.ndarray:
    """BSGS discrete log of each commitment → f32 (bindings32.rs:213-226).

    Default table matches the reference's default_discrete_log_vec
    (bsgs32.rs:36-38): m = 2^(BSGS_N_BITS/2 + PRECOMP_BIAS).
    """
    pts = sv.deserialize_rp_vec(commit_blob, device)
    m = table_size or fp.default_bsgs_table_size
    limbs, ok = bsgs.solve_discrete_log(pts, m, fp.bsgs_n_bits)
    if not bool(ok.all()):
        raise ValueError("discrete log not found")
    return fp.scalar_limbs_to_f32(fe.to_numpy(limbs))


# -- rand proofs ---------------------------------------------------------------


def create_randproof(values: np.ndarray, blinding_blob: bytes, fp: FpConfig = DEFAULT_FP,
                     rng: np.random.Generator | None = None,
                     device="cuda") -> tuple[bytes, bytes]:
    """(Vec<RandProof>, Vec<ElGamalPair>) blobs (bindings32.rs:295-322)."""
    rng = rng or np.random.default_rng()
    m = fe.to_tensor(fp.f32_to_scalar_limbs(np.asarray(values, np.float32)), device)
    r = fe.to_tensor(sv.deserialize_scalar_vec(blinding_blob), device)
    proof, c = sigma.rand_proof_prove(m, r, rng)
    return sv.serialize_rand_proof_vec(proof), sv.serialize_eg_pair_vec(c)


def verify_randproof(ped_commit_blob: bytes, rand_commit_blob: bytes, proof_blob: bytes,
                     device="cuda") -> bool:
    """Joins (L, R) point blobs into pairs and verifies
    (bindings32.rs:324-370)."""
    pairs = pedersen.ElGamalPairArray(sv.deserialize_rp_vec(ped_commit_blob, device),
                                      sv.deserialize_rp_vec(rand_commit_blob, device))
    proof = sv.deserialize_rand_proof_vec(proof_blob, device)
    return bool(sigma.rand_proof_verify(proof, pairs).all())


def create_squarerandproof(values: np.ndarray, blinding1_blob: bytes, blinding2_blob: bytes,
                           fp: FpConfig = DEFAULT_FP,
                           rng: np.random.Generator | None = None,
                           device="cuda") -> tuple[bytes, bytes]:
    """(Vec<SquareRandProof>, Vec<SquareRandProofCommitments>)
    (bindings32.rs:373-413)."""
    rng = rng or np.random.default_rng()
    m = fe.to_tensor(fp.f32_to_scalar_limbs(np.asarray(values, np.float32)), device)
    r1 = fe.to_tensor(sv.deserialize_scalar_vec(blinding1_blob), device)
    r2 = fe.to_tensor(sv.deserialize_scalar_vec(blinding2_blob), device)
    proof, c = sigma.square_rand_proof_prove(m, r1, r2, rng)
    return sv.serialize_square_rand_proof_vec(proof), sv.serialize_squaretriple_vec(c)


def verify_squarerandproof(commit_blob: bytes, proof_blob: bytes, device="cuda") -> bool:
    """bindings32.rs:415-437 (the per-lane verifier)."""
    c = sv.deserialize_squaretriple_vec(commit_blob, device)
    proof = sv.deserialize_square_rand_proof_vec(proof_blob, device)
    return bool(sigma.square_rand_proof_verify(proof, c).all())


# -- splits / joins ------------------------------------------------------------


def split_elgamal_pair_vector(commit_blob: bytes, device="cuda") -> tuple[bytes, bytes]:
    """Vec<ElGamalPair> → (Vec<Point> L, Vec<Point> R) (bindings32.rs:555-571)."""
    pairs = sv.deserialize_eg_pair_vec(commit_blob, device)
    return sv.serialize_rp_vec(pairs.L), sv.serialize_rp_vec(pairs.R)


def join_to_elgamal_pair_vector(ped_blob: bytes, rand_blob: bytes, device="cuda") -> bytes:
    """bindings32.rs:573-596."""
    return sv.serialize_eg_pair_vec(pedersen.ElGamalPairArray(
        sv.deserialize_rp_vec(ped_blob, device), sv.deserialize_rp_vec(rand_blob, device)))


def split_squaretriple_pair_vector(commit_blob: bytes,
                                   device="cuda") -> tuple[bytes, bytes, bytes]:
    """Vec<SquareRandProofCommitments> → (L, R, c_sq) point blobs
    (bindings32.rs:598-616)."""
    c = sv.deserialize_squaretriple_vec(commit_blob, device)
    return (sv.serialize_rp_vec(c.c.L), sv.serialize_rp_vec(c.c.R),
            sv.serialize_rp_vec(c.c_sq))


def join_to_squaretriple_pair_vector(ped_blob: bytes, rand_blob: bytes, square_blob: bytes,
                                     device="cuda") -> bytes:
    """bindings32.rs:618-649."""
    pairs = pedersen.ElGamalPairArray(
        sv.deserialize_rp_vec(ped_blob, device), sv.deserialize_rp_vec(rand_blob, device))
    return sv.serialize_squaretriple_vec(
        sigma.SquareRandCommitVec(pairs, sv.deserialize_rp_vec(square_blob, device)))


# -- misc ----------------------------------------------------------------------


def commits_equal(commit_a_blob: bytes, commit_b_blob: bytes, device="cuda") -> bool:
    """bindings32.rs:675-691."""
    a = sv.deserialize_rp_vec(commit_a_blob, device)
    b = sv.deserialize_rp_vec(commit_b_blob, device)
    if a.x.shape != b.x.shape:
        return False
    return bool(curve.eq(a, b).all())


def equals_neutral_group_element_vec(commit_blob: bytes, device="cuda") -> list[bool]:
    """Per-element identity check (bindings32.rs:693-704)."""
    pts = sv.deserialize_rp_vec(commit_blob, device)
    return curve.eq(pts, curve.identity(pts.batch_shape, pts.device)).tolist()


def create_zero_scalar_vector(length: int) -> bytes:
    return sv.serialize_scalar_vec(np.zeros((sc.NLIMB, length), np.uint32))


def create_zero_group_element_vector(length: int, device="cuda") -> bytes:
    return sv.serialize_rp_vec(curve.identity((length,), device))


def create_random_blinding_vector(length: int, rng: np.random.Generator | None = None,
                                  device="cuda") -> bytes:
    rng = rng or np.random.default_rng()
    return sv.serialize_scalar_vec(pedersen.rnd_scalar_limbs(length, rng, device))


def add_scalars(scalar_blob: bytes, device="cuda") -> bytes:
    """Sum a Vec<Scalar> blob → single 40-byte Scalar blob
    (bindings32.rs:727-734): log-many ``sc_add`` launches on the card."""
    limbs = fe.to_tensor(sv.deserialize_scalar_vec(scalar_blob), device)
    return sv.serialize_scalar(sc.sum_reduce(limbs))


def filter_unequal_commits(commit_a_blob: bytes, commit_b_blob: bytes,
                           device="cuda") -> tuple[bytes, bytes]:
    """Keep (a_i, b_i) where a_i != b_i (bindings32.rs:737-764)."""
    a = sv.deserialize_rp_vec(commit_a_blob, device)
    b = sv.deserialize_rp_vec(commit_b_blob, device)
    idx = torch.nonzero(~curve.eq(a, b)).reshape(-1)
    return (sv.serialize_rp_vec(PointArray(*[torch.index_select(c, 1, idx) for c in a])),
            sv.serialize_rp_vec(PointArray(*[torch.index_select(c, 1, idx) for c in b])))
