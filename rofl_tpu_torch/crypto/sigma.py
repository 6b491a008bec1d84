"""Batched Σ-protocols: RandProof, SquareRandProof, SquareProof.

Counterpart of ``rofl_tpu.crypto.sigma`` (which rebuilds rofl_crypto's
per-element Schnorr-style proofs rand_proof/, square_rand_proof/,
square_proof/): the reference maps a prover over the parameters, each with a
fresh Merlin transcript; here the whole parameter vector is proved or
verified as one batch. Commitments go through the fixed-base tables
(``point_add`` launches), the prime square commitment and every verifier
equation through the ``scalar_mul`` kernel, challenges through the batched
transcript (``compress``, plain-torch Keccak, ``sc_reduce_wide``), responses
through ``sc_mul`` / ``sc_add`` / ``sc_sub``. Bit-exact per element with the
reference given the same inputs and blindings.

Every function takes limb tensors and works on their device. The primes are
drawn from the caller's rng in the order m', r1', r2' before anything else.
With tensors on the CPU the host sampler consumes the rng exactly as the JAX
package does off the TPU, so the same seed gives the same proof bytes; on
the card the keyed XOF sampler gives other proofs, which verify the same.

Spans (``utils/profiling.py``): ``sigma_prove`` and ``sigma_verify`` on the
entry points, ``sigma.transcript`` on ``challenges``. The per-lane verifiers
return a mask that their caller reads, so their span holds the launches and
not the wait.

Transcript schedules (must match exactly):
  RandProof       (rand_proof/mod.rs:64-85, dealer.rs:15-56):
    dom-sep "randomness proof v1"; "C"(64B eg); "C_prime"(64B eg);
    challenge "c"; "Z_m"; "Z_r".
  SquareRandProof (square_rand_proof/mod.rs:78-115, constants.rs):
    dom-sep; "C_eg"(64B); "C_ped"(32B); "C_prime_eg"; "C_prime_ped";
    challenge "c"; "Z_m"; "ZR_1"; "ZR_2".
  SquareProof     (square_proof/mod.rs:77-113): same labels but c_l is a
    single Pedersen point (32B).

Response equations (party.rs in each module):
  z_m = m' + m·c;  z_r1 = r1' + r1·c;  z_r2 = r2' + (r2 − m·r1)·c.

The randomised batch verifier of the square-rand proofs
(``square_rand_proof_verify_batched``) checks one random linear combination
of every lane's equations: one 6N-term multi-scalar multiplication (the MSM
kernel on the card) and two fixed-base products.

Mesh routing (the JAX package's ``_lane_args`` / ``_maybe_slice``): the
provers and per-lane verifiers take ``mesh=None``. Every operation of their
cores is elementwise over the lanes (per-lane transcripts, fixed-base
products, ladders, responses), so with a mesh the core runs once per 'param'
shard on that shard's device (``parallel.mesh.lane_map``: the lanes padded
with identity points and zero scalars to a multiple of the axis, the outputs
joined on the mesh's first device and cut back), with no collective. The
primes are drawn for the true n lanes before any padding or split: on the
card each lane's bytes come from a keyed XOF by lane index, so a draw per
shard would change every proof. The proofs are those of the unsharded call,
byte for byte. The batched square-rand verifier has no mesh argument, as in
the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve, fe, msm, sc
from ..ops.curve import PointArray
from ..parallel import mesh as pmesh
from ..utils.profiling import span
from . import pedersen
from .batch_transcript import BatchTranscript, field_byte_cols
from .pedersen import ElGamalPairArray

DOMAIN_SEP = (b"dom-sep", b"randomness proof v1")


def point_byte_cols(p: PointArray) -> torch.Tensor:
    """A point batch → the (32, N) byte columns of its encodings."""
    return field_byte_cols(curve.compress(p))


def eg_byte_cols(pair: ElGamalPairArray) -> torch.Tensor:
    return torch.cat([point_byte_cols(pair.L), point_byte_cols(pair.R)], dim=0)


@span("sigma.transcript")
def challenges(label: bytes, messages: list) -> torch.Tensor:
    """The Fiat-Shamir challenge of every lane: a fresh transcript `label`,
    the domain separator, the (message label, (L, N) byte columns) pairs in
    order, then the challenge scalar "c" → (16, N)."""
    cols = messages[0][1]
    t = BatchTranscript(label, cols.shape[1], cols.device)
    t.append_message(*DOMAIN_SEP)
    for message_label, message in messages:
        t.append_message(message_label, message)
    return t.challenge_scalars(b"c")


# -- RandProof ---------------------------------------------------------------


@dataclass
class RandProofVec:
    c_prime: ElGamalPairArray
    z_m: torch.Tensor  # (16, N)
    z_r: torch.Tensor  # (16, N)


def _on_lanes(mesh, core, *args):
    """core(*args) over all lanes, or over the 'param' shards of `mesh`."""
    return core(*args) if mesh is None else pmesh.lane_map(mesh, core, *args)


def _rand_challenges(label: bytes, c: ElGamalPairArray, c_prime: ElGamalPairArray):
    return challenges(label, [(b"C", eg_byte_cols(c)), (b"C_prime", eg_byte_cols(c_prime))])


def _rand_prove_core(label: bytes, m, r, m_prime, r_prime, existing):
    if existing is not None:
        c = pedersen.elgamal_complete_existing(existing, r)
    else:
        c = pedersen.elgamal_commit(m, r)
    c_prime = pedersen.elgamal_commit(m_prime, r_prime)
    challenge = _rand_challenges(label, c, c_prime)
    z_m = sc.add(m_prime, sc.mul(m, challenge))
    z_r = sc.add(r_prime, sc.mul(r, challenge))
    return c, c_prime, z_m, z_r


@span("sigma_prove")
def rand_proof_prove(
    m: torch.Tensor,
    r: torch.Tensor,
    rng: np.random.Generator,
    existing: PointArray | None = None,
    transcript_label: bytes = b"RandProof",
    mesh=None,
) -> tuple[RandProofVec, ElGamalPairArray]:
    """create_randproof_vec(_existing) (rand_proof_vec/mod.rs:19-76). With
    `existing`, those points are taken as the Pedersen commitments C.L."""
    n, device = m.shape[1], m.device
    m_prime = pedersen.rnd_scalar_tensor(n, rng, device)
    r_prime = pedersen.rnd_scalar_tensor(n, rng, device)
    c, c_prime, z_m, z_r = _on_lanes(
        mesh, lambda *a: _rand_prove_core(transcript_label, *a), m, r, m_prime, r_prime,
        existing)
    return RandProofVec(c_prime, z_m, z_r), c


def _scalar_muls(pairs: list) -> list:
    """k·P for every (P, k) pair of equal lane counts: the pairs are laid
    side by side, so the ladders of one verifier run as one launch of the
    ``scalar_mul`` kernel."""
    n = pairs[0][0].x.shape[1]
    points = PointArray(*[torch.cat(cs, dim=1) for cs in zip(*[p for p, _ in pairs])])
    out = curve.scalar_mul(points, torch.cat([k for _, k in pairs], dim=1))
    return [PointArray(*[c[:, i * n:(i + 1) * n] for c in out]) for i in range(len(pairs))]


def _elgamal_relation(c_prime: ElGamalPairArray, z_m, z_r, c_times_l: PointArray,
                      c_times_r: PointArray) -> torch.Tensor:
    """B^z_m · H^z_r == C'.L + c·C.L  and  B^z_r == C'.R + c·C.R, per lane."""
    lhs = pedersen.elgamal_commit(z_m, z_r)
    return (curve.eq(lhs.L, curve.add(c_prime.L, c_times_l))
            & curve.eq(lhs.R, curve.add(c_prime.R, c_times_r)))


def _rand_verify_core(label: bytes, c, c_prime, z_m, z_r) -> torch.Tensor:
    challenge = _rand_challenges(label, c, c_prime)
    c_times_l, c_times_r = _scalar_muls([(c.L, challenge), (c.R, challenge)])
    return _elgamal_relation(c_prime, z_m, z_r, c_times_l, c_times_r)


@span("sigma_verify")
def rand_proof_verify(
    proof: RandProofVec,
    c: ElGamalPairArray,
    transcript_label: bytes = b"RandProof",
    mesh=None,
) -> torch.Tensor:
    """Batched verify (rand_proof/mod.rs:64-85) → bool mask (N,)."""
    return _on_lanes(mesh, lambda *a: _rand_verify_core(transcript_label, *a), c,
                     proof.c_prime, proof.z_m, proof.z_r)


# -- SquareRandProof ---------------------------------------------------------


@dataclass
class SquareRandProofVec:
    c_prime: ElGamalPairArray  # prime EG pair
    c_sq_prime: PointArray     # prime Pedersen point (base = C.L)
    z_m: torch.Tensor
    z_r1: torch.Tensor
    z_r2: torch.Tensor


@dataclass
class SquareRandCommitVec:
    """SquareRandProofCommitments batch: EG pair + square Pedersen point."""

    c: ElGamalPairArray
    c_sq: PointArray


def _square_rand_challenges(label: bytes, c: SquareRandCommitVec, c_prime: ElGamalPairArray,
                            c_sq_prime: PointArray) -> torch.Tensor:
    return challenges(label, [
        (b"C_eg", eg_byte_cols(c.c)),
        (b"C_ped", point_byte_cols(c.c_sq)),
        (b"C_prime_eg", eg_byte_cols(c_prime)),
        (b"C_prime_ped", point_byte_cols(c_sq_prime)),
    ])


def _square_responses(m, r1, r2, m_prime, r1_prime, r2_prime, challenge):
    z_m = sc.add(m_prime, sc.mul(m, challenge))
    z_r1 = sc.add(r1_prime, sc.mul(r1, challenge))
    z_r2 = sc.add(r2_prime, sc.mul(sc.sub(r2, sc.mul(m, r1)), challenge))
    return z_m, z_r1, z_r2


def _square_relation(c_sq_prime: PointArray, z_r2, z_m_times_l: PointArray,
                     c_times_sq: PointArray) -> torch.Tensor:
    """C.L^z_m · H^z_r2 == C'_sq + c·C_sq, per lane."""
    return curve.eq(curve.add(z_m_times_l, pedersen.base_H().mul(z_r2)),
                    curve.add(c_sq_prime, c_times_sq))


def _square_rand_prove_core(label: bytes, m, r1, r2, m_prime, r1_prime, r2_prime, existing):
    if existing is not None:
        c_eg = pedersen.elgamal_complete_existing(existing, r1)
    else:
        c_eg = pedersen.elgamal_commit(m, r1)
    # scalar-field square (party.rs:38)
    c = SquareRandCommitVec(c_eg, pedersen.pedersen_commit(sc.mul(m, m), r2))
    c_prime = pedersen.elgamal_commit(m_prime, r1_prime)
    # the prime square commitment uses C.L as base: C.L^m' · H^r2'
    c_sq_prime = curve.add(curve.scalar_mul(c_eg.L, m_prime), pedersen.base_H().mul(r2_prime))
    challenge = _square_rand_challenges(label, c, c_prime, c_sq_prime)
    z_m, z_r1, z_r2 = _square_responses(m, r1, r2, m_prime, r1_prime, r2_prime, challenge)
    return c.c, c.c_sq, c_prime, c_sq_prime, z_m, z_r1, z_r2


@span("sigma_prove")
def square_rand_proof_prove(
    m: torch.Tensor,
    r1: torch.Tensor,
    r2: torch.Tensor,
    rng: np.random.Generator,
    existing: PointArray | None = None,
    transcript_label: bytes = b"SquareRandProof",
    mesh=None,
) -> tuple[SquareRandProofVec, SquareRandCommitVec]:
    """Batched SquareRandProof::prove(_existing)
    (square_rand_proof/party.rs:17-135)."""
    n, device = m.shape[1], m.device
    m_prime = pedersen.rnd_scalar_tensor(n, rng, device)
    r1_prime = pedersen.rnd_scalar_tensor(n, rng, device)
    r2_prime = pedersen.rnd_scalar_tensor(n, rng, device)
    c_eg, c_sq, c_prime, c_sq_prime, z_m, z_r1, z_r2 = _on_lanes(
        mesh, lambda *a: _square_rand_prove_core(transcript_label, *a), m, r1, r2, m_prime,
        r1_prime, r2_prime, existing)
    return (SquareRandProofVec(c_prime, c_sq_prime, z_m, z_r1, z_r2),
            SquareRandCommitVec(c_eg, c_sq))


def _square_rand_verify_core(label: bytes, c_eg, c_sq, c_prime, c_sq_prime, z_m, z_r1,
                             z_r2) -> torch.Tensor:
    c = SquareRandCommitVec(c_eg, c_sq)
    challenge = _square_rand_challenges(label, c, c_prime, c_sq_prime)
    c_times_l, c_times_r, c_times_sq, z_m_times_l = _scalar_muls([
        (c_eg.L, challenge), (c_eg.R, challenge), (c_sq, challenge), (c_eg.L, z_m)])
    ok_eg = _elgamal_relation(c_prime, z_m, z_r1, c_times_l, c_times_r)
    return ok_eg & _square_relation(c_sq_prime, z_r2, z_m_times_l, c_times_sq)


@span("sigma_verify")
def square_rand_proof_verify(
    proof: SquareRandProofVec,
    c: SquareRandCommitVec,
    transcript_label: bytes = b"SquareRandProof",
    mesh=None,
) -> torch.Tensor:
    """Batched per-lane verify (square_rand_proof/mod.rs:78-115) → bool mask."""
    return _on_lanes(mesh, lambda *a: _square_rand_verify_core(transcript_label, *a), c.c,
                     c.c_sq, proof.c_prime, proof.c_sq_prime, proof.z_m, proof.z_r1,
                     proof.z_r2)


def square_rand_batch_terms(label: bytes, proof: SquareRandProofVec, c: SquareRandCommitVec,
                            rho: torch.Tensor):
    """The randomised batch verification's operands for weights rho
    (16, 3N): the 6N-term MSM's points and scalars, and the B and H
    coefficients (16, 1) of its two fixed-base products."""
    challenge = _square_rand_challenges(label, c, proof.c_prime, proof.c_sq_prime)
    n = proof.z_m.shape[1]
    r1, r2, r3 = rho[:, :n], rho[:, n:2 * n], rho[:, 2 * n:]
    # E1: z_m·B + z_r1·H − C' − c·C = 0         (ElGamal L row)
    # E2: z_r1·B − C'_R − c·C_R = 0             (ElGamal R row)
    # E3: z_m·C_L + z_r2·H − C'_sq − c·C_sq = 0 (Pedersen square row)
    sB = sc.sum_reduce(sc.add(sc.mul(r1, proof.z_m), sc.mul(r2, proof.z_r1)))
    sH = sc.sum_reduce(sc.add(sc.mul(r1, proof.z_r1), sc.mul(r3, proof.z_r2)))
    kCL = sc.sub(sc.mul(r3, proof.z_m), sc.mul(r1, challenge))
    kCR = sc.neg(sc.mul(r2, challenge))
    kCsq = sc.neg(sc.mul(r3, challenge))
    pts = PointArray(*[torch.cat(cs, dim=1) for cs in zip(
        c.c.L, c.c.R, c.c_sq, proof.c_prime.L, proof.c_prime.R, proof.c_sq_prime)])
    scal = torch.cat([kCL, kCR, kCsq, sc.neg(r1), sc.neg(r2), sc.neg(r3)], dim=1)
    return pts, scal, sB, sH


def _square_rand_batch_verify_core(label: bytes, proof: SquareRandProofVec,
                                   c: SquareRandCommitVec, rho: torch.Tensor) -> torch.Tensor:
    """Randomised batch verification: in place of the three per-lane group
    equations (4N ladders), one random linear combination

      Σ_i ρ1ᵢ·E1ᵢ + ρ2ᵢ·E2ᵢ + ρ3ᵢ·E3ᵢ == identity

    which is one 6N-term MSM and two single-lane fixed-base products. Sound
    with error 2^-252 per weight vector (the batch-verification argument of
    dalek's verify_multiple). The Fiat-Shamir challenge c comes from the
    same batched transcript, so honest proofs are accepted exactly where the
    per-lane verifier accepts them. Returns a (1,) bool tensor."""
    pts, scal, sB, sH = square_rand_batch_terms(label, proof, c, rho)
    total = curve.add(msm.msm(pts, scal),
                      curve.add(pedersen.base_B().mul(sB), pedersen.base_H().mul(sH)))
    return curve.eq(total, curve.identity((1,), total.device))


@span("sigma_verify")
def square_rand_proof_verify_batched(
    proof: SquareRandProofVec,
    c: SquareRandCommitVec,
    rng: np.random.Generator,
    transcript_label: bytes = b"SquareRandProof",
) -> bool:
    """Verify all lanes at once (the server's fast path) → one accept /
    reject; per-lane blame needs ``square_rand_proof_verify``. Draws the 3N
    weights from `rng` first, on the proof's device."""
    n = proof.z_m.shape[1]
    rho = pedersen.rnd_scalar_tensor(3 * n, rng, proof.z_m.device)
    return fe.to_bool(_square_rand_batch_verify_core(transcript_label, proof, c, rho).all())


# -- SquareProof (Pedersen-only) --------------------------------------------


@dataclass
class SquareProofVec:
    c_l_prime: PointArray
    c_sq_prime: PointArray
    z_m: torch.Tensor
    z_r1: torch.Tensor
    z_r2: torch.Tensor


@dataclass
class SquareCommitVec:
    c_l: PointArray
    c_sq: PointArray


def _square_challenges(label: bytes, c: SquareCommitVec, c_l_prime: PointArray,
                       c_sq_prime: PointArray) -> torch.Tensor:
    return challenges(label, [
        (b"C_eg", point_byte_cols(c.c_l)),
        (b"C_ped", point_byte_cols(c.c_sq)),
        (b"C_prime_eg", point_byte_cols(c_l_prime)),
        (b"C_prime_ped", point_byte_cols(c_sq_prime)),
    ])


def _square_prove_core(label: bytes, m, r1, r2, m_prime, r1_prime, r2_prime, existing):
    c_l = existing if existing is not None else pedersen.pedersen_commit(m, r1)
    c = SquareCommitVec(c_l, pedersen.pedersen_commit(sc.mul(m, m), r2))
    c_l_prime = pedersen.pedersen_commit(m_prime, r1_prime)
    c_sq_prime = curve.add(curve.scalar_mul(c_l, m_prime), pedersen.base_H().mul(r2_prime))
    challenge = _square_challenges(label, c, c_l_prime, c_sq_prime)
    z_m, z_r1, z_r2 = _square_responses(m, r1, r2, m_prime, r1_prime, r2_prime, challenge)
    return c.c_l, c.c_sq, c_l_prime, c_sq_prime, z_m, z_r1, z_r2


@span("sigma_prove")
def square_proof_prove(
    m: torch.Tensor,
    r1: torch.Tensor,
    r2: torch.Tensor,
    rng: np.random.Generator,
    existing: PointArray | None = None,
    transcript_label: bytes = b"SquareProof",
    mesh=None,
) -> tuple[SquareProofVec, SquareCommitVec]:
    """Batched SquareProof::prove(_existing) (square_proof/party.rs)."""
    n, device = m.shape[1], m.device
    m_prime = pedersen.rnd_scalar_tensor(n, rng, device)
    r1_prime = pedersen.rnd_scalar_tensor(n, rng, device)
    r2_prime = pedersen.rnd_scalar_tensor(n, rng, device)
    c_l, c_sq, c_l_prime, c_sq_prime, z_m, z_r1, z_r2 = _on_lanes(
        mesh, lambda *a: _square_prove_core(transcript_label, *a), m, r1, r2, m_prime,
        r1_prime, r2_prime, existing)
    return SquareProofVec(c_l_prime, c_sq_prime, z_m, z_r1, z_r2), SquareCommitVec(c_l, c_sq)


def _square_verify_core(label: bytes, c_l, c_sq, c_l_prime, c_sq_prime, z_m, z_r1,
                        z_r2) -> torch.Tensor:
    challenge = _square_challenges(label, SquareCommitVec(c_l, c_sq), c_l_prime, c_sq_prime)
    c_times_l, c_times_sq, z_m_times_l = _scalar_muls([
        (c_l, challenge), (c_sq, challenge), (c_l, z_m)])
    lhs = pedersen.pedersen_commit(z_m, z_r1)
    return curve.eq(lhs, curve.add(c_l_prime, c_times_l)) & _square_relation(
        c_sq_prime, z_r2, z_m_times_l, c_times_sq)


@span("sigma_verify")
def square_proof_verify(
    proof: SquareProofVec,
    c: SquareCommitVec,
    transcript_label: bytes = b"SquareProof",
    mesh=None,
) -> torch.Tensor:
    """Batched per-lane verify (square_proof/mod.rs:77-113) → bool mask."""
    return _on_lanes(mesh, lambda *a: _square_verify_core(transcript_label, *a), c.c_l,
                     c.c_sq, proof.c_l_prime, proof.c_sq_prime, proof.z_m, proof.z_r1,
                     proof.z_r2)
