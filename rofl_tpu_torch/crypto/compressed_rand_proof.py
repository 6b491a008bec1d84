"""CompressedRandProof: one constant-size randomness proof for a whole
vector of ElGamal commitments.

Counterpart of ``rofl_tpu.crypto.compressed_rand_proof`` (which replaces
rofl_crypto/src/compressed_rand_proof/). The N per-element ElGamal
well-formedness proofs compress into one Σ-protocol by a random linear
combination with the challenge powers c^(i+1):

  z_m = m' + Σ m_i·c^(i+1);  z_r = r' + Σ r_i·c^(i+1)
  check: EG(z_m, z_r) == C' + Σ C_i·c^(i+1)

Transcript (dealer.rs:19-35, verify mod.rs:77-103): dom-sep "randomness
proof v1"; each C_i (its 64-byte L ‖ R encoding) under a 3-byte label of
its own, the little-endian index (``index_label``, the JAX package's
canonical label scheme); "C_prime_eg"; challenge "c"; "Z_m"; "ZR". The d
commitments go into the host transcript in one call of the native helper
(``Transcript.append_labeled_messages``), bit-identical to d
``append_message`` calls.

Device work, on the device of the commitments: the commitments (fixed-base
tables, ``point_add``), ``compress`` for the transcript, the challenge
powers and the inner products (``sc_mul``, ``sc_add``), the verifier's two
d-term sums Σ C_i·c^(i+1) (``msm.msm``: the ``msm_flat`` kernel), and the
decompression of C'.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import curve, fe, msm, sc
from ..ops.curve import PointArray
from ..spec import scalar as SS
from ..spec.merlin import Transcript
from . import pedersen
from .pedersen import ElGamalPairArray

LABEL_PRIME = b"C_prime_eg"
LABEL_Z_M = b"Z_m"
LABEL_Z_R = b"ZR"
LABEL_CHALLENGE = b"c"
DOMAIN_SEP = (b"dom-sep", b"randomness proof v1")
TRANSCRIPT_LABEL = b"CompressedRandProof"


def index_label(i: int) -> bytes:
    """The 3-byte transcript label of commitment i: its index, little-endian."""
    return bytes([i & 0xFF, (i >> 8) & 0xFF, (i >> 16) & 0xFF])


def index_labels(n: int) -> bytes:
    """``index_label(0) + ... + index_label(n - 1)``."""
    i = np.arange(n, dtype=np.uint32)
    return np.stack([i & 0xFF, (i >> 8) & 0xFF, (i >> 16) & 0xFF], axis=1).astype(
        np.uint8).tobytes()


@dataclass
class CompressedRandProof:
    c_prime_L: bytes
    c_prime_R: bytes
    z_m: int
    z_r: int

    def to_bytes(self) -> bytes:
        return self.c_prime_L + self.c_prime_R + SS.to_bytes(self.z_m) + SS.to_bytes(self.z_r)

    @classmethod
    def from_bytes(cls, data: bytes) -> "CompressedRandProof":
        if len(data) != 128:
            raise ValueError("CompressedRandProof must be 128 bytes")
        z_m = SS.from_canonical_bytes(data[64:96])
        z_r = SS.from_canonical_bytes(data[96:128])
        if z_m is None or z_r is None:
            raise ValueError("non-canonical scalars")
        return cls(bytes(data[:32]), bytes(data[32:64]), z_m, z_r)


def _absorb_commitments(t: Transcript, c: ElGamalPairArray) -> None:
    """The domain separator, then each commitment's L ‖ R under its index label."""
    rows = np.concatenate([curve.compress_to_bytes(c.L), curve.compress_to_bytes(c.R)], axis=1)
    t.append_message(*DOMAIN_SEP)
    t.append_labeled_messages(index_labels(rows.shape[0]), 3, rows.tobytes(), 64)


def _challenge_powers(challenge: int, n: int, device) -> torch.Tensor:
    """c^1 ... c^n as (16, n) limbs."""
    c = fe.to_tensor(sc.pack_scalars([challenge]), device)
    return sc.powers(c, n + 1)[:, 1:].contiguous()


def _scalar_int(limbs: torch.Tensor) -> int:
    return fe.unpack_scalars(limbs)[0]


def prove(
    transcript: Transcript,
    m: torch.Tensor,
    r: torch.Tensor,
    rng: np.random.Generator,
    existing: PointArray | None = None,
) -> tuple[CompressedRandProof, ElGamalPairArray]:
    """CompressedRandProof::prove(_existing) (mod.rs:42-75, party.rs). m, r:
    (16, d) limbs on one device; with `existing`, those points are taken as
    the Pedersen commitments C.L. m' and r' are drawn from `rng` after the
    commitments, as the JAX package draws them."""
    n, device = m.shape[1], m.device
    if existing is None:
        c = pedersen.elgamal_commit(m, r)
    else:
        c = pedersen.elgamal_complete_existing(existing, r)
    m_prime = pedersen.rnd_scalar_tensor(1, rng, device)
    r_prime = pedersen.rnd_scalar_tensor(1, rng, device)
    c_prime = pedersen.elgamal_commit(m_prime, r_prime)
    cp_l = curve.compress_to_bytes(c_prime.L)[0].tobytes()
    cp_r = curve.compress_to_bytes(c_prime.R)[0].tobytes()

    _absorb_commitments(transcript, c)
    transcript.append_message(LABEL_PRIME, cp_l + cp_r)
    pows = _challenge_powers(transcript.challenge_scalar(LABEL_CHALLENGE), n, device)
    z_m = _scalar_int(sc.add(m_prime, sc.inner_product(m, pows)))
    z_r = _scalar_int(sc.add(r_prime, sc.inner_product(r, pows)))
    transcript.append_message(LABEL_Z_M, SS.to_bytes(z_m))
    transcript.append_message(LABEL_Z_R, SS.to_bytes(z_r))
    return CompressedRandProof(cp_l, cp_r, z_m, z_r), c


def verify(transcript: Transcript, proof: CompressedRandProof, c: ElGamalPairArray) -> bool:
    """CompressedRandProof::verify (mod.rs:77-103) on the device of the
    commitments. C' is decoded as the JAX package decodes it (top bit
    masked, on-curve checks, no canonicity check of the bytes); an encoding
    that is no point refuses the proof."""
    n, device = c.L.x.shape[1], c.L.device
    _absorb_commitments(transcript, c)
    transcript.append_message(LABEL_PRIME, proof.c_prime_L + proof.c_prime_R)
    challenge = transcript.challenge_scalar(LABEL_CHALLENGE)
    transcript.append_message(LABEL_Z_M, SS.to_bytes(proof.z_m))
    transcript.append_message(LABEL_Z_R, SS.to_bytes(proof.z_r))

    pows = _challenge_powers(challenge, n, device)
    lhs = pedersen.elgamal_commit(fe.to_tensor(sc.pack_scalars([proof.z_m]), device),
                                  fe.to_tensor(sc.pack_scalars([proof.z_r]), device))
    cp_enc = np.frombuffer(proof.c_prime_L + proof.c_prime_R, np.uint8).reshape(2, 32)
    cp, valid = curve.decompress(fe.to_tensor(fe.from_bytes_array(cp_enc), device))
    if not fe.to_bool(valid.all()):
        return False
    rhs_l = curve.add(PointArray(*[x[:, :1] for x in cp]), msm.msm(c.L, pows))
    rhs_r = curve.add(PointArray(*[x[:, 1:2] for x in cp]), msm.msm(c.R, pows))
    return fe.to_bool(curve.eq(lhs.L, rhs_l)[0]) and fe.to_bool(curve.eq(lhs.R, rhs_r)[0])
