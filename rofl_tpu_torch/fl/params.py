"""Encrypted-parameter protocol layer, the L2 mode — rebuild of
rofl_service params.rs.

Counterpart of ``rofl_tpu.fl.params``: ``CryptoConfig``, the mode tags, the
byte helpers of the L2 mode and ``EncParamsL2`` (params.rs:607-687):
square-rand Σ-proofs on the range proofs' commitments, L∞ Bulletproofs over
``n_partition`` chunks and one L2 sum proof. Serialization is byte-identical
with the reference: fixed-stride concatenations of 32-byte encodings in the
length-delimited ``EncNormData`` envelope (``fl/wire.py``).

The commitment vectors live as PointArrays on the device the caller names.
``EncParamsRange``, the compressed modes and the accumulator are not ported
yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..crypto import l2_range_proof as L2RP
from ..crypto import pedersen, sigma
from ..crypto import range_proof as RP
from ..crypto import range_proof_vec as RPV
from ..crypto import serde_vec as sv
from ..crypto.fp_codec import FpConfig
from ..crypto.pedersen import ElGamalPairArray
from ..ops import curve, fe, sc
from ..ops.curve import PointArray
from . import wire

PLAIN_TYPE = 1
ENC_RANGE_TYPE = 2
ENC_L2_TYPE = 3
ENC_RANGE_COMPRESSED_TYPE = 4
ENC_L2_COMPRESSED_TYPE = 5


@dataclass
class CryptoConfig:
    """Mirror of the CryptoConfig proto (flservice.proto:59-65) plus the
    runtime fixed-point configuration (a compile-time cargo feature in the
    reference, fp.rs)."""

    value_range: int = 8
    n_partition: int = 1
    l2_value_range: int = 16
    check_percentage: float = 1.0
    enc_type: int = PLAIN_TYPE
    fp: FpConfig = FpConfig(16, 7)


# -- byte helpers ------------------------------------------------------------


def _points_from_bytes(data: bytes, device="cuda") -> PointArray:
    return sv.decompress_rows(np.frombuffer(data, np.uint8).reshape(-1, 32), device)


def _pairs_to_bytes(pairs: ElGamalPairArray) -> bytes:
    return np.concatenate([curve.compress_to_bytes(pairs.L), curve.compress_to_bytes(pairs.R)],
                          axis=1).tobytes()


def _pairs_from_bytes(data: bytes, device="cuda") -> ElGamalPairArray:
    arr = np.frombuffer(data, np.uint8).reshape(-1, 64)
    pts = _points_from_bytes(np.concatenate([arr[:, :32], arr[:, 32:]]).tobytes(), device)
    n = arr.shape[0]
    return ElGamalPairArray(PointArray(*[c[:, :n] for c in pts]),
                            PointArray(*[c[:, n:] for c in pts]))


def _scalars_from_bytes(data: bytes, device="cuda") -> torch.Tensor:
    """32-byte little-endian scalars → (16, N) limbs on `device`, as they
    come: like the JAX package, no canonical check here."""
    a = np.frombuffer(data, np.uint8).reshape(-1, 32).astype(np.uint32)
    return fe.to_tensor((a[:, 0::2] | (a[:, 1::2] << 8)).T, device)


def _sq_rand_proofs_to_bytes(p: sigma.SquareRandProofVec) -> bytes:
    """SquareRandProof stride 192: C_prime(64+32) || Z_m || Z_r1 || Z_r2."""
    return np.concatenate([
        np.frombuffer(_pairs_to_bytes(p.c_prime), np.uint8).reshape(-1, 64),
        curve.compress_to_bytes(p.c_sq_prime),
        sc.to_bytes_array(p.z_m), sc.to_bytes_array(p.z_r1), sc.to_bytes_array(p.z_r2),
    ], axis=1).tobytes()


def _sq_rand_proofs_from_bytes(data: bytes, device="cuda") -> sigma.SquareRandProofVec:
    arr = np.frombuffer(data, np.uint8).reshape(-1, 192)
    return sigma.SquareRandProofVec(
        _pairs_from_bytes(arr[:, :64].tobytes(), device),
        _points_from_bytes(arr[:, 64:96].tobytes(), device),
        _scalars_from_bytes(arr[:, 96:128].tobytes(), device),
        _scalars_from_bytes(arr[:, 128:160].tobytes(), device),
        _scalars_from_bytes(arr[:, 160:192].tobytes(), device))


def _l2_commits_to_bytes(c: sigma.SquareRandCommitVec) -> bytes:
    """SquareRandProofCommitments stride 96: EG pair(64) || c_sq(32)."""
    return np.concatenate([np.frombuffer(_pairs_to_bytes(c.c), np.uint8).reshape(-1, 64),
                           curve.compress_to_bytes(c.c_sq)], axis=1).tobytes()


def _l2_commits_from_bytes(data: bytes, device="cuda") -> sigma.SquareRandCommitVec:
    arr = np.frombuffer(data, np.uint8).reshape(-1, 96)
    return sigma.SquareRandCommitVec(_pairs_from_bytes(arr[:, :64].tobytes(), device),
                                     _points_from_bytes(arr[:, 64:96].tobytes(), device))


# -- EncL2 -------------------------------------------------------------------


@dataclass
class EncParamsL2:
    enc_values: sigma.SquareRandCommitVec
    square_proofs: sigma.SquareRandProofVec
    range_proofs: list[RP.RangeProof]
    square_range_proof: RP.RangeProof
    prove_range: int
    l2_prove_range: int
    fp: FpConfig

    @classmethod
    def encrypt(cls, plaintext: np.ndarray, blindings, cfg: CryptoConfig,
                rng: np.random.Generator, device="cuda") -> "EncParamsL2":
        """params.rs:607-658. blindings: (16, d) scalar limbs (numpy or a
        tensor). The L2 bound is checked before any proof (it draws nothing
        from the rng), so an update out of bounds raises L2OverflowError or
        L2NormError at once, the error the JAX package raises after its
        range proofs."""
        fp = cfg.fp
        clipped = RPV.clip_f32_to_range_vec(plaintext, fp, cfg.value_range)
        L2RP.check_l2(clipped, fp, cfg.l2_value_range)
        blind = (blindings.to(device) if isinstance(blindings, torch.Tensor)
                 else fe.to_tensor(blindings, device))
        r2 = pedersen.rnd_scalar_tensor(len(clipped), rng, device)
        range_proofs, commits = RPV.create_rangeproof(
            clipped, blind, fp, cfg.value_range, cfg.n_partition, rng, device)
        square_range_proof, _sum_cm = L2RP.create_rangeproof_l2(
            clipped, r2, fp, cfg.l2_value_range, rng, device)
        m = fe.to_tensor(fp.f32_to_scalar_limbs(clipped), device)
        square_proofs, enc_values = sigma.square_rand_proof_prove(m, blind, r2, rng,
                                                                  existing=commits)
        return cls(enc_values, square_proofs, range_proofs, square_range_proof,
                   cfg.value_range, cfg.l2_value_range, fp)

    def verify(self, rng: np.random.Generator) -> bool:
        """params.rs:660-687 on the device of the commitments: the batched
        square-rand verify (one 6N-term MSM), the range proofs (one combined
        MSM), then the L2 sum proof against Σ c_sq."""
        if not sigma.square_rand_proof_verify_batched(self.square_proofs, self.enc_values, rng):
            return False
        if not RPV.verify_rangeproof(self.range_proofs, self.enc_values.c.L, self.fp,
                                     self.prove_range, rng):
            return False
        sum_pt = curve.unpack_points(curve.tree_sum(self.enc_values.c_sq))[0]
        return L2RP.verify_rangeproof_l2(self.square_range_proof, sum_pt, self.l2_prove_range,
                                         rng, self.enc_values.c_sq.device)

    def serialize(self) -> bytes:
        return wire.encode_length_delimited(wire.EncNormData(
            enc_values=_l2_commits_to_bytes(self.enc_values),
            square_proof=_sq_rand_proofs_to_bytes(self.square_proofs),
            range_proof=[p.to_bytes() for p in self.range_proofs],
            square_range_proof=self.square_range_proof.to_bytes(),
            range_bits=self.prove_range,
            l2_range_bits=self.l2_prove_range,
        ).to_bytes())

    @classmethod
    def deserialize(cls, data: bytes, fp: FpConfig, device="cuda") -> "EncParamsL2":
        msg = wire.EncNormData.from_bytes(wire.decode_length_delimited(data))
        return cls(
            _l2_commits_from_bytes(msg.enc_values, device),
            _sq_rand_proofs_from_bytes(msg.square_proof, device),
            [RP.RangeProof.from_bytes(b) for b in msg.range_proof],
            RP.RangeProof.from_bytes(msg.square_range_proof),
            msg.range_bits,
            msg.l2_range_bits,
            fp,
        )
