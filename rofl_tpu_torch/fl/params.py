"""Encrypted-parameter protocol layer — rebuild of rofl_service params.rs.

Counterpart of ``rofl_tpu.fl.params``, all five modes (params.rs:27-64,
type tags 1-5):

  PlainParams               the update in the clear (bincode Vec<f32>)
  EncParamsRange            per-parameter rand proofs + L∞ Bulletproofs over
                            ``n_partition`` chunks, possibly on the first
                            ``check_percentage`` of the parameters
  EncParamsL2               square-rand proofs + L∞ Bulletproofs + one L2
                            sum proof
  EncParamsRangeCompressed  one CompressedRandProof + L∞ Bulletproofs
  EncParamsL2Compressed     one CompressedRandProof + Pedersen-only square
                            proofs + L∞ Bulletproofs + one L2 sum proof

with the dispatch (``encrypt``, ``deserialize``, ``verify``,
``enc_pairs_of``) and the server's ``Accumulator``: the homomorphic ElGamal
sum from unity (B, B) pairs, extraction gated on every R == B, then BSGS.
Serialization is byte-identical with the reference: fixed-stride
concatenations of 32-byte encodings in the length-delimited ``EncRangeData``,
``EncNormData`` and ``EncNormDataCompressed`` envelopes (``fl/wire.py``),
bincode for Plain.

A reference hazard kept as it is: EncRange and EncRangeCompressed build the
rand proof's m from the unclipped plaintext while the range proofs commit to
the clipped one, and EncL2 / EncL2Compressed use the clipped m; so a value
out of range gives a verdict that depends on the mode. The port gives the
JAX package's verdict in each.

The commitment vectors live as PointArrays on the device the caller names.
Spans (``utils/profiling.py``): ``encrypt``, ``serialize``, ``deserialize``,
``verify``, ``accumulate`` and ``extract`` with its ``extract.unity``,
``extract.bsgs`` and ``extract.decode``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..crypto import compressed_rand_proof as CRP
from ..crypto import l2_range_proof as L2RP
from ..crypto import pedersen, sigma
from ..crypto import range_proof as RP
from ..crypto import range_proof_vec as RPV
from ..crypto import serde_vec as sv
from ..crypto.fp_codec import FpConfig
from ..crypto.pedersen import ElGamalPairArray
from ..ops import bsgs, curve, fe, sc
from ..ops.curve import PointArray
from ..spec.merlin import Transcript
from ..utils.profiling import span
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


def _scalars_to_bytes(limbs) -> bytes:
    return sc.to_bytes_array(limbs).tobytes()


def _rand_proofs_to_bytes(p: sigma.RandProofVec) -> bytes:
    """RandProof stride 128: C_prime(64) || Z_m || Z_r (rand_proof/mod.rs:91-97)."""
    return np.concatenate([
        np.frombuffer(_pairs_to_bytes(p.c_prime), np.uint8).reshape(-1, 64),
        sc.to_bytes_array(p.z_m), sc.to_bytes_array(p.z_r),
    ], axis=1).tobytes()


def _rand_proofs_from_bytes(data: bytes, device="cuda") -> sigma.RandProofVec:
    arr = np.frombuffer(data, np.uint8).reshape(-1, 128)
    return sigma.RandProofVec(
        _pairs_from_bytes(arr[:, :64].tobytes(), device),
        _scalars_from_bytes(arr[:, 64:96].tobytes(), device),
        _scalars_from_bytes(arr[:, 96:128].tobytes(), device))


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


def _sq_proofs_to_bytes(p: sigma.SquareProofVec) -> bytes:
    """SquareProof stride 160: C_prime(32+32) || Z_m || Z_r1 || Z_r2."""
    return np.concatenate([
        curve.compress_to_bytes(p.c_l_prime), curve.compress_to_bytes(p.c_sq_prime),
        sc.to_bytes_array(p.z_m), sc.to_bytes_array(p.z_r1), sc.to_bytes_array(p.z_r2),
    ], axis=1).tobytes()


def _sq_proofs_from_bytes(data: bytes, device="cuda") -> sigma.SquareProofVec:
    arr = np.frombuffer(data, np.uint8).reshape(-1, 160)
    return sigma.SquareProofVec(
        _points_from_bytes(arr[:, :32].tobytes(), device),
        _points_from_bytes(arr[:, 32:64].tobytes(), device),
        _scalars_from_bytes(arr[:, 64:96].tobytes(), device),
        _scalars_from_bytes(arr[:, 96:128].tobytes(), device),
        _scalars_from_bytes(arr[:, 128:160].tobytes(), device))


def _l2_commits_to_bytes(c: sigma.SquareRandCommitVec) -> bytes:
    """SquareRandProofCommitments stride 96: EG pair(64) || c_sq(32)."""
    return np.concatenate([np.frombuffer(_pairs_to_bytes(c.c), np.uint8).reshape(-1, 64),
                           curve.compress_to_bytes(c.c_sq)], axis=1).tobytes()


def _l2_commits_from_bytes(data: bytes, device="cuda") -> sigma.SquareRandCommitVec:
    arr = np.frombuffer(data, np.uint8).reshape(-1, 96)
    return sigma.SquareRandCommitVec(_pairs_from_bytes(arr[:, :64].tobytes(), device),
                                     _points_from_bytes(arr[:, 64:96].tobytes(), device))


def _blinding_tensor(blindings, device) -> torch.Tensor:
    """(16, d) blinding limbs, numpy or a tensor → a tensor on `device`."""
    if isinstance(blindings, torch.Tensor):
        return blindings.to(device)
    return fe.to_tensor(blindings, device)


def _checked_count(d: int, check_percentage: float) -> int:
    """How many leading parameters the range proofs cover: Python's round,
    half to even, of d · check_percentage (params.rs, and the JAX package's
    ``int(round(...))``)."""
    return int(round(d * check_percentage))


def _first_lanes(p: PointArray, n: int) -> PointArray:
    return PointArray(*[c[:, :n].contiguous() for c in p])


def _range_encrypt(plaintext, blindings, cfg: CryptoConfig, rng, device, prove_rand):
    """The shared body of EncRange and EncRangeCompressed encrypt
    (params.rs:468-511, 697-744): the range proofs on the clipped values (on
    the first ``num`` of them below a check percentage of 1), then
    ``prove_rand(m, blindings, existing)`` with m from the unclipped values
    (the reference's hazard, kept) and, at a percentage of 1, the range
    proofs' commitments as the existing ones."""
    fp = cfg.fp
    clipped = RPV.clip_f32_to_range_vec(plaintext, fp, cfg.value_range)
    blind = _blinding_tensor(blindings, device)
    m = fe.to_tensor(fp.f32_to_scalar_limbs(np.asarray(plaintext, np.float32)), device)
    if cfg.check_percentage >= 1.0:
        range_proofs, commits = RPV.create_rangeproof(
            clipped, blind, fp, cfg.value_range, cfg.n_partition, rng, device)
        return range_proofs, prove_rand(m, blind, commits)
    num = _checked_count(len(clipped), cfg.check_percentage)
    range_proofs, _ = RPV.create_rangeproof(
        clipped[:num], blind[:, :num].contiguous(), fp, cfg.value_range, cfg.n_partition, rng,
        device)
    return range_proofs, prove_rand(m, blind, None)


def _range_verify(enc_values: ElGamalPairArray, range_proofs, check_percentage: float,
                  fp: FpConfig, prove_range: int, rng, mesh) -> bool:
    num = _checked_count(enc_values.L.x.shape[1], check_percentage)
    return RPV.verify_rangeproof(range_proofs, _first_lanes(enc_values.L, num), fp,
                                 prove_range, rng, mesh)


# -- Plain -------------------------------------------------------------------


@dataclass
class PlainParams:
    content: np.ndarray  # float32

    def serialize(self) -> bytes:
        """bincode Vec<f32>: u64 LE length + packed f32 LE."""
        c = np.asarray(self.content, np.float32)
        return len(c).to_bytes(8, "little") + c.tobytes()

    @classmethod
    def deserialize(cls, data: bytes) -> "PlainParams":
        n = int.from_bytes(data[:8], "little")
        return cls(np.frombuffer(data[8:8 + 4 * n], np.float32).copy())


# -- EncRange ----------------------------------------------------------------


@dataclass
class EncParamsRange:
    enc_values: ElGamalPairArray
    rand_proofs: sigma.RandProofVec
    range_proofs: list[RP.RangeProof]
    prove_range: int
    check_percentage: float
    fp: FpConfig

    @classmethod
    def encrypt(cls, plaintext: np.ndarray, blindings, cfg: CryptoConfig,
                rng: np.random.Generator, device="cuda") -> "EncParamsRange":
        """params.rs:468-511: range proofs (on the first ``num`` parameters
        below a check percentage of 1), then per-parameter rand proofs, on
        the range proofs' commitments at a percentage of 1 and on fresh ones
        below it."""
        range_proofs, (rand_proofs, enc_values) = _range_encrypt(
            plaintext, blindings, cfg, rng, device,
            lambda m, r, existing: sigma.rand_proof_prove(m, r, rng, existing=existing))
        return cls(enc_values, rand_proofs, range_proofs, cfg.value_range,
                   cfg.check_percentage, cfg.fp)

    def verify(self, rng: np.random.Generator, mesh=None) -> bool:
        """Every lane's rand proof (one ``scalar_mul`` launch), then the range
        proofs against the first ``num`` commitments. With a mesh only the
        range proofs' combined MSM is sharded, as in the JAX package; the Σ
        verify stays whole."""
        if not fe.to_bool(sigma.rand_proof_verify(self.rand_proofs, self.enc_values).all()):
            return False
        return _range_verify(self.enc_values, self.range_proofs, self.check_percentage, self.fp,
                             self.prove_range, rng, mesh)

    @span("serialize")
    def serialize(self) -> bytes:
        return wire.encode_length_delimited(wire.EncRangeData(
            enc_values=_pairs_to_bytes(self.enc_values),
            rand_proof=_rand_proofs_to_bytes(self.rand_proofs),
            range_proof=[p.to_bytes() for p in self.range_proofs],
            range_bits=self.prove_range,
            check_percentage=self.check_percentage,
        ).to_bytes())

    @classmethod
    def deserialize(cls, data: bytes, fp: FpConfig, device="cuda") -> "EncParamsRange":
        msg = wire.EncRangeData.from_bytes(wire.decode_length_delimited(data))
        return cls(
            _pairs_from_bytes(msg.enc_values, device),
            _rand_proofs_from_bytes(msg.rand_proof, device),
            [RP.RangeProof.from_bytes(b) for b in msg.range_proof],
            msg.range_bits,
            msg.check_percentage,
            fp,
        )


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
        blind = _blinding_tensor(blindings, device)
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

    def verify(self, rng: np.random.Generator, mesh=None) -> bool:
        """params.rs:660-687 on the device of the commitments: the batched
        square-rand verify (one 6N-term MSM), the range proofs (one combined
        MSM, sharded over the 'param' axis of `mesh` when one is given), then
        the L2 sum proof against Σ c_sq."""
        if not sigma.square_rand_proof_verify_batched(self.square_proofs, self.enc_values, rng):
            return False
        if not RPV.verify_rangeproof(self.range_proofs, self.enc_values.c.L, self.fp,
                                     self.prove_range, rng, mesh):
            return False
        sum_pt = curve.unpack_points(curve.tree_sum(self.enc_values.c_sq))[0]
        return L2RP.verify_rangeproof_l2(self.square_range_proof, sum_pt, self.l2_prove_range,
                                         rng, self.enc_values.c_sq.device)

    @span("serialize")
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


# -- EncRangeCompressed ------------------------------------------------------


@dataclass
class EncParamsRangeCompressed:
    enc_values: ElGamalPairArray
    rand_proof: CRP.CompressedRandProof
    range_proofs: list[RP.RangeProof]
    prove_range: int
    check_percentage: float
    fp: FpConfig

    @classmethod
    def encrypt(cls, plaintext: np.ndarray, blindings, cfg: CryptoConfig,
                rng: np.random.Generator, device="cuda") -> "EncParamsRangeCompressed":
        """params.rs:697-744: as EncParamsRange, with one compressed rand
        proof for the whole vector."""
        range_proofs, (rand_proof, enc_values) = _range_encrypt(
            plaintext, blindings, cfg, rng, device,
            lambda m, r, existing: CRP.prove(Transcript(CRP.TRANSCRIPT_LABEL), m, r, rng,
                                             existing=existing))
        return cls(enc_values, rand_proof, range_proofs, cfg.value_range,
                   cfg.check_percentage, cfg.fp)

    def verify(self, rng: np.random.Generator, mesh=None) -> bool:
        """The compressed rand proof (two d-term MSMs), then the range proofs
        against the first ``num`` commitments (their combined MSM sharded
        over `mesh` when one is given)."""
        if not CRP.verify(Transcript(CRP.TRANSCRIPT_LABEL), self.rand_proof, self.enc_values):
            return False
        return _range_verify(self.enc_values, self.range_proofs, self.check_percentage, self.fp,
                             self.prove_range, rng, mesh)

    @span("serialize")
    def serialize(self) -> bytes:
        return wire.encode_length_delimited(wire.EncRangeData(
            enc_values=_pairs_to_bytes(self.enc_values),
            rand_proof=self.rand_proof.to_bytes(),
            range_proof=[p.to_bytes() for p in self.range_proofs],
            range_bits=self.prove_range,
            check_percentage=self.check_percentage,
        ).to_bytes())

    @classmethod
    def deserialize(cls, data: bytes, fp: FpConfig,
                    device="cuda") -> "EncParamsRangeCompressed":
        msg = wire.EncRangeData.from_bytes(wire.decode_length_delimited(data))
        return cls(
            _pairs_from_bytes(msg.enc_values, device),
            CRP.CompressedRandProof.from_bytes(msg.rand_proof),
            [RP.RangeProof.from_bytes(b) for b in msg.range_proof],
            msg.range_bits,
            msg.check_percentage,
            fp,
        )


# -- EncL2Compressed ---------------------------------------------------------


@dataclass
class EncParamsL2Compressed:
    enc_values: sigma.SquareRandCommitVec  # ElGamal pairs + c_sq (merged view)
    square_proofs: sigma.SquareProofVec
    rand_proof: CRP.CompressedRandProof
    range_proofs: list[RP.RangeProof]
    square_range_proof: RP.RangeProof
    prove_range: int
    l2_prove_range: int
    fp: FpConfig

    @classmethod
    def encrypt(cls, plaintext: np.ndarray, blindings, cfg: CryptoConfig,
                rng: np.random.Generator, device="cuda") -> "EncParamsL2Compressed":
        """params.rs:798-846: range proofs, the L2 sum proof, one compressed
        rand proof and the Pedersen-only square proofs, both on the range
        proofs' commitments, all on the clipped values. The L2 bound is
        checked first, as in ``EncParamsL2.encrypt``."""
        fp = cfg.fp
        clipped = RPV.clip_f32_to_range_vec(plaintext, fp, cfg.value_range)
        L2RP.check_l2(clipped, fp, cfg.l2_value_range)
        blind = _blinding_tensor(blindings, device)
        r2 = pedersen.rnd_scalar_tensor(len(clipped), rng, device)
        range_proofs, commits = RPV.create_rangeproof(
            clipped, blind, fp, cfg.value_range, cfg.n_partition, rng, device)
        square_range_proof, _ = L2RP.create_rangeproof_l2(
            clipped, r2, fp, cfg.l2_value_range, rng, device)
        m = fe.to_tensor(fp.f32_to_scalar_limbs(clipped), device)
        rand_proof, eg_pairs = CRP.prove(Transcript(CRP.TRANSCRIPT_LABEL), m, blind, rng,
                                         existing=commits)
        square_proofs, sq_commits = sigma.square_proof_prove(m, blind, r2, rng,
                                                             existing=commits)
        return cls(sigma.SquareRandCommitVec(eg_pairs, sq_commits.c_sq), square_proofs,
                   rand_proof, range_proofs, square_range_proof, cfg.value_range,
                   cfg.l2_value_range, fp)

    def verify(self, rng: np.random.Generator, mesh=None) -> bool:
        """The square proofs (one ``scalar_mul`` launch), the compressed rand
        proof, the range proofs (their combined MSM sharded over `mesh` when
        one is given), then the L2 sum proof against Σ c_sq."""
        sq_c = sigma.SquareCommitVec(self.enc_values.c.L, self.enc_values.c_sq)
        if not fe.to_bool(sigma.square_proof_verify(self.square_proofs, sq_c).all()):
            return False
        if not CRP.verify(Transcript(CRP.TRANSCRIPT_LABEL), self.rand_proof, self.enc_values.c):
            return False
        if not RPV.verify_rangeproof(self.range_proofs, self.enc_values.c.L, self.fp,
                                     self.prove_range, rng, mesh):
            return False
        sum_pt = curve.unpack_points(curve.tree_sum(self.enc_values.c_sq))[0]
        return L2RP.verify_rangeproof_l2(self.square_range_proof, sum_pt, self.l2_prove_range,
                                         rng, self.enc_values.c_sq.device)

    @span("serialize")
    def serialize(self) -> bytes:
        return wire.encode_length_delimited(wire.EncNormDataCompressed(
            enc_values=_l2_commits_to_bytes(self.enc_values),
            square_proof=_sq_proofs_to_bytes(self.square_proofs),
            rand_proof=self.rand_proof.to_bytes(),
            range_proof=[p.to_bytes() for p in self.range_proofs],
            square_range_proof=self.square_range_proof.to_bytes(),
            range_bits=self.prove_range,
            l2_range_bits=self.l2_prove_range,
        ).to_bytes())

    @classmethod
    def deserialize(cls, data: bytes, fp: FpConfig, device="cuda") -> "EncParamsL2Compressed":
        msg = wire.EncNormDataCompressed.from_bytes(wire.decode_length_delimited(data))
        return cls(
            _l2_commits_from_bytes(msg.enc_values, device),
            _sq_proofs_from_bytes(msg.square_proof, device),
            CRP.CompressedRandProof.from_bytes(msg.rand_proof),
            [RP.RangeProof.from_bytes(b) for b in msg.range_proof],
            RP.RangeProof.from_bytes(msg.square_range_proof),
            msg.range_bits,
            msg.l2_range_bits,
            fp,
        )


# -- dispatch ----------------------------------------------------------------

_MODE_CLASSES = {
    ENC_RANGE_TYPE: EncParamsRange,
    ENC_L2_TYPE: EncParamsL2,
    ENC_RANGE_COMPRESSED_TYPE: EncParamsRangeCompressed,
    ENC_L2_COMPRESSED_TYPE: EncParamsL2Compressed,
}


@span("encrypt")
def encrypt(enc_type: int, plaintext: np.ndarray, blindings, cfg: CryptoConfig,
            rng: np.random.Generator, device="cuda"):
    """EncModelParams::encrypt dispatch (params.rs:356-405)."""
    if enc_type == PLAIN_TYPE:
        return PlainParams(np.asarray(plaintext, np.float32))
    return _MODE_CLASSES[enc_type].encrypt(plaintext, blindings, cfg, rng, device)


@span("deserialize")
def deserialize(enc_type: int, data: bytes, fp: FpConfig, device="cuda"):
    """EncModelParams::deserialize dispatch (params.rs:334-354)."""
    if enc_type == PLAIN_TYPE:
        return PlainParams.deserialize(data)
    return _MODE_CLASSES[enc_type].deserialize(data, fp, device)


@span("verify")
def verify(params, rng: np.random.Generator, mesh=None) -> bool:
    """EncModelParams::verify (params.rs:181-291); Plain is trivially true.

    mesh: an optional ``parallel.mesh.Mesh``: the range-proof verification's
    combined MSM shards its terms over the 'param' axis (the reference's
    rayon verification pool becomes device parallelism)."""
    if isinstance(params, PlainParams):
        return True
    return params.verify(rng, mesh)


def enc_pairs_of(params) -> ElGamalPairArray | None:
    """The ElGamal pairs the server accumulates; None for Plain."""
    if isinstance(params, (EncParamsRange, EncParamsRangeCompressed)):
        return params.enc_values
    if isinstance(params, (EncParamsL2, EncParamsL2Compressed)):
        return params.enc_values.c
    return None


# -- accumulator -------------------------------------------------------------


class Accumulator:
    """EncModelParamsAccumulator (params.rs:80-148): starts from unity()
    pairs (B, B) and adds client vectors homomorphically (``point_add``
    launches); extraction checks every R == B (blindings cancelled), then
    solves BSGS on the L's with a table of ``bsgs_m`` entries, by default
    2^(n_bits / 2 + 8) as in the JAX package. The sum starts from B, so L
    holds B^(1 + Σ m): the extracted values are the clients' fixed-point sum
    plus one unit of the last place, as the JAX package extracts them. Plain
    mode sums float32 on the host. The unity pairs and the sums live on
    `device`."""

    def __init__(self, enc_type: int, size: int, fp: FpConfig, bsgs_m: int | None = None,
                 device="cuda"):
        self.enc_type = enc_type
        self.size = size
        self.fp = fp
        self.bsgs_m = bsgs_m or (1 << (fp.n_bits // 2 + 8))
        if enc_type == PLAIN_TYPE:
            self.plain = np.zeros(size, np.float32)
            self.pairs = None
        else:
            unity = PointArray(*[c.expand(fe.NLIMB, size).contiguous()
                                 for c in curve.basepoint((1,), device)])
            self.pairs = ElGamalPairArray(unity, unity)
            self.plain = None

    @span("accumulate")
    def accumulate(self, params) -> bool:
        """Add one client's update; False (and nothing added) for an update
        of another size, or of an encrypted kind in Plain mode or the other
        way round."""
        if self.enc_type == PLAIN_TYPE:
            if not isinstance(params, PlainParams) or len(params.content) != self.size:
                return False
            self.plain += params.content
            return True
        pairs = enc_pairs_of(params)
        if pairs is None or pairs.L.x.shape[1] != self.size:
            return False
        self.pairs = pedersen.add_pairs(self.pairs, pairs)
        return True

    @span("extract")
    def extract(self) -> np.ndarray | None:
        """The decoded float32 sum, or None where a blinding did not cancel
        or a value lies outside the BSGS range."""
        if self.enc_type == PLAIN_TYPE:
            return self.plain.copy()
        with span("extract.unity"):
            if not fe.to_bool(pedersen.right_elem_is_unity(self.pairs).all()):
                return None
        with span("extract.bsgs"):
            vals, ok = bsgs.solve_discrete_log(self.pairs.L, m=self.bsgs_m,
                                               n_bits=self.fp.n_bits)
            if not fe.to_bool(ok.all()):
                return None
        with span("extract.decode"):
            return self.fp.scalar_limbs_to_f32(fe.to_numpy(vals))
