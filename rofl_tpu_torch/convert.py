"""Carry state from the JAX package into the port, as numpy.

Everything here takes and returns numpy arrays, so this module needs nothing
of the JAX package: a caller that holds ``rofl_tpu`` state hands it over with
``np.asarray``. Layouts are the same on both sides ((16, N) radix-2^16 limbs,
limb-major); what differs is the dtype (uint32 there, int32 tensors here) and
the BSGS key words, which the port stores biased so that they sort as
unsigned under a signed dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto import sigma
from .crypto.compressed_rand_proof import CompressedRandProof
from .crypto.fp_codec import FpConfig
from .crypto.pedersen import ElGamalPairArray
from .crypto.range_proof import RangeProof
from .fl.params import (PLAIN_TYPE, Accumulator, CryptoConfig, EncParamsL2,
                        EncParamsL2Compressed, EncParamsRange, EncParamsRangeCompressed)
from .fl.server import ServerConfig
from .ops import fe
from .ops.curve import PointArray

# numpy (16, N) uint32 limbs → int32 tensor on a device, and back.
limbs_to_tensor = fe.to_tensor
tensor_to_limbs = fe.to_numpy


def point_from_numpy(x, y, z, t, device="cuda") -> PointArray:
    """A ``rofl_tpu`` PointArray given as its four numpy coordinate arrays →
    the port's PointArray on `device`."""
    return PointArray(*[fe.to_tensor(c, device) for c in (x, y, z, t)])


def point_to_numpy(p: PointArray) -> tuple:
    """The port's PointArray → four numpy uint32 coordinate arrays."""
    return tuple(fe.to_numpy(c) for c in p)


def fixed_base_table_from_numpy(x, y, z, t, device="cuda") -> PointArray:
    """A ``rofl_tpu`` ``FixedBase.table`` ((16, 32, 256) per coordinate,
    numpy) → the table ``rofl_tpu_torch.ops.fixed_base.mul`` takes."""
    for c in (x, y, z, t):
        if tuple(np.shape(c)) != (16, 32, 256):
            raise ValueError(f"fixed-base table coordinate has shape {np.shape(c)}")
    return point_from_numpy(x, y, z, t, device)


def bsgs_table_from_numpy(keys, values, device="cuda"):
    """``rofl_tpu.ops.bsgs.build_table(m)``'s sorted (keys (m+1, 8) uint32,
    values (m+1,) uint32) → the (keys, values) tensors
    ``rofl_tpu_torch.ops.bsgs.solve_with_table`` takes. Unsigned order of the
    words is signed order of the biased words, so the rows stay sorted."""
    keys = np.asarray(keys).astype(np.int64) - (1 << 31)
    values = np.asarray(values).astype(np.int64)
    return (torch.from_numpy(keys.astype(np.int32)).to(device),
            torch.from_numpy(values.astype(np.int32)).to(device))


# -- Σ-proofs and their commitments ---------------------------------------------
#
# A point is its four numpy coordinate arrays (x, y, z, t), an ElGamal pair
# is (L, R) of two such points, a response is its (16, N) limb array. The
# ``*_to_numpy`` functions return the arguments of their ``*_from_numpy``
# counterparts (without the device), in the order of the JAX package's
# dataclass fields, so ``rofl_tpu.crypto.sigma.RandProofVec(*fields)`` needs
# only each leaf wrapped in ``jnp.asarray`` / ``PointArray``.


def pair_from_numpy(left, right, device="cuda") -> ElGamalPairArray:
    return ElGamalPairArray(point_from_numpy(*left, device=device),
                            point_from_numpy(*right, device=device))


def pair_to_numpy(pair: ElGamalPairArray) -> tuple:
    return point_to_numpy(pair.L), point_to_numpy(pair.R)


def rand_proof_from_numpy(c_prime, z_m, z_r, device="cuda") -> sigma.RandProofVec:
    return sigma.RandProofVec(pair_from_numpy(*c_prime, device=device),
                              fe.to_tensor(z_m, device), fe.to_tensor(z_r, device))


def rand_proof_to_numpy(p: sigma.RandProofVec) -> tuple:
    return pair_to_numpy(p.c_prime), fe.to_numpy(p.z_m), fe.to_numpy(p.z_r)


def square_rand_proof_from_numpy(c_prime, c_sq_prime, z_m, z_r1, z_r2,
                                 device="cuda") -> sigma.SquareRandProofVec:
    return sigma.SquareRandProofVec(
        pair_from_numpy(*c_prime, device=device), point_from_numpy(*c_sq_prime, device=device),
        fe.to_tensor(z_m, device), fe.to_tensor(z_r1, device), fe.to_tensor(z_r2, device))


def square_rand_proof_to_numpy(p: sigma.SquareRandProofVec) -> tuple:
    return (pair_to_numpy(p.c_prime), point_to_numpy(p.c_sq_prime),
            fe.to_numpy(p.z_m), fe.to_numpy(p.z_r1), fe.to_numpy(p.z_r2))


def square_rand_commit_from_numpy(c, c_sq, device="cuda") -> sigma.SquareRandCommitVec:
    return sigma.SquareRandCommitVec(pair_from_numpy(*c, device=device),
                                     point_from_numpy(*c_sq, device=device))


def square_rand_commit_to_numpy(c: sigma.SquareRandCommitVec) -> tuple:
    return pair_to_numpy(c.c), point_to_numpy(c.c_sq)


def square_proof_from_numpy(c_l_prime, c_sq_prime, z_m, z_r1, z_r2,
                            device="cuda") -> sigma.SquareProofVec:
    return sigma.SquareProofVec(
        point_from_numpy(*c_l_prime, device=device), point_from_numpy(*c_sq_prime, device=device),
        fe.to_tensor(z_m, device), fe.to_tensor(z_r1, device), fe.to_tensor(z_r2, device))


def square_proof_to_numpy(p: sigma.SquareProofVec) -> tuple:
    return (point_to_numpy(p.c_l_prime), point_to_numpy(p.c_sq_prime),
            fe.to_numpy(p.z_m), fe.to_numpy(p.z_r1), fe.to_numpy(p.z_r2))


def square_commit_from_numpy(c_l, c_sq, device="cuda") -> sigma.SquareCommitVec:
    return sigma.SquareCommitVec(point_from_numpy(*c_l, device=device),
                                 point_from_numpy(*c_sq, device=device))


def square_commit_to_numpy(c: sigma.SquareCommitVec) -> tuple:
    return point_to_numpy(c.c_l), point_to_numpy(c.c_sq)


# -- the L2 round ------------------------------------------------------------------


def bp_gens_from_numpy(gens_G, gens_H, device="cuda") -> tuple[PointArray, PointArray]:
    """``rofl_tpu.crypto.range_proof.device_bp_gens(n, m)``'s two point
    arrays, each given as its four numpy coordinate arrays → the pair
    ``rofl_tpu_torch.crypto.range_proof.device_bp_gens`` returns."""
    return point_from_numpy(*gens_G, device=device), point_from_numpy(*gens_H, device=device)


def enc_params_l2_from_numpy(enc_values, square_proofs, range_proofs, square_range_proof,
                             prove_range: int, l2_prove_range: int, fp: FpConfig,
                             device="cuda") -> EncParamsL2:
    """A ``rofl_tpu.fl.params.EncParamsL2`` given field by field → the
    port's. enc_values and square_proofs in the layouts of
    ``square_rand_commit_to_numpy`` and ``square_rand_proof_to_numpy``; the
    range proofs as their ``to_bytes()`` (the same in both packages)."""
    return EncParamsL2(
        square_rand_commit_from_numpy(*enc_values, device=device),
        square_rand_proof_from_numpy(*square_proofs, device=device),
        [RangeProof.from_bytes(b) for b in range_proofs],
        RangeProof.from_bytes(square_range_proof),
        prove_range, l2_prove_range, FpConfig(fp.n_bits, fp.n_frac))


def enc_params_l2_to_numpy(p: EncParamsL2) -> tuple:
    """The port's EncParamsL2 → the arguments of ``enc_params_l2_from_numpy``
    (without the device), in the order of the JAX dataclass's fields."""
    return (square_rand_commit_to_numpy(p.enc_values), square_rand_proof_to_numpy(p.square_proofs),
            [r.to_bytes() for r in p.range_proofs], p.square_range_proof.to_bytes(),
            p.prove_range, p.l2_prove_range, p.fp)


# -- the other encrypted modes -------------------------------------------------------
#
# A CompressedRandProof (the same dataclass of bytes and ints in both
# packages) is carried as its ``to_bytes()``, a range proof as its
# ``to_bytes()``; the rest as in the functions above.


def enc_params_range_from_numpy(enc_values, rand_proofs, range_proofs, prove_range: int,
                                check_percentage: float, fp: FpConfig,
                                device="cuda") -> EncParamsRange:
    """A ``rofl_tpu.fl.params.EncParamsRange`` given field by field →
    the port's: enc_values in the layout of ``pair_to_numpy``, rand_proofs
    in that of ``rand_proof_to_numpy``."""
    return EncParamsRange(pair_from_numpy(*enc_values, device=device),
                          rand_proof_from_numpy(*rand_proofs, device=device),
                          [RangeProof.from_bytes(b) for b in range_proofs], prove_range,
                          check_percentage, FpConfig(fp.n_bits, fp.n_frac))


def enc_params_range_to_numpy(p: EncParamsRange) -> tuple:
    """The port's EncParamsRange → the arguments of
    ``enc_params_range_from_numpy`` (without the device)."""
    return (pair_to_numpy(p.enc_values), rand_proof_to_numpy(p.rand_proofs),
            [r.to_bytes() for r in p.range_proofs], p.prove_range, p.check_percentage, p.fp)


def enc_params_range_compressed_from_numpy(enc_values, rand_proof: bytes, range_proofs,
                                           prove_range: int, check_percentage: float,
                                           fp: FpConfig,
                                           device="cuda") -> EncParamsRangeCompressed:
    return EncParamsRangeCompressed(pair_from_numpy(*enc_values, device=device),
                                    CompressedRandProof.from_bytes(rand_proof),
                                    [RangeProof.from_bytes(b) for b in range_proofs],
                                    prove_range, check_percentage,
                                    FpConfig(fp.n_bits, fp.n_frac))


def enc_params_range_compressed_to_numpy(p: EncParamsRangeCompressed) -> tuple:
    return (pair_to_numpy(p.enc_values), p.rand_proof.to_bytes(),
            [r.to_bytes() for r in p.range_proofs], p.prove_range, p.check_percentage, p.fp)


def enc_params_l2_compressed_from_numpy(enc_values, square_proofs, rand_proof: bytes,
                                        range_proofs, square_range_proof: bytes,
                                        prove_range: int, l2_prove_range: int, fp: FpConfig,
                                        device="cuda") -> EncParamsL2Compressed:
    """enc_values in the layout of ``square_rand_commit_to_numpy``,
    square_proofs in that of ``square_proof_to_numpy``."""
    return EncParamsL2Compressed(
        square_rand_commit_from_numpy(*enc_values, device=device),
        square_proof_from_numpy(*square_proofs, device=device),
        CompressedRandProof.from_bytes(rand_proof),
        [RangeProof.from_bytes(b) for b in range_proofs],
        RangeProof.from_bytes(square_range_proof), prove_range, l2_prove_range,
        FpConfig(fp.n_bits, fp.n_frac))


def enc_params_l2_compressed_to_numpy(p: EncParamsL2Compressed) -> tuple:
    return (square_rand_commit_to_numpy(p.enc_values), square_proof_to_numpy(p.square_proofs),
            p.rand_proof.to_bytes(), [r.to_bytes() for r in p.range_proofs],
            p.square_range_proof.to_bytes(), p.prove_range, p.l2_prove_range, p.fp)


# -- the server's accumulator ---------------------------------------------------------


def accumulator_from_numpy(enc_type: int, size: int, fp: FpConfig, bsgs_m: int, state,
                           device="cuda") -> Accumulator:
    """A ``rofl_tpu.fl.params.Accumulator``'s state → the port's: `state` is
    its ``plain`` float32 array in Plain mode, else its ``pairs`` in the
    layout of ``pair_to_numpy``. The sums carry over as they are, so the
    port's ``extract`` gives what the JAX server's would."""
    fp = FpConfig(fp.n_bits, fp.n_frac)
    acc = Accumulator(enc_type, size, fp, bsgs_m=bsgs_m, device=device)
    if enc_type == PLAIN_TYPE:
        plain = np.asarray(state, np.float32)
        if plain.shape != (size,):
            raise ValueError(f"plain accumulator of {size} values given {plain.shape}")
        acc.plain = plain.copy()
        return acc
    pairs = pair_from_numpy(*state, device=device)
    if pairs.L.x.shape != (16, size) or pairs.R.x.shape != (16, size):
        raise ValueError(f"accumulator of {size} pairs given {tuple(pairs.L.x.shape)}")
    acc.pairs = pairs
    return acc


def accumulator_to_numpy(acc: Accumulator) -> tuple:
    """The port's Accumulator → the arguments of ``accumulator_from_numpy``
    (without the device)."""
    state = acc.plain.copy() if acc.enc_type == PLAIN_TYPE else pair_to_numpy(acc.pairs)
    return acc.enc_type, acc.size, acc.fp, acc.bsgs_m, state


# -- the FL server's configuration ---------------------------------------------------


def crypto_config_from_dict(d) -> CryptoConfig:
    """A ``rofl_tpu.fl.params.CryptoConfig`` as ``dataclasses.asdict`` gives
    it (its ``fp`` a dict too) → the port's."""
    return CryptoConfig(**{**d, "fp": FpConfig(**d["fp"])})


def server_config_from_dict(d, device="cuda") -> ServerConfig:
    """A ``rofl_tpu.fl.server.ServerConfig`` as ``dataclasses.asdict`` gives
    it (plain values and a numpy initial model) → the port's, on `device`;
    the initial model as a float32 copy."""
    initial = d["initial_model"]
    return ServerConfig(**{
        **d, "crypto": crypto_config_from_dict(d["crypto"]),
        "model_config": dict(d["model_config"]),
        "initial_model": None if initial is None else np.array(initial, np.float32),
        "device": device})
