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
from .crypto.pedersen import ElGamalPairArray
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
