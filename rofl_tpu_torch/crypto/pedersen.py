"""Pedersen / ElGamal commitment vectors on device.

Counterpart of ``rofl_tpu.crypto.pedersen`` (which replaces rofl_crypto
pedersen_ops.rs and rand_proof/el_gamal.rs):

  commit(m, r)        = (B^m · H^r, B^r)      el_gamal.rs:57-62
  complete_existing   = (C_m, B^r)            el_gamal.rs:64-69
  pedersen(m, r)      = B^m · H^r             bulletproofs PedersenGens
  add pairs           = elementwise group add  pedersen_ops.rs:61-69
  cancelling blindings: n_vec vectors of scalars whose elementwise sum ≡ 0
                        (the secure-aggregation trick, pedersen_ops.rs:110-122)

B = ristretto basepoint; H = B_blinding = sha3-512 hash-to-group of B's
encoding (el_gamal.rs:31-40). Batch layout: (16, N) int32 limbs / PointArray;
results live on the device of the scalars given.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops import curve, fe, fixed_base, keccak_batch, sc
from ..ops.curve import PointArray
from ..spec import generators as G


class ElGamalPairArray(NamedTuple):
    """Batched ElGamal pairs (L, R); R carries the blinding for the
    sum-of-blindings-is-zero aggregation check (el_gamal.rs:101-103)."""

    L: PointArray
    R: PointArray


@lru_cache(maxsize=None)
def base_B() -> fixed_base.FixedBase:
    return fixed_base.FixedBase(G.pedersen_B())


@lru_cache(maxsize=None)
def base_H() -> fixed_base.FixedBase:
    return fixed_base.FixedBase(G.pedersen_B_blinding())


def pedersen_commit(values: torch.Tensor, blindings: torch.Tensor) -> PointArray:
    """B^m · H^r batched: 2 fixed-base muls + 1 add per element."""
    return curve.add(base_B().mul(values), base_H().mul(blindings))


def pedersen_commit_no_blinding(values: torch.Tensor) -> PointArray:
    return base_B().mul(values)


def elgamal_commit(values: torch.Tensor, blindings: torch.Tensor) -> ElGamalPairArray:
    return ElGamalPairArray(
        L=pedersen_commit(values, blindings),
        R=base_B().mul(blindings),
    )


def elgamal_complete_existing(
    pedersen_points: PointArray, blindings: torch.Tensor
) -> ElGamalPairArray:
    return ElGamalPairArray(L=pedersen_points, R=base_B().mul(blindings))


def add_pairs(a: ElGamalPairArray, b: ElGamalPairArray) -> ElGamalPairArray:
    return ElGamalPairArray(curve.add(a.L, b.L), curve.add(a.R, b.R))


def sum_pairs(pairs: ElGamalPairArray, axis: int = 0) -> ElGamalPairArray:
    return ElGamalPairArray(
        curve.tree_sum(pairs.L, axis=axis), curve.tree_sum(pairs.R, axis=axis)
    )


def right_elem_is_unity(pairs: ElGamalPairArray) -> torch.Tensor:
    """Check R == basepoint per element — the reference's 'blindings
    cancelled' test before extraction (el_gamal.rs:101-103, params.rs:128).

    NOTE (faithful to reference): unity here is the BASEPOINT, not the
    identity; with truly cancelling blindings (sum ≡ 0) R = B^0 = identity,
    and the reference's server extract() actually checks
    `!right_elem_is_unity` … it accepts when R is not the basepoint. Both
    predicates are exposed; the protocol layer mirrors params.rs:126-147.
    """
    bp = curve.basepoint(pairs.R.batch_shape, pairs.R.device)
    return curve.eq(pairs.R, bp)


def right_elem_is_identity(pairs: ElGamalPairArray) -> torch.Tensor:
    ident = curve.identity(pairs.R.batch_shape, pairs.R.device)
    return curve.eq(pairs.R, ident)


# -- blinding generation (secrets) ---------------------------------------------


def rnd_scalar_tensor(n: int, rng: np.random.Generator, device="cuda") -> torch.Tensor:
    """Uniform scalars mod l as (16, n) int32 limbs on `device`: 64 uniform
    bytes reduced wide, like Scalar::random (pedersen_ops.rs rnd_scalar_vec).

    On the card the 64 bytes per lane come from a keyed Keccak-f[1600] XOF in
    counter mode (one batched permutation for all lanes; key = 32 bytes drawn
    from the caller's rng) and are reduced by the ``sc_reduce_wide`` kernel,
    so only the key goes up. Deterministic per rng seed. For ``device="cpu"``
    the host sampler draws the bytes from the rng directly, as the JAX
    package does off the TPU."""
    if fe.canonical_device(device).type == "cuda":
        return sc.reduce_wide_bytes(xof_byte_cols(rng.bytes(32), n, device))
    raw = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    return fe.to_tensor(sc.from_bytes_wide_array(raw), device)


def rnd_scalar_limbs(n: int, rng: np.random.Generator, device="cuda") -> np.ndarray:
    """``rnd_scalar_tensor`` brought back to the host as (16, n) uint32
    limbs, ready for the wire."""
    return fe.to_numpy(rnd_scalar_tensor(n, rng, device))


def xof_byte_cols(key: bytes, n: int, device="cuda") -> torch.Tensor:
    """32-byte key + lane count → (64, n) int32 byte columns: one
    Keccak-f[1600] of state = key ‖ counter ‖ domain constant per lane."""
    if len(key) != 32:
        raise ValueError("xof_byte_cols: the key is 32 bytes")
    state = torch.zeros((25, n), dtype=torch.int64, device=device)
    for k in range(4):  # lanes 0..3 = key
        state[k] = int.from_bytes(key[8 * k:8 * k + 8], "little", signed=True)
    state[4] = torch.arange(n, dtype=torch.int64, device=device)  # lane 4 = counter
    state[5] = 0x4C464F52 | (0x01 << 32)
    out = keccak_batch.keccak_f1600(state)
    return torch.stack([(out[k // 8] >> (8 * (k % 8))) & 0xFF for k in range(64)]).to(fe.DTYPE)


def cancelling_scalar_limbs(
    n_vec: int, n_dim: int, rng: np.random.Generator, device="cuda"
) -> list[np.ndarray]:
    """n_vec scalar vectors with elementwise sum ≡ 0 (mod l)
    (pedersen_ops.rs:110-122): first n-1 random, last = -(sum). The sum and
    the negation run on `device` (``sc_add`` and ``sc_sub`` launches on the
    card); the vectors come back to the host for the wire."""
    vecs = [rnd_scalar_tensor(n_dim, rng, device) for _ in range(n_vec - 1)]
    last = sc.neg(sc.sum_reduce(torch.stack(vecs, dim=1), axis=0)).reshape(fe.NLIMB, n_dim)
    return [fe.to_numpy(v) for v in vecs + [last]]
