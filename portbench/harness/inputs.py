"""The inputs a run hands the program, made from its seed: plaintext updates
and blinding scalars. The same (seed, stream, index) gives the same input
on every machine, so the check can make again what a timed step was given.

An update is d float32 values, uniform in +-``update_bound`` of the
configuration; a blinding vector is d scalars below 2^252 (< l), as (16, d)
limbs of 16 bits.
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference.curve import L

UPDATE, BLINDING, PROGRAM, CHECK, MODEL = range(5)


def rng(seed: int, stream: int, index: int = 0) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 64), stream, index % (1 << 32)])


def update(cfg: dict, seed: int, index: int) -> np.ndarray:
    bound = cfg["update_bound"]
    return rng(seed, UPDATE, index).uniform(-bound, bound, cfg["d"]).astype(np.float32)


def blinding_limbs(d: int, seed: int, index: int) -> np.ndarray:
    limbs = rng(seed, BLINDING, index).integers(0, 1 << 16, size=(16, d), dtype=np.int64)
    limbs[15] &= 0x0FFF
    return limbs


def limbs_to_ints(limbs: np.ndarray) -> list[int]:
    b = np.empty((limbs.shape[1], 32), np.uint8)
    b[:, 0::2] = limbs.T & 0xFF
    b[:, 1::2] = limbs.T >> 8
    return [int.from_bytes(row.tobytes(), "little") for row in b]


def ints_to_limbs(xs) -> np.ndarray:
    raw = np.frombuffer(b"".join(int(x).to_bytes(32, "little") for x in xs), np.uint8)
    b = raw.reshape(-1, 32).astype(np.int64)
    return np.ascontiguousarray((b[:, 0::2] | (b[:, 1::2] << 8)).T)


def cancelling_blindings(d: int, clients: int, seed: int) -> list[np.ndarray]:
    """`clients` blinding vectors whose sum is 0 mod l, lane by lane: the
    first ones drawn, the last the negated sum (RoFL's cancelling scalars)."""
    vecs = [blinding_limbs(d, seed, k) for k in range(clients - 1)]
    ints = [limbs_to_ints(v) for v in vecs]
    last = [(-sum(col)) % L for col in zip(*ints)]
    return vecs + [ints_to_limbs(last)]


def to_device(limbs: np.ndarray, device) -> torch.Tensor:
    """(16, d) limbs as the program takes them: int32 on the device."""
    return torch.from_numpy(limbs.astype(np.int32)).to(device)
