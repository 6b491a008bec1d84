"""RoFL's fixed-point embedding of float32 updates, in numpy: the values a
client commits to, and the sum and model the server must arrive at."""

from __future__ import annotations

import numpy as np

from .curve import L


def clip(values: np.ndarray, n_frac: int, range_bits: int) -> np.ndarray:
    """Clip to +-(2^(range - 1) - 1) units of the last place."""
    bound = np.float32(((1 << (range_bits - 1)) - 1) / float(1 << n_frac))
    return np.clip(np.asarray(values, np.float32), -bound, bound)


def signed_units(values: np.ndarray, n_bits: int, n_frac: int) -> np.ndarray:
    """Each value as a signed integer count of 2^-n_frac: the magnitude
    rounded half to even and saturated at 2^n_bits - 1, then the sign."""
    v = np.asarray(values, np.float32)
    mag = np.clip(np.rint(np.abs(v.astype(np.float64)) * (1 << n_frac)), 0, (1 << n_bits) - 1)
    mag = mag.astype(np.int64)
    return np.where(v < 0, -mag, mag)


def scalars(units: np.ndarray) -> list[int]:
    """Signed units → their scalars mod l (a negative value is l - |v|)."""
    return [int(u) % L for u in units]


def server_sum(updates: list, n_bits: int, n_frac: int, range_bits: int) -> np.ndarray:
    """The float32 sum the server extracts from K clipped updates: their
    fixed-point sum plus the one unit that the accumulator's start at the
    basepoint adds, decoded by sign and magnitude."""
    total = sum(signed_units(clip(u, n_frac, range_bits), n_bits, n_frac) for u in updates) + 1
    mag = np.abs(total) & ((1 << n_bits) - 1)
    return (np.where(total < 0, -mag, mag) / float(1 << n_frac)).astype(np.float32)


def next_model(model: np.ndarray, extracted: np.ndarray, clients: int,
               learning_rate: float) -> np.ndarray:
    """The global model after one round: the mean update times the rate,
    in float32 (RoFL's server.rs)."""
    update = extracted * np.float32(1.0 / clients)
    return (model + update * np.float32(learning_rate)).astype(np.float32)
