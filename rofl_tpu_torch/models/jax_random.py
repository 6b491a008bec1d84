"""JAX's default PRNG in plain torch: threefry2x32 keys, ``fold_in`` and the
bits → float maps of ``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable
= True``), so that a seed gives the port the numbers it gives the JAX package.

A key is a pair of Python ints (the two uint32 words of ``PRNGKey``). Words on
a device are int64 lanes masked to 32 bits, as ``ops/keccak_batch.py`` keeps
its lanes: CPU torch ``uint32`` has no add, shift or compare.

In partitionable mode element i of an array of `shape` is
``threefry2x32(key, (hi32(i), lo32(i)))``, its two output words xor-ed, with i
its flat index in the whole shape. ``bits`` and the maps above it take
``start``, the flat index of their first element, so that rows of a large
array can be made a tile at a time and equal the whole array's rows.

The raw bits and the float of each bit pattern are exact. ``erf_inv`` is
XLA's float32 polynomial (M. Giles' approximation, as ``chlo.erf_inv`` lowers
it), not ``torch.erfinv``; its results are within a few float32 ulps of
JAX's, not bit-equal (the order of XLA's fused products and its ``log1p``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA
SQRT2_F32 = float(np.float32(np.sqrt(2)))


# -- threefry2x32 ------------------------------------------------------------------


def threefry2x32(key: tuple[int, int], x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32 with 20 rounds (jax ``_threefry2x32_lowering``) on the
    counter words (x0, x1), int64 tensors of words, in place: x0 and x1 are
    overwritten with the two output words and returned."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0.add_(ks[0]).bitwise_and_(MASK)
    x1.add_(ks[1]).bitwise_and_(MASK)
    tmp = torch.empty_like(x1)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(x1).bitwise_and_(MASK)
            # x1 = rotl(x1, r) ^ x0, the words below 2^32 so >> is logical
            torch.bitwise_right_shift(x1, 32 - r, out=tmp)
            x1.bitwise_left_shift_(r).bitwise_and_(MASK).bitwise_or_(tmp).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(MASK)
        x1.add_(ks[(i + 2) % 3] + i + 1).bitwise_and_(MASK)
    return x0, x1


# -- keys ----------------------------------------------------------------------------


def PRNGKey(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` with 64-bit types off (JAX's default):
    the seed's low 32 bits under a zero high word."""
    return 0, int(seed) & MASK


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a uint32 `data`:
    ``threefry2x32(key, (0, data))``."""
    x0, x1 = threefry2x32(key, torch.zeros(1, dtype=torch.int64),
                          torch.tensor([int(data) & MASK], dtype=torch.int64))
    return int(x0), int(x1)


def key_data(key) -> np.ndarray:
    """The key's words as ``jax.random.key_data`` gives them."""
    return np.array(key, np.uint32)


# -- bits and floats -------------------------------------------------------------------


def bits(key: tuple[int, int], shape, device="cuda", start: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32-bit) as int64 words of `shape`;
    `start` is the flat index in the whole array of the first element."""
    n = math.prod(shape)
    idx = torch.arange(start, start + n, dtype=torch.int64, device=device)
    hi = idx >> 32
    lo = idx.bitwise_and_(MASK)
    x0, x1 = threefry2x32(key, hi, lo)
    return x0.bitwise_xor_(x1).reshape(shape)


def _unit_floats(words: torch.Tensor) -> torch.Tensor:
    """The float32 in [0, 1) of each word's top 23 bits, as jax's ``_uniform``
    makes it: the mantissa under an exponent of 1, less 1."""
    pattern = (words >> 9).bitwise_or_(0x3F800000).to(torch.int32)
    return pattern.view(torch.float32) - 1.0


def uniform(key, shape, minval=0.0, maxval=1.0, device="cuda", start: int = 0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``. XLA fuses
    ``floats * (maxval - minval) + minval`` into one fused multiply-add; here
    the product of two float32s is exact in float64, so the float64 sum
    rounded to float32 gives the same floats."""
    lo = np.float32(minval)
    scale = float(np.float32(maxval) - lo)
    floats = _unit_floats(bits(key, shape, device, start)).double()
    return floats.mul_(scale).add_(float(lo)).float().clamp_(min=float(lo))


_W_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
          -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_W_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
          -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """float32 erf⁻¹ as XLA computes it (``chlo.erf_inv``, M. Giles'
    single-precision approximation): w = -log1p(-x²); a degree-8 polynomial
    in w - 2.5 (w < 5) or √w - 3; times x; ±inf at ±1."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(small, _W_LT5[0], _W_GE5[0]).to(torch.float32)
    for a, b in zip(_W_LT5[1:], _W_GE5[1:]):
        p = torch.where(small, a, b).to(torch.float32) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


_NEXT_ABOVE_MINUS_1 = float(np.nextafter(np.float32(-1), np.float32(0)))


def normal(key, shape, device="cuda", start: int = 0) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: √2 · erf⁻¹(u), u uniform on
    [nextafter(-1, 0), 1)."""
    u = uniform(key, shape, _NEXT_ABOVE_MINUS_1, 1.0, device, start)
    return SQRT2_F32 * erf_inv(u)


def truncated_normal(key, lower: float, upper: float, shape, device="cuda",
                     start: int = 0) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``:
    √2 · erf⁻¹(u), u uniform on [erf(lower/√2), erf(upper/√2)), clipped to
    the open interval (lower, upper)."""
    sqrt2 = torch.tensor(SQRT2_F32, dtype=torch.float32)
    lo = torch.tensor(lower, dtype=torch.float32)
    hi = torch.tensor(upper, dtype=torch.float32)
    a, b = float(torch.erf(lo / sqrt2)), float(torch.erf(hi / sqrt2))
    u = uniform(key, shape, a, b, device, start)
    out = SQRT2_F32 * erf_inv(u)
    return out.clamp(float(np.nextafter(np.float32(lower), np.float32(np.inf))),
                     float(np.nextafter(np.float32(upper), np.float32(-np.inf))))
