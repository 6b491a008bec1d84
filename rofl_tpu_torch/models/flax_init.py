"""Flax 0.12.3's parameter keys and initializers in plain torch, enough to
rebuild ``module.init(PRNGKey(seed), x)`` for the networks of
``models/networks.py``.

Key derivation (``flax/core/scope.py``): a child scope keeps its parent's key
and appends its name to a suffix (``LazyRng``); ``make_rng('params')`` in a
scope appends that scope's counter of calls (1 for its first parameter) and
folds the SHA-1 of the whole suffix into the root key at once
(``_fold_in_static``: the first four bytes of the digest, big-endian, through
``fold_in``). Under ``flax_fix_rng_separator`` (off by default) a zero byte
goes before each part.

Initializers (``jax.nn.initializers``): ``lecun_normal`` (a normal truncated
at ±2, scaled by sqrt(1 / fan_in) / 0.87962566103423978), ``zeros``,
``ones``, Embed's ``variance_scaling(1, fan_in, normal, out_axis=0)`` and the
LSTM's ``orthogonal`` (QR of a normal matrix, each column times the sign of
R's diagonal entry). The QR runs in ``torch.linalg.qr``, not LAPACK through
XLA, so the orthogonal kernels agree with Flax's to float32 rounding.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from . import jax_random as R

_LECUN_TRUNCATION = 0.87962566103423978  # stddev of a unit normal truncated at ±2


def fold_in_static(key, data, fix_separator: bool = False):
    """Flax's ``_fold_in_static``: fold the SHA-1 of `data` (strings and
    non-negative ints) into `key`."""
    if not data:
        return key
    m = hashlib.sha1()
    for x in data:
        if fix_separator:
            m.update(b"\00")
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        elif isinstance(x, int):
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
        else:
            raise ValueError(f"Expected int or string, got: {x}")
    return R.fold_in(key, int.from_bytes(m.digest()[:4], byteorder="big"))


def param_key(root, scope_path: tuple, counter: int, fix_separator: bool = False):
    """The key of the `counter`-th ``make_rng('params')`` (from 1) in the
    scope at `scope_path` under the root key."""
    return fold_in_static(root, (*scope_path, counter), fix_separator)


def compute_fans(shape, in_axis: int = -2, out_axis: int = -1) -> tuple[float, float]:
    """``jax.nn.initializers._compute_fans``, in the same float arithmetic."""
    in_size, out_size = shape[in_axis], shape[out_axis]
    receptive_field_size = math.prod(shape) / in_size / out_size / 1
    return in_size * receptive_field_size, out_size * receptive_field_size


def lecun_normal(key, shape, device="cuda") -> torch.Tensor:
    fan_in, _ = compute_fans(shape)
    variance = np.float32(1.0 / fan_in)
    stddev = float(np.sqrt(variance) / np.float32(_LECUN_TRUNCATION))
    return R.truncated_normal(key, -2.0, 2.0, shape, device) * stddev


def embed_normal(key, shape, device="cuda") -> torch.Tensor:
    """``variance_scaling(1.0, 'fan_in', 'normal', out_axis=0)``, Flax
    Embed's default."""
    fan_in, _ = compute_fans(shape, in_axis=-2, out_axis=0)
    return R.normal(key, shape, device) * float(np.sqrt(np.float32(1.0 / fan_in)))


def orthogonal(key, shape, device="cuda") -> torch.Tensor:
    """``orthogonal()`` (scale 1, column axis -1) for a 2-D shape."""
    n_rows, n_cols = shape
    z = R.normal(key, (max(n_rows, n_cols), min(n_rows, n_cols)), device)
    q, r = torch.linalg.qr(z)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    return q.T.contiguous() if n_rows < n_cols else q


def zeros(key, shape, device="cuda") -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def ones(key, shape, device="cuda") -> torch.Tensor:
    return torch.ones(shape, dtype=torch.float32, device=device)


INITIALIZERS = {"lecun_normal": lecun_normal, "embed_normal": embed_normal,
                "orthogonal": orthogonal, "zeros": zeros, "ones": ones}
