"""Dataset loading — counterpart of ``rofl_tpu.models.data``: ``.npy`` files
when present, deterministic synthetic data otherwise (nothing is fetched).

The port looks for ``<name>_<split>_x.npy`` and ``_y.npy`` under
``ROFL_DATA_DIR`` and ``./data``. The synthetic data is numpy, drawn in the
JAX package's order, so both packages see the same arrays bit for bit.
"""

from __future__ import annotations

import os

import numpy as np


def data_dirs() -> list[str]:
    return [os.environ.get("ROFL_DATA_DIR", ""), "data"]


def _find(name: str):
    for d in data_dirs():
        if not d:
            continue
        x_path = os.path.join(d, f"{name}_x.npy")
        y_path = os.path.join(d, f"{name}_y.npy")
        if os.path.exists(x_path) and os.path.exists(y_path):
            return np.load(x_path), np.load(y_path)
    return None


def _synthetic(shape, n_classes: int, n: int, seed: int):
    """Class-dependent means plus noise, so that accuracy means something
    without the real datasets."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, n_classes, size=n)
    protos = rng.normal(0, 1, size=(n_classes,) + shape).astype(np.float32)
    x = protos[y] + rng.normal(0, 0.8, size=(n,) + shape).astype(np.float32)
    return x.astype(np.float32), y.astype(np.int32)


def load_dataset(name: str, split: str = "train", n_synth: int = 2048, seed: int = 1234):
    """(x, y) for 'mnist' | 'emnist' | 'cifar10' | 'shakespeare' (NHWC images,
    int32 labels; shakespeare: int32 windows of 80 characters)."""
    found = _find(f"{name}_{split}")
    if found is not None:
        return found[0].astype(np.float32), found[1].astype(np.int32)
    seed = seed + (1 if split != "train" else 0)
    if name in ("mnist", "emnist"):
        n_cls = 47 if name == "emnist" else 10
        return _synthetic((28, 28, 1), n_cls, n_synth, seed)
    if name in ("cifar10", "cifar"):
        return _synthetic((32, 32, 3), 10, n_synth, seed)
    if name == "shakespeare":
        # order-1 Markov text; y is the character after the 80-character window
        rng = np.random.default_rng(seed)
        vocab = 90
        trans = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
        stream = np.empty(n_synth + 81, np.int32)
        stream[0] = rng.integers(0, vocab)
        for i in range(1, len(stream)):
            stream[i] = rng.choice(vocab, p=trans[stream[i - 1]])
        idx = np.arange(n_synth)[:, None] + np.arange(80)[None, :]
        x = stream[idx].astype(np.int32)
        y = stream[np.arange(n_synth) + 80]
        return x, y.astype(np.int32)
    raise KeyError(f"unknown dataset {name}")


def client_shard(x, y, client_id: int, num_clients: int):
    """IID shard for client i: the i-th of `num_clients` equal slices."""
    per = len(x) // num_clients
    sl = slice(client_id * per, (client_id + 1) * per)
    return x[sl], y[sl]
