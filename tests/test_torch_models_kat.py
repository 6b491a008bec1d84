"""Known answers of the JAX package's trainer, kept honest.

A tier-1 test compiles no full network, so the port's model tests
(tests/test_torch_models.py, and ``chip_smoke.py``'s ``train`` phase on the
card) read the JAX side from ``tests/data/torch_port_models_kat.npz``.
``make_kat`` computes it with ``rofl_tpu.models.trainer.Trainer`` from fixed
seeds, for each case of ``CASES``:

  theta0     ``ravel_pytree(module.init(PRNGKey(seed), x))``, once a network
             (``theta0/<model>``)
  w0         for an intrinsic case, the z a step starts from (seeded, of
             scale 0.01); the other cases start from theta0
  w1         ``Trainer.train(ROUND)`` from w0 (the shard holds one batch of
             32, so one SGD step on ``default_rng(ROUND).permutation``)
  loss0      the step's loss on that batch at w0
  eval       ``Trainer.evaluate()`` at w0 (loss, accuracy); absent for
             shakespeare, where the JAX trainer raises (reference hazard 9)
  project    ``intrinsic.project(z, D, seed)`` and ``project_transpose`` of a
             seeded g, for the small intrinsic case

and ``meta/*``, the seeds and sizes the file was made with. mnist_dev,
mnist_cnn and cifar_lenet5 at full width; ResNet18 at width 32
with one block in each of two stages (the stride-2 block and its
projection); CharLSTM at hidden 16; mnist_dev on emnist (47 classes on a
10-class network: a NaN loss, reference hazard 10); mnist_dev_intrinsic at
d = 8 (the CPU tests) and d = 5000 (``configs/mnist_range_e2e.yml``; the
card checks it in ``chip_smoke.py``).

Regenerate the file with

    JAX_PLATFORMS=cpu python tests/test_torch_models_kat.py

(about a minute). The one test here, marked ``slow``, recomputes it and
asserts that the committed file still equals what the JAX package gives.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

import numpy as np
import pytest

KAT_PATH = Path(__file__).resolve().parent / "data" / "torch_port_models_kat.npz"
SEED = 0
ROUND = 3
BATCH = 32
CLIENTS = 64  # 2048 synthetic samples / 64 = one batch of 32 a shard
CLIENT_ID = 5
Z_SCALE = 0.01

# name → (model, dataset, intrinsic_dim); "_small" models are registered with
# reduced width and depth (``small_models``)
CASES = {
    "mnist_dev": ("mnist_dev", "mnist", None),
    "mnist_cnn": ("mnist_cnn", "mnist", None),
    "cifar_lenet5": ("cifar_lenet5", "cifar10", None),
    "resnet18_small": ("resnet18_small", "cifar10", None),
    "shakespeare_small": ("shakespeare_small", "shakespeare", None),
    "mnist_dev_emnist": ("mnist_dev", "emnist", None),
    "mnist_dev_intrinsic_8": ("mnist_dev_intrinsic", "mnist", 8),
    "mnist_dev_intrinsic_5000": ("mnist_dev_intrinsic", "mnist", 5000),
}
PROJECT_CASE = "mnist_dev_intrinsic_8"


def small_models(networks):
    """The reduced networks, by registry name, for either package's
    ``networks`` module (both take the same constructor arguments)."""
    return {
        "resnet18_small": lambda: (networks.ResNet18(width=32, stage_sizes=(1, 1)),
                                   (1, 32, 32, 3)),
        "shakespeare_small": lambda: (networks.CharLSTM(hidden=16), (1, 80)),
    }


def z0(d: int) -> np.ndarray:
    return (np.random.default_rng(100 + d).standard_normal(d) * Z_SCALE).astype(np.float32)


def first_batch(trainer):
    order = np.random.default_rng(ROUND).permutation(len(trainer.x))
    idx = order[:BATCH]
    return trainer.x[idx], trainer.y[idx]


def make_kat() -> dict:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from rofl_tpu.models import intrinsic as JI
    from rofl_tpu.models import networks as JN
    from rofl_tpu.models import trainer as JT

    JN.MODEL_REGISTRY.update(small_models(JN))
    out = {"meta/seed": np.array(SEED), "meta/round": np.array(ROUND),
           "meta/batch": np.array(BATCH), "meta/clients": np.array(CLIENTS),
           "meta/client_id": np.array(CLIENT_ID)}
    for name, (model, dataset, dim) in CASES.items():
        t = JT.Trainer(model, dataset, client_id=CLIENT_ID, num_clients=CLIENTS,
                       batch_size=BATCH, seed=SEED, intrinsic_dim=dim)
        theta0 = np.asarray(t.intrinsic.theta0 if dim else t.weights, np.float32)
        w0 = z0(dim) if dim else theta0.copy()
        xb, yb = first_batch(t)
        _, loss0 = t._step(jnp.asarray(w0), jnp.asarray(xb), jnp.asarray(yb))
        t.set_weights(w0)
        if dataset != "shakespeare":
            out[f"{name}/eval"] = np.array(t.evaluate(), np.float64)
        t.set_weights(w0)
        out[f"{name}/w1"] = np.asarray(t.train(ROUND), np.float32)
        out[f"theta0/{model.split('_intrinsic')[0]}"] = theta0
        if dim:
            out[f"{name}/w0"] = w0
        out[f"{name}/loss0"] = np.array(float(loss0), np.float64)
        if name == PROJECT_CASE:
            g = np.random.default_rng(7).standard_normal(t.full_dim).astype(np.float32)
            out[f"{name}/project"] = np.asarray(JI.project(jnp.asarray(w0), t.full_dim,
                                                           SEED + 1))
            out[f"{name}/g"] = g
            out[f"{name}/project_transpose"] = np.asarray(
                JI.project_transpose(jnp.asarray(g), dim, SEED + 1))
    return out


@pytest.mark.slow
def test_committed_kat_is_what_the_jax_trainer_gives():
    committed = np.load(KAT_PATH)
    fresh = make_kat()
    assert sorted(committed.files) == sorted(fresh)
    for key, value in fresh.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    KAT_PATH.parent.mkdir(exist_ok=True)
    np.savez_compressed(KAT_PATH, **make_kat())
    print(f"wrote {KAT_PATH} ({KAT_PATH.stat().st_size} bytes)")
