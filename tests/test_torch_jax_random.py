"""The port's copy of JAX's PRNG (``rofl_tpu_torch.models.jax_random``) and
of Flax's key derivation and initializers (``models.flax_init``) against
``jax.random``, ``jax.nn.initializers`` and ``flax`` themselves, live, at
small shapes (jax 0.9.0, ``jax_threefry_partitionable`` on, as pinned here).

Tolerances: keys, ``fold_in``, raw bits and uniforms are exact (the port
rounds XLA's fused multiply-add through float64, exactly); normals and
truncated normals go through XLA's erf⁻¹ polynomial, whose ``log1p`` and
fused products the port rounds otherwise: within 4 float32 ulps of each
JAX value; the orthogonal initializer's QR runs in another LAPACK: within
1e-5 absolute."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import scope as flax_scope

from rofl_tpu_torch.models import flax_init
from rofl_tpu_torch.models import jax_random as R

torch.set_num_threads(1)
SEEDS = [0, 1, 7, -1, 2**32 - 1, 2**32, 2**40 + 5]  # 64-bit types off: the low 32 bits


def test_threefry_partitionable_is_what_the_tests_pin():
    assert jax.__version__ == "0.9.0" and jax.config.jax_threefry_partitionable


def ulps(got, want):
    return np.max(np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32)))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_in_are_jaxs(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(np.asarray(jax.random.key_data(key))) == R.PRNGKey(seed)
    for data in (0, 1, 12345, 2**32 - 1):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(key, data)))
        np.testing.assert_array_equal(R.key_data(R.fold_in(R.PRNGKey(seed), data)), want)


@pytest.mark.parametrize("shape", [(1,), (7,), (33, 5), (2, 3, 4)])
def test_raw_bits_are_jaxs(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    want = np.asarray(jax.random.bits(key, shape))
    got = R.bits(R.fold_in(R.PRNGKey(3), 11), shape, "cpu")
    assert got.dtype == torch.int64 and got.shape == shape
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_rows_made_a_tile_at_a_time_are_the_whole_arrays_rows():
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.normal(key, (40, 7)))
    whole = R.normal(R.PRNGKey(9), (40, 7), "cpu").numpy()
    tiles = np.concatenate([R.normal(R.PRNGKey(9), (r1 - r0, 7), "cpu", start=r0 * 7).numpy()
                            for r0, r1 in ((0, 13), (13, 26), (26, 40))])
    np.testing.assert_array_equal(tiles, whole)
    assert ulps(whole, want) <= 4


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.3, 2.0), (-1.0, 1.0)])
def test_uniform_is_jaxs(bounds):
    lo, hi = bounds
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (4099,), minval=lo, maxval=hi))
    got = R.uniform(R.PRNGKey(5), (4099,), lo, hi, "cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_normal_and_truncated_normal_within_4_ulps():
    key = jax.random.fold_in(jax.random.PRNGKey(21), 2)
    tkey = R.fold_in(R.PRNGKey(21), 2)
    normal = np.asarray(jax.random.normal(key, (20000,)))
    assert ulps(R.normal(tkey, (20000,), "cpu").numpy(), normal) <= 4
    trunc = np.asarray(jax.random.truncated_normal(key, -2.0, 2.0, (20000,)))
    got = R.truncated_normal(tkey, -2.0, 2.0, (20000,), "cpu").numpy()
    assert ulps(got, trunc) <= 4 and np.all(np.abs(got) < 2)


def test_erf_inv_is_xlas_polynomial_within_4_ulps():
    x = np.linspace(-1, 1, 20001).astype(np.float32)
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(x)))
    got = R.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[[0, -1]], want[[0, -1]])  # -inf, inf
    assert ulps(got[1:-1], want[1:-1]) <= 4


@pytest.mark.parametrize("fix_separator", [False, True])
@pytest.mark.parametrize("suffix", [("Dense_0", 1), ("ResNetBlock_3", "Conv_2", 1),
                                    ("OptimizedLSTMCell_1", "hf", 2), (300,)])
def test_flax_static_fold_in(suffix, fix_separator):
    before = flax_scope.config.flax_fix_rng_separator
    flax_scope.config.update("flax_fix_rng_separator", fix_separator)
    try:
        want = np.asarray(jax.random.key_data(
            flax_scope._fold_in_static(jax.random.PRNGKey(4), suffix)))
    finally:
        flax_scope.config.update("flax_fix_rng_separator", before)
    np.testing.assert_array_equal(
        R.key_data(flax_init.fold_in_static(R.PRNGKey(4), suffix, fix_separator)), want)


INITS = [
    ("lecun_normal", jax.nn.initializers.lecun_normal(), (784, 24)),
    ("lecun_normal", jax.nn.initializers.lecun_normal(), (5, 5, 3, 6)),
    ("embed_normal", jax.nn.initializers.variance_scaling(1.0, "fan_in", "normal", out_axis=0),
     (90, 8)),
    ("orthogonal", jax.nn.initializers.orthogonal(), (16, 16)),
    ("orthogonal", jax.nn.initializers.orthogonal(), (8, 12)),
    ("orthogonal", jax.nn.initializers.orthogonal(), (12, 8)),
]


@pytest.mark.parametrize("name,init,shape", INITS,
                         ids=[f"{name}-{'x'.join(map(str, shape))}" for name, _, shape in INITS])
def test_initializers(name, init, shape):
    want = np.asarray(init(jax.random.PRNGKey(8), shape))
    got = flax_init.INITIALIZERS[name](R.PRNGKey(8), shape, "cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if name == "orthogonal":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert ulps(got, want) <= 4
