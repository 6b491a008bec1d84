"""rofl_tpu_torch.ops.sc (add, sub, mul and everything built on them) against
rofl_tpu.ops.sc (JAX CPU path) and Python integers. On the CPU the port runs
the plain versions of its sc_mul / sc_add / sc_sub kernels. Tolerance: exact
equality of limbs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.ops import sc as jsc
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import kernels as tkernels
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import scalar as SS

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(252)
L = SS.L
EDGES = [0, 1, L - 1, 2**252, 2, L - 2]
A_INT = [x for x in EDGES for _ in EDGES] + [
    int.from_bytes(rng.bytes(32), "little") % L for _ in range(24)]
B_INT = [y for _ in EDGES for y in EDGES] + [
    int.from_bytes(rng.bytes(32), "little") % L for _ in range(24)]
N = len(A_INT)
A_NP, B_NP = tsc.pack_scalars(A_INT), tsc.pack_scalars(B_INT)
A_T, B_T = tfe.to_tensor(A_NP, "cpu"), tfe.to_tensor(B_NP, "cpu")
A_J, B_J = jnp.asarray(A_NP), jnp.asarray(B_NP)

BINARY = {
    "add": (tsc.add, jsc.add, lambda x, y: (x + y) % L),
    "sub": (tsc.sub, jsc.sub, lambda x, y: (x - y) % L),
    "mul": (tsc.mul, jsc.mul, lambda x, y: x * y % L),
}


def ints(t):
    return tsc.unpack_scalars(t)


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op_equals_jax_and_the_integers(name):
    t_fn, j_fn, want = BINARY[name]
    got = t_fn(A_T, B_T)
    assert got.dtype == tfe.DTYPE and got.shape == (16, N)
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(j_fn(A_J, B_J)))
    assert ints(got) == [want(x, y) for x, y in zip(A_INT, B_INT)]


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op_broadcasts_one_lane(name):
    t_fn, j_fn, want = BINARY[name]
    got = t_fn(A_T, B_T[:, 40:41])
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(j_fn(A_J, B_J[:, 40:41])))
    assert ints(got) == [want(x, B_INT[40]) for x in A_INT]
    assert ints(t_fn(B_T[:, 40:41], A_T)) == [want(B_INT[40], x) for x in A_INT]
    # a constant of shape (16, 1) against a grid
    grid = t_fn(A_T[:, :36].reshape(16, 6, 6), tsc.constant(L - 3, (1, 1), "cpu"))
    assert grid.shape == (16, 6, 6)
    assert ints(grid) == [want(x, L - 3) for x in A_INT[:36]]


def test_mul_takes_any_16_bit_limbs():
    full = np.full((16, 3), 0xFFFF, np.uint32)
    full[:, 1] = rng.integers(0, 1 << 16, 16)
    got = tsc.mul(tfe.to_tensor(full, "cpu"), tfe.to_tensor(full, "cpu"))
    np.testing.assert_array_equal(
        tfe.to_numpy(got), np.asarray(jsc.mul(jnp.asarray(full), jnp.asarray(full))))
    assert ints(got) == [v * v % L for v in tfe.unpack_scalars(full)]


def test_the_plain_versions_are_what_the_cpu_runs():
    for name in ("sc_mul", "sc_add", "sc_sub"):
        wrapper, plain = getattr(tkernels, name), getattr(tkernels, name + "_ref")
        assert torch.equal(wrapper(A_T, B_T), plain(A_T, B_T))
    assert tkernels.LAUNCHES["sc_mul"] == tkernels.LAUNCHES["sc_add"] == 0


def test_neg_constants_and_predicates():
    np.testing.assert_array_equal(tfe.to_numpy(tsc.neg(A_T)), np.asarray(jsc.neg(A_J)))
    assert ints(tsc.neg(A_T)) == [(-x) % L for x in A_INT]
    for v in (0, 1, L - 1, L + 7, -5):
        c = tsc.constant(v, (1,), "cpu")
        assert c.shape == (16, 1)
        np.testing.assert_array_equal(tfe.to_numpy(c), np.asarray(jsc.constant(v, (1,))))
    np.testing.assert_array_equal(tfe.to_numpy(tsc.zeros((3,), "cpu")), np.asarray(jsc.zeros((3,))))
    np.testing.assert_array_equal(tfe.to_numpy(tsc.ones((3,), "cpu")), np.asarray(jsc.ones((3,))))
    assert tsc.is_zero(A_T).tolist() == [x == 0 for x in A_INT]
    assert tsc.is_zero(A_T).tolist() == np.asarray(jsc.is_zero(A_J)).tolist()
    assert tsc.eq(A_T, B_T).tolist() == [x == y for x, y in zip(A_INT, B_INT)]
    assert tsc.eq(A_T, B_T).tolist() == np.asarray(jsc.eq(A_J, B_J)).tolist()


def test_inv():
    cols = [0, 6, 12, 18, 24, 30, 36, 50]  # 0, 1, l-1, 2^252, 2, l-2 and two random ones
    a_t, a_j = A_T[:, cols], A_J[:, np.asarray(cols)]
    got = tsc.inv(a_t)
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(jsc.inv(a_j)))
    assert ints(got) == [pow(A_INT[i], L - 2, L) for i in cols]
    assert ints(tsc.mul(got, a_t)) == [0 if A_INT[i] == 0 else 1 for i in cols]


@pytest.mark.parametrize("n", [1, 2, 5, 16, 60])
def test_sum_reduce_of_any_length(n):
    got = tsc.sum_reduce(A_T[:, :n])
    assert got.shape == (16, 1)
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(jsc.sum_reduce(A_J[:, :n])))
    assert ints(got) == [sum(A_INT[:n]) % L]


def test_sum_reduce_along_an_inner_axis():
    grid_t, grid_j = A_T[:, :60].reshape(16, 3, 4, 5), A_J[:, :60].reshape(16, 3, 4, 5)
    for axis in (0, 1, 2):
        got = tsc.sum_reduce(grid_t, axis=axis)
        want = jsc.sum_reduce(grid_j, axis=axis)
        assert got.shape == tuple(want.shape)
        np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(want))
    ref = np.array(A_INT[:60], dtype=object).reshape(3, 4, 5).sum(axis=1) % L
    assert ints(tsc.sum_reduce(grid_t, axis=1)) == [int(v) for v in ref.reshape(-1)]


@pytest.mark.parametrize("groups,size", [(3, 5), (4, 8), (7, 1), (1, 13), (6, 10)])
def test_sum_reduce_groups_of_any_size(groups, size):
    n = groups * size
    got = tsc.sum_reduce_groups(A_T[:, :n], size)
    assert got.shape == (16, groups)
    np.testing.assert_array_equal(
        tfe.to_numpy(got), np.asarray(jsc.sum_reduce_groups(A_J[:, :n], size)))
    assert ints(got) == [sum(A_INT[g * size:(g + 1) * size]) % L for g in range(groups)]


def test_inner_products():
    got = tsc.inner_product(A_T, B_T)
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(jsc.inner_product(A_J, B_J)))
    assert ints(got) == [sum(x * y for x, y in zip(A_INT, B_INT)) % L]
    got = tsc.inner_product_groups(A_T[:, :15], B_T[:, :15], 5)  # 3 groups of 5
    np.testing.assert_array_equal(
        tfe.to_numpy(got),
        np.asarray(jsc.inner_product_groups(A_J[:, :15], B_J[:, :15], 5)))
    assert ints(got) == [
        sum(x * y for x, y in zip(A_INT[g:g + 5], B_INT[g:g + 5])) % L for g in (0, 5, 10)]


@pytest.mark.parametrize("n", [1, 2, 11, 16])
def test_powers(n):
    x = A_INT[45]
    got = tsc.powers(A_T[:, 45:46], n)
    assert got.shape == (16, n)
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(jsc.powers(A_J[:, 45:46], n)))
    assert ints(got) == [pow(x, i, L) for i in range(n)]
