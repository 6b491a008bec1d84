"""rofl_tpu_torch.ops.fe against rofl_tpu.ops.fe (JAX on the CPU, jnp path)
and against the pure-Python spec. Same inputs on both sides, made from a
seed with numpy; tolerance: exact equality of limbs, masks and bytes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.ops import fe as jfe
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.spec import field as SF

P = SF.P
torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(1234)

# Weakly reduced extremes first: every fully carried 256-bit value is legal.
EDGES = [0, 1, 2, 19, 38, P - 1, P, P + 1, 2 * P - 1, 2 * P, 2 * P + 37,
         2**255 - 1, 2**255, 2**256 - 39, 2**256 - 38, 2**256 - 1]
A_INTS = EDGES + [int.from_bytes(rng.bytes(32), "little") for _ in range(24)] + EDGES
B_INTS = EDGES[::-1] + [int.from_bytes(rng.bytes(32), "little") for _ in range(24)] + EDGES
A_NP = tfe.pack_scalars(A_INTS)
B_NP = tfe.pack_scalars(B_INTS)
N = len(A_INTS)


def J(a):
    return jnp.asarray(np.asarray(a, dtype=np.uint32))


def T(a):
    return tfe.to_tensor(a, "cpu")


def same(t_out, j_out):
    """Exact equality of a port result and a JAX result (limbs or masks)."""
    t_np = t_out.numpy()
    j_np = np.asarray(j_out)
    assert t_np.shape == j_np.shape
    np.testing.assert_array_equal(t_np.astype(np.int64), j_np.astype(np.int64))


BINARY = {
    "add": (lambda a, b: (a + b) % P),
    "sub": (lambda a, b: (a - b) % P),
    "mul": (lambda a, b: (a * b) % P),
}
UNARY = {
    "neg": (lambda a: (-a) % P),
    "sqr": (lambda a: (a * a) % P),
    "inv": SF.finv,
    "pow_p58": SF.fpow_p58,
    "canonicalize": (lambda a: a % P),
    "cabs": SF.fabs,
}


def test_limb_dtype_is_int32_on_the_cpu():
    assert T(A_NP).dtype == torch.int32 == tfe.DTYPE


@pytest.mark.parametrize("name", sorted(BINARY))
def test_binary_op(name):
    got = getattr(tfe, name)(T(A_NP), T(B_NP))
    assert got.dtype == tfe.DTYPE
    same(got, getattr(jfe, name)(J(A_NP), J(B_NP)))
    want = [BINARY[name](a, b) for a, b in zip(A_INTS, B_INTS)]
    assert [v % P for v in tfe.unpack_scalars(got)] == want


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_op(name):
    got = getattr(tfe, name)(T(A_NP))
    assert got.dtype == tfe.DTYPE
    same(got, getattr(jfe, name)(J(A_NP)))
    assert [v % P for v in tfe.unpack_scalars(got)] == [UNARY[name](a % P) for a in A_INTS]


def test_canonicalize_is_below_p():
    assert all(v < P for v in tfe.unpack_scalars(tfe.canonicalize(T(A_NP))))


@pytest.mark.parametrize("c", [1, 2, 38, 2047])
def test_mul_small(c):
    got = tfe.mul_small(T(A_NP), c)
    same(got, jfe.mul_small(J(A_NP), c))
    assert [v % P for v in tfe.unpack_scalars(got)] == [(a * c) % P for a in A_INTS]


def test_mul_broadcasts_a_constant():
    k = tfe.constant(SF.SQRT_M1, (N,), "cpu")
    assert k.shape == (16, 1)
    same(tfe.mul(T(A_NP), k), jfe.mul(J(A_NP), jfe.constant(SF.SQRT_M1, (N,))))


@pytest.mark.parametrize("name", ["eq", "is_zero", "is_negative"])
def test_predicates(name):
    args_np = (A_NP, B_NP) if name == "eq" else (A_NP,)
    got = getattr(tfe, name)(*[T(a) for a in args_np])
    assert got.dtype == torch.bool
    same(got, getattr(jfe, name)(*[J(a) for a in args_np]))
    if name == "eq":
        want = [a % P == b % P for a, b in zip(A_INTS, B_INTS)]
        assert any(want) and not all(want)
    elif name == "is_zero":
        want = [a % P == 0 for a in A_INTS]
    else:
        want = [SF.is_negative(a) for a in A_INTS]
    assert got.tolist() == want


def test_select():
    cond = np.arange(N) % 3 == 0
    got = tfe.select(torch.from_numpy(cond), T(A_NP), T(B_NP))
    same(got, jfe.select(jnp.asarray(cond), J(A_NP), J(B_NP)))
    assert tfe.unpack_scalars(got) == [a if c else b for c, a, b in zip(cond, A_INTS, B_INTS)]


def test_sqrt_ratio_m1():
    t_sq, t_r = tfe.sqrt_ratio_m1(T(A_NP), T(B_NP))
    j_sq, j_r = jfe.sqrt_ratio_m1(J(A_NP), J(B_NP))
    same(t_sq, j_sq)
    same(t_r, j_r)
    want = [SF.sqrt_ratio_m1(a, b) for a, b in zip(A_INTS, B_INTS)]
    assert t_sq.tolist() == [w[0] for w in want]
    assert [v % P for v in tfe.unpack_scalars(t_r)] == [w[1] for w in want]
    assert any(t_sq.tolist()) and not all(t_sq.tolist())


def test_sqrt_ratio_m1_of_one_over_v():
    """The form compress and decompress use: u is the broadcast constant 1."""
    one_t = tfe.ones((N,), "cpu")
    t_sq, t_r = tfe.sqrt_ratio_m1(one_t, T(B_NP))
    j_sq, j_r = jfe.sqrt_ratio_m1(jfe.ones((N,)), J(B_NP))
    same(t_sq, j_sq)
    same(t_r, j_r)


def test_constants_zeros_ones():
    same(tfe.zeros((5,), "cpu"), jfe.zeros((5,)))
    same(tfe.ones((5,), "cpu"), jfe.ones((5,)))
    same(tfe.constant(SF.D2, (5,), "cpu"), jfe.constant(SF.D2, (5,)))
    assert tfe.unpack_scalars(tfe.constant(SF.D, (), "cpu")) == [SF.D]


def test_pack_unpack_scalars():
    np.testing.assert_array_equal(A_NP, jfe.pack_scalars(A_INTS))
    assert A_NP.dtype == np.uint32 and A_NP.shape == (16, N)
    assert tfe.unpack_scalars(A_NP) == A_INTS == jfe.unpack_scalars(A_NP)
    assert tfe.unpack_scalars(T(A_NP)) == A_INTS


def test_bytes_codecs():
    raw = np.frombuffer(rng.bytes(32 * N), np.uint8).reshape(N, 32).copy()
    raw[0] = 0xFF  # top bit set and value >= p: masked, not reduced
    limbs = tfe.from_bytes_array(raw)
    np.testing.assert_array_equal(limbs, jfe.from_bytes_array(raw))
    assert tfe.unpack_scalars(limbs) == [SF.from_bytes(bytes(r)) for r in raw]
    out = tfe.to_bytes_array(T(A_NP))
    np.testing.assert_array_equal(out, jfe.to_bytes_array(A_NP))
    assert [bytes(r) for r in out] == [SF.to_bytes(a) for a in A_INTS]
    np.testing.assert_array_equal(tfe.to_bytes_array(A_NP), out)


def test_to_tensor_to_numpy_roundtrip():
    t = tfe.to_tensor(A_NP, "cpu")
    back = tfe.to_numpy(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, A_NP)
