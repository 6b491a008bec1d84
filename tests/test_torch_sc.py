"""The blinding sampler's device path: rofl_tpu_torch.ops.keccak_batch, the
wide reduction mod l and the keyed XOF, against their rofl_tpu counterparts
(JAX CPU path), hashlib and Python integers. Tolerance: exact equality."""

import hashlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.crypto import pedersen as jpedersen
from rofl_tpu.ops import keccak_batch as jkeccak
from rofl_tpu.ops import sc as jsc
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import keccak_batch as tkeccak
from rofl_tpu_torch.ops import kernels as tkernels
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import scalar as SS

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(1600)
N = 77
L = SS.L
WIDE = [0, 1, L - 1, L, L + 1, 2 * L, 2**252 - 1, 2**252, 2**256 - 1, 2**512 - 1,
        2**512 - 2**252, (2**260 - 1) << 252, L * (2**512 // L), L * (2**512 // L) - 1,
        2**511] + [int.from_bytes(rng.bytes(64), "little") for _ in range(N - 15)]


def byte_cols(values):
    return np.array([list(v.to_bytes(64, "little")) for v in values], np.int32).T.copy()


def test_reduce_wide_bytes_equals_jax_and_the_integers():
    cols = byte_cols(WIDE)
    got = tsc.reduce_wide_bytes(torch.from_numpy(cols))
    assert got.dtype == tfe.DTYPE and got.shape == (16, N)
    want = jsc._reduce_wide_bytes_jnp(jnp.asarray(cols.astype(np.uint32)))
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(want))
    assert tsc.unpack_scalars(got) == [v % L for v in WIDE]


def test_reduce_wide_bytes_of_one_lane_and_the_host_codec():
    cols = byte_cols(WIDE[9:10])
    got = tkernels.sc_reduce_wide(torch.from_numpy(cols))
    assert got.shape == (16, 1) and tsc.unpack_scalars(got) == [WIDE[9] % L]
    raw = np.ascontiguousarray(byte_cols(WIDE).T.astype(np.uint8))
    np.testing.assert_array_equal(
        tsc.from_bytes_wide_array(raw),
        tfe.to_numpy(tsc.reduce_wide_bytes(torch.from_numpy(byte_cols(WIDE)))))


def random_states(n):
    words = rng.integers(0, 1 << 32, size=(50, n), dtype=np.uint64).astype(np.uint32)
    words[:, 0] = 0
    words[:, 1] = 0xFFFFFFFF
    return words


def test_keccak_f1600_equals_the_jax_permutation():
    words = random_states(N)  # the JAX layout: lane l = rows 2l (low), 2l + 1 (high)
    wide = words.astype(np.uint64)
    state = torch.from_numpy((wide[0::2] | (wide[1::2] << np.uint64(32))).view(np.int64))
    got = tkeccak.keccak_f1600(state)
    assert got.shape == (25, N) and got.dtype == torch.int64
    lanes = got.numpy().view(np.uint64)
    out = np.empty((50, N), np.uint32)
    out[0::2] = lanes & np.uint64(0xFFFFFFFF)
    out[1::2] = lanes >> np.uint64(32)
    np.testing.assert_array_equal(out, jkeccak.keccak_f1600_np(words))


@pytest.mark.parametrize("msg", [b"", b"abc", bytes(range(135))])
def test_keccak_f1600_gives_sha3_256(msg):
    """One absorbed block of SHA3-256 (rate 136 bytes, padding 0x06 .. 0x80)."""
    block = bytearray(200)
    block[:len(msg)] = msg
    block[len(msg)] ^= 0x06
    block[135] ^= 0x80
    lanes = np.frombuffer(bytes(block), "<i8").reshape(25, 1).copy()
    out = tkeccak.keccak_f1600(torch.from_numpy(lanes)).numpy()
    assert out.astype("<i8").tobytes()[:32] == hashlib.sha3_256(msg).digest()


@pytest.mark.parametrize("n", [1, N])
def test_xof_byte_cols_equal_the_jax_xof(n):
    key = np.random.default_rng(7).bytes(32)
    got = tpedersen.xof_byte_cols(key, n, "cpu")
    assert got.dtype == tfe.DTYPE and got.shape == (64, n)
    want = jpedersen._xof_byte_cols(
        jnp.asarray(np.frombuffer(key, np.uint8).astype(np.uint32)), n)
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(want))
    assert len({bytes(c) for c in tfe.to_numpy(got).T.astype(np.uint8)}) == n


def test_device_sampler_composition_equals_jax():
    """What rnd_scalar_limbs computes on the card, run on the CPU: key drawn
    from the rng, XOF, wide reduction. The JAX side runs the same three steps
    through its jnp path."""
    t_rng, j_rng = np.random.default_rng(17), np.random.default_rng(17)
    got = tsc.reduce_wide_bytes(tpedersen.xof_byte_cols(t_rng.bytes(32), N, "cpu"))
    key = jnp.asarray(np.frombuffer(j_rng.bytes(32), np.uint8).astype(np.uint32))
    want = jsc._reduce_wide_bytes_jnp(jpedersen._xof_byte_cols(key, N))
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(want))
    assert all(v < L for v in tsc.unpack_scalars(got))


def test_xof_refuses_a_short_key_and_the_sampler_needs_its_card():
    with pytest.raises(ValueError):
        tpedersen.xof_byte_cols(b"short", 4, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tpedersen.rnd_scalar_limbs(4, np.random.default_rng(1))
