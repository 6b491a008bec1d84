"""rofl_tpu_torch.crypto.batch_transcript against the port's pure-Python
Merlin (spec/merlin.py), lane by lane, and against
rofl_tpu.crypto.batch_transcript (JAX CPU path): the same appends give the
same challenge bytes and challenge scalars. Tolerance: exact equality."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.crypto.batch_transcript import BatchTranscript as JBatchTranscript
from rofl_tpu.crypto import batch_transcript as jbt
from rofl_tpu.spec import keccak as jkeccak
from rofl_tpu.spec import merlin as jmerlin
from rofl_tpu_torch.crypto import batch_transcript as tbt
from rofl_tpu_torch.crypto.batch_transcript import BatchTranscript
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.spec import keccak as tkeccak
from rofl_tpu_torch.spec import scalar as SS
from rofl_tpu_torch.spec.merlin import Strobe128, Transcript

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(166)
N = 5


def columns(length):
    cols = rng.integers(0, 256, size=(length, N)).astype(np.int32)
    cols[:, 0] = 0
    cols[:, 1] = 255  # every byte's top bit set: shift 56 reaches the int64 sign bit
    return cols


def lane_bytes(cols, i):
    return bytes(cols[:, i].astype(np.uint8))


def test_the_spec_copies_equal_the_jax_package_s():
    state = bytearray(rng.bytes(200))
    a, b = bytearray(state), bytearray(state)
    tkeccak.keccak_f1600(a)
    jkeccak.keccak_f1600(b)
    assert a == b and a != state
    assert tkeccak.sha3_256(b"abc") == jkeccak.sha3_256(b"abc")
    t, j = Transcript(b"label"), jmerlin.Transcript(b"label")
    for x in (t, j):
        x.append_message(b"m", bytes(range(200)))
        x.append_u64(b"n", 2**63 + 5)
    assert t.challenge_bytes(b"c", 300) == j.challenge_bytes(b"c", 300)
    assert t.challenge_scalar(b"s") == j.challenge_scalar(b"s")
    assert t.clone().challenge_bytes(b"d", 8) == t.challenge_bytes(b"d", 8)


def test_merlin_published_vector():
    """merlin's own test vector (transcript.rs, test "equivalence_simple")."""
    t = Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == (
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615")


def test_strobe_key_op_matches():
    s, j = Strobe128(b"proto"), jmerlin.Strobe128(b"proto")
    for x in (s, j):
        x.key(b"k" * 40, False)
        x.ad(b"data", False)
    assert s.prf(64, False) == j.prf(64, False)


# message lengths on both sides of the 166-byte rate; 400 crosses it twice
@pytest.mark.parametrize("length", [1, 7, 32, 64, 130, 165, 166, 167, 400])
def test_batch_transcript_equals_the_spec_and_jax(length):
    first, second = columns(length), columns(9)
    t = BatchTranscript(b"parity", N, "cpu")
    j = JBatchTranscript(b"parity", N)
    for x, conv in ((t, torch.from_numpy), (j, lambda c: jnp.asarray(c.astype(np.uint32)))):
        x.append_message(b"dom-sep", b"randomness proof v1")
        x.append_message(b"first", conv(first))
        x.append_message(b"second", conv(second))
    got = t.challenge_bytes(b"c", 64)
    assert got.dtype == tfe.DTYPE and got.shape == (64, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j.challenge_bytes(b"c", 64)))
    got_long = t.challenge_bytes(b"long", 200)  # a squeeze across the rate boundary
    np.testing.assert_array_equal(got_long.numpy(), np.asarray(j.challenge_bytes(b"long", 200)))
    scalars = t.challenge_scalars(b"s")
    assert scalars.dtype == tfe.DTYPE and scalars.shape == (16, N)
    np.testing.assert_array_equal(tfe.to_numpy(scalars), np.asarray(j.challenge_scalars(b"s")))
    for i in range(N):
        s = Transcript(b"parity")
        s.append_message(b"dom-sep", b"randomness proof v1")
        s.append_message(b"first", lane_bytes(first, i))
        s.append_message(b"second", lane_bytes(second, i))
        assert lane_bytes(got.numpy(), i) == s.challenge_bytes(b"c", 64)
        assert lane_bytes(got_long.numpy(), i) == s.challenge_bytes(b"long", 200)
        want = s.challenge_scalar(b"s")
        assert tfe.unpack_scalars(scalars[:, i:i + 1]) == [want] and want < SS.L


def test_appends_after_a_challenge_and_one_lane():
    """The state keeps going after a squeeze (the read bytes are zeroed), and a
    batch of one lane works."""
    cols = columns(40)[:, 1:2]
    t = BatchTranscript(b"again", 1, "cpu")
    s = Transcript(b"again")
    for round_ in range(3):
        t.append_message(b"m", torch.from_numpy(cols))
        s.append_message(b"m", lane_bytes(cols, 0))
        got = t.challenge_bytes(b"c", 70 + round_)
        assert lane_bytes(got.numpy(), 0) == s.challenge_bytes(b"c", 70 + round_)


def test_byte_column_helpers():
    limbs = rng.integers(0, 1 << 16, size=(16, N)).astype(np.uint32)
    got = tbt.scalar_byte_cols(tfe.to_tensor(limbs, "cpu"))
    assert got.shape == (32, N)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jbt.scalar_byte_cols(jnp.asarray(limbs))))
    raw = tfe.to_numpy(got).T.astype(np.uint8)
    assert [int.from_bytes(bytes(r), "little") for r in raw] == tfe.unpack_scalars(limbs)
    assert torch.equal(tbt.field_byte_cols(tfe.to_tensor(limbs, "cpu")), got)
    both = tbt.concat_cols(got, got[:3])
    assert both.shape == (35, N)
    np.testing.assert_array_equal(
        both.numpy(), np.asarray(jbt.concat_cols(jnp.asarray(got.numpy()),
                                                 jnp.asarray(got.numpy()[:3]))))
