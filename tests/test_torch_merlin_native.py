"""The native STROBE helper of the port's Merlin transcripts
(``csrc/keccak.c`` through ``utils/native.py``) against the pure-Python loops
of ``spec/merlin.py`` and ``spec/keccak.py``, on the CPU.

Absorbs, overwrites and squeezes that start at every offset near the
166-byte rate and straddle it, the permutation alone, ``append_messages``
against a loop of ``append_message`` and against the JAX package's
transcript. Tolerance: none; states, positions and bytes are equal.
"""

import numpy as np
import pytest

from rofl_tpu.spec.merlin import Transcript as JaxTranscript
from rofl_tpu_torch.spec import keccak
from rofl_tpu_torch.spec import merlin as M
from rofl_tpu_torch.utils import native

rng = np.random.default_rng(166)


def random_state() -> bytearray:
    return bytearray(rng.bytes(200))


def test_permutation_equals_the_python_one():
    for _ in range(8):
        a = random_state()
        b = bytearray(a)
        native.keccak_f1600(a)
        keccak.keccak_f1600(b)
        assert a == b


@pytest.mark.parametrize("op", ["absorb", "overwrite", "squeeze"])
def test_sponge_loops_equal_the_python_ones_across_the_rate(op):
    for pos in (0, 1, 100, 164, 165):
        for length in (0, 1, 2, 165, 166, 167, 333, 500):
            state = random_state()
            pos_begin = int(rng.integers(0, 166))
            data = rng.bytes(length)
            a, b = bytearray(state), bytearray(state)
            if op == "squeeze":
                got = native.strobe_squeeze(a, pos, pos_begin, length, M.STROBE_R)
                want = M.squeeze_py(b, pos, pos_begin, length)
            else:
                got = getattr(native, f"strobe_{op}")(a, pos, pos_begin, data, M.STROBE_R)
                want = getattr(M, f"{op}_py")(b, pos, pos_begin, data)
            assert got == want and a == b, (pos, length)


def test_bytes_ff_and_zero_pass_unchanged():
    for fill in (b"\xff", b"\x00"):
        a = random_state()
        b = bytearray(a)
        data = fill * 400
        assert native.strobe_absorb(a, 7, 3, data, M.STROBE_R) == M.absorb_py(b, 7, 3, data)
        assert a == b


@pytest.mark.parametrize("msg_len", [0, 32, 64, 200])
def test_append_messages_equals_a_loop_of_append_message(msg_len):
    msgs = [rng.bytes(msg_len) for _ in range(37)]
    bulk, loop, jax_t = M.Transcript(b"RangeProof"), M.Transcript(b"RangeProof"), JaxTranscript(
        b"RangeProof")
    for t in (bulk, loop, jax_t):
        t.append_message(b"dom-sep", b"rangeproof v1")
    bulk.append_messages(b"V", msgs)
    for m in msgs:
        loop.append_message(b"V", m)
        jax_t.append_message(b"V", m)
    assert bulk.strobe.state == loop.strobe.state
    assert (bulk.strobe.pos, bulk.strobe.pos_begin, bulk.strobe.cur_flags) == (
        loop.strobe.pos, loop.strobe.pos_begin, loop.strobe.cur_flags)
    assert (bulk.challenge_scalar(b"y") == loop.challenge_scalar(b"y")
            == jax_t.challenge_scalar(b"y"))


def test_append_messages_refuses_messages_of_different_lengths():
    with pytest.raises(ValueError):
        M.Transcript(b"x").append_messages(b"V", [b"ab", b"abc"])


def test_transcript_matches_the_jax_package():
    ours, theirs = M.Transcript(b"RangeProof"), JaxTranscript(b"RangeProof")
    for label, size in ((b"a", 0), (b"b", 165), (b"c", 1000), (b"d", 32)):
        msg = rng.bytes(size)
        ours.append_message(label, msg)
        theirs.append_message(label, msg)
        assert ours.challenge_bytes(b"c", 64) == theirs.challenge_bytes(b"c", 64)
    ours.append_u64(b"n", 2 ** 40 + 3)
    theirs.append_u64(b"n", 2 ** 40 + 3)
    assert ours.challenge_scalar(b"u") == theirs.challenge_scalar(b"u")


def test_the_helper_is_built_into_the_build_directory():
    path = native.library_path()
    native.lib()
    assert path.exists() and path.parent == native.BUILD_DIR
