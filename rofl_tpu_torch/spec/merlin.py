"""Merlin transcripts (STROBE-128 over Keccak-f[1600]) — bit-exact.

Reimplements the `merlin 3` crate's Strobe128 + Transcript so that
Fiat-Shamir challenges match the reference's proofs byte-for-byte
(rofl_crypto uses merlin everywhere: rand_proof/transcript.rs:19-45,
range_proof_vec/mod.rs:124, bulletproofs internally). The port's own copy of
``rofl_tpu.spec.merlin``. It is the oracle that ``crypto/batch_transcript.py``
is held against, and the per-proof transcript of the range proofs, where the
verifier absorbs 2^16 commitments at d = 50000: the sponge's byte loops and
its permutation run in the native helper (``utils/native.py``,
``csrc/keccak.c``). The pure-Python loops below (``absorb_py``,
``overwrite_py``, ``squeeze_py`` on ``spec/keccak.py``) are what the tests
hold the helper against.

STROBE operations used by Merlin: meta-AD, AD, PRF, KEY.
"""

from __future__ import annotations

from ..utils import native
from .keccak import keccak_f1600 as keccak_f1600_py

STROBE_R = 166  # sponge rate for security level 128: 200 - 32 - 2

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_T = 1 << 3
FLAG_M = 1 << 4
FLAG_K = 1 << 5


def _run_f_py(state: bytearray, pos: int, pos_begin: int) -> None:
    state[pos] ^= pos_begin
    state[pos + 1] ^= 0x04
    state[STROBE_R + 1] ^= 0x80
    keccak_f1600_py(state)


def absorb_py(state: bytearray, pos: int, pos_begin: int, data: bytes) -> tuple[int, int]:
    """The STROBE absorb loop in pure Python → (pos, pos_begin)."""
    for byte in data:
        state[pos] ^= byte
        pos += 1
        if pos == STROBE_R:
            _run_f_py(state, pos, pos_begin)
            pos, pos_begin = 0, 0
    return pos, pos_begin


def overwrite_py(state: bytearray, pos: int, pos_begin: int, data: bytes) -> tuple[int, int]:
    for byte in data:
        state[pos] = byte
        pos += 1
        if pos == STROBE_R:
            _run_f_py(state, pos, pos_begin)
            pos, pos_begin = 0, 0
    return pos, pos_begin


def squeeze_py(state: bytearray, pos: int, pos_begin: int, n: int) -> tuple[bytes, int, int]:
    out = bytearray(n)
    for i in range(n):
        out[i] = state[pos]
        state[pos] = 0
        pos += 1
        if pos == STROBE_R:
            _run_f_py(state, pos, pos_begin)
            pos, pos_begin = 0, 0
    return bytes(out), pos, pos_begin


class Strobe128:
    """STROBE-128/1600, the subset merlin's strobe.rs implements; the sponge
    runs in the native helper."""

    def __init__(self, protocol_label: bytes):
        st = bytearray(200)
        st[0:6] = bytes([1, STROBE_R + 2, 1, 0, 1, 96])
        st[6:18] = b"STROBEv1.0.2"
        native.keccak_f1600(st)
        self.state = st
        self.pos = 0
        self.pos_begin = 0
        self.cur_flags = 0
        self.meta_ad(protocol_label, False)

    # -- the sponge underneath ---------------------------------------------

    def _run_f(self) -> None:
        self.state[self.pos] ^= self.pos_begin
        self.state[self.pos + 1] ^= 0x04
        self.state[STROBE_R + 1] ^= 0x80
        native.keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _absorb(self, data: bytes) -> None:
        self.pos, self.pos_begin = native.strobe_absorb(
            self.state, self.pos, self.pos_begin, data, STROBE_R)

    def _overwrite(self, data: bytes) -> None:
        self.pos, self.pos_begin = native.strobe_overwrite(
            self.state, self.pos, self.pos_begin, data, STROBE_R)

    def _squeeze(self, n: int) -> bytes:
        out, self.pos, self.pos_begin = native.strobe_squeeze(
            self.state, self.pos, self.pos_begin, n, STROBE_R)
        return out

    def _begin_op(self, flags: int, more: bool) -> None:
        if more:
            assert self.cur_flags == flags, "Cannot continue op with different flags"
            return
        assert flags & FLAG_T == 0, "T flag not supported"
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        force_f = bool(flags & (FLAG_C | FLAG_K))
        if force_f and self.pos != 0:
            self._run_f()

    # -- public ops (merlin strobe.rs) ------------------------------------

    def meta_ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool) -> bytes:
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)

    def key(self, data: bytes, more: bool) -> None:
        self._begin_op(FLAG_A | FLAG_C, more)
        self._overwrite(data)

    def clone(self) -> "Strobe128":
        s = object.__new__(Strobe128)
        s.state = bytearray(self.state)
        s.pos = self.pos
        s.pos_begin = self.pos_begin
        s.cur_flags = self.cur_flags
        return s


def _u32le(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    """merlin::Transcript (merlin 3.x), bit-exact."""

    MERLIN_PROTOCOL_LABEL = b"Merlin v1.0"

    def __init__(self, label: bytes):
        self.strobe = Strobe128(self.MERLIN_PROTOCOL_LABEL)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, value: int) -> None:
        self.append_message(label, int(value).to_bytes(8, "little"))

    def append_messages(self, label: bytes, msgs) -> None:
        """``append_message(label, m)`` for each of `msgs`, which all have
        one length, in one native call (the range-proof transcripts absorb
        their 2^16 commitments at d = 50000 so). Bit-identical to the loop."""
        if not msgs:
            return
        msg_len = len(msgs[0])
        blob = b"".join(msgs)
        if len(blob) != msg_len * len(msgs):
            raise ValueError("append_messages: the messages differ in length")
        s = self.strobe
        s.pos, s.pos_begin = native.merlin_absorb_msgs(
            s.state, s.pos, s.pos_begin, label, blob, msg_len, len(msgs), STROBE_R)
        s.cur_flags = FLAG_A

    def append_labeled_messages(self, labels: bytes, label_len: int, blob: bytes,
                                msg_len: int) -> None:
        """``append_message(label_i, msg_i)`` for i = 0, 1, ...: the labels
        are `labels` cut into `label_len`-byte pieces, the messages `blob`
        cut into `msg_len`-byte pieces, as many of each; one native call
        (the compressed rand proof absorbs d commitments, each under a label
        of its own). Bit-identical to the loop."""
        count = len(blob) // msg_len if msg_len else 0
        if len(blob) != msg_len * count or len(labels) != label_len * count:
            raise ValueError("append_labeled_messages: labels and messages do not pair up")
        if not count:
            return
        s = self.strobe
        s.pos, s.pos_begin = native.merlin_absorb_labeled_msgs(
            s.state, s.pos, s.pos_begin, labels, label_len, blob, msg_len, count, STROBE_R)
        s.cur_flags = FLAG_A

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le(n), True)
        return self.strobe.prf(n, False)

    def clone(self) -> "Transcript":
        t = object.__new__(Transcript)
        t.strobe = self.strobe.clone()
        return t

    # -- rofl/bulletproofs transcript protocol sugar ----------------------

    def challenge_scalar(self, label: bytes) -> int:
        """64 challenge bytes reduced wide mod l
        (rand_proof/transcript.rs:40-44; bulletproofs transcript.rs)."""
        from . import scalar as S

        return S.from_bytes_mod_order_wide(self.challenge_bytes(label, 64))
