"""N data-parallel Merlin transcripts with a shared static schedule.

Counterpart of ``rofl_tpu.crypto.batch_transcript``. The reference proves
each parameter under its own fresh transcript (`Transcript::new(b"RandProof")`
per element, rand_proof_vec/mod.rs:30-33). Because every element runs the
SAME sequence of appends and challenges (only the absorbed bytes differ), the
STROBE byte positions, flags and permutation points are identical across the
batch: all N sponges advance in lockstep with batched Keccak-f[1600] calls
(``ops/keccak_batch.py``, plain torch) while the schedule itself
(pos / pos_begin / flags) stays static Python.

The state is the Keccak state of ``ops/keccak_batch.py``: (25, N) int64 lane
patterns on the transcript's device from the first byte on. Byte `pos` of the
sponge is bits 8·(pos % 8) .. +7 of lane pos // 8. An int64 shifts right
arithmetically and a byte at shift 56 reaches the sign bit, so every read
masks after the shift and every delta is assembled with ``|`` and ``<<``.

Bit-exact with ``spec/merlin.py`` (which is pinned to merlin's published
vector).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fe, keccak_batch, sc
from ..spec.merlin import (
    FLAG_A, FLAG_C, FLAG_I, FLAG_K, FLAG_M, FLAG_T, STROBE_R, Strobe128,
)


def _u32le_bytes(n: int) -> bytes:
    return int(n).to_bytes(4, "little")


def _lane_constants(byte_values, n_lanes: int) -> np.ndarray:
    """8·n_lanes byte values → the int64 lane patterns that hold them."""
    return np.frombuffer(bytes(byte_values), dtype="<i8").reshape(n_lanes, 1).copy()


class BatchStrobe:
    """Batched STROBE-128; data is (L, N) byte columns or constant bytes."""

    def __init__(self, n: int, template: Strobe128, device="cuda"):
        self.device = torch.device(device)
        lanes = torch.from_numpy(_lane_constants(template.state, 25)).to(self.device)
        self.state = lanes.expand(25, n).contiguous()
        self.shifts = (8 * torch.arange(8, device=self.device)).reshape(1, 8, 1)
        self.n = n
        self.pos = template.pos
        self.pos_begin = template.pos_begin
        self.cur_flags = template.cur_flags

    # -- internals ---------------------------------------------------------

    def _xor_constant(self, pos: int, val: int):
        if val:
            lane, sh = divmod(pos, 8)
            self.state[lane] ^= int.from_bytes(
                (val << (8 * sh)).to_bytes(8, "little"), "little", signed=True)

    def _run_f(self):
        self._xor_constant(self.pos, self.pos_begin)
        self._xor_constant(self.pos + 1, 0x04)
        self._xor_constant(STROBE_R + 1, 0x80)
        self.state = keccak_batch.keccak_f1600(self.state)
        self.pos = 0
        self.pos_begin = 0

    def _xor_segment(self, rows: list):
        """XOR `rows` (byte values: ints and/or (N,) tensors) into the state
        at byte positions pos..pos+len-1, as one XOR over the lanes they
        touch."""
        seg = len(rows)
        if seg == 0:
            return
        l0, off = divmod(self.pos, 8)
        n_lanes = (off + seg + 7) // 8
        pad_back = 8 * n_lanes - off - seg
        if all(isinstance(b, int) for b in rows):
            if not any(rows):
                return
            delta = torch.from_numpy(_lane_constants(
                [0] * off + rows + [0] * pad_back, n_lanes)).to(self.device)
        else:
            zero = torch.zeros(self.n, dtype=torch.int64, device=self.device)
            full = [zero + b if isinstance(b, int) else b.to(torch.int64) for b in rows]
            arr = torch.stack([zero] * off + full + [zero] * pad_back)
            parts = arr.reshape(n_lanes, 8, self.n) << self.shifts
            delta = parts[:, 0]
            for s in range(1, 8):
                delta = delta | parts[:, s]
        self.state[l0:l0 + n_lanes] ^= delta

    def _absorb_iter(self, rows: list):
        i = 0
        while i < len(rows):
            seg = min(STROBE_R - self.pos, len(rows) - i)
            self._xor_segment(rows[i:i + seg])
            self.pos += seg
            i += seg
            if self.pos == STROBE_R:
                self._run_f()

    def _begin_op(self, flags: int, more: bool):
        if more:
            assert self.cur_flags == flags
            return
        assert flags & FLAG_T == 0
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb_iter([old_begin, flags])
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    @staticmethod
    def _iter_data(data) -> list:
        """bytes → list of constant ints; tensor (L, N) → list of rows."""
        if isinstance(data, (bytes, bytearray)):
            return list(data)
        return list(data.unbind(0))

    # -- STROBE ops used by merlin ----------------------------------------

    def meta_ad(self, data, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb_iter(self._iter_data(data))

    def ad(self, data, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb_iter(self._iter_data(data))

    def prf(self, n_bytes: int, more: bool) -> torch.Tensor:
        """Squeeze n_bytes per lane → (n_bytes, N) int32 byte columns; the
        bytes read are zeroed in the state (KEY/PRF semantics)."""
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        chunks = []
        taken = 0
        while taken < n_bytes:
            seg = min(STROBE_R - self.pos, n_bytes - taken)
            l0, off = divmod(self.pos, 8)
            n_lanes = (off + seg + 7) // 8
            words = self.state[l0:l0 + n_lanes]
            cols = ((words.unsqueeze(1) >> self.shifts) & 0xFF).reshape(8 * n_lanes, self.n)
            chunks.append(cols[off:off + seg])
            keep = [0xFF] * off + [0] * seg + [0xFF] * (8 * n_lanes - off - seg)
            mask = torch.from_numpy(_lane_constants(keep, n_lanes)).to(self.device)
            self.state[l0:l0 + n_lanes] = words & mask
            self.pos += seg
            taken += seg
            if self.pos == STROBE_R:
                self._run_f()
        return torch.cat(chunks).to(fe.DTYPE)


class BatchTranscript:
    """merlin::Transcript × N, lockstep schedule, on `device`."""

    def __init__(self, label: bytes, n: int, device="cuda"):
        # The constant prefix (protocol init + domain-separation label) is
        # computed once by the pure-Python spec and broadcast.
        template = Strobe128(b"Merlin v1.0")
        template.meta_ad(b"dom-sep", False)
        template.meta_ad(_u32le_bytes(len(label)), True)
        template.ad(label, False)
        self.strobe = BatchStrobe(n, template, device)
        self.n = n

    def append_message(self, label: bytes, message):
        """message: bytes (the same for every lane) or (L, N) byte columns."""
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le_bytes(len(message)), True)
        self.strobe.ad(message, False)

    def challenge_bytes(self, label: bytes, n_bytes: int) -> torch.Tensor:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32le_bytes(n_bytes), True)
        return self.strobe.prf(n_bytes, False)

    def challenge_scalars(self, label: bytes) -> torch.Tensor:
        """64 challenge bytes → canonical scalars (16, N) on the device: the
        ``sc_reduce_wide`` kernel on the card
        (rand_proof/transcript.rs:40-44 semantics)."""
        return sc.reduce_wide_bytes(self.challenge_bytes(label, 64).contiguous())


# -- byte-column helpers -----------------------------------------------------


def scalar_byte_cols(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical scalar limbs (16, N) → (32, N) byte columns (LE)."""
    return torch.stack([limbs & 0xFF, (limbs >> 8) & 0xFF], dim=1).reshape(32, -1)


def field_byte_cols(limbs: torch.Tensor) -> torch.Tensor:
    """Canonical field-element limbs (e.g. compressed points) → (32, N)."""
    return scalar_byte_cols(limbs)


def concat_cols(*cols) -> torch.Tensor:
    return torch.cat(cols, dim=0)
