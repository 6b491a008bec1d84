"""Merlin transcripts (STROBE-128 over Keccak-f[1600]) for many lanes at once.

The benchmark's own copy, for the check of a run's output: every lane runs
the same operations with messages of the same lengths, so the sponge
position is shared and only the states differ. The states live in numpy
(host, few lanes: the range proofs' one transcript a partition) or in torch
on a device (many lanes: one transcript a parameter of a Σ-proof).
"""

from __future__ import annotations

import numpy as np
import torch

R = 166  # STROBE-128 rate: 200 - 2 * 128 / 8 - 2
FLAG_I, FLAG_A, FLAG_C, FLAG_T, FLAG_M, FLAG_K = 1, 2, 4, 8, 16, 32

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rotation of lane x + 5 y, and where rho-pi sends it
_ROT = [0, 1, 62, 28, 27, 36, 44, 6, 55, 20, 3, 10, 43, 25, 39, 41, 45, 15, 21, 8, 18, 2, 61,
        56, 14]
_PI_SRC = [0] * 25
for _x in range(5):
    for _y in range(5):
        _PI_SRC[_y + 5 * ((2 * _x + 3 * _y) % 5)] = _x + 5 * _y
_X1 = [(i // 5) * 5 + (i % 5 + 1) % 5 for i in range(25)]
_X2 = [(i // 5) * 5 + (i % 5 + 2) % 5 for i in range(25)]


def _signed(x: int) -> int:
    return x - (1 << 64) if x >> 63 else x


class _Numpy:
    """Keccak-f[1600] on a (25, B) uint64 array."""

    def __init__(self):
        self.rot = np.array(_ROT, np.uint64).reshape(25, 1)
        self.rrot = np.array([(64 - r) % 64 for r in _ROT], np.uint64).reshape(25, 1)
        self.rc = [np.uint64(c) for c in _RC]
        self.one = np.uint64(1)

    def zeros(self, b):
        return np.zeros((b, 25), np.uint64)

    def as_bytes(self, st):
        return st.view(np.uint8)

    def permute(self, st):
        a = np.ascontiguousarray(st.T)
        for rc in self.rc:
            c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
            cr = c[[1, 2, 3, 4, 0]]
            d = c[[4, 0, 1, 2, 3]] ^ ((cr << self.one) | (cr >> np.uint64(63)))
            a = a ^ np.tile(d, (5, 1))
            a = (a << self.rot) | (a >> self.rrot)
            a = a[_PI_SRC]
            a = a ^ (~a[_X1] & a[_X2])
            a[0] ^= rc
        return np.ascontiguousarray(a.T)

    def to_data(self, data):
        if isinstance(data, (bytes, bytearray)):
            return np.frombuffer(bytes(data), np.uint8).reshape(1, -1)
        return np.asarray(data, np.uint8)


class _Torch:
    """Keccak-f[1600] on a (25, B) int64 tensor (right shifts masked to be
    logical)."""

    def __init__(self, device):
        self.device = device
        self.rot = torch.tensor(_ROT, dtype=torch.int64, device=device).reshape(25, 1)
        rr = [(64 - r) % 64 for r in _ROT]
        self.rrot = torch.tensor(rr, dtype=torch.int64, device=device).reshape(25, 1)
        self.rmask = torch.tensor([(1 << r) - 1 if r else -1 for r in _ROT], dtype=torch.int64,
                                  device=device).reshape(25, 1)
        self.rc = [_signed(c) for c in _RC]

    def zeros(self, b):
        return torch.zeros((b, 25), dtype=torch.int64, device=self.device)

    def as_bytes(self, st):
        return st.view(torch.uint8)

    def permute(self, st):
        a = st.T.contiguous()
        l1 = torch.tensor([1, 2, 3, 4, 0], device=self.device)
        r1 = torch.tensor([4, 0, 1, 2, 3], device=self.device)
        pi = torch.tensor(_PI_SRC, device=self.device)
        x1 = torch.tensor(_X1, device=self.device)
        x2 = torch.tensor(_X2, device=self.device)
        for rc in self.rc:
            c = a[0:5] ^ a[5:10] ^ a[10:15] ^ a[15:20] ^ a[20:25]
            cr = c[l1]
            d = c[r1] ^ ((cr << 1) | ((cr >> 63) & 1))
            a = a ^ d.repeat(5, 1)
            a = (a << self.rot) | ((a >> self.rrot) & self.rmask)
            a = a[pi]
            a = a ^ (~a[x1] & a[x2])
            a[0] ^= rc
        return a.T.contiguous()

    def to_data(self, data):
        if isinstance(data, (bytes, bytearray)):
            return torch.tensor(list(data), dtype=torch.uint8, device=self.device).reshape(1, -1)
        if isinstance(data, np.ndarray):
            return torch.from_numpy(np.array(data, np.uint8)).to(self.device)
        return data.to(torch.uint8)


class Strobe128:
    """The STROBE operations Merlin uses (meta-AD, AD, PRF), on B lanes."""

    def __init__(self, label: bytes, lanes: int, device=None):
        self.x = _Numpy() if device is None else _Torch(device)
        self.lanes = lanes
        self.st = self.x.zeros(lanes)
        head = bytes([1, R + 2, 1, 0, 1, 96]) + b"STROBEv1.0.2"
        self._bytes()[:, :len(head)] = self.x.to_data(head)
        self.st = self.x.permute(self.st)
        self.pos = self.pos_begin = self.cur_flags = 0
        self.meta_ad(label, False)

    def _bytes(self):
        return self.x.as_bytes(self.st)

    def _run_f(self):
        b = self._bytes()
        b[:, self.pos] ^= self.pos_begin
        b[:, self.pos + 1] ^= 0x04
        b[:, R + 1] ^= 0x80
        self.st = self.x.permute(self.st)
        self.pos = self.pos_begin = 0

    def _absorb(self, data):
        data = self.x.to_data(data)
        i, n = 0, data.shape[1]
        while i < n:
            k = min(n - i, R - self.pos)
            b = self._bytes()
            b[:, self.pos:self.pos + k] ^= data[:, i:i + k]
            self.pos += k
            i += k
            if self.pos == R:
                self._run_f()

    def _squeeze(self, n: int):
        out = []
        while n:
            k = min(n, R - self.pos)
            b = self._bytes()
            out.append(b[:, self.pos:self.pos + k].clone() if isinstance(self.x, _Torch)
                       else b[:, self.pos:self.pos + k].copy())
            b[:, self.pos:self.pos + k] = 0
            self.pos += k
            n -= k
            if self.pos == R:
                self._run_f()
        if isinstance(self.x, _Torch):
            return torch.cat(out, dim=1)
        return np.concatenate(out, axis=1)

    def _begin_op(self, flags: int, more: bool):
        if more:
            if flags != self.cur_flags:
                raise ValueError("STROBE: continued operation with other flags")
            return
        old_begin = self.pos_begin
        self.pos_begin = self.pos + 1
        self.cur_flags = flags
        self._absorb(bytes([old_begin, flags]))
        if flags & (FLAG_C | FLAG_K) and self.pos != 0:
            self._run_f()

    def meta_ad(self, data, more: bool):
        self._begin_op(FLAG_M | FLAG_A, more)
        self._absorb(data)

    def ad(self, data, more: bool):
        self._begin_op(FLAG_A, more)
        self._absorb(data)

    def prf(self, n: int, more: bool):
        self._begin_op(FLAG_I | FLAG_A | FLAG_C, more)
        return self._squeeze(n)


class Transcript:
    """Merlin 1.0 transcripts on `lanes` lanes. A message is bytes (the same
    in every lane) or a (lanes, n) uint8 array or tensor."""

    def __init__(self, label: bytes, lanes: int = 1, device=None):
        self.strobe = Strobe128(b"Merlin v1.0", lanes, device)
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message):
        n = len(message) if isinstance(message, (bytes, bytearray)) else message.shape[1]
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int):
        self.append_message(label, int(x).to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int):
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(n.to_bytes(4, "little"), True)
        return self.strobe.prf(n, False)

    def challenge_scalars(self, label: bytes, modulus: int) -> list[int]:
        """Each lane's 64 challenge bytes as an integer mod `modulus`."""
        raw = self.challenge_bytes(label, 64)
        if isinstance(raw, torch.Tensor):
            raw = raw.cpu().numpy()
        return [int.from_bytes(row.tobytes(), "little") % modulus for row in raw]
