"""The native STROBE-128 helper of the host Merlin transcripts.

``csrc/keccak.c`` is compiled at first use with the system ``cc`` into
``build/rofl_tpu_torch/`` (the kernels' build directory), named by a hash of
the source, and loaded with ``ctypes``. A failed build raises: nothing falls
back to the pure-Python loops, which stay in ``spec/merlin.py`` as what the
tests hold this against. The functions take the 200-byte sponge state as a
``bytearray`` and change it in place.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = _PACKAGE_DIR / "csrc" / "keccak.c"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "rofl_tpu_torch"

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    return BUILD_DIR / f"keccak-{hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]}.so"


def lib() -> ctypes.CDLL:
    """The loaded helper; builds it first where it is not built yet."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out = library_path()
        if not out.exists():
            cc = shutil.which("cc")
            if cc is None:
                raise RuntimeError("no cc on this host to build csrc/keccak.c")
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cc, "-O3", "-shared", "-fPIC", "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"cc exited with {proc.returncode} on csrc/keccak.c\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        so = ctypes.CDLL(str(out))
        so.keccak_f1600.argtypes = [ctypes.c_void_p]
        so.keccak_f1600.restype = None
        sponge = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                  ctypes.c_void_p, ctypes.c_long, ctypes.c_int]
        for fn in (so.strobe_absorb, so.strobe_overwrite, so.strobe_squeeze):
            fn.argtypes = sponge
            fn.restype = ctypes.c_int
        for fn in (so.merlin_absorb_msgs, so.merlin_absorb_labeled_msgs):
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                ctypes.c_int]
            fn.restype = ctypes.c_int
        _lib = so
        return _lib


def _state(state: bytearray):
    return (ctypes.c_ubyte * 200).from_buffer(state)


def keccak_f1600(state: bytearray) -> None:
    lib().keccak_f1600(_state(state))


def _sponge(name: str, state: bytearray, pos: int, pos_begin: int, buf, length: int,
            rate: int) -> tuple[int, int]:
    begin = ctypes.c_int(pos_begin)
    pos = getattr(lib(), name)(_state(state), pos, ctypes.byref(begin), buf, length, rate)
    return pos, begin.value


def strobe_absorb(state: bytearray, pos: int, pos_begin: int, data: bytes,
                  rate: int) -> tuple[int, int]:
    """XOR `data` into the state from `pos`, running F at each rate
    boundary → (pos, pos_begin)."""
    data = bytes(data)
    return _sponge("strobe_absorb", state, pos, pos_begin, data, len(data), rate)


def strobe_overwrite(state: bytearray, pos: int, pos_begin: int, data: bytes,
                     rate: int) -> tuple[int, int]:
    data = bytes(data)
    return _sponge("strobe_overwrite", state, pos, pos_begin, data, len(data), rate)


def strobe_squeeze(state: bytearray, pos: int, pos_begin: int, n: int,
                   rate: int) -> tuple[bytes, int, int]:
    """Read and zero `n` state bytes → (bytes, pos, pos_begin)."""
    if n == 0:
        return b"", pos, pos_begin
    out = bytearray(n)
    pos, pos_begin = _sponge("strobe_squeeze", state, pos, pos_begin,
                             (ctypes.c_ubyte * n).from_buffer(out), n, rate)
    return bytes(out), pos, pos_begin


def merlin_absorb_msgs(state: bytearray, pos: int, pos_begin: int, label: bytes,
                       blob: bytes, msg_len: int, count: int, rate: int) -> tuple[int, int]:
    """`count` Merlin append_message calls of `msg_len`-byte messages cut
    from `blob`, all under `label` → (pos, pos_begin)."""
    begin = ctypes.c_int(pos_begin)
    pos = lib().merlin_absorb_msgs(_state(state), pos, ctypes.byref(begin), bytes(label),
                                   len(label), bytes(blob), msg_len, count, rate)
    return pos, begin.value


def merlin_absorb_labeled_msgs(state: bytearray, pos: int, pos_begin: int, labels: bytes,
                               label_len: int, blob: bytes, msg_len: int, count: int,
                               rate: int) -> tuple[int, int]:
    """`count` Merlin append_message calls of `msg_len`-byte messages cut
    from `blob`, message i under the i-th `label_len`-byte label cut from
    `labels` → (pos, pos_begin)."""
    begin = ctypes.c_int(pos_begin)
    pos = lib().merlin_absorb_labeled_msgs(_state(state), pos, ctypes.byref(begin),
                                           bytes(labels), label_len, bytes(blob), msg_len,
                                           count, rate)
    return pos, begin.value
