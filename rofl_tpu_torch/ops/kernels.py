"""The hand-written Hopper kernels for the curve and scalar hot paths, their
build, their wrappers, and the plain torch version of each.

Counterpart of ``rofl_tpu/ops/kernels.py``. Five of its TPU kernels are here:

  point_add     csrc/point_add.cu     (TPU: _add_kernel / point_add)
  point_double  csrc/point_double.cu  (TPU: _double_kernel / point_double)
  compress      csrc/compress.cu      (TPU: _compress_kernel / compress)
  decompress    csrc/decompress.cu    (TPU: _decompress_kernel / decompress)
  sc_reduce_wide  csrc/sc_reduce_wide.cu  (TPU: _sc_reduce_wide_kernel / sc_reduce_wide)

Each is CUDA C++ for sm_90a, one lane per thread, sharing the field, point and
scalar device headers ``csrc/fe25519.cuh``, ``csrc/ge25519.cuh`` and
``csrc/sc25519.cuh``. The sources have
a plain C interface and are compiled by ``nvcc`` at first use, one process per
source, all started together, into ``build/rofl_tpu_torch/`` beside the
package, and loaded with ``ctypes``. A build or launch failure raises.

A wrapper takes (16, N) int32 limb tensors (a point is four of them). For a
tensor on the card it launches its kernel and adds one to ``LAUNCHES``; for a
tensor on the CPU it calls the plain version (``*_ref``), which is built on
``ops/fe.py`` and ``ops/sc.py`` and is what tests and ``chip_smoke.py`` hold the kernel against.
Nothing of the TPU wrappers' canonical lane counts, chunking or identity
padding is carried: a kernel takes any N >= 1 and guards its tail threads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from ..spec import field as SF
from . import fe, sc
from .dispatch import use_kernels

NLIMB = fe.NLIMB

_PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PACKAGE_DIR / "csrc"
BUILD_DIR = _PACKAGE_DIR.parent / "build" / "rofl_tpu_torch"

KERNEL_SOURCES = {
    "point_add": "point_add.cu",
    "point_double": "point_double.cu",
    "compress": "compress.cu",
    "decompress": "decompress.cu",
    "sc_reduce_wide": "sc_reduce_wide.cu",
}
_HEADERS = ("fe25519.cuh", "ge25519.cuh", "sc25519.cuh")

# Launch counts: a wrapper adds one where it launches its kernel, nowhere else.
LAUNCHES = {name: 0 for name in KERNEL_SOURCES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "point_add": [_P] * 4 + [_I] + [_P] * 4 + [_I] + [_P] * 4 + [_I, _P],
    "point_double": [_P] * 8 + [_I, _P],
    "compress": [_P] * 5 + [_I, _P],
    "decompress": [_P] * 6 + [_I, _P],
    "sc_reduce_wide": [_P] * 2 + [_I, _P],
}
_functions: dict = {}


# =============================================================================
# build
# =============================================================================


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _library_path(name: str) -> Path:
    """Built library for a kernel, named by a hash of what it is built from."""
    h = hashlib.sha256()
    for fname in (KERNEL_SOURCES[name],) + _HEADERS:
        h.update((CSRC_DIR / fname).read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_kernels() -> dict:
    """Compile (where not built yet) and load all the kernels; returns the C
    functions by kernel name. All compilers run at the same time."""
    if len(_functions) == len(KERNEL_SOURCES):
        return _functions
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    for name, src in KERNEL_SOURCES.items():
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [
            nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
            str(CSRC_DIR / src),
        ]
        running[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for name, (proc, tmp, out) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited with {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    for name in KERNEL_SOURCES:
        fn = getattr(ctypes.CDLL(str(_library_path(name))), f"rofl_{name}")
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        _functions[name] = fn
    return _functions


def _launch(name: str, device: torch.device, *args) -> None:
    fn = build_kernels()[name]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1


def _check_coords(what: str, coords, device: torch.device, lanes: tuple) -> None:
    """Every coordinate: (16, n) int32, contiguous, on `device`, n in `lanes`."""
    if min(lanes) < 1:
        raise ValueError(f"{what}: needs at least one lane")
    for c in coords:
        if (not isinstance(c, torch.Tensor) or c.device != device
                or c.dtype != fe.DTYPE or c.dim() != 2 or c.shape[0] != NLIMB
                or c.shape[1] not in lanes or not c.is_contiguous()):
            got = (tuple(c.shape), c.dtype, c.device) if isinstance(c, torch.Tensor) else type(c)
            raise ValueError(
                f"{what}: expected contiguous (16, n) int32 on {device} with n in "
                f"{lanes}, got {got}")


def _empty_coords(k: int, n: int, device: torch.device) -> list:
    return [torch.empty((NLIMB, n), dtype=fe.DTYPE, device=device) for _ in range(k)]


# =============================================================================
# point_add
# =============================================================================


def point_add_ref(p, q):
    """Unified extended addition add-2008-hwcd-3, a=-1 (9 field muls) on
    (x, y, z, t) tuples; operands broadcast over lanes."""
    px, py, pz, pt = p
    qx, qy, qz, qt = q
    a = fe.mul(fe.sub(py, px), fe.sub(qy, qx))
    b = fe.mul(fe.add(py, px), fe.add(qy, qx))
    c = fe.mul(fe.mul(pt, fe.constant(SF.D2, pt.shape[1:], pt.device)), qt)
    d = fe.mul_small(fe.mul(pz, qz), 2)
    e = fe.sub(b, a)
    f = fe.sub(d, c)
    g = fe.add(d, c)
    h = fe.add(b, a)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_add(p, q):
    """Batched point add on (x, y, z, t) tuples of (16, N) int32 limbs. Either
    operand may be one broadcast lane, (16, 1), against (16, N)."""
    if not use_kernels(p[0]):
        return point_add_ref(p, q)
    device = p[0].device
    n = max(p[0].shape[-1], q[0].shape[-1])
    _check_coords("point_add p", p, device, (n, 1))
    _check_coords("point_add q", q, device, (n, 1))
    pl, ql = p[0].shape[1], q[0].shape[1]
    if any(c.shape[1] != pl for c in p) or any(c.shape[1] != ql for c in q):
        raise ValueError("point_add: the coordinates of one point differ in lanes")
    out = _empty_coords(4, n, device)
    _launch("point_add", device,
            *[c.data_ptr() for c in p], pl, *[c.data_ptr() for c in q], ql,
            *[c.data_ptr() for c in out], n)
    return tuple(out)


# =============================================================================
# point_double
# =============================================================================


def point_double_ref(p):
    px, py, pz, _ = p
    a = fe.sqr(px)
    b = fe.sqr(py)
    c = fe.mul_small(fe.sqr(pz), 2)
    d = fe.neg(a)
    e = fe.sub(fe.sub(fe.sqr(fe.add(px, py)), a), b)
    g = fe.add(d, b)
    f = fe.sub(g, c)
    h = fe.sub(d, b)
    return (fe.mul(e, f), fe.mul(g, h), fe.mul(f, g), fe.mul(e, h))


def point_double(p):
    """Batched point doubling on an (x, y, z, t) tuple of (16, N) int32 limbs."""
    if not use_kernels(p[0]):
        return point_double_ref(p)
    device = p[0].device
    n = p[0].shape[-1]
    _check_coords("point_double", p, device, (n,))
    out = _empty_coords(4, n, device)
    _launch("point_double", device,
            *[c.data_ptr() for c in p], *[c.data_ptr() for c in out], n)
    return tuple(out)


# =============================================================================
# compress
# =============================================================================


def compress_ref(p):
    """Ristretto encode → canonical field limbs (mirrors
    spec.ristretto.RistrettoPoint.compress)."""
    X, Y, Z, T = p
    batch, device = X.shape[1:], X.device
    u1 = fe.mul(fe.add(Z, Y), fe.sub(Z, Y))
    u2 = fe.mul(X, Y)
    _, inv_sqrt = fe.sqrt_ratio_m1(fe.ones(batch, device), fe.mul(u1, fe.sqr(u2)))
    den1 = fe.mul(inv_sqrt, u1)
    den2 = fe.mul(inv_sqrt, u2)
    z_inv = fe.mul(fe.mul(den1, den2), T)
    sqrt_m1 = fe.constant(SF.SQRT_M1, batch, device)
    ix0 = fe.mul(X, sqrt_m1)
    iy0 = fe.mul(Y, sqrt_m1)
    enchanted = fe.mul(den1, fe.constant(SF.INVSQRT_A_MINUS_D, batch, device))
    rotate = fe.is_negative(fe.mul(T, z_inv))
    x = fe.select(rotate, iy0, X)
    y = fe.select(rotate, ix0, Y)
    den_inv = fe.select(rotate, enchanted, den2)
    y = fe.select(fe.is_negative(fe.mul(x, z_inv)), fe.neg(y), y)
    s = fe.cabs(fe.mul(den_inv, fe.sub(Z, y)))
    return fe.canonicalize(s)


def compress(p):
    """Batched ristretto encode of an (x, y, z, t) tuple of (16, N) int32
    limbs → canonical field limbs (16, N)."""
    if not use_kernels(p[0]):
        return compress_ref(p)
    device = p[0].device
    n = p[0].shape[-1]
    _check_coords("compress", p, device, (n,))
    (out,) = _empty_coords(1, n, device)
    _launch("compress", device, *[c.data_ptr() for c in p], out.data_ptr(), n)
    return out


# =============================================================================
# decompress
# =============================================================================


def decompress_ref(s):
    """Ristretto decode from field limbs s → ((x, y, z, t), valid). Checks
    the on-curve conditions (square, t >= 0, y != 0, s >= 0); canonicality of
    the byte encoding is the caller's check on the raw bytes."""
    batch, device = s.shape[1:], s.device
    ss = fe.sqr(s)
    one = fe.ones(batch, device)
    u1 = fe.sub(one, ss)
    u2 = fe.add(one, ss)
    u2_sqr = fe.sqr(u2)
    d = fe.constant(SF.D, batch, device)
    v = fe.sub(fe.neg(fe.mul(d, fe.sqr(u1))), u2_sqr)
    was_square, inv_sqrt = fe.sqrt_ratio_m1(one, fe.mul(v, u2_sqr))
    den_x = fe.mul(inv_sqrt, u2)
    den_y = fe.mul(fe.mul(inv_sqrt, den_x), v)
    x = fe.cabs(fe.mul(fe.mul_small(s, 2), den_x))
    y = fe.mul(u1, den_y)
    t = fe.mul(x, y)
    valid = (
        was_square
        & ~fe.is_negative(t)
        & ~fe.is_zero(y)
        & ~fe.is_negative(s)
    )
    return (x, y, one, t), valid


def decompress(s):
    """Batched ristretto decode of (16, N) int32 field limbs →
    ((x, y, z, t), valid (N,) bool); z is canonical 1."""
    if not use_kernels(s):
        return decompress_ref(s)
    device = s.device
    n = s.shape[-1]
    _check_coords("decompress", (s,), device, (n,))
    out = _empty_coords(4, n, device)
    valid = torch.empty((n,), dtype=torch.bool, device=device)
    _launch("decompress", device, s.data_ptr(), *[c.data_ptr() for c in out],
            valid.data_ptr(), n)
    return tuple(out), valid


# =============================================================================
# sc_reduce_wide
# =============================================================================


def sc_reduce_wide_ref(byte_cols):
    """(64, N) little-endian byte columns → canonical scalars mod l (16, N)."""
    return sc.reduce_512([byte_cols[2 * k] | (byte_cols[2 * k + 1] << 8) for k in range(32)])


def sc_reduce_wide(byte_cols):
    """Batched Scalar::from_bytes_mod_order_wide: (64, N) int32 byte columns
    (each in [0, 256), little-endian down the rows) → (16, N) int32 canonical
    scalar limbs."""
    if not use_kernels(byte_cols):
        return sc_reduce_wide_ref(byte_cols)
    device = byte_cols.device
    if (byte_cols.dtype != fe.DTYPE or byte_cols.dim() != 2 or byte_cols.shape[0] != 64
            or byte_cols.shape[1] < 1 or not byte_cols.is_contiguous()):
        raise ValueError(
            "sc_reduce_wide: expected contiguous (64, n >= 1) int32, got "
            f"{tuple(byte_cols.shape)} {byte_cols.dtype}")
    n = byte_cols.shape[1]
    (out,) = _empty_coords(1, n, device)
    _launch("sc_reduce_wide", device, byte_cols.data_ptr(), out.data_ptr(), n)
    return out
