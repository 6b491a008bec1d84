"""The hand-written Hopper kernels for the curve and scalar hot paths, their
build, their wrappers, and the plain torch version of each.

Counterpart of ``rofl_tpu/ops/kernels.py``: every one of its TPU kernels
has a counterpart here, thirteen wrappers on twelve CUDA sources
(``msm_flat`` launches the ``msm_groups`` kernel with one group, counted
apart):

  point_add     csrc/point_add.cu     (TPU: _add_kernel / point_add)
  point_double  csrc/point_double.cu  (TPU: _double_kernel / point_double)
  compress      csrc/compress.cu      (TPU: _compress_kernel / compress)
  decompress    csrc/decompress.cu    (TPU: _decompress_kernel / decompress)
  sc_reduce_wide  csrc/sc_reduce_wide.cu  (TPU: _sc_reduce_wide_kernel / sc_reduce_wide)
  sc_mul        csrc/sc_mul.cu        (TPU: _sc_mul_kernel / sc_mul)
  sc_add        csrc/sc_add.cu        (TPU: _sc_add_kernel / sc_add)
  sc_sub        csrc/sc_sub.cu        (TPU: _sc_sub_kernel / sc_sub)
  scalar_mul    csrc/scalar_mul.cu    (TPU: _scalar_mul_kernel / scalar_mul, W=1)
  msm_flat, msm_groups  csrc/msm.cu   (TPU: _msm_bitplane_kernel /
                _make_msm_window_kernel / msm_flat, msm_groups)
  shared_scalar_mul  csrc/shared_scalar_mul.cu  (TPU: _shared_mul_kernel /
                shared_scalar_mul)
  scalar_mul_window  csrc/scalar_mul_window.cu  (TPU: _make_smul_window_kernel,
                scalar_mul under ROFL_SMUL_W > 1)

No default path of either package calls the last two: the JAX package calls
``shared_scalar_mul`` nowhere, and runs its windowed ladder only where the
environment asks for it; the port's paths call ``scalar_mul``, the
counterpart of the default W = 1 body (on the card a signed radix-16
ladder, csrc/scalar_mul.cu), and have no switch for the window.

Each is CUDA C++ for sm_90a, one lane per thread (the MSM: a Pippenger
over a block's terms a thread, see ``csrc/msm.cu``), sharing the device
headers ``csrc/fe25519_32.cuh`` (field and point arithmetic on 8 limbs of
32 bits, under every curve kernel), ``csrc/sc25519.cuh`` (the scalar
kernels) and ``csrc/rofl_hd.cuh`` (the qualifiers that let both compile as
plain C++ too). The sources have
a plain C interface and are compiled by ``nvcc`` at first use, one process per
source, all started together, into ``build/rofl_tpu_torch/`` beside the
package, and loaded with ``ctypes``. A build or launch failure raises.

A wrapper takes (16, N) int32 limb tensors (a point is four of them). For a
tensor on the card it launches its kernel, adds one to ``LAUNCHES`` and N to
``LANES``; for a tensor on the CPU it calls the plain version (``*_ref``),
which is built on ``ops/fe.py`` and ``ops/sc.py`` and is what tests and
``chip_smoke.py`` hold the kernel against.
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

import numpy as np
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
    "sc_mul": "sc_mul.cu",
    "sc_add": "sc_add.cu",
    "sc_sub": "sc_sub.cu",
    "scalar_mul": "scalar_mul.cu",
    "msm_flat": "msm.cu",
    "msm_groups": "msm.cu",
    "shared_scalar_mul": "shared_scalar_mul.cu",
    "scalar_mul_window": "scalar_mul_window.cu",
}
_HEADERS = ("fe25519_32.cuh", "sc25519.cuh", "rofl_hd.cuh")

# Launch counts: a wrapper adds one where it launches its kernel, nowhere else.
LAUNCHES = {name: 0 for name in KERNEL_SOURCES}
# Lanes launched, at the same place: the sum of N over a kernel's launches
# (the MSMs: their terms), so that a launch of 50 000 lanes and one of 2
# weigh what they do.
LANES = {name: 0 for name in KERNEL_SOURCES}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = {
    "point_add": [_P] * 4 + [_I] + [_P] * 4 + [_I] + [_P] * 4 + [_I, _P],
    "point_double": [_P] * 8 + [_I, _P],
    "compress": [_P] * 5 + [_I, _P],
    "decompress": [_P] * 6 + [_I, _P],
    "sc_reduce_wide": [_P] * 2 + [_I, _P],
    "sc_mul": [_P, _I, _P, _I, _P, _I, _P],
    "sc_add": [_P, _I, _P, _I, _P, _I, _P],
    "sc_sub": [_P, _I, _P, _I, _P, _I, _P],
    "scalar_mul": [_P, _I] + [_P] * 8 + [_I, _P],
    "msm_groups": [_P, _I] + [_P] * 4 + [_I] * 3 + [_P] * 6 + [_P],
    "shared_scalar_mul": [_P, _I] + [_P] * 8 + [_I, _P],
    "scalar_mul_window": [_I, _P, _I] + [_P] * 8 + [_I, _P],
}
# The C function of a wrapper, where it is not rofl_<wrapper>: msm_flat is
# msm_groups with one group.
_ENTRY_POINTS = {"msm_flat": "msm_groups"}
# C functions beside the kernels' entry points: name -> (source, argtypes).
_HELPERS = {"msm_occupancy": ("msm.cu", [_P])}
_functions: dict = {}
# What nvcc printed for each kernel this process compiled (ptxas -v: registers,
# shared memory, spills); empty for a library that was already built.
BUILD_LOGS: dict = {}


# =============================================================================
# build
# =============================================================================


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def _library_path(src: str) -> Path:
    """Built library of a source, named by a hash of what it is built from."""
    h = hashlib.sha256()
    for fname in (src,) + _HEADERS:
        h.update((CSRC_DIR / fname).read_bytes())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def nvcc_command(src: str, out: Path, defines: tuple = ()) -> list:
    """The nvcc command that builds a source into the shared library `out`,
    with `defines` as NAME=VALUE macros."""
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "--split-compile=0", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
        *(f"-D{d}" for d in defines), "-o", str(out), str(CSRC_DIR / src),
    ]


def build_kernels() -> dict:
    """Compile (where not built yet) and load all the kernels; returns the C
    functions by kernel name. One compiler a source, all at the same time,
    each splitting its device code over the cores (--split-compile=0)."""
    if len(_functions) == len(_ARGTYPES) + len(_HELPERS):
        return _functions
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = {}
    for src in dict.fromkeys(KERNEL_SOURCES.values()):
        out = _library_path(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        running[src] = (subprocess.Popen(nvcc_command(src, tmp), stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp, out)
    failed = []
    for src, (proc, tmp, out) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"{src}: nvcc exited with {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
            BUILD_LOGS.update({name: log for name, s in KERNEL_SOURCES.items() if s == src})
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    entries = {name: (KERNEL_SOURCES[name], argtypes) for name, argtypes in _ARGTYPES.items()}
    for name, (src, argtypes) in {**entries, **_HELPERS}.items():
        fn = getattr(ctypes.CDLL(str(_library_path(src))), f"rofl_{name}")
        fn.argtypes = argtypes
        fn.restype = _I
        _functions[name] = fn
    return _functions


def _launch(name: str, device: torch.device, lanes: int, *args) -> None:
    """Launch kernel `name` on `lanes` lanes (its N) with the C arguments
    `args`, on the current stream of `device`, and count it."""
    fn = build_kernels()[_ENTRY_POINTS.get(name, name)]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    LANES[name] += lanes


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


def _identity_coords(n: int, device) -> tuple:
    return (fe.zeros((n,), device), fe.ones((n,), device), fe.ones((n,), device),
            fe.zeros((n,), device))


def _empty_coords(k: int, n: int, device: torch.device) -> list:
    return [torch.empty((NLIMB, n), dtype=fe.DTYPE, device=device) for _ in range(k)]


# =============================================================================
# point_add
# =============================================================================


def _stack(*coords):
    """Field elements side by side on a new axis after the limb axis, so that
    one call of a plain field op serves several independent operands. A lane's
    limbs come out exactly as from separate calls."""
    return torch.stack(coords, dim=1)


def point_add_ref(p, q):
    """Unified extended addition add-2008-hwcd-3, a=-1 (9 field muls) on
    (x, y, z, t) tuples; operands broadcast over lanes. Independent field
    operations of the formula share one call."""
    shape = np.broadcast_shapes(tuple(p[0].shape), tuple(q[0].shape))
    px, py, pz, pt = (c.expand(shape) for c in p)
    qx, qy, qz, qt = (c.expand(shape) for c in q)
    ys, xs = _stack(py, qy), _stack(px, qx)
    diff, total = fe.sub(ys, xs), fe.add(ys, xs)  # (py-px, qy-qx), (py+px, qy+qx)
    d2 = fe.constant(SF.D2, shape[1:], pt.device).expand(shape)
    a, b, pt_d2, pz_qz = fe.mul(_stack(diff[:, 0], total[:, 0], pt, pz),
                                _stack(diff[:, 1], total[:, 1], d2, qz)).unbind(1)
    c = fe.mul(pt_d2, qt)
    d = fe.mul_small(pz_qz, 2)
    e, f = fe.sub(_stack(b, d), _stack(a, c)).unbind(1)
    g, h = fe.add(_stack(d, b), _stack(c, a)).unbind(1)
    return tuple(fe.mul(_stack(e, g, f, e), _stack(f, h, g, h)).unbind(1))


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
    _launch("point_add", device, n,
            *[c.data_ptr() for c in p], pl, *[c.data_ptr() for c in q], ql,
            *[c.data_ptr() for c in out], n)
    return tuple(out)


# =============================================================================
# point_double
# =============================================================================


def point_double_ref(p):
    px, py, pz, _ = p
    a, b, zz, xy2 = fe.sqr(_stack(px, py, pz, fe.add(px, py))).unbind(1)
    c = fe.mul_small(zz, 2)
    d = fe.neg(a)
    e = fe.sub(fe.sub(xy2, a), b)
    g = fe.add(d, b)
    f, h = fe.sub(_stack(g, d), _stack(c, b)).unbind(1)
    return tuple(fe.mul(_stack(e, g, f, e), _stack(f, h, g, h)).unbind(1))


def point_double(p):
    """Batched point doubling on an (x, y, z, t) tuple of (16, N) int32 limbs."""
    if not use_kernels(p[0]):
        return point_double_ref(p)
    device = p[0].device
    n = p[0].shape[-1]
    _check_coords("point_double", p, device, (n,))
    out = _empty_coords(4, n, device)
    _launch("point_double", device, n,
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
    _launch("compress", device, n, *[c.data_ptr() for c in p], out.data_ptr(), n)
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
    _launch("decompress", device, n, s.data_ptr(), *[c.data_ptr() for c in out],
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
    _launch("sc_reduce_wide", device, n, byte_cols.data_ptr(), out.data_ptr(), n)
    return out


# =============================================================================
# sc_mul, sc_add, sc_sub
# =============================================================================


def sc_mul_ref(a, b):
    """a * b mod l on (16, N) limbs: the 512-bit schoolbook product (int64:
    a 16 x 16-bit partial product reaches 2^32), then the wide reduction.
    Right for any 16-bit limbs."""
    a, b = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    lo = torch.zeros((2 * NLIMB,) + a.shape[1:], dtype=torch.int64, device=a.device)
    hi = torch.zeros_like(lo)
    for i in range(NLIMB):
        p = a[i].unsqueeze(0) * b
        lo[i:i + NLIMB] += p & sc.MASK16
        hi[i + 1:i + 1 + NLIMB] += p >> 16
    return sc.reduce_512(sc.carry(list((lo + hi).unbind(0)))[:2 * NLIMB])


def sc_add_ref(a, b):
    """a + b mod l for canonical a, b: the sum is below 2l, one conditional
    subtract."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.stack(sc.cond_sub_l(sc.carry([a[k] + b[k] for k in range(NLIMB)])[:NLIMB]))


def sc_sub_ref(a, b):
    """a - b mod l for canonical a, b, as a + (l - b): at most 2l - 1, one
    conditional subtract."""
    a, b = torch.broadcast_tensors(a, b)
    l_minus_b = sc.l_minus(b)
    return torch.stack(sc.cond_sub_l(
        sc.carry([a[k] + l_minus_b[k] for k in range(NLIMB)])[:NLIMB]))


def _sc_binary(name: str, plain, a, b):
    if not use_kernels(a):
        return plain(a, b)
    device = a.device
    n = max(a.shape[-1], b.shape[-1])
    _check_coords(f"{name} a", (a,), device, (n, 1))
    _check_coords(f"{name} b", (b,), device, (n, 1))
    (out,) = _empty_coords(1, n, device)
    _launch(name, device, n, a.data_ptr(), a.shape[1], b.data_ptr(), b.shape[1],
            out.data_ptr(), n)
    return out


def sc_mul(a, b):
    """Batched a * b mod l on (16, N) int32 scalar limbs → canonical (16, N).
    Either operand may be one broadcast lane, (16, 1), against (16, N)."""
    return _sc_binary("sc_mul", sc_mul_ref, a, b)


def sc_add(a, b):
    """Batched a + b mod l for canonical scalars; operands broadcast as in
    ``sc_mul``."""
    return _sc_binary("sc_add", sc_add_ref, a, b)


def sc_sub(a, b):
    """Batched a - b mod l for canonical scalars; operands broadcast as in
    ``sc_mul``."""
    return _sc_binary("sc_sub", sc_sub_ref, a, b)


# =============================================================================
# scalar_mul
# =============================================================================


def scalar_mul_ref(k, p):
    """k * P per lane: 256 steps of acc = bit ? acc + addend : acc,
    addend = 2 addend, least significant bit first (the TPU kernel's order).
    The unified add also doubles, so a step is one plain add over 2N lanes:
    (acc, addend) + (addend, addend). For tests at a few lanes."""
    n = p[0].shape[1]
    acc = _identity_coords(n, p[0].device)
    addend = p
    for i in range(256):
        bit = ((k[i >> 4] >> (i & 15)) & 1).to(torch.bool)
        both = point_add_ref(tuple(torch.cat([a, d], dim=1) for a, d in zip(acc, addend)),
                             tuple(torch.cat([d, d], dim=1) for d in addend))
        acc = tuple(fe.select(bit, t[:, :n], a) for t, a in zip(both, acc))
        addend = tuple(t[:, n:] for t in both)
    return acc


def scalar_mul(k, p):
    """Batched variable-base scalar mul: scalars k (16, N) or one broadcast
    lane (16, 1), points p as an (x, y, z, t) tuple of (16, N) int32 limbs →
    k * P as such a tuple. All 256 bits of k count, so k need not be
    canonical. The kernel runs signed radix-16 digits from the top and the
    plain version the bits from the bottom: the results are the same group
    elements in different projective representations (compare encodings or
    with ``curve.eq``)."""
    if not use_kernels(p[0]):
        return scalar_mul_ref(k, p)
    device = p[0].device
    n = p[0].shape[-1]
    _check_coords("scalar_mul p", p, device, (n,))
    _check_coords("scalar_mul k", (k,), device, (n, 1))
    out = _empty_coords(4, n, device)
    _launch("scalar_mul", device, n, k.data_ptr(), k.shape[1],
            *[c.data_ptr() for c in p], *[c.data_ptr() for c in out], n)
    return tuple(out)


# =============================================================================
# msm_flat, msm_groups
# =============================================================================

MSM_THREADS = 64  # csrc/msm.cu THREADS
# csrc/fe25519_32.cuh MSM_C, the window c: signed digits in [-4, 4), 4
# buckets a thread, 86 windows (tune_kernels.py measures the others).
MSM_WINDOW = 3
MSM_DIGITS = -(-257 // MSM_WINDOW)  # ceil(257 / c): the top one takes the last carry
MSM_MIN_TERMS_PER_THREAD = 128
# The block's tree and running sum, in terms of one thread's loop: about a
# dozen additions against one addition and a bucket scan a term.
MSM_TREE_TERMS = 16


def msm_slices(n_groups: int, group: int, windows: int, blocks_per_wave: int) -> int:
    """Blocks a group and window of the bucket launch, for `windows` windows.
    Blocks run in waves of `blocks_per_wave` (the card's SMs times the blocks
    an SM holds), so the time goes as the waves times a block's time, its
    terms a thread plus the tree: the count of slices that makes that
    product least, from 1 up to the count that leaves each thread
    MSM_MIN_TERMS_PER_THREAD terms."""
    blocks = n_groups * windows
    most = max(1, group // (MSM_THREADS * MSM_MIN_TERMS_PER_THREAD))

    def cost(slices):
        waves = -(-blocks * slices // blocks_per_wave)
        return waves * (-(-group // (slices * MSM_THREADS)) + MSM_TREE_TERMS)

    return min(range(1, most + 1), key=cost)


_msm_waves: dict = {}


def msm_blocks_per_wave(device: torch.device) -> int:
    """The card's SMs times the bucket blocks an SM holds
    (rofl_msm_occupancy), once per device."""
    key = torch.cuda.get_device_properties(device).name
    if key not in _msm_waves:
        per_sm = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = build_kernels()["msm_occupancy"](ctypes.byref(per_sm))
        if err != 0 or per_sm.value < 1:
            raise RuntimeError(f"msm: occupancy query failed with CUDA error {err}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _msm_waves[key] = per_sm.value * sms
    return _msm_waves[key]


def halving_sums(p, group: int, add):
    """Per-group sums over contiguous groups of `group` lanes, (16, G·group)
    → (16, G): the groups padded to a power of two with the identity, then
    the upper half added onto the lower by `add` until one lane is left."""
    n_groups = p[0].shape[1] // group
    width = 1 << (group - 1).bit_length()
    coords = [c.reshape(NLIMB, n_groups, group) for c in p]
    if width != group:
        pad, device = (n_groups, width - group), coords[0].device
        ident = (fe.zeros(pad, device), fe.ones(pad, device), fe.ones(pad, device),
                 fe.zeros(pad, device))
        coords = [torch.cat([c, i], dim=2) for c, i in zip(coords, ident)]
    while width > 1:
        width //= 2
        lo = tuple(c[:, :, :width].reshape(NLIMB, -1).contiguous() for c in coords)
        hi = tuple(c[:, :, width:].reshape(NLIMB, -1).contiguous() for c in coords)
        coords = [c.reshape(NLIMB, n_groups, width) for c in add(lo, hi)]
    return tuple(c.reshape(NLIMB, n_groups).contiguous() for c in coords)


MSM_REF_SLICE = 1 << 18


def msm_groups_ref(k, p, group: int):
    """Σ k_i · P_i per contiguous group of `group` lanes: ``scalar_mul_ref``
    per lane, in slices of at most MSM_REF_SLICE lanes (which bounds the
    plain field products' memory), then the halving sums per group."""
    n = p[0].shape[1]
    parts = [scalar_mul_ref(k if k.shape[1] == 1 else k[:, lo:lo + MSM_REF_SLICE],
                            tuple(c[:, lo:lo + MSM_REF_SLICE] for c in p))
             for lo in range(0, n, MSM_REF_SLICE)]
    terms = tuple(torch.cat(cs, dim=1) for cs in zip(*parts))
    return halving_sums(terms, group, point_add_ref)


def msm_flat_ref(k, p):
    return msm_groups_ref(k, p, p[0].shape[1])


def _msm(wrapper: str, k, p, group: int):
    device = p[0].device
    n = p[0].shape[-1]
    _check_coords(f"{wrapper} p", p, device, (n,))
    _check_coords(f"{wrapper} k", (k,), device, (n, 1))
    if group < 1 or n % group:
        raise ValueError(f"{wrapper}: group {group} does not divide {n} lanes")
    n_groups = n // group
    slices = msm_slices(n_groups, group, MSM_DIGITS, msm_blocks_per_wave(device))
    digit_rows = torch.empty((MSM_DIGITS, k.shape[1]), dtype=torch.int8, device=device)
    partials = torch.empty((n_groups * slices * MSM_DIGITS, 32), dtype=fe.DTYPE, device=device)
    out = _empty_coords(4, n_groups, device)
    _launch(wrapper, device, n, k.data_ptr(), k.shape[1], *[c.data_ptr() for c in p], n, group,
            slices, digit_rows.data_ptr(), partials.data_ptr(), *[c.data_ptr() for c in out])
    return tuple(out)


def msm_groups(k, p, group: int):
    """Per-group multi-scalar multiplication: scalars k (16, N) or one
    broadcast lane (16, 1), points p as an (x, y, z, t) tuple of (16, N)
    int32 limbs, `group` dividing N → the G = N / group sums
    Σ k_i · P_i of the contiguous groups, a tuple of (16, G): the signed
    c-bit Pippenger of csrc/msm.cu (recoding, buckets, combine: three
    kernels on the stream, counted as one launch). Any group size. Equal to
    the plain version as group elements, not as coordinates (compare
    encodings or with ``curve.eq``)."""
    if not use_kernels(p[0]):
        return msm_groups_ref(k, p, group)
    return _msm("msm_groups", k, p, group)


def msm_flat(k, p):
    """Σ k_i · P_i over all N lanes → a tuple of (16, 1): ``msm_groups``
    with one group, counted apart."""
    if not use_kernels(p[0]):
        return msm_flat_ref(k, p)
    return _msm("msm_flat", k, p, p[0].shape[-1])


# =============================================================================
# shared_scalar_mul
# =============================================================================


NAF_WIDTH = 5  # csrc/fe25519_32.cuh NAF_WIDTH


def naf_digits(k: int) -> np.ndarray:
    """The width-5 NAF of 0 <= k < 2^256: int8 digits, digit i of 2^i
    first, k = Σ d_i 2^i, each digit 0 or odd in [-15, 15], no two nonzero
    digits within 5 places, the last digit nonzero (none for k = 0). At
    most 257 digits. What ``shared_scalar_mul`` hands its kernel."""
    if not 0 <= k < 1 << 256:
        raise ValueError(f"naf_digits: k must be in [0, 2^256), got {k}")
    digits = []
    while k:
        d = 0
        if k & 1:
            d = k & ((1 << NAF_WIDTH) - 1)
            if d >= 1 << (NAF_WIDTH - 1):
                d -= 1 << NAF_WIDTH
            k -= d
        digits.append(d)
        k >>= 1
    return np.array(digits, dtype=np.int8)


def _shared_scalar_limbs(k) -> np.ndarray:
    """One scalar, (16,) or (16, 1) limbs (a tensor or numpy) → its 16 limbs
    as a contiguous uint32 array on the host."""
    limbs = fe.to_numpy(k)
    if limbs.size != NLIMB:
        raise ValueError(f"shared_scalar_mul: k must be one scalar, (16,) or (16, 1), got "
                         f"{limbs.shape}")
    return np.ascontiguousarray(limbs.reshape(NLIMB), dtype=np.uint32)


def shared_scalar_mul_ref(k, p):
    """k * P_i for one scalar k, as the TPU kernel computes it: 256 steps
    from the least significant bit, acc = acc + addend on a set bit (the
    add is skipped on a zero bit, which is public), addend = 2 addend."""
    limbs = _shared_scalar_limbs(k)
    acc = _identity_coords(p[0].shape[1], p[0].device)
    addend = tuple(p)
    for i in range(256):
        if (int(limbs[i >> 4]) >> (i & 15)) & 1:
            acc = point_add_ref(acc, addend)
        addend = point_double_ref(addend)
    return tuple(c.contiguous() for c in acc)  # as the kernel returns them


def shared_scalar_mul(k, p):
    """k * P_i for one scalar k ((16,) or (16, 1) limbs, on any device)
    across the N lanes of an (x, y, z, t) tuple of (16, N) int32 limbs. All
    256 bits of k are taken, so k need not be canonical. The kernel runs k's
    width-5 NAF (``naf_digits``, made here on the host) and adds only on a
    nonzero digit, as the plain version adds only on a set bit, so the time
    depends on the weight of k: for public scalars. Equal to the plain
    version as group elements (compare encodings or with ``curve.eq``)."""
    if not use_kernels(p[0]):
        return shared_scalar_mul_ref(k, p)
    device = p[0].device
    n = p[0].shape[-1]
    _check_coords("shared_scalar_mul p", p, device, (n,))
    limbs = _shared_scalar_limbs(k)  # on the host: the kernel takes the digits by value
    digits = naf_digits(fe.unpack_scalars(limbs.reshape(NLIMB, 1))[0])
    out = _empty_coords(4, n, device)
    _launch("shared_scalar_mul", device, n, digits.ctypes.data, len(digits),
            *[c.data_ptr() for c in p], *[c.data_ptr() for c in out], n)
    return tuple(out)


# =============================================================================
# scalar_mul_window
# =============================================================================

WINDOWS = (2, 4)  # the divisors of 16 worth running; 1 is scalar_mul


def _check_window(window: int) -> None:
    if window not in WINDOWS:
        raise ValueError(f"scalar_mul_window: window must be one of {WINDOWS}, got {window}")


def scalar_mul_window_ref(k, p, window: int):
    """k * P per lane by `window`-bit windows, as the TPU kernel
    (_make_smul_window_kernel) computes it: the multiples M[0] = identity,
    M[1] = P, M[j] = 2 M[j/2] (j even) or M[j-1] + P (j odd); then from the
    top window down, `window` doublings, M[digit] picked by a select tree
    over every multiple, and one add."""
    _check_window(window)
    n = p[0].shape[1]
    mult = [_identity_coords(n, p[0].device), tuple(p)]
    for j in range(2, 1 << window):
        mult.append(point_double_ref(mult[j // 2]) if j % 2 == 0
                    else point_add_ref(mult[j - 1], tuple(p)))
    acc = mult[0]
    for wi in reversed(range(256 // window)):
        b = wi * window
        digit = (k[b >> 4] >> (b & 15)) & ((1 << window) - 1)
        cands = mult
        for level in range(window):
            bit = ((digit >> level) & 1).to(torch.bool)
            cands = [tuple(fe.select(bit, t, f) for t, f in zip(cands[2 * i + 1], cands[2 * i]))
                     for i in range(len(cands) // 2)]
        for _ in range(window):
            acc = point_double_ref(acc)
        acc = point_add_ref(acc, cands[0])
    return tuple(c.contiguous() for c in acc)  # as the kernel returns them


def scalar_mul_window(k, p, window: int):
    """The function of ``scalar_mul`` (scalars k (16, N) or one broadcast
    lane (16, 1), points an (x, y, z, t) tuple of (16, N) int32 limbs) by
    `window`-bit windows, window 2 or 4; any other raises ValueError. The
    kernel runs signed windows, its table of P .. 2^(window-1) P in shared
    memory (the window = 4 body is ``scalar_mul``'s). Equal to
    ``scalar_mul`` and to the plain version as group elements (compare
    encodings or with ``curve.eq``)."""
    _check_window(window)
    if not use_kernels(p[0]):
        return scalar_mul_window_ref(k, p, window)
    device = p[0].device
    n = p[0].shape[-1]
    _check_coords("scalar_mul_window p", p, device, (n,))
    _check_coords("scalar_mul_window k", (k,), device, (n, 1))
    out = _empty_coords(4, n, device)
    _launch("scalar_mul_window", device, n, window, k.data_ptr(), k.shape[1],
            *[c.data_ptr() for c in p], *[c.data_ptr() for c in out], n)
    return tuple(out)
