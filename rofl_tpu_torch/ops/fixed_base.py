"""Fixed-base scalar multiplication via windowed lookup tables.

Counterpart of ``rofl_tpu.ops.fixed_base``: for a base P precompute
T[w][d] = d * 2^(8w) * P for 32 windows x 256 digits; a batch of scalar muls
is then 32 gathers + 32 batched point adds with NO doublings.

The lookup is a plain gather (``torch.index_select``) on both devices. The
JAX package's ``_mul_mxu`` looks digits up by a one-hot fp32 matmul because
the TPU has no per-lane gather; it is not a Pallas kernel and is not ported.
The adds are launches of the ``point_add`` kernel, the table build's
doublings launches of ``point_double``.

Tables live on the device (32*256 points, 2 MB per base) and are cached per
device.
"""

from __future__ import annotations

import threading

import torch

from ..utils.profiling import setup_span
from . import curve, fe
from .curve import PointArray

N_WINDOWS = 32
WINDOW_BITS = 8


def build_table(base: PointArray) -> PointArray:
    """Table (16, 32, 256) per coord: T[w, d] = d * 2^(8w) * base.

    Doubling construction: the digit axis grows by powers of two
    ([0..m) ∪ ([0..m) + m·2^(8w)·P)), the window axis by 8 doublings.
    """
    device = base.device
    # Per-window base points 2^(8w) * base: 31*8 doublings.
    window_bases = [base]
    cur = base
    for _ in range(N_WINDOWS - 1):
        for _ in range(WINDOW_BITS):
            cur = curve.double(cur)
        window_bases.append(cur)
    wb = PointArray(*[
        torch.cat([getattr(p, c) for p in window_bases], dim=1) for c in PointArray._fields
    ])  # (16, 32)

    # 8 masked doubling steps: T[d] = T[d - 2^k] + 2^k·window_base for d in
    # [2^k, 2^(k+1)).
    tab = PointArray(*[
        c.expand(16, N_WINDOWS, 256).contiguous()
        for c in curve.identity((N_WINDOWS, 256), device)
    ])
    step = PointArray(*[c.unsqueeze(2) for c in wb])  # m · window_base, starts at m=1
    digit_idx = torch.arange(256, device=device).unsqueeze(0)
    for k in range(WINDOW_BITS):
        m = 1 << k
        rolled = PointArray(*[torch.roll(c, m, dims=2) for c in tab])
        shifted = curve.add(rolled, step)
        in_range = ((digit_idx >= m) & (digit_idx < 2 * m)).expand(N_WINDOWS, 256)
        tab = curve.select(in_range, shifted, tab)
        step = curve.add(step, step)
    return tab  # coords shaped (16, 32, 256)


def _digits(scalars: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [scalars[k >> 1] >> 8 if k & 1 else scalars[k >> 1] & 0xFF
         for k in range(N_WINDOWS)]
    ).to(torch.int64)  # (32, N)


def mul(table: PointArray, scalars: torch.Tensor) -> PointArray:
    """Batched fixed-base scalar mul: scalars (16, N) canonical → points.

    Per window of the table: gather the digit's table entry for every lane,
    accumulate with one batched add. A table of the first w windows
    multiplies scalars below 2^(8w)."""
    digits = _digits(scalars)
    n = scalars.shape[1]
    acc = PointArray(*[c.expand(16, n).contiguous() for c in curve.identity((n,), table.device)])
    for w in range(table.x.shape[1]):
        entry = PointArray(*[torch.index_select(c[:, w], 1, digits[w]) for c in table])
        acc = curve.add(acc, entry)
    return acc


class FixedBase:
    """A base point with its device tables, built lazily, one per device
    (once, when several threads ask at the same time)."""

    def __init__(self, spec_point):
        self.spec_point = spec_point
        self._tables: dict = {}
        self._lock = threading.Lock()

    def table(self, device="cuda") -> PointArray:
        device = fe.canonical_device(device)
        with self._lock:
            if device not in self._tables:
                with setup_span("setup.fixed_base"):
                    self._tables[device] = build_table(
                        curve.pack_points([self.spec_point], device))
            return self._tables[device]

    def mul(self, scalars: torch.Tensor) -> PointArray:
        return mul(self.table(scalars.device), scalars)
