"""Baby-step giant-step discrete log on device — replaces bsgs32.rs.

Counterpart of ``rofl_tpu.ops.bsgs``. The reference walks a HashMap of
compressed points one point at a time; here the table is a SORTED tensor of
compressed-point keys ((m+1, 8) int32) with a parallel value tensor, lookups
are branch-free batched binary searches (log2(m) fixed steps), and the
giant-step walk (cur -= mG, bsgs32.rs:48-58) is a loop of batched point adds
(one broadcast ``-mG`` against all lanes) with masked result capture. The
negative fallback (bsgs32.rs:64-73) searches -M the same way.

A key is the 256-bit encoding as 8 words of 32 bits, most significant first,
compared as unsigned. The limb dtype is signed, so each word is stored with
its top bit flipped (word - 2^31): signed order of the stored words is
unsigned order of the words.

The sorted table lives on the device and is memoised in-process per
(m, device); it is rebuilt by one fixed-base multiply and one compress per
process and never written to disk.

Table layout/semantics match BSGSTable::new(m): entries for 0..m inclusive,
giant step m, value = i*m + pow, default max_it = 2^n_bits / m.
"""

from __future__ import annotations

import math
import threading

import torch

from . import curve, fe, fixed_base, sc
from .curve import PointArray
from ..spec import ristretto as SR
from ..utils.profiling import setup_span

_tables: dict = {}
_tables_lock = threading.Lock()


def _limbs_to_keys(limbs: torch.Tensor) -> torch.Tensor:
    """(16, N) canonical field limbs → (8, N) int32 keys, most-significant
    word first, each word biased by -2^31 (see module docstring)."""
    wide = limbs.to(torch.int64)
    ks = [(wide[2 * j] | (wide[2 * j + 1] << 16)) - (1 << 31) for j in range(8)]
    return torch.stack(ks[::-1]).to(torch.int32)


def sort_table(keys: torch.Tensor, values: torch.Tensor):
    """Sort (8, M) keys lexicographically (row 0 most significant) with their
    values → ((M, 8) keys, (M,) values)."""
    order = torch.arange(keys.shape[1], device=keys.device)
    for j in range(7, -1, -1):  # stable sorts, least significant word first
        order = order[torch.sort(keys[j][order], stable=True).indices]
    return keys[:, order].T.contiguous(), values[order].contiguous()


def build_table(m: int, device="cuda"):
    """(sorted_keys (m+1, 8) int32, values (m+1,) int32) on `device`.

    k*G for k in 0..m via one fixed-base multiply over the windows that
    hold k's digits (k is public), then one batched compress and a sort on
    the device.
    """
    device = fe.canonical_device(device)
    with _tables_lock:
        if (m, device) not in _tables:
            with setup_span("setup.bsgs_table"):
                _tables[(m, device)] = _build_table(m, device)
        return _tables[(m, device)]


def _build_table(m: int, device: torch.device):
    from ..crypto import pedersen

    ks = torch.arange(m + 1, dtype=torch.int64, device=device)
    k_limbs = fe.zeros((m + 1,), device)
    k_limbs[0] = (ks & 0xFFFF).to(fe.DTYPE)
    k_limbs[1] = ((ks >> 16) & 0xFFFF).to(fe.DTYPE)
    k_limbs[2] = (ks >> 32).to(fe.DTYPE)
    windows = -(-m.bit_length() // fixed_base.WINDOW_BITS)
    table = PointArray(*[c[:, :windows] for c in pedersen.base_B().table(device)])
    tab = fixed_base.mul(table, k_limbs)
    keys = _limbs_to_keys(curve.compress(tab))  # (8, m+1)
    return sort_table(keys, ks.to(torch.int32))


def clear_tables() -> None:
    """Forget the memoised tables (they are rebuilt at the next use)."""
    with _tables_lock:
        _tables.clear()


def _lex_less(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b lexicographically; a, b: (8, N) biased keys, index 0
    most-significant."""
    lt = torch.zeros(a.shape[1:], dtype=torch.bool, device=a.device)
    decided = torch.zeros_like(lt)
    for j in range(8):
        lt = torch.where(~decided & (a[j] < b[j]), True, lt)
        decided = decided | (a[j] != b[j])
    return lt


def _binary_search(table_keys: torch.Tensor, query: torch.Tensor):
    """table_keys (M, 8) sorted; query (8, N) → (idx (N,), hit (N,))."""
    M = table_keys.shape[0]
    n_steps = int(math.ceil(math.log2(max(M, 2)))) + 1
    lo = torch.zeros(query.shape[1:], dtype=torch.int64, device=query.device)
    hi = torch.full_like(lo, M)  # exclusive
    for _ in range(n_steps):
        mid = (lo + hi) // 2
        mid_keys = table_keys[mid.clamp(max=M - 1)].T  # (8, N)
        go_right = _lex_less(mid_keys, query)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(go_right, hi, mid)
    idx = lo.clamp(0, M - 1)
    hit = torch.all(table_keys[idx].T == query, dim=0)
    return idx, hit


def _value_limbs(val: torch.Tensor) -> torch.Tensor:
    limbs = fe.zeros(val.shape, val.device)
    limbs[0] = (val & 0xFFFF).to(fe.DTYPE)
    limbs[1] = ((val >> 16) & 0xFFFF).to(fe.DTYPE)
    limbs[2] = (val >> 32).to(fe.DTYPE)
    return limbs


def solve_with_table(
    table_keys: torch.Tensor,
    table_vals: torch.Tensor,
    neg_mG: PointArray,
    points: PointArray,
    m: int,
    max_it: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The BSGS walk over a given sorted table."""

    def walk(start: PointArray):
        found = torch.zeros(start.batch_shape, dtype=torch.bool, device=start.device)
        value = torch.zeros(start.batch_shape, dtype=torch.int64, device=start.device)
        cur = start
        for i in range(max_it):
            enc = curve.compress(cur)
            idx, hit = _binary_search(table_keys, _limbs_to_keys(enc))
            vals = table_vals[idx].to(torch.int64)
            new = hit & ~found
            value = torch.where(new, i * m + vals, value)
            found = found | hit
            if i + 1 < max_it:
                cur = curve.add(cur, neg_mG)
        return value, found

    pos_val, pos_found = walk(points)
    neg_val, neg_found = walk(curve.neg(points))

    # scalar = pos_val if pos_found else -neg_val (mod l)
    neg_scalar = sc.neg(_value_limbs(neg_val))
    out = torch.where(pos_found.unsqueeze(0), _value_limbs(pos_val), neg_scalar)
    return out, pos_found | neg_found


def neg_mG_coords(m: int, device="cuda") -> PointArray:
    """-mG as (16, 1) coordinates (host spec math; tiny)."""
    return curve.pack_points([-SR.BASEPOINT.scalar_mul(m)], device)


def solve_discrete_log(
    points: PointArray,
    m: int,
    n_bits: int,
    max_it: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched solve_discrete_log_with_neg (bsgs32.rs:48-73).

    Returns (values (16, N) scalar limbs mod l, ok (N,) bool). Values are
    i*m + pow for the positive walk, l - (i*m + pow) for the negative
    fallback, exactly like the reference's Scalar conversion.
    """
    keys, vals = build_table(m, points.device)
    if max_it is None:
        max_it = max(1, (1 << n_bits) // m)
    return solve_with_table(keys, vals, neg_mG_coords(m, points.device), points, m, max_it)
