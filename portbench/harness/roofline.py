"""The least time the card needs for a kernel's work: the yardstick of every
``*_roofline`` metric. A copy of ``chip_smoke.py``'s arithmetic, kept here so
that no change to the program moves it.

Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
sheet): 3.35 TB/s of HBM3 and 67 TFLOP/s of fp32 outside the tensor cores.
The int32 peak is assumed, not published: an SM has half as many int32
lanes as fp32 lanes, so it is taken as half the fp32 rate, a multiply-add
counted as two operations. A curve operation is counted for the cheapest
layout the card allows (8 limbs of 32 bits): a 255-bit product is 64 wide
multiplies, each a low and a high 32-bit multiply-add (128), a squaring 36
(72).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2

MUL, SQR = 128, 72
LIMBS = 16 * 4  # bytes of a field element: (16, N) int32 limbs
POINT_ADD_MADDS = 9 * MUL
POINT_DOUBLE_MADDS = 4 * MUL + 4 * SQR
POINT_DOUBLE_NO_T_MADDS = 3 * MUL + 4 * SQR  # a doubling that a doubling follows

LADDER_BYTES = 9 * LIMBS      # scalar_mul: a scalar and a point in, a point out
MSM_TERM_BYTES = LIMBS * 4 + 64  # msm: a point and a 64-byte scalar a term


def least_ladder_madds() -> int:
    """Multiply-adds of the cheapest signed-window schedule for k * P with k
    secret: at window w, a table of 2^(w-1) multiples, then ceil(257 / w) - 1
    windows of w doublings (T only on the last) and one add."""
    costs = []
    for w in range(2, 9):
        half = 1 << (w - 1)
        table = half // 2 * POINT_DOUBLE_MADDS + (half // 2 - 1) * POINT_ADD_MADDS
        window = (w - 1) * POINT_DOUBLE_NO_T_MADDS + POINT_DOUBLE_MADDS + POINT_ADD_MADDS
        costs.append(table + (-(-257 // w) - 1) * window)
    return min(costs)


def _bound(t_bytes: float, t_ops: float) -> tuple[float, str]:
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def scalar_mul_bound_s(lanes: int) -> tuple[float, str]:
    """Least seconds for k_i * P_i on `lanes` lanes, and what bounds it."""
    return _bound(lanes * LADDER_BYTES / HBM_BYTES_PER_S,
                  lanes * least_ladder_madds() * 2 / INT32_OPS_PER_S)


def msm_bound_s(n: int, group: int) -> tuple[float, str]:
    """Least seconds for n terms in sums of `group` terms: each term read
    once, or Pippenger's point additions at its best window c (signed digits:
    ceil(257 / c) * (group + 2^c) a group; unsigned: ceil(256 / c) *
    (group + 2^(c+1))), whichever is larger."""
    adds = min(min(math.ceil(257 / c) * (group + 2 ** c),
                   math.ceil(256 / c) * (group + 2 ** (c + 1))) for c in range(1, 25))
    return _bound(n * MSM_TERM_BYTES / HBM_BYTES_PER_S,
                  (n // group) * adds * POINT_ADD_MADDS * 2 / INT32_OPS_PER_S)
