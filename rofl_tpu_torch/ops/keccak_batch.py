"""Batched Keccak-f[1600] in plain torch: N sponge states advance in one call.

Counterpart of ``rofl_tpu.ops.keccak_batch``, which is plain jnp there too
(no TPU kernel). The JAX module splits each 64-bit lane into two uint32 rows,
(50, N); here a lane is one int64 holding the 64-bit pattern, and a state is
(25, N) with lane A[x][y] at row x + 5y: lane l is rows 2l (low half) and
2l + 1 (high half) of the JAX layout. Validated against hashlib's SHA3 and the
JAX permutation.
"""

from __future__ import annotations

import torch

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _signed(v: int) -> int:
    """A 64-bit pattern as the int64 that holds it."""
    return v - (1 << 64) if v >> 63 else v


def _rol64(a: torch.Tensor, r: int) -> torch.Tensor:
    r %= 64
    if r == 0:
        return a
    # int64 shifts right arithmetically: mask the copies of the sign bit
    return (a << r) | ((a >> (64 - r)) & ((1 << r) - 1))


def keccak_f1600(state: torch.Tensor) -> torch.Tensor:
    """state: (25, N) int64 lane patterns, row x + 5y = lane A[x][y]."""
    lanes = [[state[x + 5 * y] for y in range(5)] for x in range(5)]
    for rc in _RC:
        # theta
        c = [lanes[x][0] ^ lanes[x][1] ^ lanes[x][2] ^ lanes[x][3] ^ lanes[x][4]
             for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol64(c[(x + 1) % 5], 1) for x in range(5)]
        lanes = [[lanes[x][y] ^ d[x] for y in range(5)] for x in range(5)]
        # rho + pi
        b = [[None] * 5 for _ in range(5)]
        for x in range(5):
            for y in range(5):
                b[y][(2 * x + 3 * y) % 5] = _rol64(lanes[x][y], _ROT[x][y])
        # chi
        lanes = [[b[x][y] ^ (~b[(x + 1) % 5][y] & b[(x + 2) % 5][y]) for y in range(5)]
                 for x in range(5)]
        # iota
        lanes[0][0] = lanes[0][0] ^ _signed(rc)
    return torch.stack([lanes[i % 5][i // 5] for i in range(25)])

