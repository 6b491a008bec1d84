"""The range verifier's host scalar algebra (``crypto/range_proof.py``, pass 1
of ``verify_multiple_batch``) against plain loops kept here as the oracle, on
the CPU: ``_sum_of_powers`` and ``_delta`` for power-of-two sizes (by
doubling), their refusal of any other size, and the batched inversion
against ``pow(v, ℓ − 2, ℓ)`` element by element, zeros included.
Tolerance: none (integers mod ℓ equal).
"""

import random

import pytest

from rofl_tpu_torch.crypto import range_proof as RP
from rofl_tpu_torch.spec import scalar as SS

L = SS.L
SIZES = [(8, 4096), (16, 1), (1, 1), (2, 2), (64, 8)]
VALUES = [0, 1, 2, L - 1, random.Random(19).randrange(L)]


def _loop_sum_of_powers(x: int, n: int) -> int:
    acc, cur = 0, 1
    for _ in range(n):
        acc = (acc + cur) % L
        cur = (cur * x) % L
    return acc


def _loop_delta(n: int, m: int, y: int, z: int) -> int:
    zz = (z * z) % L
    return ((z - zz) * _loop_sum_of_powers(y, n * m)
            - zz * z * _loop_sum_of_powers(2, n) * _loop_sum_of_powers(z, m)) % L


@pytest.mark.parametrize("x", VALUES, ids=["0", "1", "2", "l-1", "random"])
@pytest.mark.parametrize("n,m", SIZES, ids=[f"{n}x{m}" for n, m in SIZES])
def test_power_sums_and_delta_equal_the_loops(n, m, x):
    z = (x * 7 + 3) % L
    assert RP._sum_of_powers(x, n * m) == _loop_sum_of_powers(x, n * m)
    assert RP._sum_of_powers(x, m) == _loop_sum_of_powers(x, m)
    assert RP._sum_of_powers(x, 0) == 0
    assert RP._delta(n, m, x, z) == _loop_delta(n, m, x, z)
    assert RP._delta(n, m, z, x) == _loop_delta(n, m, z, x)


@pytest.mark.parametrize("n", [3, 5, 6, 10, 100, 4095, 32767])
def test_other_sizes_are_refused(n):
    x = VALUES[-1]
    with pytest.raises(ValueError):
        RP._sum_of_powers(x, n)
    with pytest.raises(ValueError):
        RP._delta(8, n, x, (x * 5 + 1) % L)


_rng = random.Random(1919)
INVERSION_CASES = {
    "empty": [],
    "one_zero": [0],
    "zeros_between": [0, 5, 0, L - 1, _rng.randrange(L), 0, 1, 2],
    "multiples_of_l": [L, 3, -L, 2 * L + 7],
    "negative": [-1, -2, _rng.randrange(L)],
    "a_chunk_batch": [_rng.randrange(L) for _ in range(16 * 16)] + [0],
}


@pytest.mark.parametrize("values", list(INVERSION_CASES.values()), ids=list(INVERSION_CASES))
def test_batched_inversion_equals_pow_per_element(values):
    got = RP._batch_inv(values)
    assert got == [pow(v, L - 2, L) for v in values]
    assert got == [RP._inv(v) for v in values]
    for v, inv in zip(values, got):
        assert (v * inv) % L == (0 if v % L == 0 else 1)
