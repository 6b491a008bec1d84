"""The CUDA kernels against their plain torch versions, on the card.

Needs an NVIDIA GPU and nvcc, so every test carries the ``gpu`` marker and the
CPU command deselects them with ``-m "not gpu"``; the fixture's skip only
guards a run that selects them without a card. On the card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

``chip_smoke.py`` makes the same comparison at the full width of the round."""

import numpy as np
import pytest
import torch

from rofl_tpu_torch.ops import curve, fe, kernels
from rofl_tpu_torch.spec import ristretto as SR

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kernels.build_kernels()
    return "cuda"


def operands(n, device, seed):
    rng = np.random.default_rng(seed)
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(8)]
    pool += [SR.identity(), SR.BASEPOINT, -SR.BASEPOINT]
    packed = curve.pack_points(pool, device)
    i = torch.from_numpy(rng.integers(0, len(pool), size=n)).to(device)
    j = torch.from_numpy(rng.integers(0, len(pool), size=n)).to(device)
    scale = fe.to_tensor(rng.integers(1, 1 << 16, size=(16, n)), device)
    p = tuple(fe.mul(c[:, i], scale) for c in packed)
    q = tuple(c[:, j].contiguous() for c in packed)
    return p, q


def canonical_equal(got, want):
    return all(torch.equal(fe.canonicalize(a), fe.canonicalize(b.expand_as(a)))
               for a, b in zip(got, want))


@pytest.mark.parametrize("n", [1, 77, 1000])
def test_kernels_equal_their_plain_versions(card, n):
    p, q = operands(n, card, seed=n)
    before = dict(kernels.LAUNCHES)
    assert canonical_equal(kernels.point_add(p, q), kernels.point_add_ref(p, q))
    q1 = tuple(c[:, :1].contiguous() for c in q)
    assert canonical_equal(kernels.point_add(p, q1), kernels.point_add_ref(p, q1))
    assert canonical_equal(kernels.point_double(p), kernels.point_double_ref(p))
    enc = kernels.compress(p)
    assert torch.equal(enc, kernels.compress_ref(p))
    enc[0, ::3] ^= 1  # every third encoding gets an odd s: invalid
    (k_pt, k_valid), (r_pt, r_valid) = kernels.decompress(enc), kernels.decompress_ref(enc)
    assert canonical_equal(k_pt, r_pt) and torch.equal(k_valid, r_valid)
    wide = torch.from_numpy(
        np.random.default_rng(n).integers(0, 256, size=(64, n)).astype(np.int32)).to(card)
    wide[:, 0] = 255  # 2^512 - 1
    assert torch.equal(kernels.sc_reduce_wide(wide), kernels.sc_reduce_wide_ref(wide))
    torch.cuda.synchronize()
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before} == {
        "point_add": 2, "point_double": 1, "compress": 1, "decompress": 1,
        "sc_reduce_wide": 1}


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    p, q = operands(8, card, seed=3)
    with pytest.raises(ValueError):
        kernels.point_add(p, tuple(c[:, :5].contiguous() for c in q))
    with pytest.raises(ValueError):
        kernels.point_double(tuple(c.to(torch.int64) for c in p))
    with pytest.raises(ValueError):
        kernels.compress(tuple(c[:, ::2] for c in p))
    with pytest.raises(ValueError):
        kernels.decompress(p[0].cpu().to(card)[:8])
    with pytest.raises(ValueError):
        kernels.sc_reduce_wide(torch.zeros((32, 8), dtype=torch.int32, device=card))
