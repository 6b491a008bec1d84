"""``kernels.scalar_mul_window`` (on the CPU: the plain version of the
``csrc/scalar_mul_window.cu`` kernel, the counterpart of the TPU kernel
``_make_smul_window_kernel``, the W-bit variant of ``scalar_mul``) against the
spec and the one-bit ladder at N = 8, as tests/test_ops_kernels.py holds the
TPU kernels, for W = 2 and 4: k = 0, 1, l-1, 2^256 - 1 and random scalars,
the identity and the basepoint as P, and one broadcast scalar for every
lane; and against the JAX package's Pallas kernel at ROFL_SMUL_W = W
(interpret mode, from the KAT file tests/data/torch_port_jax_kat.json). Any
other window is refused. Tolerance: exact equality of the 32-byte
encodings."""

import numpy as np
import pytest
import torch

from rofl_tpu_torch.ops import curve, fe, kernels, sc
from rofl_tpu_torch.spec import ristretto as SR
from rofl_tpu_torch.spec import scalar as SS
from test_torch_jax_kat import ladder_kat

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(493)
L = SS.L
RANDOM = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(4)]
POINTS = [RANDOM[0]] * 3 + [SR.identity(), SR.BASEPOINT, RANDOM[1], RANDOM[2], RANDOM[3]]
SCALARS = [0, 1, L - 1, int.from_bytes(rng.bytes(32), "little") % L, L - 1, 2**256 - 1] + [
    int.from_bytes(rng.bytes(32), "little") % L for _ in range(2)]
N = len(POINTS)
P_T = tuple(curve.pack_points(POINTS, "cpu"))
K_T = fe.to_tensor(sc.pack_scalars(SCALARS), "cpu")


def encodings(p):
    return [bytes(r) for r in curve.compress_to_bytes(curve.PointArray(*p))]


@pytest.mark.parametrize("window", kernels.WINDOWS)
def test_windowed_ladder_equals_the_spec_and_the_one_bit_ladder(window):
    before = dict(kernels.LAUNCHES)
    got = kernels.scalar_mul_window(K_T, P_T, window)
    assert kernels.LAUNCHES == before  # the CPU ran the plain version
    assert all(c.shape == (16, N) and c.is_contiguous() for c in got)  # as the kernel's
    want = [p.scalar_mul(k % L).compress() for p, k in zip(POINTS, SCALARS)]
    assert encodings(got) == want
    assert encodings(kernels.scalar_mul_ref(K_T, P_T)) == want


@pytest.mark.parametrize("window", kernels.WINDOWS)
def test_windowed_ladder_with_one_scalar_for_every_point(window):
    k = SCALARS[3]
    got = kernels.scalar_mul_window(K_T[:, 3:4].contiguous(), P_T, window)
    assert encodings(got) == [p.scalar_mul(k).compress() for p in POINTS]


@pytest.mark.parametrize("window", kernels.WINDOWS)
def test_windowed_ladder_equals_the_jax_package(window):
    ladders, p = ladder_kat()
    k = fe.to_tensor(sc.pack_scalars([int(h, 16) for h in ladders["scalars"]]), "cpu")
    got = kernels.scalar_mul_window(k, p, window)
    assert [e.hex() for e in encodings(got)] == ladders["scalar_mul"][str(window)]


@pytest.mark.parametrize("window", [0, 1, 3, 8, 16])
def test_other_windows_are_refused(window):
    with pytest.raises(ValueError):
        kernels.scalar_mul_window(K_T, P_T, window)
