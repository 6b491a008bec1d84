"""``kernels.shared_scalar_mul`` (on the CPU: the plain version of the
``csrc/shared_scalar_mul.cu`` kernel, the counterpart of the TPU kernel
``_shared_mul_kernel`` / ``shared_scalar_mul``) against the spec at N = 8, as
tests/test_ops_kernels.py holds the TPU kernel: one scalar k for every lane,
random points with the identity and the basepoint among them; k = 0, 1, l-1,
scalars of low and high Hamming weight, a random one and 2^256 - 1 (the
ladder walks all 256 bits), given as (16,) or (16, 1); and against the JAX
package's Pallas kernel (interpret mode, from the KAT file
tests/data/torch_port_jax_kat.json). ``kernels.naf_digits``, the recoding
the wrapper hands the kernel, is held to the definition of a width-5 NAF.
Tolerance: exact equality of the 32-byte encodings and of the digits' sum."""

import numpy as np
import pytest
import torch

from rofl_tpu_torch.ops import curve, fe, kernels, sc
from rofl_tpu_torch.spec import ristretto as SR
from rofl_tpu_torch.spec import scalar as SS
from test_torch_jax_kat import SHARED_KAT_SCALARS, ladder_kat

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(923)
N = 8
POINTS = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(N - 2)] + [
    SR.identity(), SR.BASEPOINT]
P_T = curve.pack_points(POINTS, "cpu")
SCALARS = {"zero": 0, "one": 1, "l_minus_1": SS.L - 1, "low_weight": (1 << 251) | 3,
           "high_weight": 2**252 - 1, "random": int.from_bytes(rng.bytes(32), "little") % SS.L,
           "all_ones": 2**256 - 1}


@pytest.mark.parametrize("name", sorted(SCALARS))
def test_shared_scalar_mul_equals_the_spec(name):
    k = SCALARS[name]
    limbs = fe.to_tensor(sc.pack_scalars([k]), "cpu")
    if name == "random":
        limbs = limbs.reshape(16)  # the TPU wrapper takes (16,) as well
    before = dict(kernels.LAUNCHES)
    got = kernels.shared_scalar_mul(limbs, tuple(P_T))
    assert kernels.LAUNCHES == before  # the CPU ran the plain version
    assert all(c.shape == (16, N) and c.dtype == fe.DTYPE and c.is_contiguous() for c in got)
    want = [p.scalar_mul(k % SS.L).compress() for p in POINTS]
    assert [bytes(r) for r in curve.compress_to_bytes(curve.PointArray(*got))] == want


def test_shared_scalar_mul_refuses_more_than_one_scalar():
    with pytest.raises(ValueError):
        kernels.shared_scalar_mul(fe.to_tensor(sc.pack_scalars([1, 2]), "cpu"), tuple(P_T))


@pytest.mark.parametrize("name", SHARED_KAT_SCALARS)
def test_shared_scalar_mul_equals_the_jax_package(name):
    ladders, p = ladder_kat()
    k = int(ladders["shared_scalars"][name], 16)
    got = kernels.shared_scalar_mul(fe.to_tensor(sc.pack_scalars([k]), "cpu"), p)
    assert [bytes(r).hex() for r in curve.compress_to_bytes(curve.PointArray(*got))] == (
        ladders["shared_scalar_mul"][name])


NAF_SCALARS = {"zero": 0, "one": 1, "two": 2, "l_minus_1": SS.L - 1, "two_255": 2**255,
               "all_ones": 2**256 - 1, "low_weight": (1 << 200) | 5, "high_weight": 2**253 - 1,
               "alternating_55": int("55" * 32, 16), "alternating_aa": int("aa" * 32, 16),
               "random": int.from_bytes(rng.bytes(32), "little")}


@pytest.mark.parametrize("name", sorted(NAF_SCALARS))
def test_naf_digits_are_a_width_5_naf(name):
    """Σ d_i 2^i = k; every digit 0 or odd in [-15, 15]; nonzero digits at
    least 5 places apart; at most 257 digits, the top one nonzero."""
    k = NAF_SCALARS[name]
    d = kernels.naf_digits(k)
    assert d.dtype == np.int8 and len(d) <= 257
    assert sum(int(x) << i for i, x in enumerate(d)) == k
    assert all(x == 0 or (x % 2 == 1 and -15 <= x <= 15) for x in d.tolist())
    nonzero = np.flatnonzero(d)
    assert (np.diff(nonzero) >= 5).all()
    assert len(d) == 0 if k == 0 else d[-1] != 0
    if name == "all_ones":
        assert len(d) == 257  # 2^256 - 1 = 2^256 - 1: digits 0 and 256


def test_naf_digits_refuse_scalars_out_of_range():
    for k in (-1, 2**256):
        with pytest.raises(ValueError):
            kernels.naf_digits(k)
