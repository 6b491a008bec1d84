"""rofl_tpu_torch.crypto.pedersen and crypto.fp_codec against their rofl_tpu
counterparts (JAX CPU path) and the spec. Tolerance: exact equality of
limbs, masks and bytes; 0.0 on decoded f32 values."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.crypto import pedersen as jpedersen
from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig
from rofl_tpu.ops import curve as jcurve
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.ops import curve as tcurve
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import generators as G
from rofl_tpu_torch.spec import scalar as SS
from torch_port_helpers import share_tables_with_jax

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(99)
N = 77
FP = FpConfig(16, 7)
VALUES = np.concatenate([
    np.array([0.0, -0.0, 0.25, -1.5, 12.5, -100.125, 255.99, 511.99, 600.0, -600.0,
              1 / 256, 3 / 256, -3 / 256], np.float32),
    rng.uniform(-300, 300, N - 13).astype(np.float32)])
M_NP = FP.f32_to_scalar_limbs(VALUES)
R_NP = tpedersen.rnd_scalar_limbs(N, np.random.default_rng(5), "cpu")
M_T, R_T = tfe.to_tensor(M_NP, "cpu"), tfe.to_tensor(R_NP, "cpu")
M_J, R_J = jnp.asarray(M_NP), jnp.asarray(R_NP)

share_tables_with_jax("base_B", "base_H")


def enc_t(p):
    return tcurve.compress_to_bytes(p)


def enc_j(p):
    return jcurve.compress_to_bytes(p)


@pytest.mark.parametrize("fp", [(16, 7), (8, 3), (32, 7)])
def test_fp_codec_equals_the_jax_codec(fp):
    t_fp, j_fp = FpConfig(*fp), JFpConfig(*fp)
    limbs = t_fp.f32_to_scalar_limbs(VALUES)
    np.testing.assert_array_equal(limbs, j_fp.f32_to_scalar_limbs(VALUES))
    assert tsc.unpack_scalars(limbs) == t_fp.f32_to_scalars(VALUES) == j_fp.f32_to_scalars(VALUES)
    back = t_fp.scalar_limbs_to_f32(limbs)
    np.testing.assert_array_equal(back, j_fp.scalar_limbs_to_f32(limbs))
    np.testing.assert_array_equal(back, t_fp.scalars_to_f32(t_fp.f32_to_scalars(VALUES)))
    assert (t_fp.default_bsgs_table_size, t_fp.bsgs_n_bits, t_fp.precomp_bias) == (
        j_fp.default_bsgs_table_size, j_fp.bsgs_n_bits, j_fp.precomp_bias)


def test_fp_encode_device():
    got = FP.encode_device(torch.from_numpy(VALUES))
    assert got.dtype == tfe.DTYPE
    np.testing.assert_array_equal(tfe.to_numpy(got), M_NP)
    np.testing.assert_array_equal(tfe.to_numpy(got),
                                  np.asarray(JFpConfig(16, 7).encode_device(VALUES)))


def test_pedersen_commit():
    got = enc_t(tpedersen.pedersen_commit(M_T, R_T))
    np.testing.assert_array_equal(got, enc_j(jpedersen.pedersen_commit(M_J, R_J)))
    B, H = G.pedersen_B(), G.pedersen_B_blinding()
    ms, rs = tsc.unpack_scalars(M_NP), tsc.unpack_scalars(R_NP)
    for i in (0, 3, 8, 9, 40):
        assert bytes(got[i]) == (B.scalar_mul(ms[i]) + H.scalar_mul(rs[i])).compress()


def test_pedersen_commit_no_blinding():
    np.testing.assert_array_equal(
        enc_t(tpedersen.pedersen_commit_no_blinding(M_T)),
        enc_j(jpedersen.pedersen_commit_no_blinding(M_J)))


def test_elgamal_commit_and_complete_existing():
    t_pair = tpedersen.elgamal_commit(M_T, R_T)
    j_pair = jpedersen.elgamal_commit(M_J, R_J)
    np.testing.assert_array_equal(enc_t(t_pair.L), enc_j(j_pair.L))
    np.testing.assert_array_equal(enc_t(t_pair.R), enc_j(j_pair.R))
    rs = tsc.unpack_scalars(R_NP)
    assert bytes(enc_t(t_pair.R)[2]) == G.pedersen_B().scalar_mul(rs[2]).compress()
    done = tpedersen.elgamal_complete_existing(t_pair.L, R_T)
    assert done.L is t_pair.L
    np.testing.assert_array_equal(enc_t(done.R), enc_t(t_pair.R))


def test_add_pairs_and_unity_predicates():
    t_a, t_b = tpedersen.elgamal_commit(M_T, R_T), tpedersen.elgamal_commit(R_T, M_T)
    j_a, j_b = jpedersen.elgamal_commit(M_J, R_J), jpedersen.elgamal_commit(R_J, M_J)
    t_sum, j_sum = tpedersen.add_pairs(t_a, t_b), jpedersen.add_pairs(j_a, j_b)
    np.testing.assert_array_equal(enc_t(t_sum.L), enc_j(j_sum.L))
    np.testing.assert_array_equal(enc_t(t_sum.R), enc_j(j_sum.R))
    # blinding 1 makes R the basepoint, blinding 0 the identity
    blind = np.zeros((16, N), np.uint32)
    blind[0, ::2] = 1
    t_pair = tpedersen.elgamal_commit(M_T, tfe.to_tensor(blind, "cpu"))
    j_pair = jpedersen.elgamal_commit(M_J, jnp.asarray(blind))
    unity = tpedersen.right_elem_is_unity(t_pair)
    ident = tpedersen.right_elem_is_identity(t_pair)
    np.testing.assert_array_equal(unity.numpy(), np.asarray(jpedersen.right_elem_is_unity(j_pair)))
    np.testing.assert_array_equal(ident.numpy(),
                                  np.asarray(jpedersen.right_elem_is_identity(j_pair)))
    assert unity.tolist() == [i % 2 == 0 for i in range(N)]
    assert ident.tolist() == [i % 2 == 1 for i in range(N)]


def test_sum_pairs():
    t_pair = tpedersen.elgamal_commit(M_T[:, :75], R_T[:, :75])
    j_pair = jpedersen.elgamal_commit(M_J[:, :75], R_J[:, :75])

    def grid(pair, cls):
        return type(pair)(*[cls(*[c.reshape(16, 3, 25) for c in p]) for p in pair])

    t_sum = tpedersen.sum_pairs(grid(t_pair, tcurve.PointArray), axis=0)
    j_sum = jpedersen.sum_pairs(grid(j_pair, jcurve.PointArray), axis=0)
    assert t_sum.L.x.shape == (16, 1, 25)
    np.testing.assert_array_equal(enc_t(t_sum.L), enc_j(j_sum.L))
    np.testing.assert_array_equal(enc_t(t_sum.R), enc_j(j_sum.R))


def test_rnd_scalar_limbs_equals_the_jax_host_sampler():
    got = tpedersen.rnd_scalar_limbs(N, np.random.default_rng(17), "cpu")
    want = jpedersen.rnd_scalar_limbs(N, np.random.default_rng(17))
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert all(v < SS.L for v in tsc.unpack_scalars(got))


@pytest.mark.parametrize("n_vec", [2, 3, 5])
def test_cancelling_scalar_limbs(n_vec):
    got = tpedersen.cancelling_scalar_limbs(n_vec, N, np.random.default_rng(23), "cpu")
    want = jpedersen.cancelling_scalar_limbs(n_vec, N, np.random.default_rng(23))
    assert len(got) == n_vec
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    totals = [sum(col) % SS.L for col in zip(*[tsc.unpack_scalars(g) for g in got])]
    assert totals == [0] * N


def test_sc_neg_and_codecs():
    from rofl_tpu.ops import sc as jsc

    ints = [0, 1, SS.L - 1, 2**252, 12345] + [
        int.from_bytes(rng.bytes(32), "little") % SS.L for _ in range(20)]
    limbs = tsc.pack_scalars(ints + [SS.L + 5])
    np.testing.assert_array_equal(limbs, jsc.pack_scalars(ints + [SS.L + 5]))
    got = tsc.neg(tfe.to_tensor(limbs, "cpu"))
    np.testing.assert_array_equal(tfe.to_numpy(got), np.asarray(jsc.neg(jnp.asarray(limbs))))
    assert tsc.unpack_scalars(got) == [(-v) % SS.L for v in ints + [5]]
    np.testing.assert_array_equal(tsc.to_bytes_array(limbs), jsc.to_bytes_array(limbs))
    wide = np.frombuffer(rng.bytes(64 * 9), np.uint8).reshape(9, 64)
    np.testing.assert_array_equal(tsc.from_bytes_wide_array(wide),
                                  jsc.from_bytes_wide_array(wide))
