"""rofl_tpu_torch.crypto.serde_vec and rofl_tpu_torch.bindings against their
rofl_tpu counterparts (JAX CPU path): the same blobs in and out, byte for
byte, and the same errors for malformed blobs."""

import struct

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import rofl_tpu.bindings as JB
import rofl_tpu_torch.bindings as TB
from rofl_tpu.crypto import pedersen as jpedersen
from rofl_tpu.crypto import serde_vec as jsv
from rofl_tpu.ops import curve as jcurve
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.crypto import serde_vec as tsv
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.ops import curve as tcurve
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import field as SF
from rofl_tpu_torch.spec import ristretto as SR
from rofl_tpu_torch.spec import scalar as SS
from torch_port_helpers import share_tables_with_jax

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(4242)
N = 77
FP = FpConfig(16, 7)
VALUES = rng.uniform(-200, 200, N).astype(np.float32)
SCALARS = [0, 1, SS.L - 1] + [int.from_bytes(rng.bytes(32), "little") % SS.L
                              for _ in range(N - 3)]
S_NP = tsc.pack_scalars(SCALARS)
POINTS = [SR.identity(), SR.BASEPOINT] + [
    SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(N - 2)]
T_PTS = tcurve.pack_points(POINTS, "cpu")
J_PTS = jcurve.PointArray(*[jnp.asarray(tfe.to_numpy(c)) for c in T_PTS])

share_tables_with_jax("base_B", "base_H")


def vec_blob(items):
    return struct.pack("<Q", len(items)) + b"".join(
        struct.pack("<Q", len(x)) + x for x in items)


# -- scalars ------------------------------------------------------------------


def test_scalar_vec_roundtrip_is_byte_identical():
    blob = tsv.serialize_scalar_vec(S_NP)
    assert blob == jsv.serialize_scalar_vec(S_NP)
    assert blob == tsv.serialize_scalar_vec(tfe.to_tensor(S_NP, "cpu"))
    assert len(blob) == 8 + 40 * N
    back = tsv.deserialize_scalar_vec(blob)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, jsv.deserialize_scalar_vec(blob))
    np.testing.assert_array_equal(back, S_NP)
    assert tsv.scalar_limbs_to_bytes_list(S_NP) == jsv.scalar_limbs_to_bytes_list(S_NP)


def test_single_scalar():
    for v in (0, 42, SS.L - 1):
        assert tsv.serialize_scalar(v) == jsv.serialize_scalar(v)
        assert tsv.deserialize_scalar(tsv.serialize_scalar(v)) == v
    assert tsv.serialize_scalar(S_NP[:, 5:6]) == jsv.serialize_scalar(S_NP[:, 5:6])


BAD_SCALAR_BLOBS = {
    "l itself": vec_blob([SS.to_bytes(1), SS.L.to_bytes(32, "little")]),
    "top bit": vec_blob([bytes(31) + b"\x80"]),
    "all ones": vec_blob([b"\xff" * 32]),
    "trailing": vec_blob([SS.to_bytes(7)]) + b"\x00",
}


@pytest.mark.parametrize("case", sorted(BAD_SCALAR_BLOBS))
@pytest.mark.parametrize("side", ["torch", "jax"])
def test_bad_scalar_blobs_raise(case, side):
    sv = tsv if side == "torch" else jsv
    with pytest.raises(ValueError):
        sv.deserialize_scalar_vec(BAD_SCALAR_BLOBS[case])


def test_short_scalar_item_raises():
    with pytest.raises(ValueError):
        tsv.deserialize_scalar_vec(vec_blob([SS.to_bytes(7)[:31], SS.to_bytes(8)]))


def test_largest_canonical_scalar_is_accepted():
    blob = vec_blob([SS.to_bytes(SS.L - 1)])
    assert tsc.unpack_scalars(tsv.deserialize_scalar_vec(blob)) == [SS.L - 1]


# -- points -------------------------------------------------------------------


def test_rp_vec_roundtrip_is_byte_identical():
    blob = tsv.serialize_rp_vec(T_PTS)
    assert blob == jsv.serialize_rp_vec(J_PTS)
    assert blob == vec_blob([p.compress() for p in POINTS])
    t_back = tsv.deserialize_rp_vec(blob, "cpu")
    j_back = jsv.deserialize_rp_vec(blob)
    assert t_back.x.dtype == tfe.DTYPE and t_back.x.device.type == "cpu"
    for t_c, j_c in zip(t_back, j_back):
        np.testing.assert_array_equal(tfe.to_numpy(t_c), np.asarray(j_c))
    assert tsv.serialize_rp_vec(t_back) == blob


def first_non_square():
    s = 2
    while SR.decompress(s.to_bytes(32, "little")) is not None:
        s += 2
    return s.to_bytes(32, "little")


GOOD = SR.BASEPOINT_COMPRESSED
BAD_POINT_BLOBS = {
    "non-canonical p": vec_blob([GOOD, SF.P.to_bytes(32, "little")]),
    "non-canonical top bit": vec_blob([bytes(31) + b"\x80"]),
    "odd s": vec_blob([bytes([GOOD[0] | 1]) + GOOD[1:]]),
    "not a square": vec_blob([GOOD, first_non_square()]),
    "y is zero": vec_blob([SF.to_bytes(SF.P - 1)]),
    "short item": vec_blob([GOOD[:31]]),
    "long item": vec_blob([GOOD + b"\x00", GOOD]),
    "trailing": vec_blob([GOOD]) + b"\x01",
}


@pytest.mark.parametrize("case", sorted(BAD_POINT_BLOBS))
def test_bad_point_blobs_raise(case):
    with pytest.raises(ValueError):
        tsv.deserialize_rp_vec(BAD_POINT_BLOBS[case], "cpu")


@pytest.mark.parametrize("case", ["non-canonical p", "odd s", "not a square", "trailing"])
def test_bad_point_blobs_raise_in_jax_too(case):
    with pytest.raises(ValueError):
        jsv.deserialize_rp_vec(BAD_POINT_BLOBS[case])


def test_decompress_bytes_list():
    raws = [p.compress() for p in POINTS[:5]]
    got = tsv.decompress_bytes_list(raws, "cpu")
    assert tcurve.eq(got, tcurve.PointArray(*[c[:, :5] for c in T_PTS])).all()
    with pytest.raises(ValueError):
        tsv.decompress_bytes_list([raws[0], raws[1][:31]], "cpu")


def test_crp_vec_and_vec_vec():
    enc = tcurve.compress_to_bytes(T_PTS)
    blob = tsv.serialize_crp_vec(enc)
    assert blob == jsv.serialize_crp_vec(enc)
    np.testing.assert_array_equal(tsv.deserialize_crp_vec(blob), jsv.deserialize_crp_vec(blob))
    np.testing.assert_array_equal(tsv.deserialize_crp_vec(blob), enc)
    vecs = [enc[:3], enc[3:3], enc[3:10]]
    blob2 = tsv.serialize_crp_vec_vec(vecs)
    assert blob2 == jsv.serialize_crp_vec_vec(vecs)
    back = tsv.deserialize_crp_vec_vec(blob2)
    assert [b.shape for b in back] == [(3, 32), (0, 32), (7, 32)]
    for b, v in zip(back, vecs):
        np.testing.assert_array_equal(b, v)
    with pytest.raises(ValueError):
        tsv.deserialize_crp_vec(vec_blob([GOOD[:30]]))


def test_eg_pair_vec_roundtrip_is_byte_identical():
    m = FP.f32_to_scalar_limbs(VALUES)
    t_pair = tpedersen.elgamal_commit(tfe.to_tensor(m, "cpu"), tfe.to_tensor(S_NP, "cpu"))
    j_pair = jpedersen.elgamal_commit(jnp.asarray(m), jnp.asarray(S_NP))
    blob = tsv.serialize_eg_pair_vec(t_pair)
    assert blob == jsv.serialize_eg_pair_vec(j_pair)
    assert len(blob) == 8 + 72 * N
    t_back = tsv.deserialize_eg_pair_vec(blob, "cpu")
    j_back = jsv.deserialize_eg_pair_vec(blob)
    for t_p, j_p in zip(t_back, j_back):
        for t_c, j_c in zip(t_p, j_p):
            np.testing.assert_array_equal(tfe.to_numpy(t_c), np.asarray(j_c))
    assert tsv.serialize_eg_pair_vec(t_back) == blob
    with pytest.raises(ValueError):
        tsv.deserialize_eg_pair_vec(vec_blob([GOOD + GOOD[:31]]), "cpu")
    with pytest.raises(ValueError):
        tsv.deserialize_eg_pair_vec(vec_blob([GOOD + first_non_square()]), "cpu")


# -- bindings -----------------------------------------------------------------


def test_say_hello():
    assert TB.say_hello() == JB.say_hello()


def test_commit_no_blinding_blob():
    blob = TB.commit_no_blinding(VALUES, device="cpu")
    assert blob == JB.commit_no_blinding(VALUES)
    assert len(blob) == 8 + 40 * N


def test_commit_blob():
    blinding = tsv.serialize_scalar_vec(S_NP)
    assert TB.commit(VALUES, blinding, device="cpu") == JB.commit(VALUES, blinding)
    small = FpConfig(8, 3)
    from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig

    assert TB.commit(VALUES, blinding, small, device="cpu") == JB.commit(
        VALUES, blinding, JFpConfig(8, 3))


@pytest.mark.parametrize("n_vec", [1, 3])
def test_generate_cancelling_blindings(n_vec):
    got = TB.generate_cancelling_blindings(n_vec, N, np.random.default_rng(8), "cpu")
    want = JB.generate_cancelling_blindings(n_vec, N, np.random.default_rng(8))
    assert got == want and len(got) == n_vec
    if n_vec > 1:
        cols = zip(*[tsc.unpack_scalars(tsv.deserialize_scalar_vec(b)) for b in got])
        assert all(sum(c) % SS.L == 0 for c in cols)


def test_select_blindings_and_commitments():
    idx = [5, 0, 76, 5, 33]
    blinding = tsv.serialize_scalar_vec(S_NP)
    assert TB.select_blindings(blinding, idx) == JB.select_blindings(blinding, idx)
    commits = tsv.serialize_rp_vec(T_PTS)
    got = TB.select_commitments(commits, idx, device="cpu")
    assert got == JB.select_commitments(commits, idx)
    assert got == vec_blob([POINTS[i].compress() for i in idx])


def test_add_commitments_transposed():
    blobs = [tsv.serialize_rp_vec(tcurve.PointArray(*[c[:, a:b] for c in T_PTS]))
             for a, b in ((0, 38), (38, 76))]  # equal lengths: one JAX compile
    got = TB.add_commitments_transposed(blobs, device="cpu")
    assert got == JB.add_commitments_transposed(blobs)
    total = POINTS[0]
    for p in POINTS[1:38]:
        total = total + p
    assert len(got) == 2 and got[0] == struct.pack("<Q", 32) + total.compress()


def test_entry_points_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: the default device exists")
    with pytest.raises((RuntimeError, AssertionError)):
        TB.commit_no_blinding(VALUES[:3])
    with pytest.raises((RuntimeError, AssertionError)):
        TB.extract_values(tsv.serialize_rp_vec(T_PTS))
    with pytest.raises((RuntimeError, AssertionError)):
        tcurve.identity((3,))
