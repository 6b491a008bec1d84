"""The Σ-proof codecs of rofl_tpu_torch.crypto.serde_vec and the split / join
and small bindings of rofl_tpu_torch.bindings against rofl_tpu's (JAX CPU
path): the same blobs in and out, byte for byte, and the same ValueErrors for
malformed blobs. The proofs are made by the port; create_* and verify_* are
held against rofl_tpu.bindings in test_torch_sigma.py, which pays the JAX
compiles of the Σ-protocols once. Tolerance: exact equality."""

import struct

import numpy as np
import pytest
import torch

import rofl_tpu.bindings as JB
import rofl_tpu_torch.bindings as TB
from rofl_tpu.crypto import serde_vec as jsv
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.crypto import serde_vec as tsv
from rofl_tpu_torch.crypto import sigma as tsigma
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.ops import curve as tcurve
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import field as SF
from rofl_tpu_torch.spec import scalar as SS

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
N = 4
FP = FpConfig(16, 7)
VALUES = np.array([0.25, -1.5, 12.5, 0.0], np.float32)
M_T = tfe.to_tensor(FP.f32_to_scalar_limbs(VALUES), "cpu")
R1_T = tpedersen.rnd_scalar_tensor(N, np.random.default_rng(1), "cpu")
R2_T = tpedersen.rnd_scalar_tensor(N, np.random.default_rng(2), "cpu")


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(77)
    rand_proof, pairs = tsigma.rand_proof_prove(M_T, R1_T, rng)
    sq_rand_proof, triples = tsigma.square_rand_proof_prove(M_T, R1_T, R2_T, rng)
    sq_proof, _ = tsigma.square_proof_prove(M_T, R1_T, R2_T, rng)
    return {
        "rand_proof": tsv.serialize_rand_proof_vec(rand_proof),
        "pairs": tsv.serialize_eg_pair_vec(pairs),
        "square_rand_proof": tsv.serialize_square_rand_proof_vec(sq_rand_proof),
        "triples": tsv.serialize_squaretriple_vec(triples),
        "square_proof": tsv.serialize_square_proof_vec(sq_proof),
    }


CODECS = {
    "rand_proof": (128, "deserialize_rand_proof_vec", "serialize_rand_proof_vec", 2),
    "square_rand_proof": (192, "deserialize_square_rand_proof_vec",
                          "serialize_square_rand_proof_vec", 3),
    "square_proof": (160, "deserialize_square_proof_vec", "serialize_square_proof_vec", 2),
    "triples": (96, "deserialize_squaretriple_vec", "serialize_squaretriple_vec", 3),
}


def reframe(blob, width, edit):
    """The blob with item 1 replaced by edit(item 1)."""
    items = [bytearray(blob[8 + (8 + width) * i + 8: 8 + (8 + width) * (i + 1)])
             for i in range(N)]
    items[1] = edit(items[1])
    return struct.pack("<Q", N) + b"".join(struct.pack("<Q", len(x)) + bytes(x) for x in items)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_proof_codec_roundtrip_is_byte_identical(blobs, name):
    width, de, ser, _ = CODECS[name]
    blob = blobs[name]
    assert len(blob) == 8 + (8 + width) * N
    obj = getattr(tsv, de)(blob, "cpu")
    assert getattr(tsv, ser)(obj) == blob
    # the JAX codec reads the port's blob and writes the same bytes back
    assert getattr(jsv, ser)(getattr(jsv, de)(blob)) == blob


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("name", sorted(CODECS))
def test_malformed_proof_blobs_raise(blobs, name, side):
    width, de, _, n_points = CODECS[name]
    decode = (lambda b: getattr(tsv, de)(b, "cpu")) if side == "port" else getattr(jsv, de)

    def set_bytes(at, raw):
        def edit(item):
            item[at:at + 32] = raw
            return item
        return edit

    with pytest.raises(ValueError, match="length"):
        decode(reframe(blobs[name], width, lambda item: item[:-1]))
    with pytest.raises(ValueError):  # a field element that is no point (s = 2: not a square)
        decode(reframe(blobs[name], width, set_bytes(0, SF.to_bytes(2))))
    with pytest.raises(ValueError):  # s >= p
        decode(reframe(blobs[name], width, set_bytes(32 * (n_points - 1), b"\xff" * 32)))
    if width > 32 * n_points:
        with pytest.raises(ValueError, match="non-canonical"):
            decode(reframe(blobs[name], width, set_bytes(width - 32, SS.L.to_bytes(32, "little"))))
        # l - 1 is canonical
        largest = (SS.L - 1).to_bytes(32, "little")
        decode(reframe(blobs[name], width, set_bytes(width - 32, largest)))
    if side == "port":
        with pytest.raises(ValueError):
            decode(blobs[name] + b"\x00")


def test_split_and_join_of_elgamal_pairs(blobs):
    left, right = TB.split_elgamal_pair_vector(blobs["pairs"], device="cpu")
    assert (left, right) == JB.split_elgamal_pair_vector(blobs["pairs"])
    joined = TB.join_to_elgamal_pair_vector(left, right, device="cpu")
    assert joined == blobs["pairs"] == JB.join_to_elgamal_pair_vector(left, right)


def test_split_and_join_of_square_triples(blobs):
    parts = TB.split_squaretriple_pair_vector(blobs["triples"], device="cpu")
    assert parts == JB.split_squaretriple_pair_vector(blobs["triples"])
    assert len(parts) == 3 and all(len(p) == 8 + 40 * N for p in parts)
    joined = TB.join_to_squaretriple_pair_vector(*parts, device="cpu")
    assert joined == blobs["triples"] == JB.join_to_squaretriple_pair_vector(*parts)
    # the first two parts are the ElGamal pair of the rand proof of the same m, r1
    assert parts[:2] == TB.split_elgamal_pair_vector(blobs["pairs"], device="cpu")


def test_commits_equal_and_filter_unequal(blobs):
    left, right = TB.split_elgamal_pair_vector(blobs["pairs"], device="cpu")
    mixed = left[:8 + 40] + right[8 + 40:8 + 80] + left[8 + 80:]  # differs in lane 1 only
    for a, b in ((left, left), (left, right), (left, mixed), (left, left[:8 + 80])):
        if len(a) == len(b):
            assert TB.commits_equal(a, b, device="cpu") == JB.commits_equal(a, b)
    assert TB.commits_equal(left, left, device="cpu")
    assert not TB.commits_equal(left, mixed, device="cpu")
    short = struct.pack("<Q", 2) + left[8:8 + 80]
    assert not TB.commits_equal(left, short, device="cpu") and not JB.commits_equal(left, short)
    got = TB.filter_unequal_commits(left, mixed, device="cpu")
    assert got == JB.filter_unequal_commits(left, mixed)
    assert got == (struct.pack("<Q", 1) + left[8 + 40:8 + 80],
                   struct.pack("<Q", 1) + right[8 + 40:8 + 80])
    none = TB.filter_unequal_commits(left, left, device="cpu")
    assert none == (struct.pack("<Q", 0),) * 2


def test_zero_vectors_and_the_neutral_element_check(blobs):
    assert TB.create_zero_scalar_vector(5) == JB.create_zero_scalar_vector(5)
    zeros = TB.create_zero_group_element_vector(3, device="cpu")
    assert zeros == JB.create_zero_group_element_vector(3)
    left, _ = TB.split_elgamal_pair_vector(blobs["pairs"], device="cpu")
    mixed = struct.pack("<Q", 4) + zeros[8:8 + 40] + left[8:8 + 80] + zeros[8:8 + 40]
    got = TB.equals_neutral_group_element_vec(mixed, device="cpu")
    assert got == JB.equals_neutral_group_element_vec(mixed) == [True, False, False, True]


@pytest.mark.parametrize("n", [1, 3, 13])
def test_add_scalars(n):
    values = [SS.L - 1, 1, 2**252] + [
        int.from_bytes(np.random.default_rng(n).bytes(32), "little") % SS.L] * 10
    blob = tsv.serialize_scalar_vec(tsc.pack_scalars(values[:n]))
    got = TB.add_scalars(blob, device="cpu")
    assert got == JB.add_scalars(blob) and len(got) == 40
    assert tsv.deserialize_scalar(got) == sum(values[:n]) % SS.L


def test_create_random_blinding_vector():
    got = TB.create_random_blinding_vector(6, np.random.default_rng(3), device="cpu")
    assert got == JB.create_random_blinding_vector(6, np.random.default_rng(3))
    limbs = tsv.deserialize_scalar_vec(got)
    assert limbs.shape == (16, 6) and len(set(tsc.unpack_scalars(limbs))) == 6


def test_proof_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    blob = tsv.serialize_scalar_vec(tfe.to_numpy(R1_T))
    for call in (lambda: TB.create_randproof(VALUES, blob, FP, np.random.default_rng(1)),
                 lambda: TB.create_squarerandproof(VALUES, blob, blob, FP,
                                                   np.random.default_rng(1)),
                 lambda: TB.add_scalars(blob),
                 lambda: TB.create_zero_group_element_vector(2),
                 lambda: tcurve.identity((2,))):
        with pytest.raises((RuntimeError, AssertionError)):
            call()
