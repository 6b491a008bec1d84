"""The port's compressed rand proof (``crypto/compressed_rand_proof.py``) and
the per-label bulk absorb of its transcript (``Transcript.
append_labeled_messages``, ``csrc/keccak.c``) against the JAX package, on the
CPU (plain versions).

The bulk absorb equals the loop of ``append_message`` it replaces, across the
sponge's rate, and the JAX package's transcript under the same labels; with
the KAT's seeds (tests/data/torch_port_modes_kat.json, made by the JAX
package at d = 7) ``prove`` gives the KAT's proof and commitment bytes; the
KAT proof verifies, and one with another z_m, another C' or an encoding of
C' that is no point is refused; ``from_bytes`` refuses what the JAX
package's refuses (a non-canonical scalar, a wrong length). Tolerance: none
(bytes, states and verdicts equal)."""

import numpy as np
import pytest
import torch

from rofl_tpu.crypto import compressed_rand_proof as JCRP
from rofl_tpu.spec.merlin import Transcript as JaxTranscript
from rofl_tpu_torch.crypto import compressed_rand_proof as CRP
from rofl_tpu_torch.crypto import pedersen
from rofl_tpu_torch.crypto import serde_vec as sv
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.ops import fe
from rofl_tpu_torch.spec import scalar as SS
from rofl_tpu_torch.spec.merlin import Transcript
from test_torch_modes_kat import load_kat

torch.set_num_threads(2)
KAT = load_kat()
FP = FpConfig(*KAT["fp"])
D = len(KAT["values"])
rng = np.random.default_rng(70)


def transcript_state(t: Transcript) -> tuple:
    s = t.strobe
    return bytes(s.state), s.pos, s.pos_begin, s.cur_flags


# (count, label length, message length): the CRP's own shape (3, 64), and
# odd lengths whose absorbs start and end at every kind of offset to the rate
BULK_CASES = [(0, 3, 64), (1, 3, 64), (7, 3, 64), (300, 3, 64), (50, 1, 7), (40, 10, 165),
              (20, 2, 166), (9, 5, 400)]


@pytest.mark.parametrize("count,label_len,msg_len", BULK_CASES)
def test_labeled_bulk_absorb_equals_the_loop(count, label_len, msg_len):
    labels, blob = rng.bytes(label_len * count), rng.bytes(msg_len * count)
    bulk, loop = Transcript(b"bulk"), Transcript(b"bulk")
    bulk.append_message(b"head", rng.bytes(int(rng.integers(0, 200))))
    loop.strobe = bulk.strobe.clone()
    bulk.append_labeled_messages(labels, label_len, blob, msg_len)
    for i in range(count):
        loop.append_message(labels[i * label_len:(i + 1) * label_len],
                            blob[i * msg_len:(i + 1) * msg_len])
    assert transcript_state(bulk) == transcript_state(loop)
    assert bulk.challenge_bytes(b"c", 64) == loop.challenge_bytes(b"c", 64)


def test_labeled_bulk_absorb_refuses_unpaired_input():
    with pytest.raises(ValueError):
        Transcript(b"t").append_labeled_messages(b"abc", 3, b"x" * 127, 64)
    with pytest.raises(ValueError):
        Transcript(b"t").append_labeled_messages(b"abcd", 3, b"x" * 128, 64)


def test_commitment_absorb_equals_the_jax_transcript():
    """The CRP's index labels through the bulk absorb give the challenge the
    JAX package's transcript gives through its per-index loop."""
    wide = 70000  # past 2^16: the third label byte is used
    assert CRP.index_labels(wide) == b"".join(JCRP.index_label(i) for i in range(wide))
    n = 600
    rows = rng.integers(0, 256, size=(n, 64), dtype=np.uint8)
    ours = Transcript(b"CompressedRandProof")
    ours.append_message(*CRP.DOMAIN_SEP)
    ours.append_labeled_messages(CRP.index_labels(n), 3, rows.tobytes(), 64)
    theirs = JaxTranscript(b"CompressedRandProof")
    theirs.append_message(*JCRP.DOMAIN_SEP)
    JCRP._absorb_commitments(theirs, rows[:, :32], rows[:, 32:])
    assert ours.challenge_bytes(b"c", 64) == theirs.challenge_bytes(b"c", 64)


@pytest.fixture(scope="module")
def kat_proof():
    proof = CRP.CompressedRandProof.from_bytes(bytes.fromhex(KAT["crp"]["proof"]))
    pairs = sv.deserialize_eg_pair_vec(bytes.fromhex(KAT["crp"]["pairs"]), "cpu")
    return proof, pairs


def test_prove_gives_the_kat_bytes():
    blind = pedersen.rnd_scalar_tensor(D, np.random.default_rng(KAT["seeds"]["crp_m"]), "cpu")
    assert sv.serialize_scalar_vec(blind).hex() == KAT["crp"]["blinding"]
    m = fe.to_tensor(FP.f32_to_scalar_limbs(np.asarray(KAT["values"], np.float32)), "cpu")
    t = Transcript(CRP.TRANSCRIPT_LABEL)
    proof, pairs = CRP.prove(t, m, blind, np.random.default_rng(KAT["seeds"]["crp_prove"]))
    assert proof.to_bytes().hex() == KAT["crp"]["proof"]
    assert sv.serialize_eg_pair_vec(pairs).hex() == KAT["crp"]["pairs"]


def test_the_kat_proof_verifies_and_another_z_m_is_refused(kat_proof):
    proof, pairs = kat_proof
    assert CRP.verify(Transcript(CRP.TRANSCRIPT_LABEL), proof, pairs)
    bad = CRP.CompressedRandProof(proof.c_prime_L, proof.c_prime_R, (proof.z_m + 1) % SS.L,
                                  proof.z_r)
    assert not CRP.verify(Transcript(CRP.TRANSCRIPT_LABEL), bad, pairs)


def test_another_c_prime_is_refused(kat_proof):
    proof, pairs = kat_proof
    swapped = CRP.CompressedRandProof(proof.c_prime_R, proof.c_prime_L, proof.z_m, proof.z_r)
    assert not CRP.verify(Transcript(CRP.TRANSCRIPT_LABEL), swapped, pairs)
    # an encoding that decodes to no point: refused without raising, as in JAX
    not_a_point = bytes([1]) + bytes(31)
    for bad in (CRP.CompressedRandProof(not_a_point, proof.c_prime_R, proof.z_m, proof.z_r),
                CRP.CompressedRandProof(proof.c_prime_L, not_a_point, proof.z_m, proof.z_r)):
        assert not CRP.verify(Transcript(CRP.TRANSCRIPT_LABEL), bad, pairs)


@pytest.mark.parametrize("case", ["z_m_is_l", "z_r_high_bit", "short", "long"])
def test_from_bytes_refuses_what_the_jax_package_refuses(case):
    good = bytes.fromhex(KAT["crp"]["proof"])
    data = {"z_m_is_l": good[:64] + SS.L.to_bytes(32, "little") + good[96:],
            "z_r_high_bit": good[:127] + bytes([good[127] | 0x80]),
            "short": good[:127], "long": good + b"\x00"}[case]
    with pytest.raises(ValueError):
        JCRP.CompressedRandProof.from_bytes(data)
    with pytest.raises(ValueError):
        CRP.CompressedRandProof.from_bytes(data)
    assert CRP.CompressedRandProof.from_bytes(good).to_bytes() == good
