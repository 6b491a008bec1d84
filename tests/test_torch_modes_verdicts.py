"""The port's verifiers of the encrypted modes (``fl/params.py``
``verify``) on the JAX package's frames, on the CPU (plain versions).

Every frame of tests/data/torch_port_modes_kat.json (EncRange,
EncRangeCompressed, EncL2Compressed at check_percentage 1.0 and the Range
modes at 0.5; the same with a value out of range) gets the verdict the JAX
package gave it. The out-of-range frames keep the reference's hazard: the
Range modes prove their rand proofs on the unclipped value, so their verdict
depends on the mode and, below a check percentage of 1, on whether the lane
is among those the range proofs cover (the port's encrypt gives the JAX
package's bytes for such a value, unclipped m (EncRange) and clipped m
(EncL2Compressed) alike, in tests/test_torch_modes_out_of_range.py). A
flipped bit in a rand proof, in a compressed rand
proof and in a square proof is refused. Tolerance: none (verdicts and bytes
equal)."""

import numpy as np
import pytest
import torch

from rofl_tpu_torch.crypto import compressed_rand_proof as CRP
from rofl_tpu_torch.crypto import sigma
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.fl import params as P
from test_torch_modes_kat import load_kat
from test_torch_modes_params import without_autograd  # noqa: F401 (autouse)

torch.set_num_threads(2)
KAT = load_kat()
FP = FpConfig(*KAT["fp"])


def decoded(case):
    return P.deserialize(case["enc_type"], bytes.fromhex(case["serialized"]), FP, "cpu")


@pytest.mark.parametrize("name", sorted(KAT["modes"]))
def test_the_port_accepts_the_jax_frames(name):
    case = KAT["modes"][name]
    assert case["verifies"]
    assert P.verify(decoded(case), np.random.default_rng(KAT["seeds"]["verify"]))


@pytest.mark.parametrize("name", sorted(KAT["out_of_range"]["cases"]))
def test_the_port_gives_the_jax_verdict_out_of_range(name):
    case = KAT["out_of_range"]["cases"][name]
    assert P.verify(decoded(case), np.random.default_rng(1)) == case["verifies"]


def test_a_flipped_rand_proof_bit_is_refused():
    enc = decoded(KAT["modes"]["range"])
    z_m = enc.rand_proofs.z_m.clone()
    z_m[0, 2] ^= 1
    enc.rand_proofs = sigma.RandProofVec(enc.rand_proofs.c_prime, z_m, enc.rand_proofs.z_r)
    assert not P.verify(enc, np.random.default_rng(2))


@pytest.mark.parametrize("name", ["range_compressed_half", "l2_compressed"])
def test_a_flipped_compressed_proof_bit_is_refused(name):
    enc = decoded(KAT["modes"][name])
    p = enc.rand_proof
    enc.rand_proof = CRP.CompressedRandProof(p.c_prime_L, p.c_prime_R, p.z_m, p.z_r ^ 1)
    assert not P.verify(enc, np.random.default_rng(3))


def test_a_flipped_square_proof_bit_is_refused():
    enc = decoded(KAT["modes"]["l2_compressed"])
    s = enc.square_proofs
    z_r1 = s.z_r1.clone()
    z_r1[0, 4] ^= 1
    enc.square_proofs = sigma.SquareProofVec(s.c_l_prime, s.c_sq_prime, s.z_m, z_r1, s.z_r2)
    assert not P.verify(enc, np.random.default_rng(4))
