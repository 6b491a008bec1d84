"""L2-norm range proof — semantics of l2_range_proof_vec/mod.rs.

Counterpart of ``rofl_tpu.crypto.l2_range_proof``. One single-value
Bulletproof over the summed square Σ mᵢ² with the summed blinding: the sum in
scalar space (mod.rs:37-42), a cross-check against the float sum ×2^frac to
catch fixed-point overflow (44-58), the L2 clip bound (60-64), then ONE range
proof (transcript "L2RangeProof", BulletproofGens(64, 1), a prefix of the
chain, so identical to gens(prove_range, 1)) over the low n_bits of the sum.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fe, sc
from ..spec import ristretto as SR
from ..spec import scalar as SS
from ..spec.merlin import Transcript
from . import range_proof as RP
from .fp_codec import FpConfig
from .range_proof_vec import is_out_of_range


class L2NormError(ValueError):
    pass


class L2OverflowError(ValueError):
    pass


def squared_sum_scalar(values_clipped, fp: FpConfig) -> int:
    """Σ f32_to_scalar(x)² in the scalar field. (l − mag)² ≡ mag² (mod l), so
    the signed encoding drops out and the sum is Σ mag² over the uint64
    magnitudes (exact in uint64 for n_bits ≤ 16 and any realistic d; Python
    integers for wider configurations)."""
    bits = fp.f32_to_bits(np.asarray(values_clipped, np.float32))
    if 2 * fp.n_bits + max(1, int(bits.size).bit_length()) <= 64:
        return int(np.sum(bits * bits, dtype=np.uint64)) % SS.L
    obj = bits.astype(object)
    return int(np.sum(obj * obj)) % SS.L


def check_l2(values_clipped, fp: FpConfig, prove_range: int) -> int:
    """Overflow and bound checks (mod.rs:44-64) → the sum scalar. Raises
    L2OverflowError where the fixed-point sum wrapped, L2NormError where it
    exceeds the bound."""
    values_clipped = np.asarray(values_clipped, np.float32)
    val = squared_sum_scalar(values_clipped, fp)
    shift = np.float32(1 << fp.n_frac)
    # float cross-check: decode(encode(x))² × 2^frac summed in order in f32
    # (the reference's fold, mod.rs:44-58; a pairwise sum would round
    # differently at the overflow boundary). np.add.accumulate adds in order.
    bits = fp.f32_to_bits(values_clipped)
    neg = (values_clipped < 0) & (bits != 0)
    dec = np.where(neg, -(bits.astype(np.float64)), bits.astype(np.float64))
    dec = (dec / fp.scale).astype(np.float32)
    terms = (dec * dec * shift).astype(np.float32)
    val_float = (np.add.accumulate(terms, dtype=np.float32)[-1] if terms.size
                 else np.float32(0))
    got = np.float32(fp.scalar_to_f32(val))
    if abs(float(got) - float(val_float)) > np.finfo(np.float32).eps:
        raise L2OverflowError(f"fixed-point overflow: {got} != {val_float}")
    if float(got) > fp.l2_clip_bound(prove_range):
        raise L2NormError(f"L2 norm out of range: {got}")
    return val


def create_rangeproof_l2(
    values_clipped,
    blindings,
    fp: FpConfig,
    prove_range: int,
    rng: np.random.Generator,
    device="cuda",
) -> tuple[RP.RangeProof, SR.RistrettoPoint]:
    """create_rangeproof_l2 (mod.rs:15-140) → (proof, sum-square commit).

    blindings: (16, d) scalar limbs (a tensor or numpy; their sum is taken on
    its device, log-many ``sc_add`` launches on the card) or a list of
    ints."""
    values_clipped = np.asarray(values_clipped, np.float32)
    if isinstance(blindings, (list, tuple)):
        if len(values_clipped) != len(blindings):
            raise ValueError("wrong number of blinding factors")
        blinding_sum = sum(int(b) for b in blindings) % SS.L
    else:
        limbs = (blindings if isinstance(blindings, torch.Tensor)
                 else fe.to_tensor(blindings, device))
        if limbs.shape[1] != len(values_clipped):
            raise ValueError("wrong number of blinding factors")
        blinding_sum = sc.unpack_scalars(sc.sum_reduce(limbs))[0]
    if is_out_of_range(values_clipped, fp, prove_range):
        raise ValueError("value out of range")
    val = check_l2(values_clipped, fp, prove_range)
    # the low n_bits of the scalar (read_from_bytes semantics, mod.rs:71-75)
    value_u64 = int.from_bytes(SS.to_bytes(val)[: (fp.n_bits + 7) // 8], "little") & fp.max_bits

    proof, v_bytes, _V = RP.prove_multiple(
        Transcript(b"L2RangeProof"), [value_u64], [blinding_sum], prove_range, rng, device)
    commit = SR.decompress(v_bytes[0])
    if commit is None:
        raise ValueError("bad commitment")
    return proof, commit


def verify_rangeproof_l2(
    proof: RP.RangeProof,
    commit: SR.RistrettoPoint,
    prove_range: int,
    rng: np.random.Generator,
    device="cuda",
) -> bool:
    """verify_rangeproof_l2 (mod.rs:185-253): one commitment."""
    return RP.verify_multiple(Transcript(b"L2RangeProof"), proof, [commit.compress()],
                              prove_range, rng, device)
