"""L∞ range-proof vector pipeline — semantics of range_proof_vec/mod.rs.

Counterpart of ``rofl_tpu.crypto.range_proof_vec``. Create (mod.rs:16-102):
clip-check → shift each value by +2^(range-1) (making the symmetric range
non-negative) → pad to a power of two with zeros → split into n_partition
chunks → one aggregated Bulletproof per chunk (a fresh
Transcript(b"RangeProof") each, mod.rs:124) → un-shift the commitments by
commit(-offset, 0).

Verify (mod.rs:149-216): re-shift the commitments by +offset, pad with
commit(0, 0) (the identity), chunk, and verify all chunks as one combined
MSM. The shifted values are computed in numpy uint64, as in the JAX package:
torch on the CPU has no uint64 arithmetic.
"""

from __future__ import annotations

import numpy as np

from ..ops import curve, fe, sc
from ..ops.curve import PointArray
from ..spec import generators as G
from ..spec import scalar as SS
from ..spec.merlin import Transcript
from . import range_proof as RP
from .fp_codec import FpConfig


def next_pow2(val: int) -> int:
    if val <= 1:
        return 1
    return 1 << (val - 1).bit_length()


def clip_f32_to_range_vec(values, fp: FpConfig, prove_range: int) -> np.ndarray:
    lo, hi = fp.clip_bounds(prove_range)
    return np.clip(np.asarray(values, np.float32), lo, hi)


def is_out_of_range(values, fp: FpConfig, prove_range: int) -> bool:
    lo, hi = fp.clip_bounds(prove_range)
    v = np.asarray(values, np.float32)
    return bool(np.any((v < lo) | (v > hi)))


def shifted_fixed_values(values, fp: FpConfig, prove_range: int) -> np.ndarray:
    """f32 → shifted fixed-point integers: the low n_bits of
    (f32_to_scalar(x) + 2^(range-1)) (mod.rs:36-43: a scalar add, then
    read_from_bytes truncation to URawFix). The low 64 bits of
    (l - mag + offset) equal (l mod 2^64) - mag + offset under uint64
    wrap-around, so no per-element big integers are needed (n_bits <= 64)."""
    v = np.asarray(values, np.float32)
    bits = fp.f32_to_bits(v)  # (d,) uint64 magnitudes
    offset = np.uint64(1 << (prove_range - 1))
    neg = (v < 0) & (bits != 0)
    l_lo64 = np.uint64(SS.L & 0xFFFFFFFFFFFFFFFF)
    pos = bits + offset
    with np.errstate(over="ignore"):
        # (l - bits + offset) mod l: where bits <= offset the sum wraps past
        # l and reduces to offset - bits; otherwise the low 64 bits of
        # l - bits + offset
        negv = np.where(bits <= offset, offset - bits, l_lo64 - bits + offset)
    return np.where(neg, negv, pos) & np.uint64(fp.max_bits)


def create_rangeproof(
    values_clipped,
    blindings,
    fp: FpConfig,
    prove_range: int,
    n_partition: int,
    rng: np.random.Generator,
    device="cuda",
    mesh=None,
) -> tuple[list[RP.RangeProof], PointArray]:
    """create_rangeproof (mod.rs:16-102) → (proofs, unshifted commitments).

    blindings: (16, d) scalar limbs (numpy or a tensor) or a list of ints.
    The commitments come back as points on `device`; the −offset un-shift
    (mod.rs:95-101) is one batched add. With a mesh, the chunk-batched
    prover's A/S and IPA L/R MSMs shard whole chunks over the 'param' axis
    (the proofs are byte-identical)."""
    values_clipped = np.asarray(values_clipped, np.float32)
    d = len(values_clipped)
    if isinstance(blindings, (list, tuple)):
        blind_limbs = sc.pack_scalars(blindings)
    else:
        blind_limbs = fe.to_numpy(blindings)
    if blind_limbs.shape[1] != d:
        raise ValueError("wrong number of blinding factors")
    if is_out_of_range(values_clipped, fp, prove_range):
        raise ValueError("value out of range")

    shifted = shifted_fixed_values(values_clipped, fp, prove_range)
    ext_len = next_pow2(d)
    shifted_ext = np.zeros(ext_len, np.uint64)
    shifted_ext[:d] = shifted
    blind_ext = np.zeros((16, ext_len), np.uint32)
    blind_ext[:, :d] = blind_limbs

    n_chunks = min(ext_len, n_partition)
    chunk = ext_len // n_chunks

    if n_chunks > 1 and n_chunks & (n_chunks - 1) == 0:
        # chunk-batched prover: all chunks' rounds in one device flow
        transcripts = [Transcript(b"RangeProof") for _ in range(n_chunks)]
        proofs, _v_chunks, V = RP.prove_multiple_batch(
            transcripts, shifted_ext.reshape(n_chunks, chunk), blind_ext, prove_range, rng,
            device, mesh)
    else:
        proofs, Vs = [], []
        blind_ints = sc.unpack_scalars(blind_ext)
        for c in range(n_chunks):
            proof, _v_bytes, V_c = RP.prove_multiple(
                Transcript(b"RangeProof"),
                [int(x) for x in shifted_ext[c * chunk:(c + 1) * chunk]],
                blind_ints[c * chunk:(c + 1) * chunk], prove_range, rng, device)
            proofs.append(proof)
            Vs.append(V_c)
        V = RP._point_concat(*Vs)

    # downshift: commit(-offset, 0) added to each (the original length only)
    offset = 1 << (prove_range - 1)
    inv_offset = G.pedersen_B().scalar_mul(SS.L - offset)
    commits = curve.add(RP._point_slice(V, slice(0, d)), curve.pack_points([inv_offset], device))
    return proofs, commits


def verify_rangeproof(
    proofs: list[RP.RangeProof],
    commits: PointArray,
    fp: FpConfig,
    prove_range: int,
    rng: np.random.Generator,
    mesh=None,
) -> bool:
    """verify_rangeproof (mod.rs:149-216) on the device of `commits`. The
    +offset re-shift, identity padding and encoding are batched; all chunks
    verify as one combined MSM (the reference loops verify_multiple per
    chunk), whose terms shard over the 'param' axis of `mesh` when one is
    given."""
    device = commits.device
    d = commits.x.shape[1]
    offset = 1 << (prove_range - 1)
    shifted = curve.add(commits, curve.pack_points([G.pedersen_B().scalar_mul(offset)], device))
    ext_len = next_pow2(d)
    if ext_len != d:
        ident = PointArray(*[c.expand(16, ext_len - d) for c in curve.identity((1,), device)])
        shifted = RP._point_concat(shifted, ident)
    all_bytes = RP._compress_bytes(shifted)
    if not proofs or ext_len % len(proofs):
        return False
    chunk = ext_len // len(proofs)
    items = [(Transcript(b"RangeProof"), proof, all_bytes[c * chunk:(c + 1) * chunk])
             for c, proof in enumerate(proofs)]
    return RP.verify_multiple_batch(items, prove_range, rng, device, mesh)
