"""FFI-parity API, aggregation section: the reference's C bindings for the
secure-aggregation round as one flat Python module.

Counterpart of ``rofl_tpu.bindings``: the same functions taking and returning
the identical bincode wire formats (see crypto/serde_vec.py), so a caller
can switch between the two packages blob for blob. The proof bindings follow
with the proofs. Heavy math runs on `device` (default the card): points are
decoded, added, committed and encoded by the CUDA kernels.

Error-returning functions (the PyRes family) raise ValueError with the
reference's error message semantics instead of returning {ret,msg} structs.
"""

from __future__ import annotations

import numpy as np
import torch

from .crypto import pedersen
from .crypto import serde_vec as sv
from .crypto.fp_codec import FpConfig
from .ops import bsgs, curve, fe, sc
from .ops.curve import PointArray

DEFAULT_FP = FpConfig(16, 7)


def say_hello() -> bytes:
    """bindings32.rs:43-58: returns serialize_scalar_vec([x]) smoke blob."""
    return sv.serialize_scalar_vec(sc.pack_scalars([42]))


# -- aggregation --------------------------------------------------------------


def add_commitments(commitment_blobs: list[bytes], device="cuda") -> bytes:
    """Elementwise sum of n Vec<RistrettoPoint> blobs (bindings32.rs:64-86)."""
    pts = [sv.deserialize_rp_vec(b, device) for b in commitment_blobs]
    acc = PointArray(*[torch.stack(cs, dim=1) for cs in zip(*pts)])
    return sv.serialize_rp_vec(curve.tree_sum(acc, axis=0))


def add_commitments_transposed(commitment_blobs: list[bytes], device="cuda") -> list[bytes]:
    """Each blob reduced to its own single-point sum (bindings32.rs:90-114)."""
    out = []
    for b in commitment_blobs:
        total = curve.tree_sum(sv.deserialize_rp_vec(b, device), axis=0)
        out.append(sv._wrap_bytes(curve.compress_to_bytes(total)[0].tobytes()))
    return out


def commit_no_blinding(values: np.ndarray, fp: FpConfig = DEFAULT_FP,
                       device="cuda") -> bytes:
    """f32 → Vec<RistrettoPoint> of unblinded commits (bindings32.rs:118-128)."""
    m = fe.to_tensor(fp.f32_to_scalar_limbs(np.asarray(values, np.float32)), device)
    return sv.serialize_rp_vec(pedersen.pedersen_commit_no_blinding(m))


def commit(values: np.ndarray, blinding_blob: bytes, fp: FpConfig = DEFAULT_FP,
           device="cuda") -> bytes:
    """f32 + Vec<Scalar> blindings → Pedersen commits (bindings32.rs:130-151)."""
    m = fe.to_tensor(fp.f32_to_scalar_limbs(np.asarray(values, np.float32)), device)
    r = fe.to_tensor(sv.deserialize_scalar_vec(blinding_blob), device)
    return sv.serialize_rp_vec(pedersen.pedersen_commit(m, r))


def generate_cancelling_blindings(n_vec: int, n_dim: int,
                                  rng: np.random.Generator | None = None,
                                  device="cuda") -> list[bytes]:
    """n_vec Vec<Scalar> blobs with elementwise sum ≡ 0 (bindings32.rs:154-166)."""
    rng = rng or np.random.default_rng()
    if n_vec == 1:
        return [sv.serialize_scalar_vec(pedersen.rnd_scalar_limbs(n_dim, rng, device))]
    vecs = pedersen.cancelling_scalar_limbs(n_vec, n_dim, rng, device)
    return [sv.serialize_scalar_vec(v) for v in vecs]


def select_blindings(blinding_blob: bytes, indices) -> bytes:
    """Index-select from a Vec<Scalar> blob (bindings32.rs:169-189)."""
    limbs = sv.deserialize_scalar_vec(blinding_blob)
    return sv.serialize_scalar_vec(limbs[:, np.asarray(indices, np.int64)])


def select_commitments(commit_blob: bytes, indices, device="cuda") -> bytes:
    """Index-select from a Vec<RistrettoPoint> blob (bindings32.rs:191-211)."""
    pts = sv.deserialize_rp_vec(commit_blob, device)
    idx = torch.as_tensor(np.asarray(indices, np.int64), device=pts.device)
    return sv.serialize_rp_vec(PointArray(*[torch.index_select(c, 1, idx) for c in pts]))


def extract_values(commit_blob: bytes, fp: FpConfig = DEFAULT_FP,
                   table_size: int | None = None, device="cuda") -> np.ndarray:
    """BSGS discrete log of each commitment → f32 (bindings32.rs:213-226).

    Default table matches the reference's default_discrete_log_vec
    (bsgs32.rs:36-38): m = 2^(BSGS_N_BITS/2 + PRECOMP_BIAS).
    """
    pts = sv.deserialize_rp_vec(commit_blob, device)
    m = table_size or fp.default_bsgs_table_size
    limbs, ok = bsgs.solve_discrete_log(pts, m, fp.bsgs_n_bits)
    if not bool(ok.all()):
        raise ValueError("discrete log not found")
    return fp.scalar_limbs_to_f32(fe.to_numpy(limbs))
