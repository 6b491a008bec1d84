"""Bincode-compatible (de)serializers — wire parity with the reference.

Counterpart of the scalar, point, compressed-point, ElGamal-pair,
Σ-proof and range-proof codecs of ``rofl_tpu.crypto.serde_vec``.

The reference serializes every crypto object through serde's
`serialize_bytes`, which bincode encodes as a u64 little-endian length
prefix followed by the raw bytes (rofl_crypto/src/serde_vec.rs:5-7 notes
the resulting 40-byte scalars). A `Vec<T>` adds one more u64 count prefix.
Element sizes on the wire:

  Scalar / RistrettoPoint / CompressedRistretto   8 + 32  = 40
  ElGamalPair (L||R compressed)                   8 + 64  = 72
  SquareRandProofCommitments (L||R||c_sq)         8 + 96  = 104
  RandProof (C'_L||C'_R||z_m||z_r)                8 + 128 = 136
  SquareProof (C'_l||C'_sq||z_m||z_r1||z_r2)      8 + 160 = 168
  SquareRandProof (C'_L||C'_R||C'_sq||z_m||z_r1||z_r2)  8 + 192 = 200

Bytes are handled on the host with numpy, whole vectors at a time; the
arrays feed the device kernels directly. Functions that create tensors take
the `device` to create them on.
"""

from __future__ import annotations

import struct

import numpy as np

from ..ops import curve, fe, sc
from ..ops.curve import PointArray
from ..spec import scalar as SS
from . import sigma
from .pedersen import ElGamalPairArray
from .range_proof import RangeProof


def _u64(n: int) -> bytes:
    return struct.pack("<Q", n)


def _read_u64(data: bytes, off: int) -> tuple[int, int]:
    return struct.unpack_from("<Q", data, off)[0], off + 8


def _wrap_bytes(raw: bytes) -> bytes:
    """serde serialize_bytes under bincode: u64 LE length + raw."""
    return _u64(len(raw)) + raw


def _iter_bytes_vec(data: bytes) -> list[bytes]:
    """Parse Vec<serialize_bytes-item> → list of raw element bytes."""
    count, off = _read_u64(data, 0)
    out = []
    for _ in range(count):
        ln, off = _read_u64(data, off)
        out.append(data[off:off + ln])
        off += ln
    if off != len(data):
        raise ValueError("trailing bytes in bincode vec")
    return out


def _bytes_vec(items: list[bytes]) -> bytes:
    return _u64(len(items)) + b"".join(_wrap_bytes(x) for x in items)


def _rows_vec(rows: np.ndarray) -> bytes:
    """(N, width) uint8 → bincode Vec of N serialize_bytes items of `width`."""
    rows = np.asarray(rows, dtype=np.uint8)
    n, width = rows.shape
    framed = np.empty((n, 8 + width), dtype=np.uint8)
    framed[:, :8] = np.frombuffer(_u64(width), dtype=np.uint8)
    framed[:, 8:] = rows
    return _u64(n) + framed.tobytes()


def _parse_rows_vec(data: bytes, width: int, what: str) -> np.ndarray:
    """Inverse of _rows_vec for items that must all be `width` bytes long;
    raises on another item length and on trailing bytes."""
    count, off = _read_u64(data, 0)
    if len(data) - off == count * (8 + width):
        framed = np.frombuffer(data, dtype=np.uint8, offset=off).reshape(count, 8 + width)
        if (framed[:, :8] == np.frombuffer(_u64(width), dtype=np.uint8)).all():
            return framed[:, 8:]
    # not the regular layout: walk it item by item to name the fault
    items = _iter_bytes_vec(data)
    for raw in items:
        if len(raw) != width:
            raise ValueError(f"bad {what} length")
    return np.frombuffer(b"".join(items), dtype=np.uint8).reshape(len(items), width)


def _limbs_below(limbs: np.ndarray, bound: int) -> np.ndarray:
    """(16, N) limbs → bool (N,): value < bound (borrow chain on the host)."""
    borrow = np.zeros(limbs.shape[1], dtype=np.int64)
    for k in range(16):
        d = limbs[k].astype(np.int64) - ((bound >> (16 * k)) & 0xFFFF) - borrow
        borrow = (d < 0).astype(np.int64)
    return borrow == 1


def _bytes_to_limbs(rows: np.ndarray) -> np.ndarray:
    """(N, 32) uint8 LE → (16, N) uint32 limbs, all 256 bits kept."""
    rows = rows.astype(np.uint32)
    return np.ascontiguousarray((rows[:, 0::2] | (rows[:, 1::2] << 8)).T)


# -- scalars ------------------------------------------------------------------


def scalar_limbs_to_bytes_list(limbs) -> list[bytes]:
    return [row.tobytes() for row in sc.to_bytes_array(limbs)]


def serialize_scalar_vec(limbs) -> bytes:
    """(16, N) canonical scalar limbs → bincode Vec<Scalar>."""
    return _rows_vec(sc.to_bytes_array(limbs))


def deserialize_scalar_vec(data: bytes) -> np.ndarray:
    """bincode Vec<Scalar> → (16, N) uint32 limbs on the host."""
    limbs = _bytes_to_limbs(_parse_rows_vec(data, 32, "Scalar"))
    if not _limbs_below(limbs, SS.L).all():
        raise ValueError("non-canonical scalar")
    return limbs


def serialize_scalar(limb_or_int) -> bytes:
    """Single Scalar → 40-byte bincode blob (serde_vec.rs:5-7)."""
    if isinstance(limb_or_int, int):
        return _wrap_bytes(SS.to_bytes(limb_or_int))
    return _wrap_bytes(scalar_limbs_to_bytes_list(limb_or_int)[0])


def deserialize_scalar(data: bytes) -> int:
    ln, off = _read_u64(data, 0)
    v = SS.from_canonical_bytes(data[off:off + ln])
    if v is None:
        raise ValueError("non-canonical scalar")
    return v


# -- points -------------------------------------------------------------------


def serialize_rp_vec(points: PointArray) -> bytes:
    """PointArray batch → bincode Vec<RistrettoPoint> (compressed wire form)."""
    return _rows_vec(curve.compress_to_bytes(points))


def deserialize_rp_vec(data: bytes, device="cuda") -> PointArray:
    """bincode Vec<RistrettoPoint> → PointArray (validates each encoding)."""
    return decompress_rows(_parse_rows_vec(data, 32, "point"), device)


def serialize_crp_vec(compressed: np.ndarray) -> bytes:
    """(N, 32) uint8 compressed encodings → bincode Vec<CompressedRistretto>."""
    return _rows_vec(np.asarray(compressed, dtype=np.uint8).reshape(-1, 32))


def deserialize_crp_vec(data: bytes) -> np.ndarray:
    return _parse_rows_vec(data, 32, "CompressedRistretto").copy()


def serialize_crp_vec_vec(vecs: list[np.ndarray]) -> bytes:
    return _u64(len(vecs)) + b"".join(serialize_crp_vec(v) for v in vecs)


def deserialize_crp_vec_vec(data: bytes) -> list[np.ndarray]:
    count, off = _read_u64(data, 0)
    out = []
    for _ in range(count):
        n, o2 = _read_u64(data, off)
        end = o2
        for _ in range(n):
            ln, end = _read_u64(data, end)
            end += ln
        out.append(deserialize_crp_vec(data[off:end]))
        off = end
    return out


def decompress_rows(rows: np.ndarray, device="cuda") -> PointArray:
    """(N, 32) uint8 encodings → PointArray on `device`; raises on a
    non-canonical field encoding (s >= p or s odd, per dalek decompress) and
    on an encoding that is no point."""
    pts, valid = curve.decompress_rows(rows, device)
    if not bool(valid.all()):
        raise ValueError("invalid ristretto encoding")
    return pts


def decompress_bytes_list(raws: list[bytes], device="cuda") -> PointArray:
    """List of 32-byte encodings → PointArray; raises on invalid points."""
    for raw in raws:
        if len(raw) != 32:
            raise ValueError("bad point length")
    return decompress_rows(
        np.frombuffer(b"".join(raws), dtype=np.uint8).reshape(len(raws), 32), device)


# -- ElGamal pairs ------------------------------------------------------------


def serialize_eg_pair_vec(pairs: ElGamalPairArray) -> bytes:
    return _rows_vec(np.concatenate(
        [curve.compress_to_bytes(pairs.L), curve.compress_to_bytes(pairs.R)], axis=1))


def deserialize_eg_pair_vec(data: bytes, device="cuda") -> ElGamalPairArray:
    rows = _parse_rows_vec(data, 64, "ElGamalPair")
    return ElGamalPairArray(
        L=decompress_rows(rows[:, :32], device),
        R=decompress_rows(rows[:, 32:], device),
    )


# -- Σ-proofs: rows of 32-byte point encodings followed by 32-byte scalars ----


def _proof_rows(points: list, scalars: list) -> np.ndarray:
    """Point batches and (16, N) scalar limbs → (N, 32·k) uint8 rows."""
    return np.concatenate(
        [curve.compress_to_bytes(p) for p in points]
        + [sc.to_bytes_array(z) for z in scalars], axis=1)


def _parse_proof_rows(data: bytes, n_points: int, n_scalars: int, what: str,
                      scalar_fault: str, device) -> tuple[list, list]:
    """Inverse of ``_proof_rows``: raises on a bad item length, then on a
    non-canonical scalar, then on an invalid point encoding. Scalars come
    back as int32 limb tensors on `device`."""
    rows = _parse_rows_vec(data, 32 * (n_points + n_scalars), what)
    cols = [rows[:, 32 * k:32 * (k + 1)] for k in range(n_points + n_scalars)]
    limbs = [_bytes_to_limbs(c) for c in cols[n_points:]]
    if not all(_limbs_below(z, SS.L).all() for z in limbs):
        raise ValueError(scalar_fault)
    return ([decompress_rows(c, device) for c in cols[:n_points]],
            [fe.to_tensor(z, device) for z in limbs])


def serialize_squaretriple_vec(c: sigma.SquareRandCommitVec) -> bytes:
    """Vec<SquareRandProofCommitments>: each C_L||C_R||C_sq."""
    return _rows_vec(_proof_rows([c.c.L, c.c.R, c.c_sq], []))


def deserialize_squaretriple_vec(data: bytes, device="cuda") -> sigma.SquareRandCommitVec:
    (left, right, c_sq), _ = _parse_proof_rows(
        data, 3, 0, "SquareRandProofCommitments", "", device)
    return sigma.SquareRandCommitVec(c=ElGamalPairArray(left, right), c_sq=c_sq)


def serialize_rand_proof_vec(proofs: sigma.RandProofVec) -> bytes:
    """Vec<RandProof>: each C'_L||C'_R||z_m||z_r (rand_proof/mod.rs:87-99)."""
    return _rows_vec(_proof_rows([proofs.c_prime.L, proofs.c_prime.R],
                                 [proofs.z_m, proofs.z_r]))


def deserialize_rand_proof_vec(data: bytes, device="cuda") -> sigma.RandProofVec:
    (left, right), (z_m, z_r) = _parse_proof_rows(
        data, 2, 2, "RandProof", "non-canonical RandProof scalars", device)
    return sigma.RandProofVec(c_prime=ElGamalPairArray(left, right), z_m=z_m, z_r=z_r)


def serialize_square_rand_proof_vec(p: sigma.SquareRandProofVec) -> bytes:
    """Vec<SquareRandProof>: C'eg(64)||C'ped(32)||z_m||z_r1||z_r2."""
    return _rows_vec(_proof_rows([p.c_prime.L, p.c_prime.R, p.c_sq_prime],
                                 [p.z_m, p.z_r1, p.z_r2]))


def deserialize_square_rand_proof_vec(data: bytes,
                                      device="cuda") -> sigma.SquareRandProofVec:
    (left, right, c_sq_prime), (z_m, z_r1, z_r2) = _parse_proof_rows(
        data, 3, 3, "SquareRandProof", "non-canonical scalars", device)
    return sigma.SquareRandProofVec(
        c_prime=ElGamalPairArray(left, right), c_sq_prime=c_sq_prime,
        z_m=z_m, z_r1=z_r1, z_r2=z_r2)


def serialize_square_proof_vec(p: sigma.SquareProofVec) -> bytes:
    """Vec<SquareProof>: C'_l(32)||C'_sq(32)||z_m||z_r1||z_r2."""
    return _rows_vec(_proof_rows([p.c_l_prime, p.c_sq_prime], [p.z_m, p.z_r1, p.z_r2]))


def deserialize_square_proof_vec(data: bytes, device="cuda") -> sigma.SquareProofVec:
    (c_l_prime, c_sq_prime), (z_m, z_r1, z_r2) = _parse_proof_rows(
        data, 2, 3, "SquareProof", "non-canonical scalars", device)
    return sigma.SquareProofVec(c_l_prime=c_l_prime, c_sq_prime=c_sq_prime,
                                z_m=z_m, z_r1=z_r1, z_r2=z_r2)


# -- RangeProof ---------------------------------------------------------------


def serialize_range_proof(proof: RangeProof) -> bytes:
    return _wrap_bytes(proof.to_bytes())


def deserialize_range_proof(data: bytes) -> RangeProof:
    ln, off = _read_u64(data, 0)
    return RangeProof.from_bytes(data[off:off + ln])


def serialize_range_proof_vec(proofs: list[RangeProof]) -> bytes:
    return _bytes_vec([p.to_bytes() for p in proofs])


def deserialize_range_proof_vec(data: bytes) -> list[RangeProof]:
    return [RangeProof.from_bytes(raw) for raw in _iter_bytes_vec(data)]
