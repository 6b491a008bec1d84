"""The check of a client's upload, independent of the system under test.

From the upload's wire bytes alone, and the plaintext update and blindings
that the benchmark handed the client, it checks:

  structure      every field present, at the sizes the configuration gives
  commitments    C_i = m_i B + r_i H and C_R_i = r_i B, with m_i the
                 fixed-point encoding of the clipped update and r_i the
                 blinding handed in (Pedersen / ElGamal, B the basepoint, H
                 the hash of its encoding under SHA3-512)
  sigma          the per-parameter Σ-proofs: rand proofs (L-infinity
                 deployments) or square-rand proofs (L2 deployments), with
                 each parameter's challenge from its own Merlin transcript
  range          the aggregated Bulletproofs, one a partition, over the
                 commitments shifted into [0, 2^range) and padded to a power
                 of two with the identity
  l2             the L2 deployment's Bulletproof on the sum of the square
                 commitments

The group equations of one kind are checked together, as one random linear
combination that must be the identity (one multi-scalar multiplication);
the weights come from the caller's rng.
"""

from __future__ import annotations

import hashlib

import numpy as np

from . import curve as C
from . import fixed_point as fxp
from .transcript import Transcript
from .wire import ENC_NORM_DATA, ENC_RANGE_DATA, parse_upload

SIGMA_DOMAIN = b"randomness proof v1"


def _rows(data: bytes, width: int) -> np.ndarray:
    return np.frombuffer(data, np.uint8).reshape(-1, width)


def _scalar_ints(rows: np.ndarray) -> list[int]:
    return [int.from_bytes(r.tobytes(), "little") for r in rows]


def _weights(rng: np.random.Generator, n: int) -> list[int]:
    """n random 128-bit weights of a batch check."""
    raw = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") | 1 for r in raw]


def pedersen_h(device):
    digest = np.frombuffer(hashlib.sha3_512(C.BASEPOINT_BYTES).digest(), np.uint8)
    return C.from_uniform_bytes(digest.reshape(1, 64), device)


def basepoint(device):
    pt, _ = C.decode(np.frombuffer(C.BASEPOINT_BYTES, np.uint8).reshape(1, 32), device)
    return pt


def bp_generators(n: int, m: int, device):
    """BulletproofGens(n, m): party j's G and H chains (SHAKE-256 of
    "GeneratorsChain" || b"G"/b"H" || le32(j), 64 bytes a point), party-major."""
    out = []
    for prefix in (b"G", b"H"):
        blobs = []
        for j in range(m):
            shake = hashlib.shake_256(b"GeneratorsChain" + prefix + j.to_bytes(4, "little"))
            blobs.append(shake.digest(64 * n))
        out.append(C.from_uniform_bytes(np.frombuffer(b"".join(blobs), np.uint8)
                                        .reshape(n * m, 64), device))
    return out


# -- range proofs ------------------------------------------------------------


def _split_proof(data: bytes, lg: int):
    """A RangeProof's wire bytes → (points (7 + 2 lg encodings as rows:
    A, S, T_1, T_2, L_0, R_0, ...), scalars t_x, t_x_blinding, e_blinding,
    a, b), or None where the length or a scalar is not canonical."""
    if len(data) != 32 * (9 + 2 * lg):
        return None
    rows = _rows(data, 32)
    sc = _scalar_ints(np.concatenate([rows[4:7], rows[-2:]]))
    if any(x >= C.L for x in sc):
        return None
    lr = rows[7:7 + 2 * lg]
    pts = np.concatenate([rows[0:4], lr[0::2], lr[1::2]])  # A S T1 T2, L..., R...
    return pts, sc


def _sum_powers(x: int, n: int) -> int:
    acc, cur = 0, 1
    for _ in range(n):
        acc = (acc + cur) % C.L
        cur = cur * x % C.L
    return acc


def range_check(label: bytes, proofs: list, v_bytes: np.ndarray, v_points, n: int,
                rng: np.random.Generator, device) -> bool:
    """Aggregated Bulletproofs of `len(proofs)` partitions, each over m values
    of n bits, checked together. v_bytes: (partitions, m, 32) encodings the
    transcripts absorb; v_points: the same commitments as points,
    partition-major (None for a partition where all are the identity: the
    identity adds nothing to the sum and is left out of it)."""
    parts, m = v_bytes.shape[0], v_bytes.shape[1]
    nm = n * m
    lg = nm.bit_length() - 1
    if len(proofs) != parts or nm != 1 << lg:
        return False
    split = [_split_proof(p, lg) for p in proofs]
    if any(s is None for s in split):
        return False
    pts_rows = np.stack([s[0] for s in split])  # (parts, 4 + 2 lg, 32)
    if (pts_rows == 0).all(axis=2).any():
        return False  # an identity encoding where the verifier refuses one
    t = Transcript(label, parts)
    t.append_message(b"dom-sep", b"rangeproof v1")
    t.append_u64(b"n", n)
    t.append_u64(b"m", m)
    for j in range(m):
        t.append_message(b"V", v_bytes[:, j])
    t.append_message(b"A", pts_rows[:, 0])
    t.append_message(b"S", pts_rows[:, 1])
    ys = t.challenge_scalars(b"y", C.L)
    zs = t.challenge_scalars(b"z", C.L)
    t.append_message(b"T_1", pts_rows[:, 2])
    t.append_message(b"T_2", pts_rows[:, 3])
    xs = t.challenge_scalars(b"x", C.L)
    for k, lab in enumerate((b"t_x", b"t_x_blinding", b"e_blinding")):
        t.append_message(lab, np.stack([np.frombuffer(s[1][k].to_bytes(32, "little"), np.uint8)
                                        for s in split]))
    ws = t.challenge_scalars(b"w", C.L)
    t.append_message(b"dom-sep", b"ipp v1")
    t.append_u64(b"n", nm)
    us = []
    for r in range(lg):
        t.append_message(b"L", pts_rows[:, 4 + r])
        t.append_message(b"R", pts_rows[:, 4 + lg + r])
        us.append(t.challenge_scalars(b"u", C.L))

    g_acc = [0] * nm
    h_acc = [0] * nm
    b_scalar = bb_scalar = 0
    point_scalars: list[int] = []
    two_pows = [pow(2, i, C.L) for i in range(n)]
    rho_all = _weights(rng, parts)
    c_all = _weights(rng, parts)
    for p in range(parts):
        y, z, x, w = ys[p], zs[p], xs[p], ws[p]
        t_x, t_xb, e_b, a, b = split[p][1]
        rho, c = rho_all[p], c_all[p]
        zz = z * z % C.L
        u = [us[r][p] for r in range(lg)]
        u_sq = [v * v % C.L for v in u]
        u_inv = [pow(v, C.L - 2, C.L) for v in u]
        u_inv_sq = [v * v % C.L for v in u_inv]
        s = [1]
        for v in u_inv:
            s[0] = s[0] * v % C.L
        for j in range(lg):
            k = u_sq[lg - 1 - j]
            s += [v * k % C.L for v in s]
        y_inv = pow(y, C.L - 2, C.L)
        z_pows = [1] * m
        for j in range(1, m):
            z_pows[j] = z_pows[j - 1] * z % C.L
        yi = 1
        for i in range(nm):
            j, bit = divmod(i, n)
            g_acc[i] = (g_acc[i] + rho * (-z - a * s[i])) % C.L
            hi = (z + yi * (zz * z_pows[j] * two_pows[bit] - b * s[nm - 1 - i])) % C.L
            h_acc[i] = (h_acc[i] + rho * hi) % C.L
            yi = yi * y_inv % C.L
        delta = ((z - zz) * _sum_powers(y, nm)
                 - zz * z % C.L * _sum_powers(2, n) * _sum_powers(z, m)) % C.L
        b_scalar = (b_scalar + rho * (w * (t_x - a * b) + c * (delta - t_x))) % C.L
        bb_scalar = (bb_scalar + rho * (-e_b - c * t_xb)) % C.L
        point_scalars += [rho * k % C.L for k in [1, x, c * x, c * x * x] + u_sq + u_inv_sq]
        if v_points[p] is not None:
            point_scalars += [rho * c * zz % C.L * zp % C.L for zp in z_pows]

    proof_pts, ok = C.decode(pts_rows.reshape(-1, 32), device)
    if not bool(ok.all()):
        return False
    # interleave each partition's proof points with its value commitments
    stride = 4 + 2 * lg
    pieces = []
    for p in range(parts):
        pieces.append(C.point_slice(proof_pts, slice(p * stride, (p + 1) * stride)))
        if v_points[p] is not None:
            pieces.append(v_points[p])
    gens_g, gens_h = bp_generators(n, m, device)
    pieces += [pedersen_h(device), basepoint(device), gens_g, gens_h]
    scalars = point_scalars + [bb_scalar, b_scalar] + g_acc + h_acc
    total = C.msm(C.point_cat(*pieces), C.scalars_to_bytes(scalars))
    return bool(C.is_identity(total)[0])


# -- the client's upload ------------------------------------------------------


def check_upload(cfg: dict, data: bytes, plaintext: np.ndarray, blindings: list[int],
                 rng: np.random.Generator, device) -> dict:
    """Every check of one upload → {check name: 1 where it failed, else 0}.
    cfg: the configuration file's keys (enc_type "l2" or "range", d,
    value_range, n_partition, l2_value_range, fp_bits, fp_frac)."""
    l2 = cfg["enc_type"] == "l2"
    d, n_bits = cfg["d"], cfg["value_range"]
    fails = {"structure": 1, "commitments_and_sigma": 1, "range_proofs": 1}
    if l2:
        fails["l2_proof"] = 1
    try:
        f = parse_upload(data, ENC_NORM_DATA if l2 else ENC_RANGE_DATA)
    except ValueError:
        return fails
    commit_w, proof_w = (96, 192) if l2 else (64, 128)
    ext = 1 << max(0, (d - 1).bit_length())
    parts = min(ext, cfg["n_partition"])
    shape_ok = (len(f.get("enc_values", b"")) == commit_w * d
                and len(f.get("square_proof" if l2 else "rand_proof", b"")) == proof_w * d
                and len(f["range_proof"]) == parts and f.get("range_bits") == n_bits)
    if l2:
        shape_ok &= f.get("l2_range_bits") == cfg["l2_value_range"]
    else:
        shape_ok &= f.get("check_percentage") == np.float32(cfg["check_percentage"])
    if not shape_ok:
        return fails
    fails["structure"] = 0

    clipped = fxp.clip(plaintext, cfg["fp_frac"], n_bits)
    m = fxp.scalars(fxp.signed_units(clipped, cfg["fp_bits"], cfg["fp_frac"]))
    commits = _rows(f["enc_values"], commit_w)
    proofs = _rows(f["square_proof" if l2 else "rand_proof"], proof_w)
    fails["commitments_and_sigma"] = int(not _sigma_check(
        l2, commits, proofs, m, blindings, rng, device))

    # the range proofs: commitments + 2^(range - 1) B, identity-padded
    c_l, ok = C.decode(commits[:, :32], device)
    if bool(ok.all()):
        offset = C.msm(basepoint(device), C.scalars_to_bytes([1 << (n_bits - 1)]))
        shifted = C.point_add(c_l, offset)
        enc = np.zeros((ext, 32), np.uint8)
        enc[:d] = C.encode(shifted)
        per = ext // parts
        v_points = []
        for p in range(parts):
            lo, hi = p * per, min(d, (p + 1) * per)
            if lo >= d:
                v_points.append(None)  # all identity: adds nothing to the sum
            elif hi - lo < per:
                v_points.append(C.point_cat(C.point_slice(shifted, slice(lo, hi)),
                                            C.identity(per - (hi - lo), device)))
            else:
                v_points.append(C.point_slice(shifted, slice(lo, hi)))
        fails["range_proofs"] = int(not range_check(
            b"RangeProof", f["range_proof"], enc.reshape(parts, per, 32), v_points, n_bits,
            rng, device))
    if l2:
        c_sq, ok_sq = C.decode(commits[:, 64:96], device)
        if bool(ok_sq.all()):
            total = C.point_sum(c_sq)
            fails["l2_proof"] = int(not range_check(
                b"L2RangeProof", [f["square_range_proof"]], C.encode(total).reshape(1, 1, 32),
                [total], cfg["l2_value_range"], rng, device))
    return fails


def _sigma_check(l2: bool, commits: np.ndarray, proofs: np.ndarray, m: list[int],
                 blindings: list[int], rng: np.random.Generator, device) -> bool:
    """Σ-proofs and commitments of every parameter, as one weighted sum."""
    d = commits.shape[0]
    label = b"SquareRandProof" if l2 else b"RandProof"
    t = Transcript(label, d, device)
    t.append_message(b"dom-sep", SIGMA_DOMAIN)
    if l2:
        t.append_message(b"C_eg", commits[:, :64])
        t.append_message(b"C_ped", commits[:, 64:96])
        t.append_message(b"C_prime_eg", proofs[:, :64])
        t.append_message(b"C_prime_ped", proofs[:, 64:96])
        zs = [_scalar_ints(proofs[:, 96 + 32 * k:128 + 32 * k]) for k in range(3)]
        point_rows = [commits[:, :32], commits[:, 32:64], commits[:, 64:96],
                      proofs[:, :32], proofs[:, 32:64], proofs[:, 64:96]]
    else:
        t.append_message(b"C", commits[:, :64])
        t.append_message(b"C_prime", proofs[:, :64])
        zs = [_scalar_ints(proofs[:, 64 + 32 * k:96 + 32 * k]) for k in range(2)]
        point_rows = [commits[:, :32], commits[:, 32:64], proofs[:, :32], proofs[:, 32:64]]
    ch = t.challenge_scalars(b"c", C.L)
    pts, ok = C.decode(np.concatenate(point_rows), device)
    if not bool(ok.all()):
        return False
    L = C.L
    r1, r2, r3, r4, r5 = (_weights(rng, d) for _ in range(5))
    z_m, z_r1 = zs[0], zs[1]
    # E1 z_m B + z_r1 H - C'_L - c C_L;  E2 z_r1 B - C'_R - c C_R
    # E3 (l2) z_m C_L + z_r2 H - C'_sq - c C_sq
    # E4 C_L - m B - r H;  E5 C_R - r B
    k_cl = [(-a * c + w4) % L for a, c, w4 in zip(r1, ch, r4)]
    if l2:
        k_cl = [(k + w3 * zm) % L for k, w3, zm in zip(k_cl, r3, z_m)]
    k_cr = [(-a * c + w5) % L for a, c, w5 in zip(r2, ch, r5)]
    coef_b = sum(a * zm + b * zr - w4 * mi - w5 * ri
                 for a, zm, b, zr, w4, mi, w5, ri in zip(r1, z_m, r2, z_r1, r4, m, r5, blindings))
    coef_h = sum(a * zr - w4 * ri for a, zr, w4, ri in zip(r1, z_r1, r4, blindings))
    scal = k_cl + k_cr
    if l2:
        coef_h += sum(w3 * zr2 for w3, zr2 in zip(r3, zs[2]))
        scal += [(-w3 * c) % L for w3, c in zip(r3, ch)]
        scal += [(-a) % L for a in r1] + [(-a) % L for a in r2] + [(-a) % L for a in r3]
    else:
        scal += [(-a) % L for a in r1] + [(-a) % L for a in r2]
    allp = C.point_cat(pts, basepoint(device), pedersen_h(device))
    total = C.msm(allp, C.scalars_to_bytes(scal + [coef_b % L, coef_h % L]))
    return bool(C.is_identity(total)[0])
