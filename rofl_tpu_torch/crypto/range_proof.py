"""Aggregated Bulletproofs range proofs and the inner-product argument.

Counterpart of ``rofl_tpu.crypto.range_proof``, a protocol-compatible rebuild
of the `bulletproofs 4.0` crate the reference uses (rofl_crypto/Cargo.toml:27;
driven from range_proof_vec/mod.rs and l2_range_proof_vec/mod.rs). The
dealer/party structure collapses into one prover whose vector phases are
batched device work:

  * bit decomposition, l/r vectors, t-poly inner products → ``ops/sc.py``
    (the ``sc_mul`` / ``sc_add`` / ``sc_sub`` / ``sc_sum`` kernels on the card)
  * A (a point sum) → ``curve.tree_sum(_groups)`` (the ``point_sum`` kernel)
  * S, the IPA L/R points and the verifier's single combined sum →
    ``ops/msm.py`` (the MSM kernel on the card)
  * IPA basis folds → ``curve.scalar_mul`` (the ``scalar_mul`` kernel)
  * generators G_i/H_i → SHAKE-256 on the host + batched Elligator
  * Fiat-Shamir → one host Merlin transcript per proof (``spec/merlin.py``,
    its sponge in the native helper), absorbing the commitments in bulk.

Transcript schedule (bulletproofs transcript.rs, dealer.rs, verification in
range_proof/mod.rs): rangeproof_domain_sep(n, m); "V"*m; "A"; "S"; y; z;
"T_1"; "T_2"; x; "t_x"; "t_x_blinding"; "e_blinding"; w; then the ipp:
innerproduct_domain_sep(nm); per round "L", "R", u.

Spans (``utils/profiling.py``): the provers' phases ``range_prove.commit``
(V, its encodings, the bits, A and S), ``range_prove.poly`` (y, z, the t
polynomials, T, x, w) and ``range_prove.ipp``; the batched verifier's
``range_verify.transcript`` (pass 1, on the host) and ``range_verify.msm``
(pass 2, to the identity check); ``setup.bp_gens`` on the generators' fill.
Pass 1 costs the Merlin transcripts and O(lg nm) big-int operations a
chunk, never a host loop over the nm terms: δ(y, z)'s power sums come by
doubling (the verifier takes only powers of two) and the chunks' challenges
are inverted in one batch.

Every function works on the device of its tensors, or on `device` where it
makes them. With ``device="cpu"`` the provers consume the rng exactly as the
JAX package does on JAX:CPU, so the same seed gives the same proof bytes; on
the card the keyed-XOF sampler gives other proofs, which verify the same.
Where the JAX package issues two MSMs in a row that do not depend on each
other (an IPA round's L and R, the two halves of S), the port issues one
grouped MSM: the same group elements in half the calls.

The mesh arguments (``mesh=None``) route as the JAX package's do: the
chunk-batched prover's A-term sums and S / IPA L-R MSMs go to
``parallel.mesh.sharded_tree_sum_groups`` / ``sharded_msm_grouped`` (whole
chunks a device, no collective; the local call where the groups do not
divide over the 'param' axis, judged on the port's own group counts, so an
IPA round's fused L and R count 2G groups), and the verifier's combined MSM
to ``sharded_msm``. The proof bytes do not depend on which way a group went.
Not carried: the ``ROFL_TIMING`` ticks.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..ops import curve, fe, msm, sc
from ..ops.curve import PointArray
from ..parallel import mesh as pmesh
from ..spec import generators as G
from ..spec import ristretto as SR
from ..spec import scalar as SS
from ..spec.merlin import Transcript
from ..utils.profiling import setup_span, span
from . import pedersen

IDENTITY_BYTES = bytes(32)


# -- generators --------------------------------------------------------------


@lru_cache(maxsize=16)
def _bp_gens(n: int, m: int, device: torch.device) -> tuple[PointArray, PointArray]:
    with setup_span("setup.bp_gens"):
        g_blobs, h_blobs = [], []
        for j in range(m):
            gb, hb = G.bp_gens_uniform_bytes(n, j)
            g_blobs.append(np.frombuffer(gb, np.uint8).reshape(n, 64))
            h_blobs.append(np.frombuffer(hb, np.uint8).reshape(n, 64))
        return (curve.from_uniform_bytes(np.concatenate(g_blobs), device),
                curve.from_uniform_bytes(np.concatenate(h_blobs), device))


_GENS_LOCK = threading.Lock()


def device_bp_gens(n: int, m: int, device="cuda") -> tuple[PointArray, PointArray]:
    """BulletproofGens(n, m) shares concatenated party-major, as points on
    `device`: host SHAKE-256 streams + batched Elligator map. Cached per
    (n, m, device); made once when several threads (a server's verifiers)
    ask at the same time."""
    with _GENS_LOCK:
        return _bp_gens(n, m, fe.canonical_device(device))


def _point_slice(p: PointArray, sl) -> PointArray:
    return PointArray(*[c[:, sl] for c in p])


def _point_concat(*points: PointArray) -> PointArray:
    return PointArray(*[torch.cat(cs, dim=-1) for cs in zip(*points)])


def _compress_bytes(p: PointArray) -> list[bytes]:
    return [bytes(row) for row in curve.compress_to_bytes(p)]


def _validate_and_append(t: Transcript, label: bytes, pt_bytes: bytes) -> bool:
    """bulletproofs TranscriptProtocol::validate_and_append_point: reject the
    identity encoding."""
    if pt_bytes == IDENTITY_BYTES:
        return False
    t.append_message(label, pt_bytes)
    return True


def _consts(xs, device) -> torch.Tensor:
    """Python ints → canonical scalar limbs (16, len(xs)) on `device`."""
    return fe.to_tensor(sc.pack_scalars(xs), device)


def _ints(limbs) -> list[int]:
    return sc.unpack_scalars(fe.to_numpy(limbs).reshape(sc.NLIMB, -1))


def _inv(x: int) -> int:
    return pow(x, SS.L - 2, SS.L)


# -- proof container ---------------------------------------------------------


@dataclass
class InnerProductProof:
    L: list[bytes]
    R: list[bytes]
    a: int
    b: int

    def to_bytes(self) -> bytes:
        out = b"".join(l + r for l, r in zip(self.L, self.R))
        return out + SS.to_bytes(self.a) + SS.to_bytes(self.b)


@dataclass
class RangeProof:
    """Mirror of bulletproofs::RangeProof. Wire form (dalek to_bytes):
    A, S, T_1, T_2, t_x, t_x_blinding, e_blinding, then the ipp's L_i, R_i
    interleaved and its a, b."""

    A: bytes
    S: bytes
    T_1: bytes
    T_2: bytes
    t_x: int
    t_x_blinding: int
    e_blinding: int
    ipp: InnerProductProof

    def to_bytes(self) -> bytes:
        return (
            self.A + self.S + self.T_1 + self.T_2
            + SS.to_bytes(self.t_x)
            + SS.to_bytes(self.t_x_blinding)
            + SS.to_bytes(self.e_blinding)
            + self.ipp.to_bytes()
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "RangeProof":
        if len(data) < 7 * 32 or len(data) % 32 != 0:
            raise ValueError("malformed RangeProof")
        head = [data[i * 32:(i + 1) * 32] for i in range(7)]
        rest = data[7 * 32:]
        n_pts = len(rest) // 32 - 2
        if n_pts < 0 or n_pts % 2:
            raise ValueError("malformed ipp")
        k = n_pts // 2
        L = [rest[i * 64: i * 64 + 32] for i in range(k)]
        R = [rest[i * 64 + 32: i * 64 + 64] for i in range(k)]
        a = SS.from_canonical_bytes(rest[-64:-32])
        b = SS.from_canonical_bytes(rest[-32:])
        if a is None or b is None:
            raise ValueError("non-canonical ipp scalars")
        tx = SS.from_canonical_bytes(head[4])
        txb = SS.from_canonical_bytes(head[5])
        eb = SS.from_canonical_bytes(head[6])
        if tx is None or txb is None or eb is None:
            raise ValueError("non-canonical scalars")
        return cls(head[0], head[1], head[2], head[3], tx, txb, eb,
                   InnerProductProof(L, R, a, b))


# -- prover ------------------------------------------------------------------


def _bits(values: np.ndarray, n: int) -> np.ndarray:
    """(k,) uint64 values → their n low bits, value-major, as (k·n,) int64."""
    values = np.asarray(values, dtype=np.uint64)
    return ((values[:, None] >> np.arange(n, dtype=np.uint64)) & 1).ravel().astype(np.int64)


def _a_vectors(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a_L (the bits as scalars) and a_R = a_L - 1."""
    a_L = fe.zeros(bits.shape, bits.device)
    a_L[0] = bits.to(fe.DTYPE)
    return a_L, sc.sub(a_L, sc.ones((1,), bits.device))


def prove_multiple(
    transcript: Transcript,
    values: list[int],
    blindings: list[int],
    n: int,
    rng: np.random.Generator,
    device="cuda",
) -> tuple[RangeProof, list[bytes], PointArray]:
    """RangeProof::prove_multiple (range_proof/mod.rs + party/dealer).

    values: non-negative ints < 2^n (the shifted fixed-point values,
    range_proof_vec/mod.rs:36-43); blindings: scalars. m = len(values) must
    be a power of two (range_proof_vec pads, mod.rs:46-51).

    Returns (proof, V_bytes, V_points): the V commitments as compressed bytes
    (transcript, wire) and as points on `device`.
    """
    m = len(values)
    if m & (m - 1):
        raise ValueError("m must be a power of two")
    nm = n * m
    with span("range_prove.commit"):
        gens_G, gens_H = device_bp_gens(n, m, device)

        transcript.append_message(b"dom-sep", b"rangeproof v1")
        transcript.append_u64(b"n", n)
        transcript.append_u64(b"m", m)

        # V commitments (per party): B^v · H^gamma
        V = pedersen.pedersen_commit(_consts(values, device), _consts(blindings, device))
        V_bytes = _compress_bytes(V)
        transcript.append_messages(b"V", V_bytes)

        bits = torch.from_numpy(_bits(np.array([int(v) for v in values], np.uint64), n)
                                ).to(device)
        a_L, a_R = _a_vectors(bits)

        # A = B_blinding^a_blinding + Σ (bit ? G_i : -H_i)
        a_blinding = _ints(pedersen.rnd_scalar_tensor(1, rng, device))[0]
        terms = curve.select(bits == 1, gens_G, curve.neg(gens_H))
        A_pt = curve.add(pedersen.base_H().mul(_consts([a_blinding], device)),
                         curve.tree_sum(terms))
        # S = B_blinding^s_blinding + <s_L, G> + <s_R, H>: one MSM over [G | H]
        s_blinding = _ints(pedersen.rnd_scalar_tensor(1, rng, device))[0]
        s_L = pedersen.rnd_scalar_tensor(nm, rng, device)
        s_R = pedersen.rnd_scalar_tensor(nm, rng, device)
        S_pt = curve.add(pedersen.base_H().mul(_consts([s_blinding], device)),
                         msm.msm(_point_concat(gens_G, gens_H), torch.cat([s_L, s_R], dim=1)))
        A_bytes, S_bytes = _compress_bytes(_point_concat(A_pt, S_pt))
        transcript.append_message(b"A", A_bytes)
        transcript.append_message(b"S", S_bytes)

    with span("range_prove.poly"):
        y = transcript.challenge_scalar(b"y")
        z = transcript.challenge_scalar(b"z")
        zz = (z * z) % SS.L

        exp_y = sc.powers(_consts([y], device), nm)
        zz2 = _zz2_vec(n, m, z, zz, device)
        z_vec = _consts([z], device)

        l0 = sc.sub(a_L, z_vec)
        l1 = s_L
        r0 = sc.add(sc.mul(exp_y, sc.add(a_R, z_vec)), zz2)
        r1 = sc.mul(exp_y, s_R)

        t0_i, t2_i, t1f_i = _ints(torch.cat([
            sc.inner_product(l0, r0, axis=0), sc.inner_product(l1, r1, axis=0),
            sc.inner_product(sc.add(l0, l1), sc.add(r0, r1), axis=0)], dim=1))
        t1_i = (t1f_i - t0_i - t2_i) % SS.L

        t_1_blinding = _ints(pedersen.rnd_scalar_tensor(1, rng, device))[0]
        t_2_blinding = _ints(pedersen.rnd_scalar_tensor(1, rng, device))[0]
        T_bytes = _compress_bytes(pedersen.pedersen_commit(
            _consts([t1_i, t2_i], device), _consts([t_1_blinding, t_2_blinding], device)))
        transcript.append_message(b"T_1", T_bytes[0])
        transcript.append_message(b"T_2", T_bytes[1])

        x = transcript.challenge_scalar(b"x")

        t_x = (t0_i + t1_i * x + t2_i * x * x) % SS.L
        t_x_blinding = (
            sum(zz * pow(z, j, SS.L) * blindings[j] for j in range(m))
            + x * t_1_blinding + x * x * t_2_blinding
        ) % SS.L
        e_blinding = (a_blinding + x * s_blinding) % SS.L

        transcript.append_message(b"t_x", SS.to_bytes(t_x))
        transcript.append_message(b"t_x_blinding", SS.to_bytes(t_x_blinding))
        transcript.append_message(b"e_blinding", SS.to_bytes(e_blinding))

        w = transcript.challenge_scalar(b"w")
        Q = curve.pack_points([SR.BASEPOINT.scalar_mul(w)], device)

        x_c = _consts([x], device)
        l_vec = sc.add(l0, sc.mul(l1, x_c))
        r_vec = sc.add(r0, sc.mul(r1, x_c))

    with span("range_prove.ipp"):
        # The H factors y^-i are not multiplied into the H points (dalek scales
        # the bases, a ladder a lane): they ride along as pending scalar factors
        # in _ipp_create and touch only the mod-l vectors; the group outputs are
        # the same.
        ipp = _ipp_create(transcript, Q, gens_G, gens_H, l_vec, r_vec, nm, _inv(y))

    proof = RangeProof(A_bytes, S_bytes, T_bytes[0], T_bytes[1], t_x, t_x_blinding,
                       e_blinding, ipp)
    return proof, V_bytes, V


def _u64_to_limbs(vals: np.ndarray) -> np.ndarray:
    """(N,) uint64 (< 2^64 < l) → (16, N) uint32 limb scalars, vectorised."""
    vals = np.asarray(vals, dtype=np.uint64)
    out = np.zeros((16, vals.shape[0]), dtype=np.uint32)
    for k in range(4):
        out[k] = ((vals >> np.uint64(16 * k)) & np.uint64(0xFFFF)).astype(np.uint32)
    return out


def _tile_points(p: PointArray, g: int) -> PointArray:
    return PointArray(*[c.repeat(1, g) for c in p])


def _p3(p: PointArray, n_groups: int, s: int) -> PointArray:
    return PointArray(*[c.reshape(16, n_groups, s) for c in p])


def _pflat(p: PointArray) -> PointArray:
    return PointArray(*[c.reshape(16, -1) for c in p])


def _pslice3(p: PointArray, sl) -> PointArray:
    return PointArray(*[c[:, :, sl] for c in p])


def _pconcat3(a: PointArray, b: PointArray) -> PointArray:
    return PointArray(*[torch.cat([x, y], dim=2) for x, y in zip(a, b)])


def _columns(xs, device) -> torch.Tensor:
    """One scalar per group → (16, G, 1)."""
    return _consts(xs, device)[:, :, None]


def _msm_grouped(points: PointArray, scalars: torch.Tensor, group: int, mesh) -> PointArray:
    """Per-chunk MSMs, mesh-routed over 'param' when a mesh is given."""
    if mesh is not None:
        return pmesh.sharded_msm_grouped(mesh, points, scalars, group)
    return msm.msm_grouped(points, scalars, group)


def _tree_sum_groups(p: PointArray, group: int, mesh) -> PointArray:
    if mesh is not None:
        return pmesh.sharded_tree_sum_groups(mesh, p, group)
    return curve.tree_sum_groups(p, group)


def prove_multiple_batch(
    transcripts: list[Transcript],
    values_chunks: np.ndarray,
    blind_limbs,
    n: int,
    rng: np.random.Generator,
    device="cuda",
    mesh=None,
) -> tuple[list[RangeProof], list[list[bytes]], PointArray]:
    """All chunks of a vector proved in one device flow.

    The reference proves chunks in parallel rayon tasks
    (range_proof_vec/mod.rs:53-78); here the chunk axis is batched into the
    lanes: every per-round operation (inner products, L/R MSMs, basis folds)
    runs once over G · nm lanes with group-local sums. Each chunk keeps its
    own Merlin transcript and challenges; the proofs are those of sequential
    ``prove_multiple`` calls.

    values_chunks: (G, m) uint64 shifted in-range values; blind_limbs:
    (16, G·m) scalar limbs (numpy or a tensor).
    """
    values_chunks = np.asarray(values_chunks, dtype=np.uint64)
    n_groups, m = values_chunks.shape
    nm = n * m
    lanes = n_groups * nm
    with span("range_prove.commit"):
        gens_G, gens_H = device_bp_gens(n, m, device)
        gens_G_t = _tile_points(gens_G, n_groups)
        gens_H_t = _tile_points(gens_H, n_groups)

        all_vals = values_chunks.reshape(-1)
        gamma = (blind_limbs.to(device) if isinstance(blind_limbs, torch.Tensor)
                 else fe.to_tensor(blind_limbs, device))
        V = pedersen.pedersen_commit(fe.to_tensor(_u64_to_limbs(all_vals), device), gamma)
        V_bytes_all = _compress_bytes(V)
        V_chunks = [V_bytes_all[g * m:(g + 1) * m] for g in range(n_groups)]

        bits = torch.from_numpy(_bits(all_vals, n)).to(device)
        a_L, a_R = _a_vectors(bits)

        # A_g = H^a_blind_g + Σ over group g of (bit ? G_i : -H_i)
        a_blind = pedersen.rnd_scalar_tensor(n_groups, rng, device)
        terms = curve.select(bits == 1, gens_G_t, curve.neg(gens_H_t))
        A_pt = curve.add(pedersen.base_H().mul(a_blind), _tree_sum_groups(terms, nm, mesh))
        del terms

        # S_g = H^s_blind_g + <s_L, G> + <s_R, H> per group
        s_blind = pedersen.rnd_scalar_tensor(n_groups, rng, device)
        s_L = pedersen.rnd_scalar_tensor(lanes, rng, device).reshape(16, n_groups, nm)
        s_R = pedersen.rnd_scalar_tensor(lanes, rng, device).reshape(16, n_groups, nm)
        bases_GH = _tile_points(_point_concat(gens_G, gens_H), n_groups)
        s_cat = torch.cat([s_L, s_R], dim=2).reshape(16, 2 * lanes)
        S_pt = curve.add(pedersen.base_H().mul(s_blind),
                         _msm_grouped(bases_GH, s_cat, 2 * nm, mesh))
        del bases_GH, s_cat
        AS_bytes = _compress_bytes(_point_concat(A_pt, S_pt))

    with span("range_prove.poly"):
        for t, vbs in zip(transcripts, V_chunks):
            t.append_message(b"dom-sep", b"rangeproof v1")
            t.append_u64(b"n", n)
            t.append_u64(b"m", m)
            t.append_messages(b"V", vbs)

        ys, zs = [], []
        for g, t in enumerate(transcripts):
            t.append_message(b"A", AS_bytes[g])
            t.append_message(b"S", AS_bytes[n_groups + g])
            ys.append(t.challenge_scalar(b"y"))
            zs.append(t.challenge_scalar(b"z"))
        zzs = [(z * z) % SS.L for z in zs]

        exp_y = torch.cat([sc.powers(_consts([y], device), nm) for y in ys], dim=1)
        zz2 = torch.cat([_zz2_vec(n, m, z, zz, device) for z, zz in zip(zs, zzs)], dim=1)
        z_rep = torch.repeat_interleave(_consts(zs, device), nm, dim=1)

        l0 = sc.sub(a_L, z_rep)
        l1 = s_L.reshape(16, lanes)
        r0 = sc.add(sc.mul(exp_y, sc.add(a_R, z_rep)), zz2)
        r1 = sc.mul(exp_y, s_R.reshape(16, lanes))

        t_polys = _ints(torch.cat([
            sc.sum_reduce_groups(sc.mul(l0, r0), nm), sc.sum_reduce_groups(sc.mul(l1, r1), nm),
            sc.sum_reduce_groups(sc.mul(sc.add(l0, l1), sc.add(r0, r1)), nm)], dim=1))
        t0_i, t2_i, t1f_i = (t_polys[k * n_groups:(k + 1) * n_groups] for k in range(3))
        t1_i = [(f - a0 - a2) % SS.L for f, a0, a2 in zip(t1f_i, t0_i, t2_i)]

        t1_blind = _ints(pedersen.rnd_scalar_tensor(n_groups, rng, device))
        t2_blind = _ints(pedersen.rnd_scalar_tensor(n_groups, rng, device))
        T_bytes = _compress_bytes(pedersen.pedersen_commit(
            _consts(t1_i + t2_i, device), _consts(t1_blind + t2_blind, device)))  # T1s then T2s
        xs = []
        for g, t in enumerate(transcripts):
            t.append_message(b"T_1", T_bytes[g])
            t.append_message(b"T_2", T_bytes[n_groups + g])
            xs.append(t.challenge_scalar(b"x"))

        # Σ_j zz·z^j·γ_{g,j} per chunk, on the device
        zz_zj = torch.cat([sc.mul(sc.powers(_consts([z], device), m), _consts([zz], device))
                           for z, zz in zip(zs, zzs)], dim=1)  # (16, G·m)
        bsums = _ints(sc.sum_reduce_groups(sc.mul(zz_zj, gamma), m))

        a_bls = _ints(a_blind)
        s_bls = _ints(s_blind)
        t_xs, t_x_blinds, e_blinds, ws = [], [], [], []
        for g, t in enumerate(transcripts):
            x = xs[g]
            t_x = (t0_i[g] + t1_i[g] * x + t2_i[g] * x * x) % SS.L
            t_x_blinding = (bsums[g] + x * t1_blind[g] + x * x * t2_blind[g]) % SS.L
            e_blinding = (a_bls[g] + x * s_bls[g]) % SS.L
            t.append_message(b"t_x", SS.to_bytes(t_x))
            t.append_message(b"t_x_blinding", SS.to_bytes(t_x_blinding))
            t.append_message(b"e_blinding", SS.to_bytes(e_blinding))
            ws.append(t.challenge_scalar(b"w"))
            t_xs.append(t_x)
            t_x_blinds.append(t_x_blinding)
            e_blinds.append(e_blinding)

        x_rep = _columns(xs, device)
        a_vec = sc.add(l0.reshape(16, n_groups, nm), sc.mul(l1.reshape(16, n_groups, nm), x_rep))
        b_vec = sc.add(r0.reshape(16, n_groups, nm), sc.mul(r1.reshape(16, n_groups, nm), x_rep))

    with span("range_prove.ipp"):
        ipps = _ipp_create_batch(transcripts, ws, gens_G_t, gens_H_t, a_vec, b_vec, nm,
                                 [_inv(y) for y in ys], mesh)

    proofs = [RangeProof(AS_bytes[g], AS_bytes[n_groups + g], T_bytes[g], T_bytes[n_groups + g],
                         t_xs[g], t_x_blinds[g], e_blinds[g], ipps[g])
              for g in range(n_groups)]
    return proofs, V_chunks, V


def _ipp_create_batch(
    transcripts: list[Transcript],
    ws: list[int],
    G_pts: PointArray,
    H_pts: PointArray,
    a: torch.Tensor,  # (16, G, nm)
    b: torch.Tensor,
    n: int,
    y_invs: list[int],
    mesh=None,
) -> list[InnerProductProof]:
    """Chunk-batched InnerProductProof::create: the factored folds of
    ``_ipp_create`` with per-chunk pending scalars, and the w_g·Q term as a
    fixed-base B multiply. A round's L and R sums are one grouped MSM over
    2G groups of s terms."""
    n_groups = len(transcripts)
    device = a.device
    for t in transcripts:
        t.append_message(b"dom-sep", b"ipp v1")
        t.append_u64(b"n", n)

    y_inv_pows = torch.stack(
        [sc.powers(_consts([yi], device), max(n // 2, 1)) for yi in y_invs], dim=1)

    Gc = _p3(G_pts, n_groups, n)
    Hc = _p3(H_pts, n_groups, n)
    gps = [1] * n_groups
    chs = [1] * n_groups
    L_bytes: list[list[bytes]] = [[] for _ in range(n_groups)]
    R_bytes: list[list[bytes]] = [[] for _ in range(n_groups)]
    base_B = pedersen.base_B()
    w_col = _consts(ws, device)

    s = n
    while s > 1:
        h = s // 2
        a_L, a_R = a[:, :, :h], a[:, :, h:s]
        b_L, b_R = b[:, :, :h], b[:, :, h:s]
        G_L, G_R = _pslice3(Gc, slice(0, h)), _pslice3(Gc, slice(h, s))
        H_L, H_R = _pslice3(Hc, slice(0, h)), _pslice3(Hc, slice(h, s))

        c_LR = sc.sum_reduce_groups(torch.cat(
            [sc.mul(a_L, b_R), sc.mul(a_R, b_L)], dim=1).reshape(16, -1), h)  # (16, 2G)

        ypend = sc.mul(y_inv_pows[:, :, :h], _columns(chs, device))
        gp_rep = _columns(gps, device)
        yRs = [pow(yi, h, SS.L) for yi in y_invs]

        # L_g = gp·<a_L, Ĝ_R> + <ch·y^-j·b_R, Ĥ_L> + c_L·w·B, R_g the mirror;
        # bases (16, 2G, s): the L groups, then the R groups
        bases = PointArray(*[torch.cat([torch.cat([gr, hl], dim=2), torch.cat([gl, hr], dim=2)],
                                       dim=1) for gr, hl, gl, hr in zip(G_R, H_L, G_L, H_R)])
        scal = torch.cat([
            torch.cat([sc.mul(a_L, gp_rep), sc.mul(b_R, ypend)], dim=2),
            torch.cat([sc.mul(a_R, gp_rep),
                       sc.mul(b_L, sc.mul(ypend, _columns(yRs, device)))], dim=2)], dim=1)
        LR_sum = _msm_grouped(_pflat(bases), scal.reshape(16, -1), s, mesh)
        LR_pt = curve.add(LR_sum, base_B.mul(sc.mul(c_LR, w_col.repeat(1, 2))))

        both = _compress_bytes(LR_pt)
        us, u_invs = [], []
        for g, t in enumerate(transcripts):
            Lb, Rb = both[g], both[n_groups + g]
            L_bytes[g].append(Lb)
            R_bytes[g].append(Rb)
            t.append_message(b"L", Lb)
            t.append_message(b"R", Rb)
            u = t.challenge_scalar(b"u")
            us.append(u)
            u_invs.append(_inv(u))

        u_rep = _columns(us, device)
        uinv_rep = _columns(u_invs, device)
        a = sc.add(sc.mul(a_L, u_rep), sc.mul(a_R, uinv_rep))
        b = sc.add(sc.mul(b_L, uinv_rep), sc.mul(b_R, u_rep))
        if h > 1:
            usq = [(u * u) % SS.L for u in us]
            uisq_yR = [((ui * ui) % SS.L) * yR % SS.L for ui, yR in zip(u_invs, yRs)]
            # one fold for both bases: [Ĝ'|Ĥ'] = [Ĝ_L|Ĥ_L] + [u²|u⁻²y^-h]·[Ĝ_R|Ĥ_R]
            fold_k = torch.cat([_columns(usq, device).expand(16, n_groups, h),
                                _columns(uisq_yR, device).expand(16, n_groups, h)], dim=2)
            folded = _p3(curve.add(
                _pflat(_pconcat3(G_L, H_L)),
                curve.scalar_mul(_pflat(_pconcat3(G_R, H_R)), fold_k.reshape(16, -1)),
            ), n_groups, 2 * h)
            Gc = _pslice3(folded, slice(0, h))
            Hc = _pslice3(folded, slice(h, 2 * h))
            gps = [(gp * ui) % SS.L for gp, ui in zip(gps, u_invs)]
            chs = [(c * u) % SS.L for c, u in zip(chs, us)]
        s = h

    a_fin = _ints(a.reshape(16, n_groups))
    b_fin = _ints(b.reshape(16, n_groups))
    return [InnerProductProof(L_bytes[g], R_bytes[g], a_fin[g], b_fin[g])
            for g in range(n_groups)]


def _ipp_create(
    transcript: Transcript,
    Q: PointArray,
    G_pts: PointArray,
    H_pts: PointArray,
    a: torch.Tensor,
    b: torch.Tensor,
    n: int,
    y_inv: int,
) -> InnerProductProof:
    """InnerProductProof::create, factored-fold formulation.

    Gives the L/R points of dalek's create() with G_factors = 1,
    H_factors = y^-i, but keeps scalars out of the base points where a
    pending-scalar substitution can do the work in mod-l arithmetic:

      * the y^-i H factors stay a pending per-lane factor c_k·y^-j
        (geometric, ratio kept by the folds) on the L/R MSM scalars;
      * each fold Ĝ' = u_inv·G_L + u·G_R is computed as Ĝ_L + u²·Ĝ_R with
        the global u_inv tracked in gp (compensated in the MSM scalars):
        one half-length ladder instead of two full-length ones.

    A round's L and R are one grouped MSM of two groups of s + 1 terms.
    """
    device = a.device
    transcript.append_message(b"dom-sep", b"ipp v1")
    transcript.append_u64(b"n", n)

    y_inv_pows = sc.powers(_consts([y_inv], device), n)

    gp = 1  # G pending: G^(k) = gp · Ĝ^(k)
    ch = 1  # H pending scale: H^(k)_j = ch · y^-j · Ĥ^(k)_j

    L_bytes: list[bytes] = []
    R_bytes: list[bytes] = []
    s = n
    while s > 1:
        h = s // 2
        a_L, a_R = a[:, :h], a[:, h:s]
        b_L, b_R = b[:, :h], b[:, h:s]
        G_L, G_R = _point_slice(G_pts, slice(0, h)), _point_slice(G_pts, slice(h, s))
        H_L, H_R = _point_slice(H_pts, slice(0, h)), _point_slice(H_pts, slice(h, s))

        c_L = sc.inner_product(a_L, b_R)
        c_R = sc.inner_product(a_R, b_L)

        ypend = sc.mul(y_inv_pows[:, :h], _consts([ch], device))
        yR = pow(y_inv, h, SS.L)
        gp_c = _consts([gp], device)
        # L = gp·<a_L, Ĝ_R> + <ch·y^-j·b_R, Ĥ_L> + c_L·Q (true group values)
        L_scal = torch.cat([sc.mul(a_L, gp_c), sc.mul(b_R, ypend), c_L], dim=1)
        R_scal = torch.cat([sc.mul(a_R, gp_c),
                            sc.mul(b_L, sc.mul(ypend, _consts([yR], device))), c_R], dim=1)
        LR_pt = msm.msm_grouped(_point_concat(G_R, H_L, Q, G_L, H_R, Q),
                                torch.cat([L_scal, R_scal], dim=1), s + 1)

        Lb, Rb = _compress_bytes(LR_pt)
        L_bytes.append(Lb)
        R_bytes.append(Rb)
        transcript.append_message(b"L", Lb)
        transcript.append_message(b"R", Rb)
        u = transcript.challenge_scalar(b"u")
        u_inv = _inv(u)

        u_c, uinv_c = _consts([u], device), _consts([u_inv], device)
        a = sc.add(sc.mul(a_L, u_c), sc.mul(a_R, uinv_c))
        b = sc.add(sc.mul(b_L, uinv_c), sc.mul(b_R, u_c))
        if h > 1:
            usq = (u * u) % SS.L
            uinv_sq = (u_inv * u_inv) % SS.L
            # Ĝ' = Ĝ_L + u²·Ĝ_R (true G' = gp·u_inv·Ĝ');
            # Ĥ' = Ĥ_L + (u_inv²·y^-h)·Ĥ_R (true H'_j = ch·u·y^-j·Ĥ'_j): one ladder
            fold_k = torch.cat([_consts([usq], device).expand(16, h),
                                _consts([(uinv_sq * yR) % SS.L], device).expand(16, h)], dim=1)
            folded = curve.add(_point_concat(G_L, H_L),
                               curve.scalar_mul(_point_concat(G_R, H_R), fold_k))
            G_pts = _point_slice(folded, slice(0, h))
            H_pts = _point_slice(folded, slice(h, 2 * h))
            gp = (gp * u_inv) % SS.L
            ch = (ch * u) % SS.L
        s = h

    a_final = _ints(a[:, :1])[0]
    b_final = _ints(b[:, :1])[0]
    return InnerProductProof(L_bytes, R_bytes, a_final, b_final)


# -- verifier ----------------------------------------------------------------


def _zz2_vec(n: int, m: int, z: int, zz: int, device="cuda") -> torch.Tensor:
    """(16, n·m) vector of z²·z^j·2^i at index k = j·n + i, on `device`."""
    two_pows = sc.powers(_consts([2], device), n)
    z_pows = sc.mul(sc.powers(_consts([z], device), m), _consts([zz], device))
    return sc.mul(torch.repeat_interleave(z_pows, n, dim=1), two_pows.repeat(1, m))


def _sum_of_powers(x: int, n: int) -> int:
    """Σ_{k<n} x^k mod ℓ for n = 0 or a power of two, by doubling as dalek's
    util::sum_of_powers: Σ_{k<2N} x^k = (1 + x^N)·Σ_{k<N} x^k, 2·log₂n
    multiplications and no division, so x = 1 needs no case of its own. The
    verifier takes no other n; any other n raises ValueError."""
    if n < 2:
        return n
    if n & (n - 1):
        raise ValueError(f"power sum over {n} terms: not a power of two")
    result, factor = (1 + x) % SS.L, x % SS.L
    while n > 2:
        factor = (factor * factor) % SS.L
        result = (result + factor * result) % SS.L
        n //= 2
    return result


def _delta(n: int, m: int, y: int, z: int) -> int:
    """(z−z²)·Σ_{k<nm} y^k − z³·Σ_{i<n} 2^i·Σ_{j<m} z^j; Σ_{i<n} 2^i is
    2^n − 1."""
    zz = (z * z) % SS.L
    return (
        (z - zz) * _sum_of_powers(y, n * m)
        - (zz * z % SS.L) * ((1 << n) - 1) * _sum_of_powers(z, m)
    ) % SS.L


def _batch_inv(values: list[int]) -> list[int]:
    """[_inv(v) for v in values] with one ``pow`` (Montgomery's trick): the
    running product of the nonzero values is inverted once and unwound; a
    value ≡ 0 is left out of the product and maps to 0, as ``_inv`` maps it."""
    vs = [v % SS.L for v in values]
    prefix = []
    acc = 1
    for v in vs:
        prefix.append(acc)
        if v:
            acc = (acc * v) % SS.L
    inv = _inv(acc)
    out = [0] * len(vs)
    for i in range(len(vs) - 1, -1, -1):
        if vs[i]:
            out[i] = (inv * prefix[i]) % SS.L
            inv = (inv * vs[i]) % SS.L
    return out


def _pow_rows(base: torch.Tensor, count: int) -> torch.Tensor:
    """Per-group powers by doubling: base (16, G, 1) → [1, b, b², …] rows
    (16, G, count)."""
    rows = sc.ones((base.shape[1], 1), base.device)
    cur = base
    while rows.shape[2] < count:
        rows = torch.cat([rows, sc.mul(rows, cur)], dim=2)
        cur = sc.mul(cur, cur)
    return rows[:, :, :count]


def verify_multiple_batch(
    items: list[tuple[Transcript, RangeProof, list[bytes]]],
    n: int,
    rng: np.random.Generator,
    device="cuda",
    mesh=None,
) -> bool:
    """Batched RangeProof::verify_multiple_with_rng over many aggregated
    proofs sharing the same (n, m) generators: the chunks of one vector
    verify as one MSM.

    Each chunk's verification equation is scaled by a fresh random weight ρ
    and the equations summed; the G/H coefficients collapse across chunks
    (shared bases), so the combined MSM has 2nm + Σ(4 + 2lg + m) terms
    instead of n_chunks·(2nm + 4 + 2lg + m). The reference loops
    verify_multiple per chunk (range_proof_vec/mod.rs:149-216); dalek batches
    this way inside one proof. The rng draws ρ then c per chunk, 64 bytes
    each, as the JAX package does.

    Pass 1 is the chunks' transcripts with O(lg nm) host scalar work each:
    δ's sums by doubling, and one inversion for every chunk's y and u
    (Montgomery's trick), so no host loop runs over the nm terms.
    """
    if not items:
        return True
    m = len(items[0][2])
    nm = n * m
    if m & (m - 1) or nm & (nm - 1):
        return False
    lg = nm.bit_length() - 1
    with span("range_verify.transcript"):
        gens_G, gens_H = device_bp_gens(n, m, device)

        B_scalar = 0
        Bb_scalar = 0
        decode_list: list[bytes] = []
        host_scalars: list[int] = []
        metas = []

        # pass 1: the host transcripts
        for transcript, proof, V_bytes in items:
            if len(V_bytes) != m:
                return False
            rho = int.from_bytes(rng.bytes(64), "little") % SS.L

            transcript.append_message(b"dom-sep", b"rangeproof v1")
            transcript.append_u64(b"n", n)
            transcript.append_u64(b"m", m)
            # V may be the identity (zero value, zero blinding: the pow2 padding
            # of range_proof_vec relies on it; dalek PR #248 allows it)
            transcript.append_messages(b"V", V_bytes)
            if not _validate_and_append(transcript, b"A", proof.A):
                return False
            if not _validate_and_append(transcript, b"S", proof.S):
                return False
            y = transcript.challenge_scalar(b"y")
            z = transcript.challenge_scalar(b"z")
            zz = (z * z) % SS.L
            if not _validate_and_append(transcript, b"T_1", proof.T_1):
                return False
            if not _validate_and_append(transcript, b"T_2", proof.T_2):
                return False
            x = transcript.challenge_scalar(b"x")
            transcript.append_message(b"t_x", SS.to_bytes(proof.t_x))
            transcript.append_message(b"t_x_blinding", SS.to_bytes(proof.t_x_blinding))
            transcript.append_message(b"e_blinding", SS.to_bytes(proof.e_blinding))
            w = transcript.challenge_scalar(b"w")

            c = int.from_bytes(rng.bytes(64), "little") % SS.L  # value combiner

            if len(proof.ipp.L) != lg or lg >= 32:
                return False
            transcript.append_message(b"dom-sep", b"ipp v1")
            transcript.append_u64(b"n", nm)
            challenges = []
            for Lb, Rb in zip(proof.ipp.L, proof.ipp.R):
                if not _validate_and_append(transcript, b"L", Lb):
                    return False
                if not _validate_and_append(transcript, b"R", Rb):
                    return False
                challenges.append(transcript.challenge_scalar(b"u"))

            a, b = proof.ipp.a, proof.ipp.b
            basepoint_scalar = (w * (proof.t_x - a * b)
                                + c * (_delta(n, m, y, z) - proof.t_x)) % SS.L
            B_scalar = (B_scalar + rho * basepoint_scalar) % SS.L
            Bb_scalar = (Bb_scalar + rho * (-proof.e_blinding - c * proof.t_x_blinding)) % SS.L

            decode_list += ([proof.A, proof.S, proof.T_1, proof.T_2] + proof.ipp.L + proof.ipp.R
                            + V_bytes)
            metas.append(dict(rho=rho, z=z, zz=zz, c=c, a=a, b=b, x=x, y=y, u=challenges))

        # every chunk's y and u inverted at once
        invs = _batch_inv([v for mt in metas for v in [mt["y"]] + mt["u"]])
        for g, mt in enumerate(metas):
            mt["y_inv"], *u_inv = invs[g * (1 + lg):(g + 1) * (1 + lg)]
            u_sq = [(u * u) % SS.L for u in mt["u"]]
            u_inv_sq = [(v * v) % SS.L for v in u_inv]
            all_inv = 1
            for v in u_inv:
                all_inv = (all_inv * v) % SS.L
            mt.update(u_sq=u_sq, all_inv=all_inv)
            rho, x, c = mt["rho"], mt["x"], mt["c"]
            host_scalars += [(k * rho) % SS.L for k in
                             [1, x, (c * x) % SS.L, (c * x * x) % SS.L] + u_sq + u_inv_sq]

    with span("range_verify.msm"):
        # pass 2: every chunk's scalar vectors at once, on the device
        n_groups = len(items)

        def col(key):
            return _columns([mt[key] for mt in metas], device)  # (16, G, 1)

        # s vector by doubling, with per-chunk u² columns
        s_all = col("all_inv")
        for j in range(lg):
            usq_j = _columns([mt["u_sq"][(lg - 1) - j] for mt in metas], device)
            s_all = torch.cat([s_all, sc.mul(s_all, usq_j)], dim=2)
        s_inv_all = torch.flip(s_all, dims=[2])

        yi_pows = _pow_rows(col("y_inv"), nm)
        z_pows = _pow_rows(col("z"), m)  # (16, G, m)
        two_pows = sc.powers(_consts([2], device), n)  # (16, n)
        zz2_all = sc.mul(torch.repeat_interleave(sc.mul(z_pows, col("zz")), n, dim=2),
                         two_pows[:, None, :].repeat(1, n_groups, m))

        neg_z = _columns([(SS.L - mt["z"]) % SS.L for mt in metas], device)
        g_all = sc.mul(sc.sub(neg_z, sc.mul(s_all, col("a"))), col("rho"))
        h_all = sc.mul(sc.add(col("z"),
                              sc.mul(yi_pows, sc.sub(zz2_all, sc.mul(s_inv_all, col("b"))))),
                       col("rho"))
        # mod-l sums over the chunk axis
        g_acc = sc.sum_reduce(g_all, axis=0).reshape(16, nm)
        h_acc = sc.sum_reduce(h_all, axis=0).reshape(16, nm)

        czr = _columns([(mt["c"] * mt["zz"] % SS.L) * mt["rho"] % SS.L for mt in metas], device)
        value_cols = sc.mul(z_pows, czr)  # (16, G, m)

        rows = np.frombuffer(b"".join(decode_list), np.uint8).reshape(len(decode_list), 32)
        pts, valid = curve.decompress_rows(rows, device)
        if not fe.to_bool(valid.all()):
            return False

        # per chunk: its 4 + 2lg host scalars, then its m value columns, in
        # decode_list order
        stride = 4 + 2 * lg
        hs = _consts(host_scalars, device)
        cols = []
        for g in range(n_groups):
            cols.append(hs[:, g * stride:(g + 1) * stride])
            cols.append(value_cols[:, g])
        fixed = curve.pack_points([G.pedersen_B_blinding(), G.pedersen_B()], device)
        all_pts = _point_concat(pts, fixed, gens_G, gens_H)
        all_scalars = torch.cat(cols + [_consts([Bb_scalar, B_scalar], device), g_acc, h_acc],
                                dim=1)
        if mesh is not None:
            total = pmesh.sharded_msm(mesh, all_pts, all_scalars)
        else:
            total = msm.msm(all_pts, all_scalars)
        return fe.to_bool(curve.eq(total, curve.identity((1,), total.device))[0])


def verify_multiple(
    transcript: Transcript,
    proof: RangeProof,
    V_bytes: list[bytes],
    n: int,
    rng: np.random.Generator,
    device="cuda",
) -> bool:
    """RangeProof::verify_multiple_with_rng, one proof."""
    return verify_multiple_batch([(transcript, proof, V_bytes)], n, rng, device)
