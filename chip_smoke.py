"""Drive the PyTorch/CUDA port once on the card: build the kernels, hold each
against its plain version, run the secure-aggregation round and the
Σ-protocol path (prove → wire → per-lane verify) at full width.

    python3 chip_smoke.py

needs one NVIDIA GPU (built for sm_90a: an H100), `nvcc`, and nothing else.
It imports only ``rofl_tpu_torch``. Every phase prints one JSON line; the
first failure of any phase ends the run with a non-zero exit code. The last
line is ``{"ok": true, "device": {...}}``.

Phases:
  device   the card's name and power limit, torch and CUDA versions
  build    nvcc builds the nine kernels from rofl_tpu_torch/csrc (in
           parallel) and reports ptxas' registers and spill bytes for each
  kernels  point_add, point_double, compress, decompress, sc_reduce_wide,
           sc_mul, sc_add, sc_sub, scalar_mul against their plain torch
           versions on the card, at the lane counts the two paths use and at
           N = 1 and 77, random and edge inputs, canonical limbs bit-equal
           (scalar_mul: canonical encodings of the results); times at N = 50000
  round    d = 50000, 4 clients, FpConfig(16, 7), through ``bindings``:
           cancelling blindings (keyed Keccak XOF on the card, reduced mod l
           by sc_reduce_wide) -> commit -> add_commitments -> extract_values
           with the default table (m = 2^16); the ElGamal-pair form of the
           same round through the wire format; an extract with a small table
           (m = 2^12) on 4096 lanes, which walks 16 giant steps. Sums are
           held against numpy's fixed-point sum, exactly.
  sigma    d = 50000, FpConfig(16, 7): rand proofs and square-rand proofs
           through ``bindings`` (create -> split / join -> verify), square
           proofs through ``crypto.sigma``, the ``existing=`` form on the
           round's own commitments; tampered proofs must be refused, lane by
           lane; the first lanes of each proof are recomputed by the
           pure-Python spec (spec/merlin.py, spec/ristretto.py) and held equal
           byte for byte; the transcripts are timed apart.
Launch counts are set to zero just before each of the two paths and read just
after it.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from rofl_tpu_torch import bindings  # noqa: E402
from rofl_tpu_torch.crypto import pedersen, sigma  # noqa: E402
from rofl_tpu_torch.crypto import serde_vec as sv  # noqa: E402
from rofl_tpu_torch.crypto.fp_codec import FpConfig  # noqa: E402
from rofl_tpu_torch.ops import bsgs, curve, fe, kernels, sc  # noqa: E402
from rofl_tpu_torch.spec import generators as G  # noqa: E402
from rofl_tpu_torch.spec import ristretto as SR  # noqa: E402
from rofl_tpu_torch.spec import scalar as SS  # noqa: E402
from rofl_tpu_torch.spec.merlin import Transcript  # noqa: E402

DEVICE = "cuda"
D = 50000
N_CLIENTS = 4
FP = FpConfig(16, 7)
SMALL_TABLE = 1 << 12
SMALL_LANES = 4096
SEED = 2024
# Client updates are whole multiples of 2^-7 in [-100, 100]: the fixed-point sum
# of four is exact and stays inside the 16-bit extraction range.
UPDATE_BITS = 12800

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet):
# 3.35 TB/s of HBM3, 67 TFLOP/s fp32 outside the tensor cores. An SM has half
# as many int32 lanes as fp32 lanes, so the 32-bit integer peak is taken as
# half the fp32 rate, a multiply-add counted as two operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2

# 32-bit multiply-adds per lane, counted for the cheapest layout the card
# allows and not for the kernels' own 16x16-bit limbs (256 per product): with
# 8 limbs of 32 bits a 255-bit product is 64 wide multiplies, each a low and a
# high 32-bit multiply-add, so 128, and a squaring is 36 wide multiplies, 72.
# Field operations counted from the formulas in csrc/ge25519.cuh:
#   add        9 products
#   double     4 products + 4 squarings
#   sqrt_ratio 19 products + 254 squarings
#   compress   sqrt_ratio + 13 products + 1 squaring
#   decompress sqrt_ratio + 7 products + 3 squarings
# sc_reduce_wide folds 9, 5 and 2 words of 32 bits against the 4 words of
# 2^252 - l (csrc/sc25519.cuh): 64 wide multiplies, 128 multiply-adds.
# sc_mul is 64 wide multiplies for the 512-bit product and 64 for the folds:
# 256 multiply-adds. sc_add and sc_sub have no multiply: 8 word adds or
# subtracts with carry, 8 more for the correction by l and 8 selects, counted
# as 24 operations. scalar_mul is counted for the cheapest schedule of the same
# function, a fixed 4-bit window: 252 doublings, 64 adds and 14 adds for the
# table of 16 multiples, 291 456 multiply-adds; the ladder as written does 256
# doublings and 256 adds (499 712 at the same 128 / 72 a product / squaring).
# Bytes per lane: (16, N) int32 arrays read and written once, the validity
# byte of decompress, the 64 int32 byte columns of sc_reduce_wide.
MUL, SQR = 128, 72
LIMBS = 16 * 4
POINT_ADD_MADDS = 9 * MUL
POINT_DOUBLE_MADDS = 4 * MUL + 4 * SQR
KERNEL_FACTS = {
    "point_add": dict(
        source="rofl_tpu_torch/csrc/point_add.cu", replaces="rofl_tpu/ops/kernels.py:428",
        madds=9 * MUL, bytes=12 * LIMBS),
    "point_double": dict(
        source="rofl_tpu_torch/csrc/point_double.cu", replaces="rofl_tpu/ops/kernels.py:433",
        madds=4 * MUL + 4 * SQR, bytes=8 * LIMBS),
    "compress": dict(
        source="rofl_tpu_torch/csrc/compress.cu", replaces="rofl_tpu/ops/kernels.py:639",
        madds=32 * MUL + 255 * SQR, bytes=5 * LIMBS),
    "decompress": dict(
        source="rofl_tpu_torch/csrc/decompress.cu", replaces="rofl_tpu/ops/kernels.py:675",
        madds=26 * MUL + 257 * SQR, bytes=5 * LIMBS + 1),
    "sc_reduce_wide": dict(
        source="rofl_tpu_torch/csrc/sc_reduce_wide.cu",
        replaces="rofl_tpu/ops/kernels.py:1153", madds=128, bytes=64 * 4 + LIMBS),
    "sc_mul": dict(
        source="rofl_tpu_torch/csrc/sc_mul.cu", replaces="rofl_tpu/ops/kernels.py:1133",
        madds=256, bytes=3 * LIMBS),
    "sc_add": dict(
        source="rofl_tpu_torch/csrc/sc_add.cu", replaces="rofl_tpu/ops/kernels.py:1193",
        madds=12, bytes=3 * LIMBS),
    "sc_sub": dict(
        source="rofl_tpu_torch/csrc/sc_sub.cu", replaces="rofl_tpu/ops/kernels.py:1174",
        madds=12, bytes=3 * LIMBS),
    "scalar_mul": dict(
        source="rofl_tpu_torch/csrc/scalar_mul.cu", replaces="rofl_tpu/ops/kernels.py:475",
        madds=252 * POINT_DOUBLE_MADDS + (64 + 14) * POINT_ADD_MADDS, bytes=9 * LIMBS),
}
NEW_KERNELS = ("sc_mul", "sc_add", "sc_sub", "scalar_mul")
# Lane counts the round gives the kernels (fixed-base tables: 1 and 8192;
# blindings, commits and wire: 50000; first halving of the 4-client sum:
# 100000; default BSGS table: 65537; small extract: 4096), and 77. The Σ path
# gives the scalar kernels 50000 lanes, and the first halving of the blinding
# sum 100000. Its ladders run at 50000 lanes (provers) and, one launch a
# verifier, at 100000, 150000 and 200000 lanes.
REJECT_LANES = 64
CHECK_LANES = (1, 77, SMALL_LANES, 8192, D, (1 << 16) + 1, 2 * D)
SCALAR_MUL_LANES = (1, 77, SMALL_LANES, D, 2 * D, 3 * D, 4 * D)


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def synced(fn):
    """(result, seconds) of fn() with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median device time of one fn() in ms. The stream is first held busy so
    that the launches queue up behind it and run back to back: the events
    then bracket device time, not the host's time to enqueue."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def bound_ms(name: str, n: int) -> tuple[float, str]:
    """Least time the card could take for n lanes: every input read once and
    every output written once over the memory rate, or the multiply-adds over
    the int32 rate, whichever is larger."""
    f = KERNEL_FACTS[name]
    t_bytes = n * f["bytes"] / HBM_BYTES_PER_S
    t_ops = n * f["madds"] * 2 / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1: device -----------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return smi


# -- phase 2: build ------------------------------------------------------------


def phase_build() -> None:
    t0 = time.perf_counter()
    kernels.build_kernels()
    seconds = time.perf_counter() - t0
    version = subprocess.run([kernels.nvcc_path(), "--version"], check=True,
                             capture_output=True, text=True).stdout
    version = next(ln.strip() for ln in version.splitlines() if "release" in ln)
    ptxas = {}
    for name, log in kernels.BUILD_LOGS.items():
        used = re.search(r"Used (\d+) registers", log)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
        smem = re.search(r"(\d+) bytes smem", log)
        ptxas[name] = {"registers": int(used.group(1)),
                       "spill_store_bytes": int(spill.group(1)),
                       "spill_load_bytes": int(spill.group(2)),
                       "shared_bytes": int(smem.group(1)) if smem else 0}
    emit({"phase": "build", "seconds": seconds, "nvcc": version, "ptxas": ptxas})


# -- phase 3: kernels against their plain versions -----------------------------


def test_points(n: int, rng: np.random.Generator):
    """Two (x, y, z, t) tuples of n lanes on the card: random group elements
    in random projective representations, with identity, basepoint and
    P, -P pairs among them."""
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(12)]
    pool += [SR.identity(), SR.BASEPOINT, -SR.BASEPOINT, pool[0], -pool[0]]
    packed = curve.pack_points(pool, DEVICE)
    i = torch.from_numpy(rng.integers(0, len(pool), size=n)).to(DEVICE)
    j = torch.from_numpy(rng.integers(0, len(pool), size=n)).to(DEVICE)
    if n >= len(pool):  # every pool member at least once, P + P and P + (-P) included
        i[:len(pool)] = torch.arange(len(pool))
        j[:len(pool)] = torch.tensor(
            list(range(12)) + [12, 14, 13, 16, 15], device=DEVICE)
    scale = fe.to_tensor(rng.integers(1, 1 << 16, size=(16, n)), DEVICE)
    p = tuple(fe.mul(c[:, i], scale) for c in packed)
    q = tuple(c[:, j].contiguous() for c in packed)
    return p, q


def test_encodings(enc: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    """Valid encodings with invalid ones mixed in: random field elements
    (non-squares, negative t), odd s, and s = 0 and 1."""
    n = enc.shape[1]
    s = enc.clone()
    rand = fe.to_tensor(rng.integers(0, 1 << 16, size=(16, n)), DEVICE)
    rand[15] &= 0x7FFF
    kind = torch.from_numpy(rng.integers(0, 4, size=n)).to(DEVICE)
    s = torch.where((kind == 1).unsqueeze(0), rand, s)
    s[0] = torch.where(kind == 2, s[0] ^ 1, s[0])
    s[:, -1] = 0
    s[0, -1] = n % 2
    return s


def max_abs_err(got, want, field: bool = True) -> int:
    """Largest limb difference: between the canonical representatives mod p
    for field elements, between the limbs as they are for scalars and masks."""
    err = 0
    for a, b in zip(got, want):
        if field and a.dtype == fe.DTYPE:
            a, b = fe.canonicalize(a), fe.canonicalize(b.expand_as(a))
        err = max(err, int((a.to(torch.int32) - b.to(torch.int32)).abs().max()))
    return err


EDGE_SCALARS = (0, 1, SS.L - 1, 1 << 252)


def test_scalars(n: int, rng: np.random.Generator):
    """Two (16, n) batches of canonical scalars on the card: uniform, with
    every pairing of 0, 1, l-1 and 2^252 in the first 16 lanes."""
    a, b = (kernels.sc_reduce_wide(torch.from_numpy(
        rng.integers(0, 256, size=(64, n)).astype(np.int32)).to(DEVICE)) for _ in range(2))
    if n >= len(EDGE_SCALARS) ** 2:
        pairs = [(x, y) for x in EDGE_SCALARS for y in EDGE_SCALARS]
        a[:, :len(pairs)] = fe.to_tensor(sc.pack_scalars([x for x, _ in pairs]), DEVICE)
        b[:, :len(pairs)] = fe.to_tensor(sc.pack_scalars([y for _, y in pairs]), DEVICE)
    return a, b


def test_ladder_operands(n: int, rng: np.random.Generator):
    """Scalars and points for scalar_mul: random ones, and k = 0, 1, l-1
    against a random point, the basepoint and the identity."""
    p, _ = test_points(n, rng)
    k, _ = test_scalars(n, rng)
    if n >= 32:
        edge_k = fe.to_tensor(sc.pack_scalars([0, 1, SS.L - 1]), DEVICE)
        fixed = {0: None, 17: curve.basepoint((1,), DEVICE), 20: curve.identity((1,), DEVICE)}
        for first, point in fixed.items():
            k[:, first:first + 3] = edge_k
            if point is not None:
                for c, v in zip(p, point):
                    c[:, first:first + 3] = v
    return k, p


SC_KERNELS = {
    "sc_mul": (kernels.sc_mul, kernels.sc_mul_ref),
    "sc_add": (kernels.sc_add, kernels.sc_add_ref),
    "sc_sub": (kernels.sc_sub, kernels.sc_sub_ref),
}


def phase_kernels() -> dict:
    rng = np.random.default_rng(SEED)
    records = {name: {"name": name, "route": "cuda", "match": True, "max_abs_err": 0,
                      "checked_lanes": list(CHECK_LANES)} for name in KERNEL_FACTS}
    records["scalar_mul"]["checked_lanes"] = list(SCALAR_MUL_LANES)

    def hold(name, got, want, field=True):
        err = max_abs_err(got, want, field)
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        if err != 0:
            records[name]["match"] = False

    def timed(name, n, kernel_fn, plain_fn=None, plain_ms=None, **kwargs):
        records[name]["n"] = n
        records[name]["ms"] = device_ms(kernel_fn, **kwargs)
        records[name]["plain_ms"] = plain_ms if plain_fn is None else (
            1e3 * min(synced(plain_fn)[1] for _ in range(2)))
        records[name]["bound_ms"], records[name]["bound_by"] = bound_ms(name, n)
        records[name]["library_ms"] = None

    for n in CHECK_LANES:
        p, q = test_points(n, rng)
        q1 = tuple(c[:, :1].contiguous() for c in q)
        hold("point_add", kernels.point_add(p, q), kernels.point_add_ref(p, q))
        hold("point_add", kernels.point_add(p, q1), kernels.point_add_ref(p, q1))
        hold("point_add", kernels.point_add(q1, p), kernels.point_add_ref(q1, p))
        hold("point_double", kernels.point_double(p), kernels.point_double_ref(p))
        enc = kernels.compress(p)
        hold("compress", (enc,), (kernels.compress_ref(p),))
        s = test_encodings(enc, rng)
        (k_pt, k_valid), (r_pt, r_valid) = kernels.decompress(s), kernels.decompress_ref(s)
        hold("decompress", k_pt + (k_valid,), r_pt + (r_valid,))
        wide = torch.from_numpy(rng.integers(0, 256, size=(64, n)).astype(np.int32)).to(DEVICE)
        wide[:, 0] = 255  # 2^512 - 1
        wide[:, -1] = 0
        hold("sc_reduce_wide", (kernels.sc_reduce_wide(wide),),
             (kernels.sc_reduce_wide_ref(wide),), field=False)
        a, b = test_scalars(n, rng)
        b1 = b[:, n // 2:n // 2 + 1].contiguous()
        for name, (kernel_fn, plain_fn) in SC_KERNELS.items():
            for x, y in ((a, b), (a, b1), (b1, a)):
                hold(name, (kernel_fn(x, y),), (plain_fn(x, y),), field=False)
        if n == D:
            calls = {
                "point_add": (lambda: kernels.point_add(p, q), lambda: kernels.point_add_ref(p, q)),
                "point_double": (lambda: kernels.point_double(p),
                                 lambda: kernels.point_double_ref(p)),
                "compress": (lambda: kernels.compress(p), lambda: kernels.compress_ref(p)),
                "decompress": (lambda: kernels.decompress(enc),
                               lambda: kernels.decompress_ref(enc)),
                "sc_reduce_wide": (lambda: kernels.sc_reduce_wide(wide),
                                   lambda: kernels.sc_reduce_wide_ref(wide)),
            }
            calls.update({name: (lambda f=fns[0]: f(a, b), lambda f=fns[1]: f(a, b))
                          for name, fns in SC_KERNELS.items()})
            for name, (kernel_fn, plain_fn) in calls.items():
                timed(name, n, kernel_fn, plain_fn)
            records["decompress"]["valid_share"] = float(k_valid.float().mean())

    # scalar_mul: the kernel walks the bits from the top, the plain version
    # from the bottom, so the results are held equal as canonical encodings.
    for n in SCALAR_MUL_LANES:
        k, p = test_ladder_operands(n, rng)
        got = kernels.scalar_mul(k, p)
        want, plain_seconds = synced(lambda: kernels.scalar_mul_ref(k, p))
        hold("scalar_mul", (kernels.compress(got),), (kernels.compress(want),))
        if n <= D:  # one scalar for every point
            k1 = k[:, n // 2:n // 2 + 1].contiguous()
            hold("scalar_mul", (kernels.compress(kernels.scalar_mul(k1, p)),),
                 (kernels.compress(kernels.scalar_mul_ref(k1, p)),))
        if n == D:
            timed("scalar_mul", n, lambda: kernels.scalar_mul(k, p),
                  plain_ms=1e3 * plain_seconds, reps=3, rounds=3)
        if n == 4 * D:
            records["scalar_mul"]["ms_at_4n"] = device_ms(
                lambda: kernels.scalar_mul(k, p), reps=2, rounds=3)
    torch.cuda.synchronize()
    bad = [name for name, r in records.items() if not r["match"]]
    emit({"phase": "kernels", "tolerance": "canonical limbs and masks bit-equal (0)",
          "kernels": list(records.values())})
    if bad:
        sys.exit(f"kernels disagree with their plain versions: {bad}")
    return records


# -- phase 4: the round ----------------------------------------------------------


ROUND_KERNELS = ("point_add", "point_double", "compress", "decompress", "sc_reduce_wide",
                 "sc_add", "sc_sub")
SIGMA_KERNELS = ("point_add", "compress", "decompress", "sc_reduce_wide") + NEW_KERNELS


def start_path() -> None:
    """Zero every launch count and the peak-memory mark before a path is driven."""
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats()


def phase_round() -> tuple[dict, dict]:
    rng = np.random.default_rng(SEED + 1)
    seconds = {}

    def stage(name, fn):
        out, seconds[name] = synced(fn)
        return out

    # A fresh process state: no fixed-base or BSGS table is built yet.
    pedersen.base_B.cache_clear()
    pedersen.base_H.cache_clear()
    bsgs.clear_tables()
    start_path()

    bits = rng.integers(-UPDATE_BITS, UPDATE_BITS + 1, size=(N_CLIENTS, D))
    updates = (bits / FP.scale).astype(np.float32)
    want = (bits.sum(axis=0) / FP.scale).astype(np.float32)

    # Pedersen-blob form, through the bindings. The cancelling vector is summed
    # and negated on the card: sc_add and sc_sub launches.
    blindings = stage("generate_cancelling_blindings",
                      lambda: bindings.generate_cancelling_blindings(
                          N_CLIENTS, D, rng, device=DEVICE))
    blinding_launches = {k: kernels.LAUNCHES[k] for k in ("sc_reduce_wide", "sc_add", "sc_sub")}
    blinding_sum = bindings.add_scalars(
        sv.serialize_scalar_vec(np.concatenate(
            [sv.deserialize_scalar_vec(b)[:, :REJECT_LANES] for b in blindings], axis=1)),
        device=DEVICE)
    blindings_cancel = blinding_sum == sv.serialize_scalar(0)
    # What the stage is made of, each timed apart on the same data: one draw of
    # D scalars (XOF in plain torch + sc_reduce_wide), the sum and negation of
    # N_CLIENTS - 1 vectors on the card (sc_add, sc_sub), the framing of one
    # blob on the host, and the same sum as Python integers on the host, which
    # the sum on the card replaced.
    before = dict(kernels.LAUNCHES)
    vecs = [fe.to_tensor(sv.deserialize_scalar_vec(b), DEVICE) for b in blindings[:-1]]
    stage("blindings_one_draw", lambda: pedersen.rnd_scalar_tensor(D, rng, DEVICE))
    last = stage("blindings_sum_on_card",
                 lambda: fe.to_numpy(sc.neg(sc.sum_reduce(torch.stack(vecs, dim=1), axis=0))))
    stage("blindings_one_blob_framing", lambda: sv.serialize_scalar_vec(last.reshape(16, D)))

    def python_integer_sum():
        total = [0] * D
        for v in vecs:
            total = [(t + x) % SS.L for t, x in zip(total, sc.unpack_scalars(v))]
        return sc.pack_scalars([-t for t in total])

    blindings_cancel &= bool(np.array_equal(stage("blindings_sum_python_integers",
                                                  python_integer_sum), last.reshape(16, D)))
    kernels.LAUNCHES.update(before)  # measurements beside the path, not of it
    # The first client's commit also builds the two fixed-base tables.
    blobs = [stage(f"commit_client_{c}",
                   lambda: bindings.commit(updates[c], blindings[c], FP, device=DEVICE))
             for c in range(N_CLIENTS)]
    total = stage("add_commitments", lambda: bindings.add_commitments(blobs, device=DEVICE))
    got = stage("extract_values", lambda: bindings.extract_values(total, FP, device=DEVICE))
    pedersen_exact = bool(got.shape == (D,) and np.isfinite(got).all()
                          and np.array_equal(got, want))

    # The commitments are the reference group elements: first lanes against the spec.
    r0 = sv.deserialize_scalar_vec(blindings[0])
    spec_ok = True
    for lane in range(3):
        m = FP.f32_to_scalars(updates[0, lane:lane + 1])[0]
        r = fe.unpack_scalars(r0[:, lane:lane + 1])[0]
        enc = (G.pedersen_B().scalar_mul(m) + G.pedersen_B_blinding().scalar_mul(r)).compress()
        spec_ok &= blobs[0][8 + 40 * lane + 8: 8 + 40 * (lane + 1)] == enc

    # The sampler's XOF on the card gives the bytes the same code gives on the CPU.
    key = rng.bytes(32)
    xof_ok = bool(torch.equal(pedersen.xof_byte_cols(key, 77, DEVICE).cpu(),
                              pedersen.xof_byte_cols(key, 77, "cpu")))

    # ElGamal-pair form of the same round, through the wire format.
    def elgamal_round():
        acc = None
        for c in range(N_CLIENTS):
            m = fe.to_tensor(FP.f32_to_scalar_limbs(updates[c]), DEVICE)
            r = fe.to_tensor(sv.deserialize_scalar_vec(blindings[c]), DEVICE)
            wire = sv.serialize_eg_pair_vec(pedersen.elgamal_commit(m, r))
            pairs = sv.deserialize_eg_pair_vec(wire, DEVICE)
            acc = pairs if acc is None else pedersen.add_pairs(acc, pairs)
        cancelled = bool(pedersen.right_elem_is_identity(acc).all())
        limbs, ok = bsgs.solve_discrete_log(acc.L, FP.default_bsgs_table_size, FP.bsgs_n_bits)
        return cancelled, bool(ok.all()), FP.scalar_limbs_to_f32(fe.to_numpy(limbs))

    cancelled, found, got_eg = stage("elgamal_round", elgamal_round)
    elgamal_exact = bool(cancelled and found and np.array_equal(got_eg, want))

    # Small table: 2^16 / 2^12 = 16 giant steps on 4096 lanes.
    lanes = np.arange(SMALL_LANES)
    small_blob = bindings.select_commitments(total, lanes, device=DEVICE)
    before = dict(kernels.LAUNCHES)
    got_small = stage("extract_values_small_table", lambda: bindings.extract_values(
        small_blob, FP, table_size=SMALL_TABLE, device=DEVICE))
    small_launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    giant_steps = (1 << FP.bsgs_n_bits) // SMALL_TABLE
    small_exact = bool(np.array_equal(got_small, want[:SMALL_LANES]))

    # Blindings that do not cancel (one client missing) must fail extraction.
    partial = bindings.add_commitments(
        [bindings.select_commitments(b, lanes[:REJECT_LANES], device=DEVICE)
         for b in blobs[:-1]],
        device=DEVICE)
    try:
        bindings.extract_values(partial, FP, table_size=SMALL_TABLE, device=DEVICE)
        rejected = False
    except ValueError:
        rejected = True

    launches = dict(kernels.LAUNCHES)
    result = {
        "phase": "round", "d": D, "clients": N_CLIENTS, "fp": [FP.n_bits, FP.n_frac],
        "bsgs_m": FP.default_bsgs_table_size, "small_table_m": SMALL_TABLE,
        "small_table_lanes": SMALL_LANES, "giant_steps": giant_steps,
        "small_table_launches": small_launches,
        "wire_bytes_per_client": len(blobs[0]),
        "blinding_launches": blinding_launches, "blindings_cancel": blindings_cancel,
        "pedersen_sum_exact": pedersen_exact, "commitments_match_spec": bool(spec_ok),
        "xof_matches_cpu": xof_ok,
        "elgamal_sum_exact": elgamal_exact, "small_table_sum_exact": small_exact,
        "uncancelled_round_rejected": rejected,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "seconds": seconds, "launches": launches,
    }
    emit(result)
    checks = ("blindings_cancel", "pedersen_sum_exact", "commitments_match_spec",
              "xof_matches_cpu",
              "elgamal_sum_exact", "small_table_sum_exact", "uncancelled_round_rejected")
    failed = [c for c in checks if not result[c]]
    # two walks (the value and its negative), each of 16 steps: a compress per
    # step and an add of -mG between steps; the table build adds 32 + 1 more
    if (small_launches["compress"] < 2 * giant_steps + 1
            or small_launches["point_add"] < 2 * (giant_steps - 1) + 32):
        failed.append("giant steps did not run on the card")
    failed += [f"{name} was never launched" for name in ROUND_KERNELS if launches[name] == 0]
    if failed:
        sys.exit(f"round failed: {failed}")
    state = {"updates": updates, "blindings": blindings, "blobs": blobs}
    return launches, state


# -- phase 5: the Σ-protocol path -------------------------------------------------

SPEC_LANES = 3
TAMPERED_LANE = 4321


def spec_scalars(limbs, lanes=SPEC_LANES) -> list:
    return fe.unpack_scalars(fe.to_numpy(limbs)[:, :lanes])


def spec_challenge(label: bytes, messages: list) -> int:
    t = Transcript(label)
    t.append_message(*sigma.DOMAIN_SEP)
    for message_label, message in messages:
        t.append_message(message_label, message)
    return t.challenge_scalar(b"c")


def spec_square_lane(label: bytes, with_pair: bool, m, r1, r2, m_p, r1_p, r2_p, c_l=None):
    """One lane of a square-rand proof (with_pair) or a square proof, by the
    pure-Python spec → (commitment bytes, proof bytes)."""
    B, H = G.pedersen_B(), G.pedersen_B_blinding()
    c_l = c_l or B.scalar_mul(m) + H.scalar_mul(r1)
    c_sq = B.scalar_mul(m * m % SS.L) + H.scalar_mul(r2)
    c_l_prime = B.scalar_mul(m_p) + H.scalar_mul(r1_p)
    c_sq_prime = c_l.scalar_mul(m_p) + H.scalar_mul(r2_p)
    left = c_l.compress() + (B.scalar_mul(r1).compress() if with_pair else b"")
    left_prime = c_l_prime.compress() + (B.scalar_mul(r1_p).compress() if with_pair else b"")
    c = spec_challenge(label, [
        (b"C_eg", left), (b"C_ped", c_sq.compress()),
        (b"C_prime_eg", left_prime), (b"C_prime_ped", c_sq_prime.compress())])
    z = [(m_p + m * c) % SS.L, (r1_p + r1 * c) % SS.L, (r2_p + (r2 - m * r1) * c) % SS.L]
    return (left + c_sq.compress(),
            left_prime + c_sq_prime.compress() + b"".join(SS.to_bytes(v) for v in z))


def blob_rows(blob: bytes, width: int, lanes=SPEC_LANES) -> list:
    return [blob[8 + (8 + width) * i + 8: 8 + (8 + width) * (i + 1)] for i in range(lanes)]


def flip_bit(blob: bytes, width: int, lane: int, offset: int) -> bytes:
    """The blob with the lowest bit of one byte of one item flipped."""
    out = bytearray(blob)
    out[8 + (8 + width) * lane + 8 + offset] ^= 1
    return bytes(out)


def phase_sigma(state: dict) -> dict:
    rng = np.random.default_rng(SEED + 2)
    seconds = {}

    def stage(name, fn):
        out, seconds[name] = synced(fn)
        return out

    def primes(n_draws):
        """The primes the next prover will draw: the sampler is a function of
        the rng alone, so a copy of the rng gives them without touching it."""
        twin = np.random.default_rng()
        twin.bit_generator.state = rng.bit_generator.state
        counted = dict(kernels.LAUNCHES)  # these draws are the check's, not the path's
        draws = [spec_scalars(pedersen.rnd_scalar_tensor(D, twin, DEVICE))
                 for _ in range(n_draws)]
        kernels.LAUNCHES.update(counted)
        return draws

    start_path()
    values = state["updates"][0]
    m_limbs = FP.f32_to_scalar_limbs(values)
    m_int = fe.unpack_scalars(m_limbs[:, :SPEC_LANES])
    b1 = bindings.create_random_blinding_vector(D, rng, device=DEVICE)
    b2 = bindings.create_random_blinding_vector(D, rng, device=DEVICE)
    r1_limbs, r2_limbs = sv.deserialize_scalar_vec(b1), sv.deserialize_scalar_vec(b2)
    r1_int, r2_int = spec_scalars(r1_limbs), spec_scalars(r2_limbs)
    m, r1, r2 = (fe.to_tensor(x, DEVICE) for x in (m_limbs, r1_limbs, r2_limbs))
    B, H = G.pedersen_B(), G.pedersen_B_blinding()
    checks = {}

    # -- rand proofs, through the bindings
    m_p, r_p = primes(2)
    proof, pairs = stage("create_randproof",
                         lambda: bindings.create_randproof(values, b1, FP, rng, device=DEVICE))
    left, right = stage("split_elgamal_pair_vector",
                        lambda: bindings.split_elgamal_pair_vector(pairs, device=DEVICE))
    checks["rand_proof_accepted"] = stage(
        "verify_randproof", lambda: bindings.verify_randproof(left, right, proof, device=DEVICE))
    checks["elgamal_join_is_split_inverse"] = (
        bindings.join_to_elgamal_pair_vector(left, right, device=DEVICE) == pairs)
    bad = flip_bit(proof, 128, TAMPERED_LANE, 64)  # one limb of z_m
    checks["tampered_rand_proof_refused"] = not bindings.verify_randproof(
        left, right, bad, device=DEVICE)
    mask = sigma.rand_proof_verify(
        sv.deserialize_rand_proof_vec(bad, DEVICE), sv.deserialize_eg_pair_vec(pairs, DEVICE))
    checks["tampered_rand_proof_refused_in_its_lane_only"] = (
        int((~mask).sum()) == 1 and not bool(mask[TAMPERED_LANE]))
    spec_ok = True
    for i in range(SPEC_LANES):
        c_bytes = ((B.scalar_mul(m_int[i]) + H.scalar_mul(r1_int[i])).compress()
                   + B.scalar_mul(r1_int[i]).compress())
        cp_bytes = ((B.scalar_mul(m_p[i]) + H.scalar_mul(r_p[i])).compress()
                    + B.scalar_mul(r_p[i]).compress())
        c = spec_challenge(b"RandProof", [(b"C", c_bytes), (b"C_prime", cp_bytes)])
        want = (cp_bytes + SS.to_bytes((m_p[i] + m_int[i] * c) % SS.L)
                + SS.to_bytes((r_p[i] + r1_int[i] * c) % SS.L))
        spec_ok &= blob_rows(pairs, 64)[i] == c_bytes and blob_rows(proof, 128)[i] == want
    checks["rand_proof_matches_spec"] = spec_ok
    wire = {"rand_proof": len(proof), "elgamal_pairs": len(pairs)}

    # -- square-rand proofs, through the bindings
    sq_primes = primes(3)
    sq_proof, triples = stage("create_squarerandproof", lambda: bindings.create_squarerandproof(
        values, b1, b2, FP, rng, device=DEVICE))
    checks["square_rand_proof_accepted"] = stage(
        "verify_squarerandproof",
        lambda: bindings.verify_squarerandproof(triples, sq_proof, device=DEVICE))
    parts = stage("split_squaretriple_pair_vector",
                  lambda: bindings.split_squaretriple_pair_vector(triples, device=DEVICE))
    checks["squaretriple_join_is_split_inverse"] = stage(
        "join_to_squaretriple_pair_vector",
        lambda: bindings.join_to_squaretriple_pair_vector(*parts, device=DEVICE)) == triples
    checks["tampered_square_rand_proof_refused"] = not bindings.verify_squarerandproof(
        triples, flip_bit(sq_proof, 192, TAMPERED_LANE, 96 + 64), device=DEVICE)  # z_r2
    # a square commitment to m in place of m^2: only lanes with m^2 == m may pass
    c_vec = sv.deserialize_squaretriple_vec(triples, DEVICE)
    p_vec = sv.deserialize_square_rand_proof_vec(sq_proof, DEVICE)
    mask = sigma.square_rand_proof_verify(
        p_vec, sigma.SquareRandCommitVec(c_vec.c, pedersen.pedersen_commit(m, r2)))
    m_is_its_square = sc.eq(sc.mul(m, m), m)
    checks["commitment_to_m_for_m_squared_refused"] = bool(
        torch.equal(mask, m_is_its_square) and int((~mask).sum()) > D // 2)
    spec_ok = True
    for i in range(SPEC_LANES):
        want_c, want_p = spec_square_lane(
            b"SquareRandProof", True, m_int[i], r1_int[i], r2_int[i],
            *[draw[i] for draw in sq_primes])
        spec_ok &= blob_rows(triples, 96)[i] == want_c and blob_rows(sq_proof, 192)[i] == want_p
    checks["square_rand_proof_matches_spec"] = spec_ok
    wire.update({"square_rand_proof": len(sq_proof), "square_rand_commitments": len(triples)})

    # -- square proofs, through crypto.sigma and the codec
    sq_primes = primes(3)
    s_proof, s_commit = stage("square_proof_prove",
                              lambda: sigma.square_proof_prove(m, r1, r2, rng))
    s_blob = stage("serialize_square_proof_vec", lambda: sv.serialize_square_proof_vec(s_proof))
    s_proof = sv.deserialize_square_proof_vec(s_blob, DEVICE)
    mask = stage("square_proof_verify", lambda: sigma.square_proof_verify(s_proof, s_commit))
    checks["square_proof_accepted"] = bool(mask.all())
    mask = sigma.square_proof_verify(
        s_proof, sigma.SquareCommitVec(s_commit.c_l, pedersen.pedersen_commit(m, r2)))
    checks["square_commitment_to_m_refused"] = bool(torch.equal(mask, m_is_its_square))
    spec_ok = True
    s_commit_rows = np.concatenate([curve.compress_to_bytes(s_commit.c_l),
                                    curve.compress_to_bytes(s_commit.c_sq)], axis=1)
    for i in range(SPEC_LANES):
        want_c, want_p = spec_square_lane(
            b"SquareProof", False, m_int[i], r1_int[i], r2_int[i],
            *[draw[i] for draw in sq_primes])
        spec_ok &= s_commit_rows[i].tobytes() == want_c and blob_rows(s_blob, 160)[i] == want_p
    checks["square_proof_matches_spec"] = spec_ok
    wire["square_proof"] = len(s_blob)

    # -- the existing= form on the round's own commitments (client 0)
    r0 = fe.to_tensor(sv.deserialize_scalar_vec(state["blindings"][0]), DEVICE)
    existing = sv.deserialize_rp_vec(state["blobs"][0], DEVICE)
    e_proof, e_pairs = stage("rand_proof_prove_existing",
                             lambda: sigma.rand_proof_prove(m, r0, rng, existing=existing))
    checks["existing_commitments_kept"] = (
        sv.serialize_rp_vec(e_pairs.L) == state["blobs"][0])
    checks["existing_rand_proof_accepted"] = bool(stage(
        "rand_proof_verify_existing", lambda: sigma.rand_proof_verify(e_proof, e_pairs)).all())
    # the same proof against the pairs of another blinding must fail in every lane
    checks["existing_rand_proof_refused_for_other_pairs"] = not bool(
        sigma.rand_proof_verify(e_proof, sv.deserialize_eg_pair_vec(pairs, DEVICE)).any())

    # -- the square-rand transcript apart from the rest of prove and verify
    messages = stage("square_rand_transcript_compress", lambda: [
        (b"C_eg", sigma.eg_byte_cols(c_vec.c)), (b"C_ped", sigma.point_byte_cols(c_vec.c_sq)),
        (b"C_prime_eg", sigma.eg_byte_cols(p_vec.c_prime)),
        (b"C_prime_ped", sigma.point_byte_cols(p_vec.c_sq_prime))])
    stage("square_rand_transcript", lambda: sigma.challenges(b"SquareRandProof", messages))
    rand_messages = [(b"C", messages[0][1]), (b"C_prime", messages[2][1])]
    stage("rand_transcript", lambda: sigma.challenges(b"RandProof", rand_messages))

    launches = dict(kernels.LAUNCHES)
    want_wire = {"rand_proof": 8 + 136 * D, "elgamal_pairs": 8 + 72 * D,
                 "square_rand_proof": 8 + 200 * D, "square_rand_commitments": 8 + 104 * D,
                 "square_proof": 8 + 168 * D}
    checks["wire_sizes"] = wire == want_wire
    result = {"phase": "sigma", "d": D, "fp": [FP.n_bits, FP.n_frac], "spec_lanes": SPEC_LANES,
              "tampered_lane": TAMPERED_LANE, "wire_bytes": wire, **checks,
              "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "seconds": seconds, "launches": launches}
    emit(result)
    failed = [name for name, ok in checks.items() if not ok]
    failed += [f"{name} was never launched" for name in SIGMA_KERNELS if launches[name] == 0]
    if failed:
        sys.exit(f"sigma failed: {failed}")
    return launches


def main() -> None:
    smi = phase_device()
    phase_build()
    records = phase_kernels()
    round_launches, state = phase_round()
    sigma_launches = phase_sigma(state)
    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "match",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "n")
    rows = []
    for name, rec in records.items():
        by_path = {"round": round_launches[name], "sigma": sigma_launches[name]}
        rec = {**rec, **KERNEL_FACTS[name], "launches": sum(by_path.values()),
               "launches_by_path": by_path}
        rows.append({k: rec[k] for k in keys})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
