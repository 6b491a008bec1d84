"""Drive the PyTorch/CUDA port once on the card: build the kernels, hold each
against its plain version, run the secure-aggregation round at full width.

    python3 chip_smoke.py

needs one NVIDIA GPU (built for sm_90a: an H100), `nvcc`, and nothing else.
It imports only ``rofl_tpu_torch``. Every phase prints one JSON line; the
first failure of any phase ends the run with a non-zero exit code. The last
line is ``{"ok": true, "device": {...}}``.

Phases:
  device   the card's name and power limit, torch and CUDA versions
  build    nvcc builds the five kernels from rofl_tpu_torch/csrc (in parallel)
  kernels  point_add, point_double, compress, decompress, sc_reduce_wide
           against their plain torch versions on the card, at the lane counts
           the round uses and at N = 1 and 77, random and edge inputs,
           canonical limbs bit-equal; times at N = 50000
  round    d = 50000, 4 clients, FpConfig(16, 7), through ``bindings``:
           cancelling blindings (keyed Keccak XOF on the card, reduced mod l
           by sc_reduce_wide) -> commit -> add_commitments -> extract_values
           with the default table (m = 2^16); the ElGamal-pair form of the
           same round through the wire format; an extract with a small table
           (m = 2^12) on 4096 lanes, which walks 16 giant steps. Sums are
           held against numpy's fixed-point sum, exactly.
Launch counts are set to zero just before the round and read just after it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from rofl_tpu_torch import bindings  # noqa: E402
from rofl_tpu_torch.crypto import pedersen  # noqa: E402
from rofl_tpu_torch.crypto import serde_vec as sv  # noqa: E402
from rofl_tpu_torch.crypto.fp_codec import FpConfig  # noqa: E402
from rofl_tpu_torch.ops import bsgs, curve, fe, kernels  # noqa: E402
from rofl_tpu_torch.spec import generators as G  # noqa: E402
from rofl_tpu_torch.spec import ristretto as SR  # noqa: E402

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
# Bytes per lane: (16, N) int32 arrays read and written once, the validity
# byte of decompress, the 64 int32 byte columns of sc_reduce_wide.
MUL, SQR = 128, 72
LIMBS = 16 * 4
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
}
# Lane counts the round gives the kernels (fixed-base tables: 1 and 8192;
# blindings, commits and wire: 50000; first halving of the 4-client sum:
# 100000; default BSGS table: 65537; small extract: 4096), and 77.
REJECT_LANES = 64
CHECK_LANES = (1, 77, SMALL_LANES, 8192, D, (1 << 16) + 1, 2 * D)


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
    emit({"phase": "build", "seconds": seconds, "nvcc": version})


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


def phase_kernels() -> dict:
    rng = np.random.default_rng(SEED)
    records = {name: {"name": name, "route": "cuda", "match": True, "max_abs_err": 0,
                      "checked_lanes": list(CHECK_LANES)} for name in KERNEL_FACTS}

    def hold(name, got, want, field=True):
        err = max_abs_err(got, want, field)
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        if err != 0:
            records[name]["match"] = False

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
            for name, (kernel_fn, plain_fn) in calls.items():
                records[name]["n"] = n
                records[name]["ms"] = device_ms(kernel_fn)
                records[name]["plain_ms"] = 1e3 * min(synced(plain_fn)[1] for _ in range(2))
                records[name]["bound_ms"], records[name]["bound_by"] = bound_ms(name, n)
                records[name]["library_ms"] = None
            records["decompress"]["valid_share"] = float(k_valid.float().mean())
    torch.cuda.synchronize()
    bad = [name for name, r in records.items() if not r["match"]]
    emit({"phase": "kernels", "tolerance": "canonical limbs and masks bit-equal (0)",
          "kernels": list(records.values())})
    if bad:
        sys.exit(f"kernels disagree with their plain versions: {bad}")
    return records


# -- phase 4: the round ----------------------------------------------------------


def phase_round() -> dict:
    rng = np.random.default_rng(SEED + 1)
    seconds = {}

    def stage(name, fn):
        out, seconds[name] = synced(fn)
        return out

    # A fresh process state: no fixed-base or BSGS table is built yet.
    pedersen.base_B.cache_clear()
    pedersen.base_H.cache_clear()
    bsgs.clear_tables()
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
    torch.cuda.reset_peak_memory_stats()

    bits = rng.integers(-UPDATE_BITS, UPDATE_BITS + 1, size=(N_CLIENTS, D))
    updates = (bits / FP.scale).astype(np.float32)
    want = (bits.sum(axis=0) / FP.scale).astype(np.float32)

    # Pedersen-blob form, through the bindings.
    blindings = stage("generate_cancelling_blindings",
                      lambda: bindings.generate_cancelling_blindings(
                          N_CLIENTS, D, rng, device=DEVICE))
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
        "pedersen_sum_exact": pedersen_exact, "commitments_match_spec": bool(spec_ok),
        "xof_matches_cpu": xof_ok,
        "elgamal_sum_exact": elgamal_exact, "small_table_sum_exact": small_exact,
        "uncancelled_round_rejected": rejected,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "seconds": seconds, "launches": launches,
    }
    emit(result)
    checks = ("pedersen_sum_exact", "commitments_match_spec", "xof_matches_cpu",
              "elgamal_sum_exact", "small_table_sum_exact", "uncancelled_round_rejected")
    failed = [c for c in checks if not result[c]]
    # two walks (the value and its negative), each of 16 steps: a compress per
    # step and an add of -mG between steps; the table build adds 32 + 1 more
    if (small_launches["compress"] < 2 * giant_steps + 1
            or small_launches["point_add"] < 2 * (giant_steps - 1) + 32):
        failed.append("giant steps did not run on the card")
    failed += [f"{name} was never launched" for name, k in launches.items() if k == 0]
    if failed:
        sys.exit(f"round failed: {failed}")
    return launches


def main() -> None:
    smi = phase_device()
    phase_build()
    records = phase_kernels()
    launches = phase_round()
    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "match", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "n")
    rows = []
    for name, rec in records.items():
        rec = {**rec, **KERNEL_FACTS[name], "launches": launches[name]}
        rows.append({k: rec[k] for k in keys})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
