"""Time the compile-time choices of the rebuilt kernels on the card: the
MSM's window c (csrc/msm.cu, ROFL_MSM_C; the package builds c = 3), the
ladder's threads a block (csrc/scalar_mul.cu, ROFL_LADDER_THREADS; the
package builds 64) and the blocks an SM the point sums ask for
(csrc/point_sum.cu, ROFL_SUM_MIN_BLOCKS, which caps their registers).

    python -m rofl_tpu_torch.tune_kernels

needs one CUDA card and nvcc. It builds msm.cu at c = 3, 4 and 5,
scalar_mul.cu at 32, 64 and 128 threads and point_sum.cu at 1, 2 and 4
blocks an SM, all at once, into build/rofl_tpu_torch/ beside the package's
own libraries; runs each variant through its C entry point on the same
random inputs (msm_groups: 16 groups of 65 536 terms; scalar_mul: 50 000
lanes; point_sum: the paths' layouts SUM_LAYOUTS, each planned by
kernels.sum_plan for a wave of the card's SMs times the variant's blocks),
holds its result equal to the package's wrapper as canonical encodings, and
prints one JSON line per variant: ptxas' registers and spill bytes for each
entry point, the slices a group (the MSM) or the plans (the sums), and the
median device time of one call in ms. A variant that disagrees ends the run
with a non-zero exit code.
"""

from __future__ import annotations

import ctypes
import json
import re
import statistics
import subprocess
import sys

import numpy as np
import torch

from .ops import curve, fe, kernels

MSM_WINDOWS = (3, 4, 5)
LADDER_THREADS = (32, 64, 128)
SUM_MIN_BLOCKS = (1, 2, 4)
MSM_SHAPE = (16, 1 << 16)  # groups, terms a group: the provers' S sum
LADDER_LANES = 50_000
# (outer, R, inner): tree_sum of d, the provers' A sums, the clients' sums,
# the range verifier's chunk sums, the IPA's last groups
SUM_LAYOUTS = ((1, 50_000, 1), (16, 32_768, 1), (1, 4, 50_000), (1, 16, 32_768), (32, 2, 1))


def build_variants() -> dict:
    """(source, define) -> (library path, ptxas records), built in parallel."""
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    wanted = [("msm.cu", f"ROFL_MSM_C={c}") for c in MSM_WINDOWS] + [
        ("scalar_mul.cu", f"ROFL_LADDER_THREADS={t}") for t in LADDER_THREADS] + [
        ("point_sum.cu", f"ROFL_SUM_MIN_BLOCKS={b}") for b in SUM_MIN_BLOCKS]
    running = {}
    for src, define in wanted:
        base = kernels._library_path(src)
        out = base.with_name(f"{base.stem}-{define.replace('=', '')}.so")
        running[(src, define)] = (subprocess.Popen(
            kernels.nvcc_command(src, out, (define,)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), out)
    built = {}
    for key, (proc, out) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            sys.exit(f"{key}: nvcc exited with {proc.returncode}\n{log}")
        built[key] = (out, ptxas_records(log))
    return built


def ptxas_records(log: str) -> list:
    records = []
    for chunk in log.split("Compiling entry function")[1:]:
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        records.append({"entry": re.search(r"'(\S+)'", chunk).group(1),
                        "registers": int(re.search(r"Used (\d+) registers", chunk).group(1)),
                        "spill_store_bytes": int(spill.group(1)),
                        "spill_load_bytes": int(spill.group(2))})
    return records


def device_ms(fn, reps: int = 2, rounds: int = 3) -> float:
    """Median device time of one fn() in ms, the launches queued behind a
    busy stream so that the events bracket device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def random_operands(n: int, device: torch.device, rng: np.random.Generator):
    """n random 256-bit scalars and n random group elements (random
    multiples of the basepoint)."""
    def scalars():
        return fe.to_tensor(rng.integers(0, 1 << 16, size=(16, n)), device)

    base = tuple(c.expand(16, n).contiguous() for c in curve.basepoint((1,), device))
    return scalars(), kernels.scalar_mul(scalars(), base)


def call(lib_path, name: str, argtypes: list, *args) -> None:
    fn = getattr(ctypes.CDLL(str(lib_path)), name)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        sys.exit(f"{lib_path.name} {name}: CUDA error {err}")


def msm_slices(lib_path, c: int, n_groups: int, group: int, device) -> int:
    """The slices a group the package's wrapper would pick for a built
    msm.cu variant of window c (its occupancy on this card)."""
    per_sm = ctypes.c_int(0)
    fn = ctypes.CDLL(str(lib_path)).rofl_msm_occupancy
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    if fn(ctypes.byref(per_sm)) != 0:
        sys.exit(f"{lib_path.name}: occupancy query failed")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return kernels.msm_slices(n_groups, group, -(-257 // c), per_sm.value * sms)


def msm_variant(lib_path, c: int, k, p, group: int, slices: int):
    """One call of a built msm.cu variant, its scratch sized for window c."""
    device, n = p[0].device, p[0].shape[1]
    n_groups, windows = n // group, -(-257 // c)
    digit_rows = torch.empty((windows, n), dtype=torch.int8, device=device)
    partials = torch.empty((n_groups * slices * windows, 32), dtype=fe.DTYPE, device=device)
    out = [torch.empty((16, n_groups), dtype=fe.DTYPE, device=device) for _ in range(4)]
    call(lib_path, "rofl_msm_groups", kernels._ARGTYPES["msm_groups"], k.data_ptr(), n,
         *[t.data_ptr() for t in p], n, group, slices, digit_rows.data_ptr(),
         partials.data_ptr(), *[t.data_ptr() for t in out])
    return tuple(out)


def ladder_variant(lib_path, k, p):
    n = p[0].shape[1]
    out = [torch.empty((16, n), dtype=fe.DTYPE, device=p[0].device) for _ in range(4)]
    call(lib_path, "rofl_scalar_mul", kernels._ARGTYPES["scalar_mul"],
         k.data_ptr(), n, *[t.data_ptr() for t in p], *[t.data_ptr() for t in out], n)
    return tuple(out)


def point_sum_variant(lib_path, p, layout: tuple, plan: tuple):
    """One call of a built point_sum.cu variant with the plan given."""
    outer, r, inner = layout
    tpl, slices, tpl2 = plan
    device, m = p[0].device, outer * inner
    scratch = [torch.empty((16, slices * m), dtype=fe.DTYPE, device=device) for _ in range(4)]
    out = [torch.empty((16, m), dtype=fe.DTYPE, device=device) for _ in range(4)]
    call(lib_path, "rofl_point_sum", kernels._ARGTYPES["point_sum"], *[t.data_ptr() for t in p],
         outer, r, inner, tpl, slices, tpl2, *[t.data_ptr() for t in scratch],
         *[t.data_ptr() for t in out])
    return tuple(out)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("tune_kernels: no CUDA device")
    device = torch.device("cuda")
    rng = np.random.default_rng(11)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": smi}), flush=True)
    built = build_variants()
    bad = []

    n_groups, group = MSM_SHAPE
    k, p = random_operands(n_groups * group, device, rng)
    want = kernels.compress(kernels.msm_groups(k, p, group))
    for c in MSM_WINDOWS:
        lib_path, ptxas = built[("msm.cu", f"ROFL_MSM_C={c}")]
        slices = msm_slices(lib_path, c, n_groups, group, device)
        got = msm_variant(lib_path, c, k, p, group, slices)
        match = torch.equal(kernels.compress(got), want)
        bad += [] if match else [f"msm c={c}"]
        print(json.dumps({"kernel": "msm_groups", "window": c, "groups": n_groups,
                          "group": group, "slices": slices, "match": match,
                          "ms": device_ms(lambda: msm_variant(lib_path, c, k, p, group, slices)),
                          "ptxas": ptxas}), flush=True)
    del k, p
    torch.cuda.empty_cache()

    k, p = random_operands(LADDER_LANES, device, rng)
    want = kernels.compress(kernels.scalar_mul(k, p))
    for t in LADDER_THREADS:
        lib_path, ptxas = built[("scalar_mul.cu", f"ROFL_LADDER_THREADS={t}")]
        match = torch.equal(kernels.compress(ladder_variant(lib_path, k, p)), want)
        bad += [] if match else [f"scalar_mul threads={t}"]
        print(json.dumps({"kernel": "scalar_mul", "threads": t, "lanes": LADDER_LANES,
                          "match": match, "ms": device_ms(lambda: ladder_variant(lib_path, k, p)),
                          "ptxas": ptxas}), flush=True)
    del k, p
    torch.cuda.empty_cache()

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    for layout in SUM_LAYOUTS:
        _, p = random_operands(layout[0] * layout[1] * layout[2], device, rng)
        want = kernels.compress(kernels.point_sum(p, *layout))
        for b in SUM_MIN_BLOCKS:
            lib_path, ptxas = built[("point_sum.cu", f"ROFL_SUM_MIN_BLOCKS={b}")]
            plan = kernels.sum_plan(*layout, sms * b)
            match = torch.equal(kernels.compress(point_sum_variant(lib_path, p, layout, plan)),
                                want)
            bad += [] if match else [f"point_sum blocks={b} at {layout}"]
            print(json.dumps({"kernel": "point_sum", "min_blocks_per_sm": b,
                              "layout": list(layout), "plan": list(plan), "match": match,
                              "ms": device_ms(lambda: point_sum_variant(lib_path, p, layout, plan),
                                              reps=10),
                              "ptxas": ptxas}), flush=True)
        del p
        torch.cuda.empty_cache()
    if bad:
        sys.exit(f"variants disagree with the package's kernels: {bad}")


if __name__ == "__main__":
    main()
