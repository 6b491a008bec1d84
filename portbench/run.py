"""Run one cell of the port's benchmark once, and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the cell's cards. The run
loads the cell's configuration and traffic (``BENCHMARK.json``), builds and
warms the program (``rofl_tpu_torch``) from the seed, runs whole steps for
``--seconds``, frees the program's state, checks what the timed steps
produced against the benchmark's own reference, and prints one JSON object
as the last line of standard output. With ``--trace 0`` its metrics are the
cell's end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` (its first 20 seconds) with the layers' spans, and its
metrics are the per-layer ones. The numbers compared are printed, each beside its limit, as the last
lines of standard error and under "checks", the last key of the line.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "rofl_tpu"}


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is one of FORBIDDEN."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _pin_caches(root) -> None:
    """Kernel caches of the process inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["USE_FLAX"] = "0"


class Run:
    """What a metric reader reads: the loop's counts and window, the spans,
    the launch shapes and the device trace's summary."""

    def __init__(self, loop, setup_s, recorder=None, trace=None):
        self.counts = loop.counts()
        self.window_s = loop.window_s
        self.setup_s = setup_s
        self.spans = recorder.seconds if recorder else {}
        self.span_calls = recorder.calls if recorder else {}
        self.launches = recorder.launches if recorder else {}
        self.trace = trace


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             fp_frac_delta: int = 0, t0: float = T0, config: dict | None = None,
             traffic: dict | None = None) -> tuple[dict, list]:
    """One run of a cell → (result line, the forbidden modules loaded once
    the window closed). `config`
    and `traffic`, where given, stand in for the cell's files (the CPU tests
    run a cell at a tiny size)."""
    import torch

    from .harness import bench as B
    from .harness import devtrace
    from .harness.loops import LOOPS, sync
    from .harness.spans import Recorder

    spec = B.load_benchmark()
    cell = B.cell(spec, workload)
    cfg = config or B.config(spec, cell["config"])
    traffic = traffic or B.traffic(cell["traffic"])
    on_card = torch.device(device).type == "cuda"
    _pin_caches(B.ROOT)
    loop = LOOPS[traffic["loop"]](cfg, traffic, seed, device, fp_frac_delta)
    loop.setup()
    sync(device)
    setup_s = time.perf_counter() - t0

    recorder = trace_rec = summary = None
    if trace:
        recorder = Recorder(device)
        loop.span_layers(recorder)
        loop.interval = recorder.interval
        trace_rec = devtrace.DeviceTrace(recorder, on_card)
        loop.after_step = trace_rec.after_step
        trace_rec.start()
    tw = time.perf_counter()
    try:
        loop.window(seconds)
        sync(device)
    finally:
        window_s = time.perf_counter() - tw
        if trace:
            trace_rec.stop()
            recorder.close()
    if trace:
        tp = time.perf_counter()
        summary = trace_rec.summary()
        del trace_rec
        print(f"portbench: trace of {summary['window_s']:.3f} s read in "
              f"{time.perf_counter() - tp:.3f} s", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = Run(loop, setup_s, recorder, summary)
    metrics = {}
    for m in B.metrics_for(spec, workload, trace):
        value = B.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    loaded = forbidden_modules()
    tc = time.perf_counter()
    loop.release()
    numbers = loop.check()
    print(f"portbench: setup {setup_s:.3f} s, window {window_s:.3f} s, release and check "
          f"{time.perf_counter() - tc:.3f} s", file=sys.stderr)
    print(f"portbench: seconds of each step (round): {[round(x, 4) for x in loop.step_s]}",
          file=sys.stderr)
    if summary:
        print(f"portbench: {summary['events']} device events, the first "
              f"{summary['first_event_after_window_start_s']} s after the window opened",
              file=sys.stderr)
    counts = loop.counts()
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": peak}
    result = {"correct": all(v <= lim for v, lim in numbers.values()),
              "attempted": counts["attempted"], "failed": counts["failed"],
              "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in numbers.items()}
    return result, loaded


def main(argv=None) -> int:
    args = _parse(argv)
    import torch

    from .harness import bench as B

    chips = B.cell(B.load_benchmark(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result, loaded = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if loaded:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {loaded}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
