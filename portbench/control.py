"""The control of a cell, over several seeds in one process: the program at
the next lower fixed-point precision (one fractional bit fewer, in the
clients and the server alike), checked by the same reference at the
configuration's precision. Its readings are the upper ends the limits are
set below; the benchmark's own runs never run it.

    python3 -m portbench.control --workload l2_d50k.client --seconds 5 \\
        --seeds 2147483951 2147483952 2147483953

Prints a JSON line a run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from .run import run_cell

    for seed in args.seeds:
        result, _ = run_cell(args.workload, seed, args.seconds, False, fp_frac_delta=1,
                             t0=time.perf_counter())
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "correct": result["correct"], "steps": result["attempted"],
                          "metrics": {k: v["value"] for k, v in result["metrics"].items()},
                          "checks": {k: v["value"] for k, v in result["checks"].items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
