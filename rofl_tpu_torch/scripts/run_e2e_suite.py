"""E2E experiment suite — counterpart of ``scripts/run_e2e_suite.py``: runs
the MNIST experiment in several crypto modes through ``run_e2e`` and writes
an e2e_table.csv-style summary (accuracy, mean round time, bandwidth,
slowdown vs plain), the single-host counterpart of the reference's ansible
e2ebench.yml + plots/data/e2e_table.csv.

Usage:
  python -m rofl_tpu_torch.scripts.run_e2e_suite [--modes Plain Range l2Compressed]
      [--clients 4] [--rounds 3] [--out build/results] [--device cuda]

Kept from the JAX script: the configs it writes (``make_config``), what it
reads from the logs (``parse_logs``), the table's columns, and its defaults,
but ``--out``, whose JAX default (``results``) holds tracked files; added:
``--device``, passed to ``run_e2e``. ``run_e2e`` runs in this process, and
``main`` returns the rows and each mode's ``run_e2e.Outcome``.
"""

from __future__ import annotations

import argparse
import csv
import os
import re
import sys
import time

from ..fl.yaml_subset import safe_dump, safe_load
from . import run_e2e


def make_config(base_cfg: str, mode: str, clients: int, rounds: int,
                out_path: str):
    with open(base_cfg) as f:
        doc = safe_load(f.read())
    doc["environment"]["num_clients"] = clients
    doc["environment"]["num_selected_clients"] = clients
    doc["server"]["num_rounds"] = rounds
    doc["crypto"]["enc_type"] = mode
    doc["crypto"]["n_partition"] = 2
    with open(out_path, "w") as f:
        f.write(safe_dump(doc))


def parse_logs(logdir: str):
    """Mean round ms + total bandwidth from client benchlogs; accuracy from
    the observer log ([EVAL] (round, loss, acc))."""
    rounds = {}
    total_bytes = 0
    for fn in os.listdir(logdir):
        if fn.startswith("client") and fn.endswith(".bench"):
            with open(os.path.join(logdir, fn)) as f:
                for line in f:
                    parts = [p.strip() for p in line.split(",")]
                    if len(parts) >= 7:
                        try:
                            r = int(parts[0])
                            total = float(parts[5])
                            recv, sent = int(parts[-2]), int(parts[-1])
                        except ValueError:
                            continue
                        rounds.setdefault(r, []).append(total)
                        total_bytes += recv + sent
    mean_round_ms = (
        sum(sum(v) / len(v) for v in rounds.values()) / max(len(rounds), 1)
    )
    acc = None
    obs = os.path.join(logdir, "observer.log")
    if os.path.exists(obs):
        with open(obs) as f:
            for line in f:
                m = re.search(r"\[EVAL\]\s*\((\d+),\s*([\d.]+),\s*([\d.]+)\)", line)
                if m:
                    acc = float(m.group(3))
    return mean_round_ms, total_bytes, acc


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rofl_tpu_torch.scripts.run_e2e_suite")
    ap.add_argument("--modes", nargs="+",
                    default=["Plain", "Range", "l2Compressed"])
    ap.add_argument("--clients", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--config", default="configs/example_config.yml")
    ap.add_argument("--out", default="build/results")
    ap.add_argument("--trainers", type=int, default=1)
    ap.add_argument("--observer", action="store_true", default=True)
    ap.add_argument("--port", type=int, default=50620)
    ap.add_argument("--timeout", type=float, default=2400)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    """Run the modes in turn; returns (rows of the table, {mode: Outcome})."""
    args = parser().parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    rows, outcomes = [], {}
    plain_ms = None
    for i, mode in enumerate(args.modes):
        cfg = os.path.join(args.out, f"cfg_{mode}.yml")
        make_config(args.config, mode, args.clients, args.rounds, cfg)
        logdir = os.path.join(args.out, f"benchlog_{mode}")
        run_args = ["-c", cfg, "-p", str(args.port + 10 * i),
                    "--trainer-port", str(args.port + 10 * i + 5),
                    "--logdir", logdir, "--timeout", str(args.timeout),
                    "--device", args.device]
        if args.trainers:
            run_args += ["--trainers", str(args.trainers)]
        else:
            run_args += ["--dummy"]
        if args.observer:
            run_args += ["--observer"]
        print(f"=== {mode}: run_e2e {' '.join(run_args)}", flush=True)
        t0 = time.time()
        outcomes[mode] = run_e2e.main(run_args)
        wall = time.time() - t0
        ms, bw, acc = parse_logs(logdir)
        if mode == "Plain":
            plain_ms = ms
        rows.append({
            "dataset": "mnist", "mode": mode,
            "accuracy": round(acc, 4) if acc is not None else "",
            "mean_round_ms": round(ms, 1),
            "total_bandwidth_bytes": bw,
            "slowdown_vs_plain": round(ms / plain_ms, 2) if plain_ms else "",
            "wall_s": round(wall, 1),
            "clients": args.clients, "rounds": args.rounds,
        })
        print(f"=== {mode}: round={ms:.0f} ms bw={bw} acc={acc}", flush=True)

    out_csv = os.path.join(args.out, "e2e_table.csv")
    with open(out_csv, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print(f"wrote {out_csv}")
    for r in rows:
        print(r)
    return rows, outcomes


if __name__ == "__main__":
    _, outcomes = main()
    sys.exit(0 if all(o.ok for o in outcomes.values()) else 1)
