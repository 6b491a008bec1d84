"""Parse benchlog/*.bench phase-timing files into a per-round and summary
table — counterpart of ``scripts/parse_benchlog.py`` (the reference's
plots/plots/e2e_parse_benchlog.py), with the same table, CSV and rules.

Server lines:  round, aggregate_ms, extract_ms, verify_ms, total_ms
Client lines:  round, recv_ms, train_ms, encrypt_ms, send_ms, total_ms,
               bytes_recv, bytes_sent
(format: rofl_service logs.rs:42-108; README.md:190-216)

Usage: python -m rofl_tpu_torch.scripts.parse_benchlog [benchlog_dir] [--csv out.csv]
"""

import argparse
import csv
import glob
import os
import sys


def parse_file(path):
    rows = []
    with open(path) as f:
        for line in f:
            parts = [p.strip() for p in line.strip().split(",") if p.strip()]
            if not parts:
                continue
            try:
                rows.append([float(p) for p in parts])
            except ValueError:
                continue
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("logdir", nargs="?", default="benchlog")
    ap.add_argument("--csv", default=None)
    args = ap.parse_args(argv)

    files = sorted(glob.glob(os.path.join(args.logdir, "*.bench")))
    if not files:
        print(f"no .bench files in {args.logdir}", file=sys.stderr)
        return 1

    summary = []
    for path in files:
        rows = parse_file(path)
        if not rows:
            continue
        name = os.path.basename(path).replace(".bench", "")
        is_client = name.startswith("client")
        # skip round 0 (includes first-call costs) for the mean when >1 round
        steady = rows[1:] if len(rows) > 1 else rows
        # total is the last timing column (before bandwidth columns if any)
        tot_idx = -3 if (is_client and len(rows[0]) >= 7) else -1
        mean_total = sum(r[tot_idx] for r in steady) / len(steady)
        rec = {
            "source": name,
            "rounds": len(rows),
            "mean_round_ms": round(mean_total, 1),
        }
        if is_client and len(rows[0]) >= 7:
            rec["mean_recv_ms"] = round(
                sum(r[1] for r in steady) / len(steady), 1)
            rec["mean_train_ms"] = round(
                sum(r[2] for r in steady) / len(steady), 1)
            rec["mean_encrypt_ms"] = round(
                sum(r[3] for r in steady) / len(steady), 1)
            rec["mean_send_ms"] = round(
                sum(r[4] for r in steady) / len(steady), 1)
            rec["bytes_recv"] = int(sum(r[-2] for r in rows))
            rec["bytes_sent"] = int(sum(r[-1] for r in rows))
        summary.append(rec)

    cols = ["source", "rounds", "mean_round_ms", "mean_recv_ms",
            "mean_train_ms", "mean_encrypt_ms", "mean_send_ms",
            "bytes_recv", "bytes_sent"]
    widths = {c: max(len(c), 12) for c in cols}
    print("  ".join(c.ljust(widths[c]) for c in cols))
    for rec in summary:
        print("  ".join(str(rec.get(c, "")).ljust(widths[c]) for c in cols))

    if args.csv:
        with open(args.csv, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=cols)
            w.writeheader()
            w.writerows(summary)
        print(f"wrote {args.csv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
