"""The metrics read from the program's own spans and counters
(``portbench/harness/program_spans.py``), in a traced run of a client and a
server cell on the CPU at a tiny size, as ``test_portbench_faults.py`` runs
them: every such metric prints a positive number in each cell it lists and
reads None in the others, each phase sum is no larger than the outside span
it splits, and an untraced run prints none of them. Several minutes of
plain torch; run apart from the repository's tier-1 tests:

    python -m pytest portbench/tests/test_portbench_program_spans.py -q
"""

from __future__ import annotations

import pytest

from portbench import run as R
from portbench.harness import bench as B

SEED = 2**31 + 18
PROGRAM = ("program_span", "program_counter")
PHASES = {"range_prove_s": ["range_prove_commit_s", "range_prove_poly_s", "range_prove_ipp_s"],
          "range_verify_s": ["range_verify_encode_s", "range_verify_transcript_s",
                             "range_verify_msm_s"]}


def _program_metrics(spec) -> list[dict]:
    """The per-layer metrics read from the program: those whose reader
    imports ``program_spans``."""
    return [m for m in spec["per_layer"] if m["source"] in PROGRAM
            and "program_spans" in (B.PORTBENCH / "metrics" / f"{m['name']}.py").read_text()]


def _run(workload: str, trace: bool, **traffic) -> dict:
    spec = B.load_benchmark()
    cell = B.cell(spec, workload)
    cfg = dict(B.config(spec, cell["config"]), d=2, n_partition=2)
    tr = dict(B.traffic(cell["traffic"]), **traffic)
    result, _ = R.run_cell(workload, SEED, 0.01, trace, device="cpu", config=cfg, traffic=tr)
    return result


@pytest.mark.parametrize("workload,traffic", [("l2_d50k.client", {"warmup_steps": 1}),
                                              ("range_d62006.server",
                                               {"clients": 2, "warmup_rounds": 0})])
def test_program_metrics_in_a_traced_run(workload, traffic):
    spec = B.load_benchmark()
    mine = _program_metrics(spec)
    assert len(mine) == 13
    result = _run(workload, True, **traffic)
    assert result["correct"], result["checks"]
    metrics = result["metrics"]
    for m in mine:
        if workload in m["workloads"]:
            assert metrics[m["name"]]["value"] > 0, m["name"]
        else:
            assert m["name"] not in metrics
            assert B.reader(m["name"])(None) is None, m["name"]
    for outside, phases in PHASES.items():
        if outside in metrics:
            assert sum(metrics[p]["value"] for p in phases) <= metrics[outside]["value"]
    untraced = _run(workload, False, **traffic)
    assert not set(untraced["metrics"]) & {m["name"] for m in mine}
