"""``BENCHMARK.json`` and the files it names: a cell's configuration, its
traffic mix and the readers of its metrics, all found by name."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
PORTBENCH = ROOT / "portbench"


def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell(bench: dict, workload: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((ROOT / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return json.loads((PORTBENCH / "traffic" / f"{name}.json").read_text())


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of `workload` prints: with trace, the per-layer ones
    that list it (or list no cells and move an end-to-end metric it reports);
    without, its end-to-end ones."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(name: str):
    """The ``read(run)`` function of metric `name`
    (``portbench/metrics/<name>.py``)."""
    path = PORTBENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
