"""The port's experiment orchestration on the CPU, as an operator runs it:
``rofl_tpu_torch.scripts.run_e2e_suite`` in Plain mode with 2 clients for 2
rounds, the in-client dummy trainer and the observer, each role
``python -m rofl_tpu_torch.cli --device cpu`` in its own process, started
by ``run_e2e`` in the run's own directory (about 15 s). The suite's table
has the JAX suite's columns (read from ``scripts/run_e2e_suite.py``), each
client's bench log one line a round, the server exits 0 before the timeout,
no child's process group is left, and nothing is written into the repo."""

import ast
import csv
import hashlib
import os
import socket
import subprocess
from pathlib import Path

from rofl_tpu_torch.scripts import run_e2e_suite

ROOT = Path(__file__).resolve().parent.parent


def jax_table_columns() -> list[str]:
    """The keys of the row dict ``scripts/run_e2e_suite.py`` appends."""
    tree = ast.parse((ROOT / "scripts" / "run_e2e_suite.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append" and node.args
                and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no rows.append({...}) in the JAX suite")


def repo_state() -> dict:
    """What a run that wrote into its working directory or the JAX
    defaults would change: the tracked round model, results/, benchlog/,
    and the repo's git status where git is there."""
    state = {name: sorted((p.name, hashlib.sha256(p.read_bytes()).hexdigest())
                          for p in (ROOT / name).iterdir() if p.is_file())
             for name in ("results", "models")}
    state["model_1_round_1.txt"] = hashlib.sha256(
        (ROOT / "model_1_round_1.txt").read_bytes()).hexdigest()
    state["benchlog"] = (ROOT / "benchlog").exists()
    status = subprocess.run(["git", "status", "--porcelain", "--untracked-files=all"],
                            cwd=ROOT, capture_output=True, text=True)
    state["git"] = status.stdout if status.returncode == 0 else None
    return state


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_a_plain_suite_run_through_separate_processes(tmp_path):
    before = repo_state()
    out = tmp_path / "results"
    rows, outcomes = run_e2e_suite.main([
        "--modes", "Plain", "--clients", "2", "--rounds", "2", "--trainers", "0",
        "--device", "cpu", "--out", str(out), "--port", str(free_port()), "--timeout", "240"])
    outcome = outcomes["Plain"]
    assert outcome.ok and outcome.server_rc == 0 and outcome.finished, outcome
    for pid in outcome.pids:  # every child's process group is gone
        try:
            os.killpg(pid, 0)
        except ProcessLookupError:
            continue
        raise AssertionError(f"process group {pid} is still there")
    logdir = out / "benchlog_Plain"
    for i in range(2):
        lines = (logdir / f"client{i}.bench").read_text().splitlines()
        assert [line.split(", ")[0] for line in lines] == ["0", "1"]
        assert len(lines[0].split(", ")) == 8
    # the server wrote into the run's own directory
    assert (logdir / "model_1_round_1.txt").exists()
    assert (logdir / "benchlog" / "server_model1.bench").exists()

    with open(out / "e2e_table.csv") as f:
        table = list(csv.DictReader(f))
    assert list(table[0]) == jax_table_columns() == list(rows[0])
    assert len(table) == 1 and table[0]["mode"] == "Plain"
    assert table[0]["accuracy"] != "" and float(table[0]["mean_round_ms"]) > 0
    assert int(table[0]["total_bandwidth_bytes"]) > 0
    assert repo_state() == before
