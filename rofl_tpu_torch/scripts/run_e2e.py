"""Single-host e2e experiment orchestrator — counterpart of
``scripts/run_e2e.py`` (the reference's ansible/e2ebench.yml +
roles/e2e-experiment-start/*): launches the aggregation server, optional
trainer services, an optional observer and one ``clients`` process of N FL
clients, each ``python -m rofl_tpu_torch.cli`` in its own process, waits for
the server to finish, then parses the clients' benchlogs into one table
(``parse_benchlog``).

Usage:
  python -m rofl_tpu_torch.scripts.run_e2e -c configs/example_config.yml --trainers 1 --observer
  python -m rofl_tpu_torch.scripts.run_e2e -c configs/mnist_range_e2e.yml --dummy --device cpu

Kept from the JAX script: its arguments and defaults, and reference hazard
11 (no ``--lr`` or ``--batch-size`` reaches a trainer service). Changed:
- ``--device cuda|cpu`` (default ``cuda``) replaces ``--platform`` and goes
  to every child; on the card the kernels are built once, here, before the
  first child starts;
- every child runs in the run's own directory, ``--logdir``, with the repo
  on ``PYTHONPATH``. The server writes ``model_1_round_<r>.txt`` and
  ``benchlog/server_model1.bench`` into its working directory (reference
  hazard 13), so they land there, beside the children's logs and the
  clients' ``client<i>.bench``. A ``client.model_init_path`` that is
  relative is resolved against the repo, where the JAX script ran its
  children: the server then reads a copy of the config, ``<logdir>/config.yml``;
- the server and the trainer services start together, the observer once
  the server listens, and the clients once the server and every trainer
  service listen and the observer follows the model, instead of after
  fixed sleeps (a client does not retry a refused connection);
- once the server has exited, the clients and the observer get ``GRACE_S``
  to take DONE and exit before every child's process group is killed;
- ``main`` returns the run's ``Outcome``, and the exit code says whether
  the server exited 0 before ``--timeout``.
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

from ..fl.yaml_subset import safe_dump, safe_load
from . import parse_benchlog

REPO = Path(__file__).resolve().parents[2]
STARTUP_TIMEOUT_S = 300.0  # a child that imports torch and opens a CUDA context
GRACE_S = 30.0


@dataclass
class Outcome:
    """How one experiment ended. ``server_rc`` is the server's exit code
    (negative: killed by that signal); ``finished``: it exited before
    ``--timeout``; ``error``: why the run stopped while starting, if it did."""

    server_rc: int | None
    finished: bool
    seconds: float
    logdir: str
    pids: list[int]
    error: str | None = None

    @property
    def ok(self) -> bool:
        return self.finished and self.server_rc == 0 and self.error is None


class StartupError(RuntimeError):
    """A child exited, or did not come up, while the experiment started."""


def launch(name, args, logdir, device):
    logpath = os.path.join(logdir, f"{name}.log")
    path = os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p)
    with open(logpath, "w") as out:
        p = subprocess.Popen(
            [sys.executable, "-m", "rofl_tpu_torch.cli", *args, "--device", device],
            stdout=out, stderr=subprocess.STDOUT, cwd=logdir,
            env={**os.environ, "PYTHONPATH": path}, start_new_session=True,
        )
    p.logpath = logpath
    print(f"[{name}] pid={p.pid}: rofl_tpu_torch.cli {' '.join(args)} --device {device}",
          flush=True)
    return p


def check_alive(p, name):
    """Stop early (with the log tail) if a freshly-launched process died."""
    if p.poll() is not None:
        tail = ""
        try:
            with open(p.logpath) as f:
                tail = "".join(f.readlines()[-20:])
        except OSError:
            pass
        raise StartupError(
            f"[{name}] exited during startup (rc={p.returncode}); log tail:\n{tail}")


def wait_until(p, name, ready, what: str):
    """Poll `ready()` until it holds, `p` alive, for STARTUP_TIMEOUT_S."""
    deadline = time.monotonic() + STARTUP_TIMEOUT_S
    while not ready():
        check_alive(p, name)
        if time.monotonic() > deadline:
            raise StartupError(f"[{name}] {what} after {STARTUP_TIMEOUT_S:.0f} s")
        time.sleep(0.2)


def listening(port: int):
    def ready():
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return True
        except OSError:
            return False
    return ready


def logged(p, text: str):
    def ready():
        with open(p.logpath) as f:
            return text in f.read()
    return ready


def stop(procs):
    """SIGTERM every child's process group, then SIGKILL what is left."""
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGTERM)
        except ProcessLookupError:
            pass
    for p in procs:
        try:
            p.wait(5)
        except subprocess.TimeoutExpired:
            pass
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()


def run_config(config: str, logdir: str):
    """(path of the config the server reads, its dict)."""
    with open(config) as f:
        doc = safe_load(f.read())
    client = doc.get("client") or {}
    init = client.get("model_init_path")
    if init and not os.path.isabs(init):
        client["model_init_path"] = str(REPO / init)
        path = os.path.join(logdir, "config.yml")
        with open(path, "w") as f:
            f.write(safe_dump(doc))
        return path, doc
    return os.path.abspath(config), doc


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rofl_tpu_torch.scripts.run_e2e")
    ap.add_argument("-c", "--config", required=True)
    ap.add_argument("-p", "--port", type=int, default=50551)
    ap.add_argument("--trainer-port", type=int, default=50616)
    ap.add_argument("--trainers", type=int, default=0,
                    help="number of trainservice processes (0 = dummy)")
    ap.add_argument("--dummy", action="store_true",
                    help="use the in-client dummy trainer (no trainer service)")
    ap.add_argument("--observer", action="store_true")
    ap.add_argument("--logdir", default="benchlog")
    ap.add_argument("--timeout", type=float, default=1800)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every child's crypto and training run")
    return ap


def main(argv=None) -> Outcome:
    args = parser().parse_args(argv)
    logdir = os.path.abspath(args.logdir)
    os.makedirs(logdir, exist_ok=True)
    config, doc = run_config(args.config, logdir)
    n_clients = int(doc.get("environment", {}).get("num_clients", 1))
    model_name = doc.get("client", {}).get("model_name", "mnist_dev")
    dataset = doc.get("dataset", {}).get("dataset", "mnist")
    intrinsic = doc.get("server", {}).get("intrinsic_dimension")
    if args.device == "cuda":
        from ..ops import kernels

        kernels.build_kernels()

    procs, server, error, finished = [], None, None, False
    t0 = time.time()
    try:
        server = launch("server", [
            "server", "-c", config, "-a", "127.0.0.1", "-p", str(args.port),
        ], logdir, args.device)
        procs.append(server)

        # the trainer services start beside the server: neither calls the other
        trainers, trainer_flag = [], []
        if args.trainers > 0 and not args.dummy:
            for i in range(args.trainers):
                t_args = ["trainservice", "-p", str(args.trainer_port + i),
                          "--model", model_name, "--dataset", dataset,
                          "--client-id", str(i),
                          "--num-clients", str(n_clients)]
                if intrinsic:
                    t_args += ["--intrinsic-dim", str(intrinsic)]
                trainers.append(launch(f"trainservice{i}", t_args, logdir, args.device))
            procs += trainers
            trainer_flag = ["-r", str(args.trainer_port),
                            "--numtrainers", str(args.trainers)]
        wait_until(server, "server", listening(args.port), f"does not listen on {args.port}")

        if args.observer:
            observer = launch("observer", [
                "observer", "-a", "127.0.0.1", "-p", str(args.port),
                "--model", model_name, "--dataset", dataset,
            ] + (["--intrinsic-dim", str(intrinsic)] if intrinsic else []),
                logdir, args.device)
            procs.append(observer)
        for i, p in enumerate(trainers):
            port = args.trainer_port + i
            wait_until(p, f"trainservice{i}", listening(port), f"does not listen on {port}")
        if args.observer:
            wait_until(observer, "observer", logged(observer, "observing model"),
                       "does not follow the model")

        clients = launch("clients", [
            "clients", "-n", str(n_clients), "-a", "127.0.0.1",
            "-p", str(args.port), "--benchlog", logdir,
        ] + trainer_flag, logdir, args.device)
        procs.append(clients)

        # wait for the server to finish (it exits when training completes)
        while server.poll() is None:
            if time.time() - t0 > args.timeout:
                print("TIMEOUT — killing experiment", flush=True)
                break
            time.sleep(0.5)
        finished = server.poll() is not None
        # the clients and the observer end at DONE; trainer services serve on
        ending = [clients] + ([observer] if args.observer else [])
        deadline = time.monotonic() + GRACE_S
        while finished and time.monotonic() < deadline and any(p.poll() is None for p in ending):
            time.sleep(0.2)
    except StartupError as e:
        error = str(e)
        print(error, flush=True)
    finally:
        stop(procs)

    seconds = time.time() - t0
    print(f"\nexperiment done in {seconds:.1f}s; parsing benchlogs", flush=True)
    parse_benchlog.main([logdir])
    return Outcome(server_rc=None if server is None else server.returncode, finished=finished,
                   seconds=seconds, logdir=logdir, pids=[p.pid for p in procs], error=error)


if __name__ == "__main__":
    sys.exit(0 if main().ok else 1)
