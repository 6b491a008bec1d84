"""The port's command line (``python -m rofl_tpu_torch.cli``) end to end on
the CPU, as an operator runs an experiment: a ``server`` from a YAML file
(Plain, mnist_dev with all 19 090 parameters from
``models/mnist_dev_initialized.txt``, 2 clients, 2 rounds), a
``trainservice`` a client (the real trainer at the CLI's defaults: lr 0.1,
batch 32, one epoch; reference hazard 11: the file's learning rate, batch
size and optimizer do not reach it), ``clients`` with ``-r`` and an
``observer``, each its own process, all with ``--device cpu``. The model
file the server writes is held against a replay of the rule in this
process with the port's ``Trainer`` (to 1e-6 absolute: the processes' CPU
products may block differently). Then ``test-train`` against a dummy
``trainservice`` (the 19 166 parameters of basic_server.rs, reference
hazard 12)."""

import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

from rofl_tpu_torch.fl.util import read_model_from_file
from rofl_tpu_torch.models.trainer import Trainer

ROOT = Path(__file__).resolve().parent.parent
CONFIG = """\
environment:
  num_clients: 2
  experiment_name: "cli_plain"
server:
  num_rounds: 2
  global_learning_rate: 1.0
client:
  model_name: mnist_dev
  model_init_path: "{root}/models/mnist_dev_initialized.txt"
  benign_training:
    num_epochs: 1
    batch_size: 16   # never reaches the trainer (reference hazard 11)
    optimizer: Adam
    learning_rate: 0.5
crypto:
  enc_type: Plain
dataset:
  dataset: mnist
"""


def free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def cli(*args, cwd):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen([sys.executable, "-m", "rofl_tpu_torch.cli", *args, "--device", "cpu"],
                            cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)


def wait_listening(port, proc, timeout=60.0):
    """Until something accepts connections on `port` (the process that
    should listen there still running)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate()[0]
        try:
            socket.create_connection(("127.0.0.1", port), timeout=1).close()
            return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"nothing listens on port {port}")


class Lines:
    """The output of a process, read line by line in a thread as it comes."""

    def __init__(self, proc):
        self.proc, self.lines = proc, []
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append(line)

    def wait_for(self, text, timeout=60.0):
        deadline = time.monotonic() + timeout
        while not any(text in line for line in self.lines):
            assert self.proc.poll() is None or self.thread.is_alive(), "".join(self.lines)
            assert time.monotonic() < deadline, f"no {text!r} in {''.join(self.lines)}"
            time.sleep(0.1)

    def text(self):
        self.thread.join(30)
        return "".join(self.lines)


def stop(procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGTERM)
    for p in procs:
        try:
            p.wait(10)
        except subprocess.TimeoutExpired:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()


def test_a_plain_experiment_through_the_cli(tmp_path):
    (tmp_path / "cfg.yml").write_text(CONFIG.format(root=ROOT))
    port, trainer_port, _ = free_ports(3)
    services = [cli("trainservice", "-p", str(trainer_port + i), "--client-id", str(i),
                    "--num-clients", "2", cwd=tmp_path) for i in range(2)]
    server = cli("server", "-c", "cfg.yml", "-p", str(port), cwd=tmp_path)
    observer = clients = None
    try:
        for i, service in enumerate(services):
            wait_listening(trainer_port + i, service)
        wait_listening(port, server)
        observer = cli("observer", "-p", str(port), "--model", "mnist_dev", cwd=tmp_path)
        observed = Lines(observer)
        observed.wait_for("observing model 1")  # it sees round 0's broadcast
        clients = cli("clients", "-n", "2", "-p", str(port), "-r", str(trainer_port),
                      "--numtrainers", "2", cwd=tmp_path)
        out, _ = clients.communicate(timeout=240)
        assert clients.returncode == 0, out
        server_out, _ = server.communicate(timeout=60)
        assert server.returncode == 0, server_out
        observer.wait(60)
        observer_out = observed.text()
        assert observer.returncode == 0, observer_out
    finally:
        stop([p for p in services + [server, observer, clients] if p is not None])
    got = read_model_from_file(str(tmp_path / "model_1_round_1.txt"))

    model = read_model_from_file(str(ROOT / "models" / "mnist_dev_initialized.txt"))
    trainers = [Trainer("mnist_dev", "mnist", client_id=i, num_clients=2, device="cpu")
                for i in range(2)]
    for r in range(2):
        extracted = np.zeros(len(model), np.float32)
        for t in trainers:
            t.set_weights(model)
            extracted += t.train(r) - model
        model = model + extracted * (1.0 / 2) * 1.0
    assert got.shape == (19090,) and np.isfinite(got).all()
    np.testing.assert_allclose(got, model, rtol=0, atol=1e-6)
    assert "[EVAL] (0," in observer_out and "[EVAL] (1," in observer_out


def test_test_train_against_a_dummy_trainservice(tmp_path):
    (port,) = free_ports(1)
    service = cli("trainservice", "-p", str(port), "--dummy", cwd=tmp_path)
    env = {**os.environ, "PYTHONPATH": str(ROOT)}
    try:
        wait_listening(port, service)
        out = subprocess.run([sys.executable, "-m", "rofl_tpu_torch.cli", "test-train", "-p",
                              str(port)], cwd=tmp_path, env=env, capture_output=True, text=True,
                             timeout=120)
    finally:
        stop([service])
    assert out.returncode == 0, out.stderr
    assert "update: len=19166 first=[0.001 0.001 0.001 0.001]" in out.stdout
