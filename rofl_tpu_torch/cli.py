"""Command-line entry points — counterpart of ``rofl_tpu.cli`` (the
reference binaries config_server, basic_server, basic_client (flclients),
test_train_client, plus the trainer service and the observer), with the JAX
package's arguments and defaults and one more, ``--device`` (default
``cuda``: the crypto and the trainer run on the card; ``cpu`` runs the plain
torch versions).

  python -m rofl_tpu_torch.cli server  -c cfg.yml -a 0.0.0.0 -p 50051 [--dleval]
  python -m rofl_tpu_torch.cli clients -n 4 -a 127.0.0.1 -p 50051 [-r TRAINER_PORT]
  python -m rofl_tpu_torch.cli trainservice -p 50016 [--dummy | --mock-cifar]
  python -m rofl_tpu_torch.cli observer -a 127.0.0.1 -p 50051 [--model mnist_dev]
  python -m rofl_tpu_torch.cli test-train -p 50016

The calls go over the port's transport (``fl/transport.py``), so these
commands talk to each other and not to the JAX package's.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BASIC_NUM_PARAMS = 19166  # basic_server.rs and test_train_client.rs (reference hazard 12)


def _add_common(p):
    p.add_argument("-a", "--address", default="127.0.0.1")
    p.add_argument("-p", "--port", type=int, default=50051)


def _add_device(p):
    p.add_argument("--device", default="cuda",
                   help="where the crypto and the trainer run: cuda (the kernels) or cpu")


def cmd_server(args):
    from .fl.config import load_experiment
    from .fl.server import serve

    exp = load_experiment(args.config, lazy_eval=args.dleval, std_init=args.initstd,
                          device=args.device)
    exp.server.verification_threads = args.vthreads
    exp.server.terminate_on_done = True
    asyncio.run(serve(exp.server, f"{args.address}:{args.port}"))


def cmd_basic_server(args):
    """Hardcoded smoke server: a 19 166-parameter Plain model (basic_server.rs)."""
    from .fl import params as P
    from .fl.server import ServerConfig, serve

    cfg = ServerConfig(model_id=1, num_clients=args.num_clients, num_params=BASIC_NUM_PARAMS,
                       num_rounds=args.rounds, enc_type=P.PLAIN_TYPE, device=args.device)
    asyncio.run(serve(cfg, f"{args.address}:{args.port}"))


def cmd_clients(args):
    from .fl.client import FlServiceClient
    from .fl.trainclient import DummyTrainer, GrpcTrainer

    async def main():
        # The clients run as tasks of this one event loop and encrypt on its
        # default executor. On the card four encrypts at once in one
        # interpreter took 54.8-57.3 s each, against about 2 s one at a time
        # (PERF.md §6): every kernel launch hands the GIL over. So the
        # executor has one thread, and the encrypts take turns.
        asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(1))
        tasks = []
        for i in range(args.num_clients):
            if args.trainer_port:
                port = args.trainer_port + (i % args.numtrainers)
                trainer = GrpcTrainer(f"127.0.0.1:{port}")
            else:
                trainer = DummyTrainer()
            c = FlServiceClient(f"{args.address}:{args.port}", args.model_id, i, trainer,
                                bench_dir=args.benchlog, device=args.device)
            tasks.append(asyncio.create_task(c.train_model()))
        await asyncio.gather(*tasks)

    asyncio.run(main())


def make_train_service(args):
    """The service `trainservice` serves, from its arguments."""
    from .fl.trainservice import DummyTrainService, MockCIFARTrainService, TorchTrainService

    if args.dummy:
        return DummyTrainService()
    if args.mock_cifar:
        return MockCIFARTrainService()
    from .models.trainer import Trainer

    trainer = Trainer(args.model, args.dataset, client_id=args.client_id,
                      num_clients=args.num_clients, batch_size=args.batch_size,
                      local_epochs=args.epochs, lr=args.lr, intrinsic_dim=args.intrinsic_dim,
                      device=args.device)
    return TorchTrainService(trainer)


def cmd_trainservice(args):
    from .fl.trainservice import serve

    asyncio.run(serve(make_train_service(args), f"0.0.0.0:{args.port}"))


def make_evaluator(args):
    """The observer's evaluator: a ``Trainer`` of `--model`, or None."""
    if not args.model:
        return None
    from .models.trainer import Trainer

    return Trainer(args.model, args.dataset, intrinsic_dim=args.intrinsic_dim,
                   device=args.device)


def cmd_observer(args):
    from .fl.observer import FLObserver

    obs = FLObserver(f"{args.address}:{args.port}", args.model_id, make_evaluator(args))
    asyncio.run(obs.observe())


def cmd_test_train(args):
    """Smoke test against the trainer service (test_train_client.rs:12-35)."""
    from .fl.trainclient import GrpcTrainer

    async def main():
        t = GrpcTrainer(f"127.0.0.1:{args.port}")
        update = await t.train_for_round(None, np.zeros(BASIC_NUM_PARAMS, np.float32), 0)
        print(f"update: len={len(update)} first={update[:4]}")

    asyncio.run(main())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rofl_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("server")
    _add_common(s)
    s.add_argument("-c", "--config", required=True)
    s.add_argument("--dleval", action="store_true", help="lazy (pipelined) verification")
    s.add_argument("--vthreads", type=int, default=4)
    s.add_argument("--initstd", type=float, default=0.0)
    _add_device(s)
    s.set_defaults(fn=cmd_server)

    s = sub.add_parser("basic-server")
    _add_common(s)
    s.add_argument("-n", "--num-clients", type=int, default=1)
    s.add_argument("--rounds", type=int, default=10)
    _add_device(s)
    s.set_defaults(fn=cmd_basic_server)

    s = sub.add_parser("clients")
    _add_common(s)
    s.add_argument("-n", "--num-clients", type=int, default=1)
    s.add_argument("-r", "--trainer-port", type=int, default=0,
                   help="0 = dummy trainer (basic_client.rs:18-19)")
    s.add_argument("--numtrainers", type=int, default=1)
    s.add_argument("--model-id", type=int, default=1)
    s.add_argument("--benchlog", default=None)
    _add_device(s)
    s.set_defaults(fn=cmd_clients)

    s = sub.add_parser("trainservice")
    s.add_argument("-p", "--port", type=int, default=50016)
    s.add_argument("--dummy", action="store_true")
    s.add_argument("--mock-cifar", action="store_true")
    s.add_argument("--model", default="mnist_dev")
    s.add_argument("--dataset", default="mnist")
    s.add_argument("--client-id", type=int, default=0)
    s.add_argument("--num-clients", type=int, default=1)
    s.add_argument("--batch-size", type=int, default=32)
    s.add_argument("--epochs", type=int, default=1)
    s.add_argument("--lr", type=float, default=0.1)
    s.add_argument("--intrinsic-dim", type=int, default=None)
    _add_device(s)
    s.set_defaults(fn=cmd_trainservice)

    s = sub.add_parser("observer")
    _add_common(s)
    s.add_argument("--model-id", type=int, default=1)
    s.add_argument("--model", default=None)
    s.add_argument("--dataset", default="mnist")
    s.add_argument("--intrinsic-dim", type=int, default=None)
    _add_device(s)
    s.set_defaults(fn=cmd_observer)

    s = sub.add_parser("test-train")
    s.add_argument("-p", "--port", type=int, default=50016)
    s.set_defaults(fn=cmd_test_train)
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    args = parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
