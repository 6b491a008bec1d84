"""Secure-aggregation FL server — counterpart of ``rofl_tpu.fl.server``
(rebuild of rofl_service server.rs), over the port's own transport
(``fl/transport.py``) in place of ``grpc.aio``.

The JAX server's state machine, step by step (SURVEY.md §3.1):

  register all clients → broadcast Config + global model (1 MiB DataBlocks)
  → per-client upload reassembly (a stale round's upload dropped) →
  deserialize (one-thread crypto pool) → verify (``verification_threads``
  pool, eagerly or lazily overlapped with the next round) → homomorphic
  accumulate → when all clients are in: extract via BSGS, update the global
  model in numpy float32 (÷ num_clients, × lr, server.rs:231-237), wait for
  this round's (eager) or the previous round's (lazy, server.rs:161-175,
  739-743) verification → next round, or DONE and the model file.

The crypto runs on ``ServerConfig.device`` (default ``"cuda"``). Every
kernel launches on the current stream, which is the same default stream in
the crypto thread and the verify threads, so a verify never reads a tensor
that a deserialize has not finished writing. With more than one card (and
the device a card) the server builds ``param_mesh()`` over every card, as the
JAX server does over its devices, and each verification's range-proof MSM
shards its terms over it; on one card there is no mesh.
"""

from __future__ import annotations

import asyncio
import logging
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..parallel.mesh import param_mesh
from . import params as P
from . import transport, wire
from .logs import BenchLogger, TimeState
from .util import CHUNK_SIZE, DataBlockStorage, chunk_bytes, write_model_to_file

logger = logging.getLogger("rofl_tpu_torch.server")

BSGS_TABLE_SIZE = 1 << 16  # server.rs:36


@dataclass
class ServerConfig:
    model_id: int = 1
    num_clients: int = 1
    num_params: int = 0
    num_rounds: int = 10
    learning_rate: float = 1.0
    enc_type: int = P.PLAIN_TYPE
    crypto: P.CryptoConfig = field(default_factory=P.CryptoConfig)
    model_config: dict = field(default_factory=dict)
    in_memory_rounds: int = 2
    lazy_verification: bool = False
    verification_threads: int = 1
    terminate_on_done: bool = False
    initial_model: np.ndarray | None = None
    write_model_file: bool = True
    bench_dir: str | None = "benchlog"
    device: str = "cuda"


class TrainingRoundState:
    """Per-round accumulator + verification bookkeeping (server.rs:393-509).
    ``extracted`` holds the round's decoded sum once it is extracted."""

    def __init__(self, round_id: int, expected_clients: int, cfg: ServerConfig):
        self.round_id = round_id
        self.expected_clients = expected_clients
        self.accumulator = P.Accumulator(cfg.enc_type, cfg.num_params, cfg.crypto.fp,
                                         bsgs_m=BSGS_TABLE_SIZE, device=cfg.device)
        self.done_count = 0
        self.verify_tasks: list[asyncio.Future] = []
        self.verification_failed = False
        self.time_state = TimeState()
        self.finished = asyncio.Event()
        self.extracted: np.ndarray | None = None

    async def wait_for_verif_completion(self) -> bool:
        if self.verify_tasks:
            results = await asyncio.gather(*self.verify_tasks)
            if not all(results):
                self.verification_failed = True
        return not self.verification_failed

    def is_done(self) -> bool:
        return self.finished.is_set()


class TrainingState:
    def __init__(self, cfg: ServerConfig):
        self.cfg = cfg
        self.global_model = (
            cfg.initial_model.astype(np.float32).copy()
            if cfg.initial_model is not None
            else np.zeros(cfg.num_params, np.float32)
        )
        if cfg.num_params == 0:
            cfg.num_params = len(self.global_model)
        self.client_queues: dict[int, asyncio.Queue] = {}
        self.observer_queues: list[asyncio.Queue] = []
        self.rounds: list[TrainingRoundState] = []
        self.status = "register"
        self.lock = asyncio.Lock()
        self.verify_pool = ThreadPoolExecutor(cfg.verification_threads)
        self.crypto_pool = ThreadPoolExecutor(1)  # serialize device work
        # several cards: shard the verification's combined MSM over a 'param'
        # mesh of all of them (the reference's rayon verify pool becomes
        # device parallelism)
        self.mesh = (param_mesh() if torch.device(cfg.device).type == "cuda"
                     and torch.cuda.device_count() > 1 else None)
        self.bench = BenchLogger(cfg.bench_dir or "", f"server_model{cfg.model_id}") \
            if cfg.bench_dir else BenchLogger("", "server")
        self.rng = np.random.default_rng()
        self.done_event = asyncio.Event()
        self.update_tasks: set[asyncio.Task] = set()

    def close(self) -> None:
        """Shut the two pools down (waiting for work they hold)."""
        self.verify_pool.shutdown()
        self.crypto_pool.shutdown()

    # -- round management --------------------------------------------------

    def current_round(self) -> TrainingRoundState:
        return self.rounds[-1]

    def previous_round(self) -> TrainingRoundState | None:
        return self.rounds[-2] if len(self.rounds) > 1 else None

    def start_new_round(self, round_id: int):
        self.rounds.append(TrainingRoundState(round_id, self.cfg.num_clients, self.cfg))
        keep = self.cfg.in_memory_rounds
        while len(self.rounds) > keep and self.rounds[0].is_done():
            self.rounds.pop(0)

    # -- broadcast ---------------------------------------------------------

    def _config_response(self) -> wire.TrainResponse:
        mc = wire.ModelConfig(model_id=self.cfg.model_id, num_of_clients=self.cfg.num_clients,
                              learning_rate=self.cfg.learning_rate)
        for k, v in self.cfg.model_config.items():
            if k not in mc.__dataclass_fields__:
                raise AttributeError(f"ModelConfig has no field {k!r}")
            setattr(mc, k, v)
        cc = wire.CryptoConfig(value_range=self.cfg.crypto.value_range,
                               n_partition=self.cfg.crypto.n_partition,
                               l2_value_range=self.cfg.crypto.l2_value_range,
                               check_percentage=self.cfg.crypto.check_percentage,
                               enc_type=self.cfg.enc_type)
        return wire.TrainResponse(params=wire.ServerModelData(
            config=wire.Config(model_config=mc, crypto_config=cc)))

    def _model_responses(self, round_id: int) -> list[wire.TrainResponse]:
        chunks = chunk_bytes(P.PlainParams(self.global_model).serialize(), CHUNK_SIZE)
        meta = wire.ModelParametersMeta(model_id=self.cfg.model_id, round_id=round_id,
                                        num_blocks=len(chunks))
        blocks = [wire.ModelParameters(param_block=wire.DataBlock(block_number=i, data=c))
                  for i, c in enumerate(chunks)]
        return [wire.TrainResponse(params=wire.ServerModelData(model_block=m))
                for m in [wire.ModelParameters(param_meta=meta)] + blocks]

    async def broadcast_global_model(self):
        msgs = self._model_responses(self.current_round().round_id)
        for q in list(self.client_queues.values()) + self.observer_queues:
            for m in msgs:
                await q.put(m)

    async def broadcast_config(self):
        msg = self._config_response()
        for q in self.client_queues.values():
            await q.put(msg)

    async def broadcast_done(self):
        msg = wire.TrainResponse(done_message=wire.StatusMessage(status=wire.STATUS_DONE))
        for q in list(self.client_queues.values()) + self.observer_queues:
            await q.put(msg)

    # -- update processing -------------------------------------------------

    def start_update(self, client_id: int, data: bytes) -> None:
        """Process one reassembled upload in a task the state holds."""
        task = asyncio.create_task(self.handle_client_update(client_id, data))
        self.update_tasks.add(task)
        task.add_done_callback(self._update_done)

    def _update_done(self, task: asyncio.Task) -> None:
        self.update_tasks.discard(task)
        if not task.cancelled():
            task.exception()  # logged in handle_client_update

    async def handle_client_update(self, client_id: int, data: bytes):
        try:
            await self._handle_client_update(client_id, data)
        except Exception:
            logger.exception("round processing failed (client %d)", client_id)
            self.status = "failed"
            self.done_event.set()
            raise

    async def _handle_client_update(self, client_id: int, data: bytes):
        loop = asyncio.get_running_loop()
        state = self.current_round()
        state.time_state.record()
        enc_params = await loop.run_in_executor(
            self.crypto_pool, P.deserialize, self.cfg.enc_type, data, self.cfg.crypto.fp,
            self.cfg.device)
        # verification on the dedicated pool (eager or lazily awaited)
        fut = loop.run_in_executor(self.verify_pool, P.verify, enc_params, self.rng, self.mesh)
        state.verify_tasks.append(fut)
        async with self.lock:
            ok = await loop.run_in_executor(self.crypto_pool, state.accumulator.accumulate,
                                            enc_params)
            if not ok:
                logger.error("accumulate failed for client %d", client_id)
                return
            state.done_count += 1
            logger.info("aggregated client %d round %d (%d/%d)", client_id, state.round_id,
                        state.done_count, state.expected_clients)
            if state.done_count == state.expected_clients:
                await self._finalize_round(state)

    async def _finalize_round(self, state: TrainingRoundState):
        loop = asyncio.get_running_loop()
        state.time_state.record()
        extracted = await loop.run_in_executor(self.crypto_pool, state.accumulator.extract)
        state.time_state.record()
        if extracted is None:
            logger.error("extraction failed (blindings not cancelled?)")
            state.verification_failed = True
            self.done_event.set()
            return
        state.extracted = extracted
        # lazy: wait only for the PREVIOUS round's proofs; eager: this one's
        wait_state = self.previous_round() if self.cfg.lazy_verification else state
        if wait_state is not None:
            ok = await wait_state.wait_for_verif_completion()
            if not ok:
                logger.error("verification FAILED for round %d", wait_state.round_id)
                raise RuntimeError("proof verification failed")
        update = extracted * (1.0 / self.cfg.num_clients)
        self.global_model = self.global_model + update * self.cfg.learning_rate
        state.time_state.record()
        state.time_state.log_bench_times(self.bench, state.round_id)
        state.finished.set()

        if state.round_id + 1 >= self.cfg.num_rounds or self.status == "terminate":
            if self.cfg.lazy_verification:
                ok = await state.wait_for_verif_completion()
                if not ok:
                    raise RuntimeError("proof verification failed (final round)")
            await self.broadcast_done()
            self.status = "done"
            if self.cfg.write_model_file:
                write_model_to_file(f"model_{self.cfg.model_id}_round_{state.round_id}.txt",
                                    self.global_model)
            self.done_event.set()
            return
        self.start_new_round(state.round_id + 1)
        await self.broadcast_global_model()


class FlServiceServicer:
    """The three calls of flservice.Flservice (``transport.Server`` serves them)."""

    def __init__(self, states: dict[int, TrainingState]):
        self.states = states

    async def TrainModel(self, requests):
        state: TrainingState | None = None
        client_id = None
        queue: asyncio.Queue = asyncio.Queue()
        storage = DataBlockStorage()

        async def reader():
            nonlocal state, client_id
            async for req in requests:
                which = req.which_oneof()
                if which == "start_message":
                    model_id = req.start_message.model_id
                    client_id = req.start_message.client_id
                    state = self.states[model_id]
                    if state.status not in ("register",):
                        # training already started: answer STATUS_LATE and
                        # end the stream instead of leaving the client
                        # hanging (ref server.rs:583-591)
                        logger.warning("late registration from %d", client_id)
                        await queue.put(wire.TrainResponse(
                            done_message=wire.StatusMessage(status=wire.STATUS_LATE)))
                        await queue.put(wire.TrainResponse(
                            done_message=wire.StatusMessage(status=wire.STATUS_DONE)))
                        state = None
                        continue
                    state.client_queues[client_id] = queue
                    logger.info("registered client %d (%d/%d)", client_id,
                                len(state.client_queues), state.cfg.num_clients)
                    if len(state.client_queues) == state.cfg.num_clients:
                        state.status = "in_progress"
                        state.start_new_round(0)
                        await state.broadcast_config()
                        await state.broadcast_global_model()
                elif which == "params":
                    p = req.params
                    if p.which_oneof() == "param_meta":
                        storage.init(p.param_meta.round_id, p.param_meta.num_blocks)
                    else:
                        block = p.param_block or wire.DataBlock()
                        storage.apply(block.block_number, block.data)
                        if storage.is_done():
                            data = storage.data()
                            upload_round = storage.round_id
                            storage.init(-1, 0)
                            # a straggler's stale-round upload must NOT be
                            # accumulated into the current round (the
                            # reference's DataBlockStorage round-id check,
                            # util.rs:30-44)
                            current = state.current_round() if state.rounds else None
                            if current is None or upload_round != current.round_id:
                                logger.warning(
                                    "dropping stale upload from client %d: round %d != "
                                    "current %d", client_id, upload_round,
                                    -1 if current is None else current.round_id)
                                continue
                            state.start_update(client_id, data)

        reader_task = asyncio.create_task(reader())
        try:
            while True:
                msg = await queue.get()
                yield msg
                if msg.which_oneof() == "done_message":
                    break
        finally:
            reader_task.cancel()

    async def TerminateModelTraining(self, request: wire.ModelSelection) -> wire.StatusMessage:
        state = self.states.get(request.model_id)
        if state is None:
            return wire.StatusMessage(status=wire.STATUS_NOK)
        state.status = "terminate"
        return wire.StatusMessage(status=wire.STATUS_OK)

    async def ObserverModelTraining(self, request: wire.ModelSelection):
        state = self.states.get(request.model_id)
        if state is None:
            return
        queue: asyncio.Queue = asyncio.Queue()
        state.observer_queues.append(queue)
        while True:
            msg = await queue.get()
            yield msg
            if msg.which_oneof() == "done_message":
                break


def make_server(states: dict[int, TrainingState], address: str) -> transport.Server:
    """The server of `states` on `address`; ``await server.start()`` binds it
    (port 0: an ephemeral port, then ``server.port``)."""
    return transport.Server(FlServiceServicer(states), address)


async def serve(cfg: ServerConfig, address: str = "[::]:50051") -> TrainingState:
    state = TrainingState(cfg)
    server = make_server({cfg.model_id: state}, address)
    await server.start()
    logger.info("server listening on %s", address)
    try:
        await state.done_event.wait()
        await asyncio.sleep(0.5)
        await server.stop(1.0)
    finally:
        state.close()
    return state
