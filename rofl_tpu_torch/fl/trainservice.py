"""The trainer service — counterpart of ``rofl_tpu.fl.trainservice``
(rebuild of rofl_train_client service.py), over ``grpc.aio``
(``fl/transport.py``), with gRPC's default message limits as the JAX
service has.

Serves ``FLClientTrainService.TrainForRound`` (``transport.TRAIN_FOR_ROUND``)
to a port or JAX ``GrpcTrainer``, and answers any other call ``UNIMPLEMENTED``:
collect the model's float blocks, train for the round, stream back the
update (service.py:46-80). ``TorchTrainService`` trains with the port's
``models.trainer.Trainer``; ``DummyTrainService`` (a constant 0.001 update)
and ``MockCIFARTrainService`` (sleeps 43.3 s) are the fakes of the
reference's e2e harness (service.py:83-95).
"""

from __future__ import annotations

import asyncio
import logging
import threading
import time

import numpy as np

from . import transport, wire
from .util import NUM_FLOATS_PACKET

logger = logging.getLogger("rofl_tpu_torch.trainservice")


class TrainServiceBase:
    def train_model(self, weights: np.ndarray, round_id: int) -> np.ndarray:
        raise NotImplementedError

    async def TrainForRound(self, requests):
        """Skip the config message, read the meta message, read float blocks
        until ``num_floats`` have come; train on the loop's executor; answer
        with a meta message and blocks of ``NUM_FLOATS_PACKET`` floats."""
        floats: list[float] = []
        expected = None
        round_id = 0
        async for msg in requests:
            which = msg.which_oneof()
            if which == "config":
                continue
            if which == "meta_block_message":
                expected = msg.meta_block_message.num_floats
                round_id = msg.meta_block_message.round_id
                continue
            floats.extend((msg.model_block or wire.FloatBlock()).floats)
            if expected is not None and len(floats) >= expected:
                break
        weights = np.array(floats[:expected], np.float32)
        update = await asyncio.get_running_loop().run_in_executor(
            None, self.train_model, weights, round_id)
        n = len(update)
        num_blocks = (n + NUM_FLOATS_PACKET - 1) // NUM_FLOATS_PACKET
        yield wire.ClientModelMessage(meta_block_message=wire.MetaFloatBlockMessage(
            round_id=round_id, num_floats=n, num_blocks=num_blocks))
        for b in range(num_blocks):
            yield wire.ClientModelMessage(model_block=wire.FloatBlock(
                block_number=b,
                floats=update[b * NUM_FLOATS_PACKET:(b + 1) * NUM_FLOATS_PACKET].tolist()))


class TorchTrainService(TrainServiceBase):
    """Real local training (``JaxTrainService``'s counterpart): the update is
    train(weights) - weights, in float32. Calls run one at a time: several
    clients may share one service, and its trainer's weights and module are
    shared (``functional_call`` swaps the module's parameters in place), so
    two calls at once would train on each other's tensors."""

    def __init__(self, trainer):
        self.trainer = trainer
        self._lock = threading.Lock()

    def train_model(self, weights: np.ndarray, round_id: int) -> np.ndarray:
        with self._lock:
            self.trainer.set_weights(weights)
            new_w = self.trainer.train(round_id)
        return np.asarray(new_w, np.float32) - weights


class DummyTrainService(TrainServiceBase):
    """service.py:83-86: a constant 0.001 update."""

    def train_model(self, weights, round_id):
        return np.full(len(weights), 0.001, np.float32)


class MockCIFARTrainService(TrainServiceBase):
    """service.py:90-95: CIFAR training's latency (43.3 s), then 0.001."""

    def __init__(self, sleep_s: float = 43.3):
        self.sleep_s = sleep_s

    def train_model(self, weights, round_id):
        time.sleep(self.sleep_s)
        return np.full(len(weights), 0.001, np.float32)


def make_train_server(service: TrainServiceBase, address: str) -> transport.Server:
    """The trainer service on `address`; ``await server.start()`` binds it
    (port 0: an ephemeral port, then ``server.port``)."""
    return transport.Server(service, address)


async def serve(service: TrainServiceBase, address: str) -> None:
    """Serve `service` on `address` until cancelled."""
    server = make_train_server(service, address)
    await server.start()
    logger.info("trainservice on %s", address)
    try:
        await asyncio.Event().wait()
    finally:
        await server.stop(1.0)
