"""Trainer bridge — counterpart of ``rofl_tpu.fl.trainclient`` (rebuild of
trainclient.rs FlTraining::{Dummy, Grpc}).

The FL client delegates local training to a trainer: ``DummyTrainer`` (a
constant 0.001 update, trainclient.rs:28-30, for cluster-free runs),
``InProcessTrainer``, which wraps a local trainer object with
``set_weights`` / ``train`` semantics, or ``GrpcTrainer``, a trainer service
(``fl/trainservice.py``) reached over the port's transport.
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np

from . import transport, wire
from .util import NUM_FLOATS_PACKET

logger = logging.getLogger("rofl_tpu_torch.trainclient")


class DummyTrainer:
    async def train_for_round(self, config, model: np.ndarray, round_id: int) -> np.ndarray:
        return np.full(len(model), 0.001, np.float32)


class InProcessTrainer:
    """A local trainer in this process (analysis_client.py:14-55 equivalent):
    the update is its new weights less the global model, in float32."""

    def __init__(self, trainer):
        self.trainer = trainer

    async def train_for_round(self, config, model: np.ndarray, round_id: int) -> np.ndarray:
        def run():
            self.trainer.set_weights(model)
            new_weights = self.trainer.train(round_id)
            return np.asarray(new_weights, np.float32) - model

        return await asyncio.get_running_loop().run_in_executor(None, run)


class GrpcTrainer:
    """A trainer service's ``TrainForRound`` (trainclient.rs:31-58, 77-176),
    by its JAX name, over the port's transport rather than gRPC: it sends a
    config message, a meta message (model_id, round_id, num_blocks,
    num_floats) and the model in blocks of ``NUM_FLOATS_PACKET`` floats, and
    reassembles the update from the answer's meta message and blocks. A call
    that fails to connect, breaks off, or ends before ``num_floats`` floats is
    tried again after ``retry_s`` seconds (5, as in the reference), forever."""

    retry_s = 5.0

    def __init__(self, address: str):
        self.address = address

    async def train_for_round(self, config, model: np.ndarray, round_id: int) -> np.ndarray:
        while True:
            try:
                return await self._attempt(config, model, round_id)
            except (ConnectionError, OSError, transport.FrameError) as e:
                logger.warning("trainer unavailable (%s); retrying in %gs", e, self.retry_s)
                await asyncio.sleep(self.retry_s)

    async def _attempt(self, config, model: np.ndarray, round_id: int) -> np.ndarray:
        model_id = (config.model_id if config is not None else 0) or 0
        n = len(model)
        num_blocks = (n + NUM_FLOATS_PACKET - 1) // NUM_FLOATS_PACKET
        async with transport.open_call(self.address, transport.TRAIN_FOR_ROUND) as call:
            await call.send(wire.ClientModelMessage(config=config or wire.ModelConfig()))
            await call.send(wire.ClientModelMessage(meta_block_message=wire.MetaFloatBlockMessage(
                model_id=model_id, round_id=round_id, num_blocks=num_blocks, num_floats=n)))
            for b in range(num_blocks):
                await call.send(wire.ClientModelMessage(model_block=wire.FloatBlock(
                    block_number=b,
                    floats=model[b * NUM_FLOATS_PACKET:(b + 1) * NUM_FLOATS_PACKET].tolist())))
            call.done_writing()
            floats: list[float] = []
            expected = None
            async for resp in call.responses(wire.ClientModelMessage):
                which = resp.which_oneof()
                if which == "meta_block_message":
                    expected = resp.meta_block_message.num_floats
                elif which == "model_block":
                    floats.extend(resp.model_block.floats)
                    if expected is not None and len(floats) >= expected:
                        return np.array(floats[:expected], np.float32)
            if expected == 0:
                return np.zeros(0, np.float32)
            raise ConnectionError(
                f"the trainer's answer ended after {len(floats)} of {expected} floats")
