"""Training observer — counterpart of ``rofl_tpu.fl.observer`` (rebuild of
observer.py FLClientTrainObserver), over the port's transport.

Calls ObserverModelTraining, reassembles each broadcast global model and
evaluates it, logging "[EVAL] (round, loss, acc)" (observer.py:45-84); with
no evaluator it logs the model's norm.
"""

from __future__ import annotations

import logging

import numpy as np

from . import params as P
from . import transport, wire
from .util import DataBlockStorage

logger = logging.getLogger("rofl_tpu_torch.observer")


class FLObserver:
    def __init__(self, address: str, model_id: int, evaluator=None):
        """evaluator: object with set_weights(w) + evaluate() -> (loss, acc)."""
        self.address = address
        self.model_id = model_id
        self.evaluator = evaluator
        self.evals: list[tuple[int, float, float]] = []

    async def observe(self):
        """Follow the broadcasts until the server's done_message."""
        async with transport.open_call(self.address, transport.OBSERVER_MODEL_TRAINING) as call:
            await call.send(wire.ModelSelection(model_id=self.model_id))
            call.done_writing()
            logger.info("observing model %d at %s", self.model_id, self.address)
            storage = DataBlockStorage()
            async for resp in call.responses(wire.TrainResponse):
                which = resp.which_oneof()
                if which == "done_message":
                    logger.info("[EVAL] observer done")
                    return
                if which != "params":
                    continue
                mp = resp.params.model_block or wire.ModelParameters()
                if mp.which_oneof() == "param_meta":
                    storage.init(mp.param_meta.round_id, mp.param_meta.num_blocks)
                    continue
                block = mp.param_block or wire.DataBlock()
                storage.apply(block.block_number, block.data)
                if storage.is_done():
                    model = P.PlainParams.deserialize(storage.data()).content
                    self._evaluate(storage.round_id, model)
        raise ConnectionError("the server ended the observer's call before DONE")

    def _evaluate(self, round_id: int, weights: np.ndarray):
        if self.evaluator is None:
            logger.info("[EVAL] (%d, -, -) |w|=%f", round_id, float(np.linalg.norm(weights)))
            return
        self.evaluator.set_weights(weights)
        loss, acc = self.evaluator.evaluate()
        self.evals.append((round_id, loss, acc))
        logger.info("[EVAL] (%d, %f, %f)", round_id, loss, acc)
