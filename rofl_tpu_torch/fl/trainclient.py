"""Trainer bridge — counterpart of ``rofl_tpu.fl.trainclient`` (rebuild of
trainclient.rs FlTraining::Dummy).

The FL client delegates local training to a trainer: ``DummyTrainer`` (a
constant 0.001 update, trainclient.rs:28-30, for cluster-free runs) or
``InProcessTrainer``, which wraps a local trainer object with
``set_weights`` / ``train`` semantics. The JAX package's ``GrpcTrainer``
(a trainer process over FLClientTrainService) is not ported yet.
"""

from __future__ import annotations

import asyncio

import numpy as np


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
