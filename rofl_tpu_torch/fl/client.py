"""FL client runtime — counterpart of ``rofl_tpu.fl.client`` (rebuild of
client.rs FlServiceClient), over ``grpc.aio`` (``fl/transport.py``): it reaches
a port server or the JAX package's.

Protocol loop (client.rs:194-305): register → receive Config → receive the
chunked global model → train locally (trainer bridge) → encrypt + prove on
``device`` (``params.encrypt``, on the loop's default executor) → chunked
upload; per-phase TimeState (received, trained, encrypted, sent) with
bandwidth (client.rs:276-287), written to a bench log when ``bench_dir`` is
given and kept in ``round_log`` either way.

Blindings: the reference prototype client uses all-zero blindings
(derive_dummy_blindings, client.rs:70-72); real cancelling blindings
(``pedersen.cancelling_scalar_limbs``) are injected via ``blinding_fn``
for true multi-client secure aggregation.
"""

from __future__ import annotations

import asyncio
import logging

import numpy as np

from . import params as P
from . import transport, wire
from .logs import BenchLogger, TimeState
from .util import CHUNK_SIZE, DataBlockStorage, chunk_bytes

logger = logging.getLogger("rofl_tpu_torch.client")


class FlServiceClient:
    def __init__(self, address: str, model_id: int, client_id: int, trainer,
                 blinding_fn=None, bench_dir: str | None = None, device="cuda"):
        self.address = address
        self.model_id = model_id
        self.client_id = client_id
        self.trainer = trainer
        self.blinding_fn = blinding_fn  # (round_id, n) -> (16, n) limbs
        self.device = device
        self.bench = BenchLogger(bench_dir or "", f"client{client_id}") if bench_dir else None
        self.rng = np.random.default_rng()
        self.config: wire.ModelConfig | None = None
        self.crypto_cfg: P.CryptoConfig | None = None
        self.enc_type = P.PLAIN_TYPE
        self.final_model: np.ndarray | None = None
        self.done_status: int | None = None  # the status of the done_message that ended the call
        # round_id -> what the bench line says: stage deltas (ms), bytes
        # received and sent, and the upload's DataBlocks
        self.round_log: dict[int, dict] = {}

    def _blindings(self, round_id: int, n: int):
        if self.blinding_fn is not None:
            return self.blinding_fn(round_id, n)
        return np.zeros((16, n), np.uint32)  # dummy (client.rs:70-72)

    async def train_model(self):
        """Run rounds until the server's done_message; raises if the call
        ends before it."""
        async with transport.open_call(self.address, transport.TRAIN_MODEL) as call:
            await call.send(wire.TrainRequest(start_message=wire.WorkerRegisterMessage(
                model_id=self.model_id, client_id=self.client_id)))
            outgoing: asyncio.Queue = asyncio.Queue()
            sender = asyncio.create_task(self._send_all(call, outgoing))
            try:
                await self._receive_all(call, outgoing)
                await sender
            finally:
                sender.cancel()

    @staticmethod
    async def _send_all(call: transport.Call, outgoing: asyncio.Queue):
        while (msg := await outgoing.get()) is not None:
            await call.send(msg)
        await call.done_writing()

    async def _receive_all(self, call: transport.Call, outgoing: asyncio.Queue):
        storage = DataBlockStorage()
        time_state = TimeState()
        async for resp in call.responses(wire.TrainResponse):
            which = resp.which_oneof()
            if which == "done_message":
                self.done_status = resp.done_message.status
                logger.info("client %d: done (status %d)", self.client_id, self.done_status)
                await outgoing.put(None)
                return
            if which == "error_message":
                logger.error("server error: %s", resp.error_message.msg)
                continue
            params = resp.params or wire.ServerModelData()
            if params.which_oneof() == "config":
                config = params.config
                self.config = config.model_config or wire.ModelConfig()
                cc = config.crypto_config or wire.CryptoConfig()
                self.enc_type = cc.enc_type or P.PLAIN_TYPE
                self.crypto_cfg = P.CryptoConfig(
                    value_range=cc.value_range or 8,
                    n_partition=cc.n_partition or 1,
                    l2_value_range=cc.l2_value_range or 16,
                    check_percentage=cc.check_percentage or 1.0,
                    enc_type=self.enc_type,
                )
                continue
            mp = params.model_block or wire.ModelParameters()
            if mp.which_oneof() == "param_meta":
                time_state.reset()
                time_state.record()
                storage.init(mp.param_meta.round_id, mp.param_meta.num_blocks)
                continue
            block = mp.param_block or wire.DataBlock()
            storage.apply(block.block_number, block.data)
            if not storage.is_done():
                continue
            round_id = storage.round_id
            model = P.PlainParams.deserialize(storage.data()).content
            self.final_model = model
            time_state.record()  # received
            update = await self.trainer.train_for_round(self.config, model, round_id)
            time_state.record()  # trained
            enc = await asyncio.get_running_loop().run_in_executor(
                None, self._encrypt, update, round_id)
            time_state.record()  # encrypted
            sent = await self._upload(outgoing, round_id, enc)
            time_state.record()  # sent
            received = len(storage.data())
            self.round_log[round_id] = {"deltas_ms": time_state.deltas_ms(),
                                        "recv_bytes": received, "sent_bytes": sent,
                                        "blocks": max(1, -(-sent // CHUNK_SIZE))}
            if self.bench:
                time_state.log_bench_times_with_bandwidth(self.bench, round_id, received, sent)
            logger.info("client %d: round %d uploaded (%d bytes)", self.client_id, round_id,
                        sent)
        raise ConnectionError(f"client {self.client_id}: the server ended the call before DONE")

    def _encrypt(self, update: np.ndarray, round_id: int) -> bytes:
        blind = self._blindings(round_id, len(update))
        enc = P.encrypt(self.enc_type, update, blind, self.crypto_cfg, self.rng, self.device)
        return enc.serialize()

    async def _upload(self, outgoing: asyncio.Queue, round_id: int, data: bytes) -> int:
        chunks = chunk_bytes(data, CHUNK_SIZE)
        await outgoing.put(wire.TrainRequest(params=wire.ModelParameters(
            param_meta=wire.ModelParametersMeta(model_id=self.model_id, round_id=round_id,
                                                num_blocks=len(chunks)))))
        for i, c in enumerate(chunks):
            await outgoing.put(wire.TrainRequest(params=wire.ModelParameters(
                param_block=wire.DataBlock(block_number=i, data=c))))
        return len(data)
