"""The port's FL runtime (``rofl_tpu_torch.fl.{server,client,observer,
transport}``) against the JAX package's (``rofl_tpu.fl.{server,client}``),
cheap: Plain mode on the CPU, over gRPC on 127.0.0.1.

- The server's ``Config`` response and its model frames for a seeded global
  model of 300 000 floats (two 1 MiB blocks) are byte-equal to the JAX
  ``TrainingState``'s, the port's server started from the JAX server's
  configuration (``convert.server_config_from_dict``).
- The client's upload frames are byte-equal to the JAX client's ``_upload``.
- Plain, 3 clients, 2 rounds, d = 11 gives 0.002 everywhere, and the model
  file ``model_1_round_1.txt`` is the JAX writer's output byte for byte.
- A late registration gets ``LATE`` and its stream ends; an observer sees
  every broadcast and ``DONE``; ``TerminateModelTraining`` answers ``OK`` /
  ``NOK``; a stale-round upload is dropped.
- The server refuses a message above 64 MiB (``RESOURCE_EXHAUSTED``), and
  the client one it would send; a path the servicer lacks is
  ``UNIMPLEMENTED``; a client whose call ends before ``DONE`` raises.
Tolerance: none (the model in float32, bit for bit)."""

import asyncio
import dataclasses

import grpc
import numpy as np
import pytest

from rofl_tpu.fl import client as jclient
from rofl_tpu.fl import params as JP
from rofl_tpu.fl import server as jserver
from rofl_tpu.fl import util as jutil
from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig
from rofl_tpu_torch import convert
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl import transport, wire
from rofl_tpu_torch.fl.client import FlServiceClient
from rofl_tpu_torch.fl.observer import FLObserver
from rofl_tpu_torch.fl.server import ServerConfig, TrainingState, make_server
from rofl_tpu_torch.fl.trainclient import DummyTrainer
from torch_port_fl import run_fl


def plain_cfg(**kw):
    base = dict(model_id=1, num_clients=3, num_params=11, num_rounds=2, learning_rate=1.0,
                enc_type=P.PLAIN_TYPE, write_model_file=False, bench_dir=None, device="cpu")
    return ServerConfig(**{**base, **kw})


def replay(model, n_clients, rounds, lr):
    """The JAX server's float32 update rule over DummyTrainer updates:
    the Plain accumulator's sum from zeros, ÷ n, × lr."""
    for _ in range(rounds):
        extracted = np.zeros(len(model), np.float32)
        for _ in range(n_clients):
            extracted += np.full(len(model), 0.001, np.float32)
        model = model + extracted * (1.0 / n_clients) * lr
    return model


def jax_config(d: int) -> jserver.ServerConfig:
    model = np.random.default_rng(17).standard_normal(d).astype(np.float32)
    return jserver.ServerConfig(
        model_id=7, num_clients=4, num_rounds=3, learning_rate=0.25, enc_type=JP.ENC_L2_TYPE,
        crypto=JP.CryptoConfig(value_range=8, n_partition=16, l2_value_range=16,
                               check_percentage=0.7, enc_type=JP.ENC_L2_TYPE,
                               fp=JFpConfig(16, 7)),
        model_config={"optimizer": "adam", "client_batch_size": 32, "num_local_epochs": 2,
                      "loss": "sparse_categorical_crossentropy", "lr_decay": 0.5,
                      "image_augmentation": True, "fp_bits": 16, "fp_frac": 7},
        initial_model=model, write_model_file=False, bench_dir=None)


def test_broadcast_frames_are_the_jax_servers():
    jcfg = jax_config(300_000)
    jstate = jserver.TrainingState(jcfg)
    state = TrainingState(convert.server_config_from_dict(dataclasses.asdict(jcfg), "cpu"))
    try:
        assert state.cfg.device == "cpu" and state.cfg.num_params == 300_000
        assert state.cfg.crypto == P.CryptoConfig(8, 16, 16, 0.7, P.ENC_L2_TYPE)
        assert state._config_response().to_bytes() == jstate._config_response().SerializeToString()
        for round_id in (0, 2):
            port = [m.to_bytes() for m in state._model_responses(round_id)]
            jax = [m.SerializeToString() for m in jstate._model_responses(round_id)]
            assert port == jax and len(port) == 3  # the meta and two 1 MiB blocks
        done = wire.TrainResponse(done_message=wire.StatusMessage(status=wire.STATUS_DONE))
        assert done.to_bytes() == bytes.fromhex("1a020803")
    finally:
        state.close()


@pytest.mark.parametrize("size", [0, 5, 3 * (1 << 20) // 2])
def test_upload_frames_are_the_jax_clients(size):
    data = np.random.default_rng(size).bytes(size)

    async def frames(client):
        queue = asyncio.Queue()
        sent = await client._upload(queue, 3, data)
        out = []
        while not queue.empty():
            m = queue.get_nowait()
            out.append(m.to_bytes() if hasattr(m, "to_bytes") else m.SerializeToString())
        return sent, out

    port = asyncio.run(frames(FlServiceClient("127.0.0.1:1", 5, 2, DummyTrainer(),
                                              device="cpu")))
    jax = asyncio.run(frames(jclient.FlServiceClient("127.0.0.1:1", 5, 2, None)))
    assert port == jax and port[0] == size and len(port[1]) == 1 + max(1, -(-size // (1 << 20)))


def test_plain_two_rounds_give_0_002(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    state, clients = run_fl(plain_cfg(write_model_file=True), 3, timeout=60)
    assert state.status == "done"
    np.testing.assert_array_equal(state.global_model, replay(np.zeros(11, np.float32), 3, 2, 1.0))
    np.testing.assert_allclose(state.global_model, np.full(11, 0.002, np.float32), atol=1e-6)
    assert [c.done_status for c in clients] == [wire.STATUS_DONE] * 3
    assert all(sorted(c.round_log) == [0, 1] and c.round_log[1]["sent_bytes"] == 8 + 4 * 11
               for c in clients)
    jutil.write_model_to_file(str(tmp_path / "jax.txt"), state.global_model)
    assert (tmp_path / "model_1_round_1.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert not (tmp_path / "model_1_round_0.txt").exists()


def test_plain_rounds_equal_the_jax_servers_numpy_update_rule():
    """lr 0.5, 2 clients, 3 rounds from a seeded model: the port's model is
    the JAX server's float32 update replayed, bit for bit."""
    model = np.random.default_rng(9).standard_normal(11).astype(np.float32)
    state, _ = run_fl(plain_cfg(num_clients=2, num_rounds=3, learning_rate=0.5,
                                initial_model=model), 2, timeout=60)
    assert state.global_model.dtype == np.float32
    np.testing.assert_array_equal(state.global_model, replay(model, 2, 3, 0.5))


async def serve(cfg):
    state = TrainingState(cfg)
    server = make_server({cfg.model_id: state}, "127.0.0.1:0")
    await server.start()
    return state, server, f"127.0.0.1:{server.port}"


async def stop(state, server):
    await server.stop(0.5)
    state.close()


def test_a_late_registration_gets_late_and_its_stream_ends():
    async def main():
        state, server, address = await serve(plain_cfg(num_clients=1, num_rounds=1))
        try:
            await asyncio.wait_for(FlServiceClient(address, 1, 0, DummyTrainer(),
                                                   device="cpu").train_model(), 30)
            async with transport.open_call(address, transport.TRAIN_MODEL) as call:
                await call.send(wire.TrainRequest(start_message=wire.WorkerRegisterMessage(
                    model_id=1, client_id=99)))
                await call.done_writing()
                got = [r async for r in call.responses(wire.TrainResponse)]
            return state.status, got
        finally:
            await stop(state, server)

    status, got = asyncio.run(main())
    assert status == "done"
    # LATE is a done_message: the stream ends there, in the JAX server too
    # (its response loop stops at the first done_message; the DONE queued
    # after it is never sent)
    assert [r.done_message.status for r in got] == [wire.STATUS_LATE]


class GatedTrainer(DummyTrainer):
    """Trains only once `go` is set; `started` tells that a round is in."""

    def __init__(self):
        self.started = asyncio.Event()
        self.go = asyncio.Event()

    async def train_for_round(self, config, model, round_id):
        self.started.set()
        await self.go.wait()
        return await super().train_for_round(config, model, round_id)


def test_terminate_answers_ok_and_nok():
    """OK for a model the server holds, which then ends after its current
    round (of 5); NOK for one it does not hold."""
    async def main():
        state, server, address = await serve(plain_cfg(num_clients=1, num_rounds=5))
        try:
            trainer = GatedTrainer()
            client = FlServiceClient(address, 1, 0, trainer, device="cpu")
            task = asyncio.create_task(client.train_model())
            await asyncio.wait_for(trainer.started.wait(), 30)
            out = []
            for model_id in (1, 2):
                async with transport.open_call(address,
                                               transport.TERMINATE_MODEL_TRAINING) as call:
                    await call.send(wire.ModelSelection(model_id=model_id))
                    await call.done_writing()
                    out.append(await call.response(wire.StatusMessage))
            trainer.go.set()
            await asyncio.wait_for(task, 30)
            return out, state.status, client
        finally:
            await stop(state, server)

    (ok, nok), status, client = asyncio.run(main())
    assert ok.status == wire.STATUS_OK and ok.to_bytes() == b""
    assert nok.status == wire.STATUS_NOK
    assert status == "done" and sorted(client.round_log) == [0]
    assert client.done_status == wire.STATUS_DONE


class Recorder:
    def __init__(self):
        self.weights = []

    def set_weights(self, w):
        self.weights.append(w.copy())

    def evaluate(self):
        return 0.0, 1.0


def test_an_observer_sees_every_broadcast_and_done():
    async def main():
        state, server, address = await serve(plain_cfg(num_clients=2, num_rounds=3))
        try:
            recorder = Recorder()
            observer = FLObserver(address, 1, recorder)
            watch = asyncio.create_task(observer.observe())
            while not state.observer_queues:
                await asyncio.sleep(0.01)
            clients = [FlServiceClient(address, 1, i, DummyTrainer(), device="cpu")
                       for i in range(2)]
            await asyncio.wait_for(asyncio.gather(watch, *[c.train_model() for c in clients]),
                                   30)
            return observer, recorder, clients
        finally:
            await stop(state, server)

    observer, recorder, clients = asyncio.run(main())
    assert [e[0] for e in observer.evals] == [0, 1, 2]  # every broadcast, then DONE
    zeros = np.zeros(11, np.float32)
    for r, seen in enumerate(recorder.weights):
        np.testing.assert_array_equal(seen, replay(zeros, 2, r, 1.0))
    np.testing.assert_array_equal(recorder.weights[-1], clients[0].final_model)


def test_a_stale_round_upload_is_dropped():
    """A client uploads for round 5 during round 0 (100.0 everywhere), then
    its round-0 update: only the round-0 update is accumulated."""
    async def main():
        state, server, address = await serve(plain_cfg(num_clients=2, num_rounds=1))
        try:
            honest = FlServiceClient(address, 1, 1, DummyTrainer(), device="cpu")
            honest_task = asyncio.create_task(honest.train_model())
            async with transport.open_call(address, transport.TRAIN_MODEL) as call:
                await call.send(wire.TrainRequest(start_message=wire.WorkerRegisterMessage(
                    model_id=1, client_id=0)))
                responses = call.responses(wire.TrainResponse)
                seen = [await anext(responses) for _ in range(3)]  # Config, meta, one block
                assert seen[0].params.which_oneof() == "config"
                for round_id, value in ((5, 100.0), (0, 0.001)):
                    blob = P.PlainParams(np.full(11, value, np.float32)).serialize()
                    await call.send(wire.TrainRequest(params=wire.ModelParameters(
                        param_meta=wire.ModelParametersMeta(model_id=1, round_id=round_id,
                                                            num_blocks=1))))
                    await call.send(wire.TrainRequest(params=wire.ModelParameters(
                        param_block=wire.DataBlock(block_number=0, data=blob))))
                rest = [r async for r in responses]
            await asyncio.wait_for(honest_task, 30)
            return state, rest
        finally:
            await stop(state, server)

    state, rest = asyncio.run(main())
    assert [r.which_oneof() for r in rest] == ["done_message"]
    assert state.status == "done" and state.rounds[-1].done_count == 2
    np.testing.assert_allclose(state.global_model, np.full(11, 0.001, np.float32), atol=1e-7)


def selection_of(size: int) -> bytes:
    """A ModelSelection of model_id 1 and `size` bytes in all: an unknown
    length-delimited field (15) pads it, which the port's parser skips, as
    protobuf's does."""
    head = wire.encode_varint(1 << 3) + wire.encode_varint(1)
    pad = size - len(head) - 1
    pad -= len(wire.encode_varint(pad))
    data = head + wire.encode_varint(15 << 3 | 2) + wire.encode_varint(pad) + bytes(pad)
    assert len(data) == size and wire.ModelSelection.from_bytes(data).model_id == 1
    return data


def test_a_message_above_64_mib_is_refused_with_resource_exhausted():
    """The server's receive limit is the JAX server's 64 MiB: a request of
    exactly 64 MiB is answered, one byte more is refused RESOURCE_EXHAUSTED,
    unary or streamed. The port's client has the JAX client's send limit
    too: it refuses to send such a request itself (grpc.aio's write fails in
    the core, INTERNAL, where the server would have said
    RESOURCE_EXHAUSTED)."""
    big = wire.TrainRequest(params=wire.ModelParameters(
        param_block=wire.DataBlock(data=bytes(transport.MAX_MESSAGE))))

    async def main():
        state, server, address = await serve(plain_cfg())
        try:
            async with grpc.aio.insecure_channel(
                    address, options=[("grpc.max_send_message_length", -1)]) as channel:
                terminate = channel.unary_unary(transport.TERMINATE_MODEL_TRAINING)
                at_limit = wire.StatusMessage.from_bytes(
                    await terminate(selection_of(transport.MAX_MESSAGE)))
                with pytest.raises(grpc.aio.AioRpcError) as unary:
                    await terminate(selection_of(transport.MAX_MESSAGE + 1))
                stream = channel.stream_stream(transport.TRAIN_MODEL)()
                await stream.write(big.to_bytes())
                with pytest.raises(grpc.aio.AioRpcError) as streamed:
                    await stream.read()
            async with transport.open_call(address, transport.TRAIN_MODEL) as call:
                with pytest.raises(transport.RpcError) as sent:
                    await call.send(big)
            return at_limit, unary.value, streamed.value, sent.value, state.client_queues
        finally:
            await stop(state, server)

    at_limit, unary, streamed, sent, registered = asyncio.run(main())
    assert len(big.to_bytes()) > transport.MAX_MESSAGE
    assert at_limit.status == wire.STATUS_OK
    assert unary.code() == streamed.code() == grpc.StatusCode.RESOURCE_EXHAUSTED
    assert sent.code() == grpc.StatusCode.INTERNAL and not registered


def test_a_path_the_servicer_lacks_is_unimplemented():
    """The FL server serves the three Flservice calls and nothing else:
    TrainForRound (a trainer server's call) and an unknown method of
    Flservice are answered UNIMPLEMENTED, and the server goes on serving."""
    async def main():
        state, server, address = await serve(plain_cfg(num_clients=1, num_rounds=1))
        try:
            async with transport.open_call(address, transport.TRAIN_FOR_ROUND) as call:
                await call.send(wire.ClientModelMessage(config=wire.ModelConfig()))
                await call.done_writing()
                with pytest.raises(transport.RpcError) as train:
                    await anext(call.responses(wire.ClientModelMessage))
            async with grpc.aio.insecure_channel(address) as channel:
                with pytest.raises(grpc.aio.AioRpcError) as unknown:
                    await channel.unary_unary("/flservice.Flservice/Nope")(b"")
            client = FlServiceClient(address, 1, 0, DummyTrainer(), device="cpu")
            await asyncio.wait_for(client.train_model(), 30)
            return train.value, unknown.value, client
        finally:
            await stop(state, server)

    train, unknown, client = asyncio.run(main())
    assert train.code() == grpc.StatusCode.UNIMPLEMENTED
    assert unknown.code() == grpc.StatusCode.UNIMPLEMENTED
    assert client.done_status == wire.STATUS_DONE


class EndsAtOnce:
    """A servicer whose calls end, cleanly, before DONE."""

    async def TrainModel(self, requests):
        async for _ in requests:
            return
        yield  # an async generator, as grpc.aio needs for a streamed answer

    async def ObserverModelTraining(self, request):
        return
        yield


def test_a_client_whose_call_ends_before_done_raises():
    """A call cut by the server's stop raises the RPC's error (UNAVAILABLE);
    a call the server ends cleanly before DONE raises ConnectionError, for a
    client and for an observer."""
    async def main():
        state, server, address = await serve(plain_cfg(num_clients=2))
        client = asyncio.create_task(FlServiceClient(address, 1, 0, DummyTrainer(),
                                                     device="cpu").train_model())
        while not state.client_queues:
            await asyncio.sleep(0.01)
        await stop(state, server)  # cancels the call
        with pytest.raises(transport.RpcError) as cut:
            await asyncio.wait_for(client, 30)
        assert cut.value.code() == grpc.StatusCode.UNAVAILABLE

        server = transport.Server(EndsAtOnce(), "127.0.0.1:0")
        await server.start()
        address = f"127.0.0.1:{server.port}"
        try:
            with pytest.raises(ConnectionError, match="before DONE"):
                await asyncio.wait_for(FlServiceClient(address, 1, 0, DummyTrainer(),
                                                       device="cpu").train_model(), 30)
            with pytest.raises(ConnectionError, match="before DONE"):
                await asyncio.wait_for(FLObserver(address, 1).observe(), 30)
        finally:
            await server.stop(0.5)

    asyncio.run(main())
