"""The trainer service and its client over the port's transport
(``fl/trainservice.py``, ``fl/trainclient.GrpcTrainer``) against the JAX
package's over gRPC (``rofl_tpu.fl.trainservice``, ``trainclient``):

- ``TrainForRound``'s answer to the same requests is the JAX service's,
  message by message, byte for byte;
- ``GrpcTrainer`` sends the JAX client's requests byte for byte (the JAX
  pair runs over ``grpc.aio`` on 127.0.0.1, the port's over its transport)
  and returns the same update;
- ``TorchTrainService`` over the transport returns train(w) - w of the
  port's ``Trainer``, bit for bit;
- the client reconnects: to a service that is not listening yet, and after
  a call that breaks off before its floats; a trainer server refuses a
  method it does not serve.
Tolerance: none."""

import asyncio
import logging
import socket

import numpy as np
import pytest

from rofl_tpu.fl import proto as pb
from rofl_tpu.fl import trainclient as jtrainclient
from rofl_tpu.fl import trainservice as jtrainservice
from rofl_tpu_torch.fl import transport, wire
from rofl_tpu_torch.fl.trainclient import GrpcTrainer
from rofl_tpu_torch.fl.trainservice import (DummyTrainService, MockCIFARTrainService,
                                            TorchTrainService, TrainServiceBase,
                                            make_train_server)
from rofl_tpu_torch.models.trainer import Trainer

D = 25_003  # three blocks of NUM_FLOATS_PACKET, the last one short


def model(d=D, seed=5):
    return np.random.default_rng(seed).standard_normal(d).astype(np.float32)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Recording(TrainServiceBase):
    """A Dummy service of the port that keeps the bytes of every request."""

    def __init__(self):
        self.requests: list[bytes] = []

    async def TrainForRound(self, requests):
        async def recorded():
            async for msg in requests:
                self.requests.append(msg.to_bytes())
                yield msg
        async for out in super().TrainForRound(recorded()):
            yield out

    def train_model(self, weights, round_id):
        return weights * np.float32(0.5) + np.float32(round_id)


class JaxRecording(jtrainservice.TrainServiceBase):
    def __init__(self):
        self.requests: list[bytes] = []

    async def TrainForRound(self, request_iterator, context):
        async def recorded():
            async for msg in request_iterator:
                self.requests.append(msg.SerializeToString())
                yield msg
        async for out in super().TrainForRound(recorded(), context):
            yield out

    def train_model(self, weights, round_id):
        return weights * np.float32(0.5) + np.float32(round_id)


async def port_call(service, fn):
    server = make_train_server(service, "127.0.0.1:0")
    await server.start()
    try:
        return await fn(f"127.0.0.1:{server.port}")
    finally:
        await server.stop(0.5)


def test_the_answer_to_the_same_requests_is_the_jax_services():
    w = model()
    requests = [wire.ClientModelMessage(config=wire.ModelConfig(model_id=3)),
                wire.ClientModelMessage(meta_block_message=wire.MetaFloatBlockMessage(
                    model_id=3, round_id=2, num_blocks=3, num_floats=D))]
    requests += [wire.ClientModelMessage(model_block=wire.FloatBlock(
        block_number=b, floats=w[b * 10_000:(b + 1) * 10_000].tolist())) for b in range(3)]

    async def answers(service, msgs, port_side):
        async def gen():
            for m in msgs:
                yield m
        if port_side:
            return [m.to_bytes() async for m in service.TrainForRound(gen())]
        return [m.SerializeToString() async for m in service.TrainForRound(gen(), None)]

    jax_msgs = [pb.ClientModelMessage.FromString(m.to_bytes()) for m in requests]
    for port_svc, jax_svc in ((DummyTrainService(), jtrainservice.DummyTrainService()),
                              (Recording(), JaxRecording())):
        got = asyncio.run(answers(port_svc, requests, True))
        want = asyncio.run(answers(jax_svc, jax_msgs, False))
        assert got == want and len(got) == 4  # the meta message and three blocks


def test_grpc_trainer_sends_the_jax_clients_requests():
    w = model()
    config = wire.ModelConfig(model_id=4, num_of_clients=2, learning_rate=1.0)

    async def jax_side():
        svc = JaxRecording()
        server = jtrainservice.make_train_server(svc, "127.0.0.1:0")
        port = server.add_insecure_port("127.0.0.1:0")
        await server.start()
        try:
            jconfig = pb.ModelConfig.FromString(config.to_bytes())
            update = await jtrainclient.GrpcTrainer(f"127.0.0.1:{port}").train_for_round(
                jconfig, w, 6)
        finally:
            await server.stop(0.5)
        return svc.requests, update

    svc = Recording()
    update = asyncio.run(port_call(svc, lambda a: GrpcTrainer(a).train_for_round(config, w, 6)))
    jax_requests, jax_update = asyncio.run(jax_side())
    assert svc.requests == jax_requests and len(jax_requests) == 5
    assert update.dtype == np.float32 and np.array_equal(update, jax_update)
    assert np.array_equal(update, w * np.float32(0.5) + np.float32(6))
    # no config: the JAX client sends a config message holding model_id 0
    svc = Recording()
    asyncio.run(port_call(svc, lambda a: GrpcTrainer(a).train_for_round(None, w[:3], 0)))
    assert svc.requests[0] == pb.ClientModelMessage(
        config=pb.ModelConfig(model_id=0)).SerializeToString()


def test_torch_train_service_returns_the_trainers_update():
    trainer = Trainer("mnist_dev", "mnist", client_id=1, num_clients=32, device="cpu")
    twin = Trainer("mnist_dev", "mnist", client_id=1, num_clients=32, device="cpu")
    w = twin.get_weights() + model(19090, 9) * np.float32(0.01)
    update = asyncio.run(port_call(TorchTrainService(trainer),
                                   lambda a: GrpcTrainer(a).train_for_round(None, w, 4)))
    twin.set_weights(w)
    want = twin.train(4) - w
    assert update.dtype == np.float32 and np.array_equal(update, want)
    assert np.any(update != 0) and trainer.round_log[4]["steps"] == 2


class FailsOnce(DummyTrainService):
    def __init__(self):
        self.calls = 0

    def train_model(self, weights, round_id):
        self.calls += 1
        if self.calls == 1:
            raise RuntimeError("the first training fails")
        return super().train_model(weights, round_id)


def test_the_client_reconnects(monkeypatch, caplog):
    assert GrpcTrainer.retry_s == 5.0  # trainclient.rs: 5 s between attempts
    monkeypatch.setattr(GrpcTrainer, "retry_s", 0.05)
    port = free_port()
    w = model(12)

    async def late_server():
        client = asyncio.create_task(GrpcTrainer(f"127.0.0.1:{port}").train_for_round(None, w, 1))
        await asyncio.sleep(0.3)  # the client has been refused a few times by now
        server = make_train_server(DummyTrainService(), f"127.0.0.1:{port}")
        await server.start()
        try:
            return await asyncio.wait_for(client, 30)
        finally:
            await server.stop(0.5)

    with caplog.at_level(logging.WARNING, logger="rofl_tpu_torch.trainclient"):
        update = asyncio.run(late_server())
    assert np.array_equal(update, np.full(12, 0.001, np.float32))
    assert sum("retrying" in r.message for r in caplog.records) >= 2

    svc = FailsOnce()  # the first call ends before its floats: the client tries again
    update = asyncio.run(port_call(svc, lambda a: GrpcTrainer(a).train_for_round(None, w, 0)))
    assert svc.calls == 2 and np.array_equal(update, np.full(12, 0.001, np.float32))


def test_a_trainer_server_refuses_the_fl_calls():
    async def call(address):
        async with transport.open_call(address, transport.TRAIN_MODEL) as c:
            c.done_writing()
            return [m async for m in c.responses(wire.TrainResponse)]

    assert asyncio.run(port_call(DummyTrainService(), call)) == []


def test_mock_cifar_sleeps_then_answers_as_the_dummy():
    assert MockCIFARTrainService().sleep_s == 43.3
    out = MockCIFARTrainService(sleep_s=0.01).train_model(np.zeros(3, np.float32), 0)
    assert np.array_equal(out, np.full(3, 0.001, np.float32))


@pytest.mark.parametrize("n", [0, 1, 10_000])
def test_block_counts_at_the_edges(n):
    w = model(n) if n else np.zeros(0, np.float32)
    update = asyncio.run(port_call(Recording(), lambda a: GrpcTrainer(a).train_for_round(
        None, w, 0)))
    assert np.array_equal(update, w * np.float32(0.5))
