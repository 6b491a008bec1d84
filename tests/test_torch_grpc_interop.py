"""JAX and port peers over gRPC: the port's FL runtime (``rofl_tpu_torch.fl``)
and the JAX package's (``rofl_tpu.fl``) reach each other, in Plain mode on
the CPU, on 127.0.0.1 (ephemeral ports), with ``device="cpu"`` on the port's
side:

- three JAX clients complete 2 rounds on a port server, and three port
  clients on a JAX server: 0.002 everywhere, every client ends with DONE;
- a JAX observer on a port server and a port observer on a JAX server see
  every broadcast and DONE;
- a JAX ``GrpcTrainer`` on a port trainer service and a port one on a JAX
  service return the same update;
- a late JAX client on a port server gets ``LATE`` alone;
- ``TerminateModelTraining`` answers OK and NOK both ways.

Nothing here compiles a prover or a verifier: the encrypted modes' payloads
are held byte-equal to the JAX package's by the known-answer tests.
Tolerance: 1e-6 on the model (float32 sums of 0.001)."""

import asyncio

import grpc
import numpy as np
import pytest

from rofl_tpu.fl import client as jclient
from rofl_tpu.fl import observer as jobserver
from rofl_tpu.fl import params as JP
from rofl_tpu.fl import proto as pb
from rofl_tpu.fl import server as jserver
from rofl_tpu.fl import trainclient as jtrainclient
from rofl_tpu.fl import trainservice as jtrainservice
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl import transport, wire
from rofl_tpu_torch.fl import server as pserver
from rofl_tpu_torch.fl.client import FlServiceClient
from rofl_tpu_torch.fl.observer import FLObserver
from rofl_tpu_torch.fl.trainclient import DummyTrainer, GrpcTrainer
from rofl_tpu_torch.fl.trainservice import DummyTrainService, make_train_server

D = 11
TIMEOUT = 60


def port_cfg(num_clients=3, num_rounds=2):
    return pserver.ServerConfig(model_id=1, num_clients=num_clients, num_params=D,
                                num_rounds=num_rounds, learning_rate=1.0,
                                enc_type=P.PLAIN_TYPE, write_model_file=False,
                                bench_dir=None, device="cpu")


def jax_cfg(num_clients=3, num_rounds=2):
    return jserver.ServerConfig(model_id=1, num_clients=num_clients, num_params=D,
                                num_rounds=num_rounds, learning_rate=1.0,
                                enc_type=JP.PLAIN_TYPE, write_model_file=False, bench_dir=None)


class Recording(pserver.FlServiceServicer):
    """The port's servicer, keeping what each TrainModel call answered."""

    def __init__(self, states):
        super().__init__(states)
        self.answers: list[list] = []

    async def TrainModel(self, requests):
        answered = []
        self.answers.append(answered)
        async for msg in super().TrainModel(requests):
            answered.append(msg)
            yield msg


class PortServer:
    """A port FL server of `cfg` on an ephemeral port."""

    def __init__(self, cfg):
        self.state = pserver.TrainingState(cfg)
        self.servicer = Recording({cfg.model_id: self.state})
        self.server = transport.Server(self.servicer, "127.0.0.1:0")

    async def __aenter__(self):
        await self.server.start()
        self.address = f"127.0.0.1:{self.server.port}"
        return self

    async def __aexit__(self, *exc):
        await self.server.stop(0.5)
        self.state.close()


class JaxServer:
    """A JAX FL server of `cfg` on an ephemeral port; keeps the global model
    at each of its broadcasts."""

    def __init__(self, cfg):
        self.state = jserver.TrainingState(cfg)
        self.broadcast: list[np.ndarray] = []
        broadcast = self.state.broadcast_global_model

        async def recorded():
            self.broadcast.append(self.state.global_model.copy())
            await broadcast()

        self.state.broadcast_global_model = recorded
        self.server = jserver.make_server({cfg.model_id: self.state}, "127.0.0.1:0")

    async def __aenter__(self):
        port = self.server.add_insecure_port("127.0.0.1:0")
        await self.server.start()
        self.address = f"127.0.0.1:{port}"
        return self

    async def __aexit__(self, *exc):
        await self.server.stop(0.5)


def statuses(answers: list) -> list[int]:
    return [m.done_message.status for m in answers if m.which_oneof() == "done_message"]


def test_jax_clients_complete_plain_rounds_on_a_port_server():
    async def main():
        async with PortServer(port_cfg()) as srv:
            clients = [jclient.FlServiceClient(srv.address, 1, i, jtrainclient.DummyTrainer())
                       for i in range(3)]
            await asyncio.wait_for(asyncio.gather(*(c.train_model() for c in clients)),
                                   TIMEOUT)
            return srv, clients

    srv, clients = asyncio.run(main())
    assert srv.state.status == "done"
    np.testing.assert_allclose(srv.state.global_model, np.full(D, 0.002, np.float32), atol=1e-6)
    assert [statuses(a) for a in srv.servicer.answers] == [[wire.STATUS_DONE]] * 3
    for c in clients:  # each trained on the last model broadcast, 0.001
        np.testing.assert_allclose(c.final_model, np.full(D, 0.001, np.float32), atol=1e-6)


def test_port_clients_complete_plain_rounds_on_a_jax_server():
    async def main():
        async with JaxServer(jax_cfg()) as srv:
            clients = [FlServiceClient(srv.address, 1, i, DummyTrainer(), device="cpu")
                       for i in range(3)]
            await asyncio.wait_for(asyncio.gather(*(c.train_model() for c in clients)),
                                   TIMEOUT)
            return srv, clients

    srv, clients = asyncio.run(main())
    assert srv.state.status == "done" and len(srv.broadcast) == 2
    np.testing.assert_allclose(srv.state.global_model, np.full(D, 0.002, np.float32), atol=1e-6)
    assert [c.done_status for c in clients] == [wire.STATUS_DONE] * 3
    for c in clients:  # the client's final model is the last one the JAX server sent
        assert sorted(c.round_log) == [0, 1]
        np.testing.assert_array_equal(c.final_model, srv.broadcast[-1])


class Seen:
    def __init__(self):
        self.weights = []

    def set_weights(self, w):
        self.weights.append(np.asarray(w).copy())

    def evaluate(self):
        return 0.0, 1.0


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_an_observer_across_the_boundary_sees_every_broadcast_and_done(server_side):
    """A JAX observer on a port server, or a port observer on a JAX server,
    with two port or JAX clients, three rounds."""
    async def main():
        if server_side == "port":
            srv, make_observer = PortServer(port_cfg(2, 3)), jobserver.FLObserver
            make_client = lambda a, i: jclient.FlServiceClient(a, 1, i,  # noqa: E731
                                                               jtrainclient.DummyTrainer())
        else:
            srv, make_observer = JaxServer(jax_cfg(2, 3)), FLObserver
            make_client = lambda a, i: FlServiceClient(a, 1, i, DummyTrainer(),  # noqa: E731
                                                       device="cpu")
        async with srv:
            seen = Seen()
            watch = asyncio.create_task(make_observer(srv.address, 1, seen).observe())
            while not srv.state.observer_queues:
                await asyncio.sleep(0.01)
            clients = [make_client(srv.address, i) for i in range(2)]
            await asyncio.wait_for(asyncio.gather(watch, *(c.train_model() for c in clients)),
                                   TIMEOUT)
            return srv, seen

    srv, seen = asyncio.run(main())
    assert srv.state.status == "done"
    # every broadcast, rounds 0, 1 and 2, then DONE ended the observer's call
    # (a port observer raises where its call ends before DONE)
    want = [np.full(D, 0.001 * r, np.float32) for r in range(3)]
    assert len(seen.weights) == 3
    for got, w in zip(seen.weights, want):
        np.testing.assert_allclose(got, w, atol=1e-6)
    assert srv.state.observer_queues[0].empty()  # DONE was sent, nothing after it


@pytest.mark.parametrize("client_side", ["jax", "port"])
def test_a_trainer_across_the_boundary_returns_the_same_update(client_side):
    """A JAX GrpcTrainer on a port DummyTrainService, or a port one on a JAX
    DummyTrainService, at 25 003 floats (three blocks, the last one short)."""
    w = np.random.default_rng(3).standard_normal(25_003).astype(np.float32)
    config = wire.ModelConfig(model_id=1, num_of_clients=3, learning_rate=1.0)

    async def main():
        if client_side == "jax":
            server = make_train_server(DummyTrainService(), "127.0.0.1:0")
            await server.start()
            port = server.port
            trainer = jtrainclient.GrpcTrainer(f"127.0.0.1:{port}")
            cfg = pb.ModelConfig.FromString(config.to_bytes())
        else:
            server = jtrainservice.make_train_server(jtrainservice.DummyTrainService(),
                                                     "127.0.0.1:0")
            port = server.add_insecure_port("127.0.0.1:0")
            await server.start()
            trainer, cfg = GrpcTrainer(f"127.0.0.1:{port}"), config
        try:
            return await asyncio.wait_for(trainer.train_for_round(cfg, w, 1), TIMEOUT)
        finally:
            await server.stop(0.5)

    update = asyncio.run(main())
    assert update.dtype == np.float32
    np.testing.assert_array_equal(update, np.full(len(w), 0.001, np.float32))


class NeverTrains(jtrainclient.DummyTrainer):
    async def train_for_round(self, config, model, round_id):
        raise AssertionError("a late client is sent no model")


def test_a_late_jax_client_on_a_port_server_gets_late_alone():
    async def main():
        async with PortServer(port_cfg(1, 1)) as srv:
            first = jclient.FlServiceClient(srv.address, 1, 0, jtrainclient.DummyTrainer())
            await asyncio.wait_for(first.train_model(), TIMEOUT)
            late = jclient.FlServiceClient(srv.address, 1, 99, NeverTrains())
            await asyncio.wait_for(late.train_model(), TIMEOUT)
            return srv, late

    srv, late = asyncio.run(main())
    assert srv.state.status == "done"
    first, answered = srv.servicer.answers
    assert statuses(first) == [wire.STATUS_DONE]
    assert [m.to_bytes() for m in answered] == [wire.TrainResponse(
        done_message=wire.StatusMessage(status=wire.STATUS_LATE)).to_bytes()]
    assert late.config is None and late.final_model is None


def test_terminate_answers_ok_and_nok_both_ways():
    """The port's call on a JAX server, and a gRPC call of the JAX package's
    messages on a port server (the JAX package has no client of this call):
    OK for the model the server holds, NOK for another."""
    async def port_caller(address):
        out = []
        for model_id in (1, 2):
            async with transport.open_call(address, transport.TERMINATE_MODEL_TRAINING) as call:
                await call.send(wire.ModelSelection(model_id=model_id))
                out.append((await call.response(wire.StatusMessage)).status)
        return out

    async def jax_caller(address):
        async with grpc.aio.insecure_channel(address) as channel:
            terminate = channel.unary_unary(
                transport.TERMINATE_MODEL_TRAINING,
                request_serializer=lambda m: m.SerializeToString(),
                response_deserializer=pb.StatusMessage.FromString)
            return [(await terminate(pb.ModelSelection(model_id=m))).status for m in (1, 2)]

    async def main():
        async with JaxServer(jax_cfg(1, 5)) as jsrv, PortServer(port_cfg(1, 5)) as psrv:
            return (await port_caller(jsrv.address), jsrv.state.status,
                    await jax_caller(psrv.address), psrv.state.status)

    on_jax, jax_status, on_port, port_status = asyncio.run(main())
    assert on_jax == on_port == [wire.STATUS_OK, wire.STATUS_NOK]
    assert jax_status == port_status == "terminate"
    assert (wire.STATUS_OK, wire.STATUS_NOK) == (pb.STATUS_OK, pb.STATUS_NOK)
