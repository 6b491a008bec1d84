"""The FL service's transport: the calls of ``flservice.Flservice`` and of
``flservice.FLClientTrainService`` over ``grpc.aio``, as the JAX package
makes them, so that JAX and port peers reach each other.

A message crosses the wire as the bytes of ``wire.*.to_bytes``, which are the
JAX package's protobuf bytes, byte for byte; ``grpc``'s generic handlers take
them as the serializers, so the port needs no ``google.protobuf``. Each call
runs on a channel of its own (one HTTP/2 connection), opened by
``open_call`` and closed when the call's block ends.

Message limits are the JAX package's: a server of ``flservice.Flservice``
sends and receives up to 64 MiB (``rofl_tpu/fl/server.py:369-372``), a
trainer server keeps gRPC's defaults (``trainservice.py:94``); on the
channel, a client's ``TrainModel`` 64 MiB both ways (``client.py:54-57``), an
observer 64 MiB received (``observer.py:30-32``), ``GrpcTrainer`` the
defaults (``trainclient.py:63``).

One ``Server`` serves any servicer: a path of ``METHODS`` whose method the
servicer has goes to that method; any other path is answered
``UNIMPLEMENTED``. The FL server's servicer has the three ``Flservice``
methods, a trainer service (``fl/trainservice.py``) has ``TrainForRound``;
each listens on its own address, as in the JAX package.

Errors propagate: a call that fails raises ``RpcError`` at the caller, with
the status gRPC gave it (``UNAVAILABLE`` where nothing listens,
``RESOURCE_EXHAUSTED`` above a limit). A servicer method that raises ends its
call with a gRPC error status, and the server goes on serving the other
calls.
"""

from __future__ import annotations

import contextlib
import logging

import grpc

from . import wire

logger = logging.getLogger("rofl_tpu_torch.transport")

RpcError = grpc.aio.AioRpcError
MAX_MESSAGE = 64 << 20
_RECEIVE = ("grpc.max_receive_message_length", MAX_MESSAGE)
_SEND = ("grpc.max_send_message_length", MAX_MESSAGE)
FL_SERVICE = "flservice.Flservice"
TRAIN_SERVICE = "flservice.FLClientTrainService"
SERVER_OPTIONS = {FL_SERVICE: [_RECEIVE, _SEND], TRAIN_SERVICE: []}
TRAIN_MODEL = f"/{FL_SERVICE}/TrainModel"
TERMINATE_MODEL_TRAINING = f"/{FL_SERVICE}/TerminateModelTraining"
OBSERVER_MODEL_TRAINING = f"/{FL_SERVICE}/ObserverModelTraining"
TRAIN_FOR_ROUND = f"/{TRAIN_SERVICE}/TrainForRound"
# path → (servicer method, request message, whether the requests stream,
# whether the responses stream, the caller's channel options)
METHODS = {
    TRAIN_MODEL: ("TrainModel", wire.TrainRequest, True, True, [_RECEIVE, _SEND]),
    OBSERVER_MODEL_TRAINING: ("ObserverModelTraining", wire.ModelSelection, False, True,
                              [_RECEIVE]),
    TERMINATE_MODEL_TRAINING: ("TerminateModelTraining", wire.ModelSelection, False, False,
                               []),
    TRAIN_FOR_ROUND: ("TrainForRound", wire.ClientModelMessage, True, True, []),
}


def _serialize(msg) -> bytes:
    return msg.to_bytes()


# -- client ------------------------------------------------------------------------


class Call:
    """The client's end of one call. A call whose requests stream starts at
    once and takes each ``send``; a call of one request starts at its
    ``send``."""

    def __init__(self, channel: grpc.aio.Channel, method: str):
        _, _, stream_in, stream_out, _ = METHODS[method]
        kind = {(True, True): channel.stream_stream, (False, True): channel.unary_stream,
                (False, False): channel.unary_unary}[stream_in, stream_out]
        self._start = kind(method, request_serializer=_serialize)
        self._stream_in = stream_in
        self._call = self._start() if stream_in else None

    async def send(self, msg) -> None:
        if self._stream_in:
            await self._call.write(msg)
        else:
            self._call = self._start(msg)

    async def done_writing(self) -> None:
        """End the request stream (a call of one request has ended it)."""
        if self._stream_in:
            await self._call.done_writing()

    async def responses(self, cls):
        """The call's responses as `cls` messages, until the server ends it."""
        async for data in self._call:
            yield cls.from_bytes(data)

    async def response(self, cls):
        """The one response of a unary call."""
        return cls.from_bytes(await self._call)


@contextlib.asynccontextmanager
async def open_call(address: str, method: str):
    """A channel to `address` with the options of `method`'s caller, and a
    call of `method` on it; the channel closes when the block ends."""
    async with grpc.aio.insecure_channel(address, options=METHODS[method][4]) as channel:
        yield Call(channel, method)


# -- server --------------------------------------------------------------------------


def _handler(method, request_cls, stream_in: bool, stream_out: bool):
    """`method` as gRPC's handler. grpc.aio takes a handler as streaming only
    where it is itself an async generator function."""
    if stream_out:
        async def handle(request, context):
            async with contextlib.aclosing(method(request)) as responses:
                async for msg in responses:
                    yield msg
    else:
        async def handle(request, context):
            return await method(request)
    kind = {(True, True): grpc.stream_stream_rpc_method_handler,
            (False, True): grpc.unary_stream_rpc_method_handler,
            (False, False): grpc.unary_unary_rpc_method_handler}[stream_in, stream_out]
    return kind(handle, request_deserializer=request_cls.from_bytes,
                response_serializer=_serialize)


class Server:
    """Serves the calls of `servicer` on `address` (port 0: an ephemeral
    port, which ``port`` holds after ``start``). A call of a path in
    ``METHODS`` goes to the servicer's method of that name: streamed
    requests arrive as an async iterator, a unary one as the message; a
    streaming method is an async generator of responses, a unary one returns
    its response."""

    def __init__(self, servicer, address: str):
        self.servicer = servicer
        self.address = address
        self.port: int | None = None
        self._server: grpc.aio.Server | None = None

    async def start(self) -> None:
        services: dict[str, dict] = {}
        for path, (name, request_cls, stream_in, stream_out, _) in METHODS.items():
            method = getattr(self.servicer, name, None)
            if method is not None:
                service = path.split("/")[1]
                services.setdefault(service, {})[name] = _handler(method, request_cls,
                                                                  stream_in, stream_out)
        self._server = grpc.aio.server(
            options=[o for service in services for o in SERVER_OPTIONS[service]])
        self._server.add_generic_rpc_handlers(tuple(
            grpc.method_handlers_generic_handler(service, handlers)
            for service, handlers in services.items()))
        self.port = self._server.add_insecure_port(self.address)
        await self._server.start()
        logger.info("serving %s on %s (port %d)", sorted(services), self.address, self.port)

    async def stop(self, grace: float | None = None) -> None:
        """Stop listening, give running calls `grace` seconds, then cancel them."""
        await self._server.stop(grace)
