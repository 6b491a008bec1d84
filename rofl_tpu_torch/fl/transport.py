"""The FL service's transport: the three calls of ``flservice.Flservice``
over asyncio TCP streams, in place of the JAX package's ``grpc.aio``.

Each call is one TCP connection. Its first frame names the method by its
gRPC path (``TRAIN_MODEL``, ``TERMINATE_MODEL_TRAINING``,
``OBSERVER_MODEL_TRAINING``); the frames after it carry one message each.
A frame is a varint length and the bytes: the length prefix of
``wire.encode_length_delimited``, around the payload the JAX package puts
inside its gRPC frames, byte for byte. So a JAX client cannot reach a port
server: only the framing differs, but it differs. A frame above 64 MiB is
refused on both ends, as the JAX channel's ``max_*_message_length`` refuses
it. The client ends its request stream by closing its side for writing
(``Call.done_writing``); the server closes the connection when the call's
responses end (``TrainModel`` after a ``done_message``).

Errors propagate: a connection cut inside a frame, a frame too large or a
call that ends before its response raises at the caller. On the server a
call that fails is logged with its traceback and its connection closed; the
server goes on serving the other calls, as a gRPC server does.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging

from . import wire

logger = logging.getLogger("rofl_tpu_torch.transport")

MAX_FRAME = 64 << 20  # grpc.max_{send,receive}_message_length (server.py:369-372)
TRAIN_MODEL = "/flservice.Flservice/TrainModel"
TERMINATE_MODEL_TRAINING = "/flservice.Flservice/TerminateModelTraining"
OBSERVER_MODEL_TRAINING = "/flservice.Flservice/ObserverModelTraining"


def parse_address(address: str) -> tuple[str, int]:
    """``host:port`` (``[::]:50051``, ``127.0.0.1:0``) → (host, port)."""
    host, sep, port = address.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"address {address!r} is not host:port")
    return host.strip("[]"), int(port)


async def read_frame(reader: asyncio.StreamReader) -> bytes | None:
    """The next frame's bytes; None where the stream ends before a frame."""
    n = shift = 0
    while True:
        byte = await reader.read(1)
        if not byte:
            if shift == 0:
                return None
            raise ConnectionError("stream ended inside a frame's length")
        n |= (byte[0] & 0x7F) << shift
        shift += 7
        if not byte[0] & 0x80:
            break
        if shift > 63:
            raise ValueError("overlong frame length")
    if n > MAX_FRAME:
        raise ValueError(f"frame of {n} bytes is above the limit of {MAX_FRAME}")
    try:
        return await reader.readexactly(n)
    except asyncio.IncompleteReadError as e:
        raise ConnectionError(f"stream ended {len(e.partial)} bytes into a frame of {n}") from e


async def write_frame(writer: asyncio.StreamWriter, payload: bytes) -> None:
    if len(payload) > MAX_FRAME:
        raise ValueError(f"frame of {len(payload)} bytes is above the limit of {MAX_FRAME}")
    writer.write(wire.encode_varint(len(payload)))
    writer.write(payload)
    await writer.drain()


async def read_messages(reader: asyncio.StreamReader, cls):
    """The frames of `reader` as `cls` messages, until the stream ends."""
    while (frame := await read_frame(reader)) is not None:
        yield cls.from_bytes(frame)


async def read_message(reader: asyncio.StreamReader, cls):
    """The one message of a unary call's side."""
    frame = await read_frame(reader)
    if frame is None:
        raise ConnectionError("the call ended without its message")
    return cls.from_bytes(frame)


async def _close(writer: asyncio.StreamWriter) -> None:
    writer.close()
    # The peer may already have reset a connection whose messages were all
    # read; closing it then is not a fault of the call.
    with contextlib.suppress(ConnectionError):
        await writer.wait_closed()


# -- client ------------------------------------------------------------------------


class Call:
    """The client's end of one call."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer

    async def send(self, msg) -> None:
        await write_frame(self.writer, msg.to_bytes())

    def done_writing(self) -> None:
        """End the request stream (the server reads EOF)."""
        self.writer.write_eof()

    def responses(self, cls):
        """The call's responses as `cls` messages, until the server closes."""
        return read_messages(self.reader, cls)

    async def response(self, cls):
        """The one response of a unary call."""
        return await read_message(self.reader, cls)


@contextlib.asynccontextmanager
async def open_call(address: str, method: str):
    """Connect to `address` and start a call of `method`."""
    host, port = parse_address(address)
    reader, writer = await asyncio.open_connection(host, port)
    try:
        await write_frame(writer, method.encode())
        yield Call(reader, writer)
    finally:
        await _close(writer)


# -- server --------------------------------------------------------------------------


class Server:
    """Serves the calls of ``flservice.Flservice`` on `address` (port 0: an
    ephemeral port, which ``port`` holds after ``start``) to `servicer`, an
    object with the async methods ``TrainModel(requests)`` and
    ``ObserverModelTraining(request)`` (async generators of responses) and
    ``TerminateModelTraining(request)``."""

    def __init__(self, servicer, address: str):
        self.servicer = servicer
        self.address = address
        self.port: int | None = None
        self._server: asyncio.Server | None = None
        self._calls: set[asyncio.Task] = set()

    async def start(self) -> None:
        host, port = parse_address(self.address)
        self._server = await asyncio.start_server(self._serve_call, host or None, port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("serving on %s (port %d)", self.address, self.port)

    async def stop(self, grace: float | None = None) -> None:
        """Stop listening, give running calls `grace` seconds, then cancel them."""
        self._server.close()
        if self._calls and grace:
            await asyncio.wait(list(self._calls), timeout=grace)
        for task in list(self._calls):
            task.cancel()
        await asyncio.gather(*self._calls, return_exceptions=True)
        await self._server.wait_closed()

    async def _serve_call(self, reader: asyncio.StreamReader,
                          writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._calls.add(task)
        method = None
        try:
            frame = await read_frame(reader)
            method = None if frame is None else frame.decode()
            if method == TRAIN_MODEL:
                await self._stream(writer, self.servicer.TrainModel(
                    read_messages(reader, wire.TrainRequest)))
            elif method == OBSERVER_MODEL_TRAINING:
                request = await read_message(reader, wire.ModelSelection)
                await self._stream(writer, self.servicer.ObserverModelTraining(request))
            elif method == TERMINATE_MODEL_TRAINING:
                request = await read_message(reader, wire.ModelSelection)
                response = await self.servicer.TerminateModelTraining(request)
                await write_frame(writer, response.to_bytes())
            else:
                logger.error("unknown method %r", method)
        except Exception:  # one failed call ends its connection, not the server
            logger.exception("call %s failed", method)
        finally:
            self._calls.discard(task)
            await _close(writer)

    @staticmethod
    async def _stream(writer: asyncio.StreamWriter, responses) -> None:
        async with contextlib.aclosing(responses):
            async for msg in responses:
                await write_frame(writer, msg.to_bytes())


