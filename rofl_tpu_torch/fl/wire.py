"""The protobuf wire format of the FL service's messages, written and read
by hand.

Counterpart of the 19 messages of ``rofl_tpu/fl/proto/flservice.proto``
(the three encrypted-update envelopes ``EncRangeData``, ``EncNormData``,
``EncNormDataCompressed`` and the 16 messages of the service and its
trainer bridge) and of the envelopes' length-delimited framing
(``encode_length_delimited`` / ``decode_length_delimited``, as prost frames
params.rs serialize()). The port needs neither ``google.protobuf`` nor
``protoc``; every message encodes as proto3 encodes it, byte-identical to the
protobuf runtime's output.

A message is a dataclass with one attribute per field; ``SCHEMA`` lists
(attribute, field number, kind) in field-number order, each number written
out beside its attribute (``_field``). The kinds: ``int32`` and the enum
``Status`` (varints; a negative value goes out as ten bytes), ``uint32``,
``bool``, ``float`` (fixed32, the little-endian float32: it reads back as
that float32's value, 0.7 as 0.699999988...), ``bytes``, ``string`` (UTF-8),
``repeated bytes``, ``repeated float`` (written packed) and nested messages.
Fields go out in field-number order. A scalar at its default is left out
(0, False, empty, and a float whose 32 bits are all zero: 0.0, not -0.0); a
nested message is written when present (not None), even when it is empty,
and so is the member of a oneof that is set: ``TrainResponse(done_message=
StatusMessage())`` is ``1a 00``. A message with a oneof lists its members in
``ONEOF``; ``which_oneof()`` names the one that is set (the runtime's
``WhichOneof``), and writing a message with two set raises.

The reader takes fields in any order, keeps the last value of a singular
scalar, merges a nested message that comes twice into one (as the runtime
merges), lets a oneof member replace another read before it, reads a
repeated float packed or not, and skips fields it does not know, or whose
wire type is not the field's, groups (wire types 3 and 4, nested, each
closed by the end-group of its own field number) among them. It raises
where the protobuf runtime raises: on a truncated field, a string that is
not valid UTF-8, a packed float field whose length is not a multiple of 4,
a stray or mismatched end-group, an unterminated group, groups nested deeper
than 100 (a nested message counts as one level), wire types 6 and 7, and field number 0 or above
2^29 - 1.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field, fields
from typing import ClassVar

import numpy as np

_VARINT, _I64, _LEN, _START_GROUP, _END_GROUP, _I32 = 0, 1, 2, 3, 4, 5
_MAX_FIELD = (1 << 29) - 1
_MAX_DEPTH = 100  # nesting limit of the protobuf runtime and of prost
# What a field holds; a nested message field's kind is the message's class.
INT32, ENUM, UINT32, BOOL, FLOAT = "int32", "enum", "uint32", "bool", "float"
BYTES, STRING, REPEATED_BYTES, REPEATED_FLOAT = "bytes", "string", "repeated bytes", "repeated float"
_WIRE_TYPE = {INT32: _VARINT, ENUM: _VARINT, UINT32: _VARINT, BOOL: _VARINT, FLOAT: _I32,
              BYTES: _LEN, STRING: _LEN, REPEATED_BYTES: _LEN, REPEATED_FLOAT: _LEN}
_DEFAULT = {INT32: 0, ENUM: 0, UINT32: 0, BOOL: False, FLOAT: 0.0, BYTES: b"", STRING: ""}

# StatusMessage.Status
STATUS_OK, STATUS_NOK, STATUS_LATE, STATUS_DONE = 0, 1, 2, 3


def encode_varint(n: int) -> bytes:
    """Unsigned LEB128; a negative int32 goes out as its 64-bit two's
    complement, ten bytes, as protobuf writes it."""
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def decode_varint(data: bytes, i: int) -> tuple[int, int]:
    """(value, next offset)."""
    n = shift = 0
    while True:
        if i >= len(data) or shift > 63:
            raise ValueError("truncated or overlong varint")
        b = data[i]
        n |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return n, i
        shift += 7


def _int32(n: int) -> int:
    n &= (1 << 32) - 1
    return n - (1 << 32) if n >> 31 else n


class _Message:
    """A proto3 message of the kinds above. A subclass is a dataclass whose
    fields are made by ``_field`` and which ``_schema`` decorates; ``ONEOF``
    names the members of its oneof, if it has one."""

    SCHEMA: ClassVar[tuple] = ()
    ONEOF: ClassVar[tuple] = ()

    def which_oneof(self) -> str | None:
        """The member of the oneof that is set, or None."""
        present = [name for name in self.ONEOF if getattr(self, name) is not None]
        if len(present) > 1:
            raise ValueError(f"{type(self).__name__}: oneof members {present} all set")
        return present[0] if present else None

    def to_bytes(self) -> bytes:
        self.which_oneof()
        out = bytearray()
        for name, number, kind in self.SCHEMA:
            value = getattr(self, name)
            key = encode_varint(number << 3 | _wire_type(kind))
            if isinstance(kind, type):
                if value is not None:
                    body = value.to_bytes()
                    out += key + encode_varint(len(body)) + body
            elif kind == REPEATED_BYTES:
                for item in value:
                    out += key + encode_varint(len(item)) + item
            elif kind == REPEATED_FLOAT:
                if len(value):
                    body = np.asarray(value, "<f4").tobytes()
                    out += key + encode_varint(len(body)) + body
            elif kind in (BYTES, STRING):
                raw = value.encode("utf-8") if kind == STRING else value
                if raw:
                    out += key + encode_varint(len(raw)) + raw
            elif kind == FLOAT:
                raw = struct.pack("<f", value)
                if raw != bytes(4):
                    out += key + raw
            elif kind == BOOL:
                if value:
                    out += key + b"\x01"
            elif kind == UINT32:
                if not 0 <= value < 1 << 32:
                    raise ValueError(f"{name}: {value} is no uint32")
                if value:
                    out += key + encode_varint(value)
            elif value:  # INT32, ENUM
                out += key + encode_varint(_int32(value))
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes):
        msg = cls()
        msg._merge(data, 0)
        return msg

    def _merge(self, data: bytes, depth: int) -> None:
        """Read the fields of `data` into this message (protobuf's merge)."""
        by_number = {number: (name, kind) for name, number, kind in self.SCHEMA}
        i = 0
        while i < len(data):
            number, wire_type, i = _read_key(data, i)
            value, i = _read_value(data, i, number, wire_type, depth)
            name, kind = by_number.get(number, (None, None))
            if kind == REPEATED_FLOAT and wire_type == _I32:  # one unpacked element
                getattr(self, name).append(struct.unpack("<f", value)[0])
                continue
            if name is None or _wire_type(kind) != wire_type:
                continue
            if isinstance(kind, type):
                if name in self.ONEOF:
                    for other in self.ONEOF:
                        if other != name:
                            setattr(self, other, None)
                if getattr(self, name) is None:
                    setattr(self, name, kind())
                getattr(self, name)._merge(value, depth + 1)
            elif kind == REPEATED_BYTES:
                getattr(self, name).append(value)
            elif kind == REPEATED_FLOAT:
                if len(value) % 4:
                    raise ValueError(f"{name}: packed floats of {len(value)} bytes")
                getattr(self, name).extend(np.frombuffer(value, "<f4").tolist())
            elif kind == STRING:
                setattr(self, name, value.decode("utf-8"))  # UnicodeDecodeError is a ValueError
            elif kind == BYTES:
                setattr(self, name, value)
            elif kind == FLOAT:
                setattr(self, name, struct.unpack("<f", value)[0])
            elif kind == BOOL:
                setattr(self, name, value != 0)
            elif kind == UINT32:
                setattr(self, name, value & 0xFFFFFFFF)
            else:  # INT32, ENUM
                setattr(self, name, _int32(value))


def _wire_type(kind) -> int:
    return _LEN if isinstance(kind, type) else _WIRE_TYPE[kind]


def _read_key(data: bytes, i: int) -> tuple[int, int, int]:
    """(field number, wire type, next offset)."""
    key, i = decode_varint(data, i)
    number = key >> 3
    if number == 0 or number > _MAX_FIELD:
        raise ValueError(f"invalid field number {number}")
    return number, key & 7, i


def _read_value(data: bytes, i: int, number: int, wire_type: int, depth: int):
    """(value, next offset) of the field whose key ends at i: an int, the
    bytes of a length-delimited or fixed-width field, or None for a group,
    skipped up to its end-group."""
    if wire_type == _VARINT:
        return decode_varint(data, i)
    if wire_type == _LEN:
        length, i = decode_varint(data, i)
        if i + length > len(data):
            raise ValueError("truncated length-delimited field")
        return bytes(data[i:i + length]), i + length
    if wire_type in (_I64, _I32):
        width = 8 if wire_type == _I64 else 4
        if i + width > len(data):
            raise ValueError("truncated fixed-width field")
        return bytes(data[i:i + width]), i + width
    if wire_type == _START_GROUP:
        if depth == _MAX_DEPTH:
            raise ValueError(f"groups nested deeper than {_MAX_DEPTH}")
        while True:
            if i >= len(data):
                raise ValueError(f"unterminated group of field {number}")
            inner, inner_type, i = _read_key(data, i)
            if inner_type == _END_GROUP:
                if inner != number:
                    raise ValueError(f"end-group of field {inner} closes field {number}")
                return None, i
            _, i = _read_value(data, i, inner, inner_type, depth + 1)
    if wire_type == _END_GROUP:
        raise ValueError(f"end-group of field {number} outside a group")
    raise ValueError(f"unsupported wire type {wire_type}")


def _field(number: int, kind):
    """A dataclass field holding field `number` of `kind`, at its default:
    the kind's zero, an empty list, or None (a nested message, absent)."""
    meta = {"number": number, "kind": kind}
    if kind in (REPEATED_BYTES, REPEATED_FLOAT):
        return field(default_factory=list, metadata=meta)
    return field(default=None if isinstance(kind, type) else _DEFAULT[kind], metadata=meta)


def _schema(cls):
    """Make `cls` a dataclass and give it ``SCHEMA`` from its fields."""
    cls = dataclass(cls)
    cls.SCHEMA = tuple(sorted(((f.name, f.metadata["number"], f.metadata["kind"])
                               for f in fields(cls)), key=lambda s: s[1]))
    return cls


# -- training and crypto configuration (flservice.proto:26-56) --------------------


@_schema
class ModelConfig(_Message):
    num_of_clients: int = _field(1, INT32)
    client_batch_size: int = _field(2, INT32)
    num_local_epochs: int = _field(3, INT32)
    optimizer: str = _field(4, STRING)
    learning_rate: float = _field(5, FLOAT)
    loss: str = _field(6, STRING)
    metrics: str = _field(7, STRING)
    image_augmentation: bool = _field(8, BOOL)
    lr_decay: float = _field(9, FLOAT)
    model_id: int = _field(10, INT32)
    probabilistic_quantization: bool = _field(11, BOOL)
    fp_bits: int = _field(12, INT32)
    fp_frac: int = _field(13, INT32)
    range_bits: int = _field(14, INT32)


@_schema
class CryptoConfig(_Message):
    value_range: int = _field(1, INT32)
    n_partition: int = _field(2, INT32)
    l2_value_range: int = _field(3, INT32)
    check_percentage: float = _field(4, FLOAT)
    enc_type: int = _field(5, INT32)


@_schema
class Config(_Message):
    model_config: ModelConfig | None = _field(1, ModelConfig)
    crypto_config: CryptoConfig | None = _field(2, CryptoConfig)


# -- chunked transport (flservice.proto:58-89) -------------------------------------


@_schema
class DataBlock(_Message):
    block_number: int = _field(1, UINT32)
    data: bytes = _field(2, BYTES)


@_schema
class MetaFloatBlockMessage(_Message):
    model_id: int = _field(1, INT32)
    round_id: int = _field(2, INT32)
    num_blocks: int = _field(3, INT32)
    num_floats: int = _field(4, INT32)


@_schema
class FloatBlock(_Message):
    block_number: int = _field(1, UINT32)
    floats: list = _field(2, REPEATED_FLOAT)  # written packed


@_schema
class ModelParametersMeta(_Message):  # ModelParameters.ModelParametersMeta
    model_id: int = _field(1, INT32)
    round_id: int = _field(2, INT32)
    num_blocks: int = _field(3, INT32)


@_schema
class ModelParameters(_Message):
    ONEOF: ClassVar[tuple] = ("param_meta", "param_block")  # oneof param_message
    param_meta: ModelParametersMeta | None = _field(1, ModelParametersMeta)
    param_block: DataBlock | None = _field(2, DataBlock)


# -- encrypted-update envelopes (flservice.proto:91-116) ---------------------------


@_schema
class EncRangeData(_Message):
    enc_values: bytes = _field(1, BYTES)        # ElGamal pairs, 64 B stride
    rand_proof: bytes = _field(2, BYTES)        # RandProofs (128 B each) or one compressed
    range_proof: list = _field(3, REPEATED_BYTES)  # one Bulletproof a partition
    range_bits: int = _field(4, INT32)
    check_percentage: float = _field(5, FLOAT)


@_schema
class EncNormData(_Message):
    enc_values: bytes = _field(1, BYTES)        # SquareRandProofCommitments, 96 B stride
    square_proof: bytes = _field(2, BYTES)      # SquareRandProofs, 192 B each
    range_proof: list = _field(3, REPEATED_BYTES)  # one Bulletproof a partition
    square_range_proof: bytes = _field(4, BYTES)  # the L2 sum Bulletproof
    range_bits: int = _field(5, INT32)
    l2_range_bits: int = _field(6, INT32)


@_schema
class EncNormDataCompressed(_Message):
    enc_values: bytes = _field(1, BYTES)        # SquareRandProofCommitments, 96 B stride
    square_proof: bytes = _field(2, BYTES)      # SquareProofs, 160 B each
    rand_proof: bytes = _field(3, BYTES)        # one CompressedRandProof (128 B)
    range_proof: list = _field(4, REPEATED_BYTES)
    square_range_proof: bytes = _field(5, BYTES)
    range_bits: int = _field(6, INT32)
    l2_range_bits: int = _field(7, INT32)


# -- control messages (flservice.proto:118-178) ------------------------------------


@_schema
class WorkerRegisterMessage(_Message):
    model_id: int = _field(1, INT32)
    client_id: int = _field(2, INT32)


@_schema
class ModelRegisterResponse(_Message):
    success: bool = _field(1, BOOL)
    model_id: int = _field(2, INT32)


@_schema
class StatusMessage(_Message):
    status: int = _field(1, ENUM)  # STATUS_OK, _NOK, _LATE, _DONE


@_schema
class ErrorMessage(_Message):
    version: int = _field(1, INT32)
    msg: str = _field(2, STRING)


@_schema
class ModelSelection(_Message):
    model_id: int = _field(1, INT32)


@_schema
class ClientModelMessage(_Message):
    ONEOF: ClassVar[tuple] = ("config", "meta_block_message", "model_block")  # model_message
    config: ModelConfig | None = _field(1, ModelConfig)
    meta_block_message: MetaFloatBlockMessage | None = _field(2, MetaFloatBlockMessage)
    model_block: FloatBlock | None = _field(3, FloatBlock)


@_schema
class ServerModelData(_Message):
    ONEOF: ClassVar[tuple] = ("config", "model_block")  # oneof model_message
    config: Config | None = _field(1, Config)
    model_block: ModelParameters | None = _field(2, ModelParameters)


@_schema
class TrainRequest(_Message):
    ONEOF: ClassVar[tuple] = ("start_message", "params", "status_message")  # param_message
    start_message: WorkerRegisterMessage | None = _field(1, WorkerRegisterMessage)
    params: ModelParameters | None = _field(2, ModelParameters)
    status_message: StatusMessage | None = _field(3, StatusMessage)


@_schema
class TrainResponse(_Message):
    ONEOF: ClassVar[tuple] = ("params", "error_message", "done_message")  # param_message
    params: ServerModelData | None = _field(1, ServerModelData)
    error_message: ErrorMessage | None = _field(2, ErrorMessage)
    done_message: StatusMessage | None = _field(3, StatusMessage)


def encode_length_delimited(payload: bytes) -> bytes:
    """prost encode_length_delimited: a varint length prefix, then the message."""
    return encode_varint(len(payload)) + payload


def decode_length_delimited(data: bytes) -> bytes:
    """The message bytes of a length-delimited frame (prost
    decode_length_delimited)."""
    n, i = decode_varint(data, 0)
    if i + n > len(data):
        raise ValueError("truncated length-delimited message")
    return bytes(data[i:i + n])
