"""The protobuf wire format of the encrypted-update envelopes, written and
read by hand.

Counterpart of the ``EncRangeData``, ``EncNormData`` and
``EncNormDataCompressed`` messages of ``rofl_tpu/fl/proto``
(flservice.proto:91-116) and of their length-delimited framing
(``encode_length_delimited`` / ``decode_length_delimited``, as prost frames
params.rs serialize()). The port needs neither ``google.protobuf`` nor
``protoc``: each message is a few ``bytes`` fields (one of them repeated),
``int32`` fields and, in ``EncRangeData``, one ``float``, encoded as proto3
encodes them, byte-identical to the protobuf runtime's output. Fields go out
in field-number order; a ``bytes`` field that is empty, an ``int32`` that is
0 and a ``float`` whose 32 bits are all zero (0.0, not -0.0) are left out,
every element of a repeated field is written. A ``float`` is fixed32, the
little-endian float32, and reads back as that float32's value (0.7 reads
back as 0.699999988...), as from the protobuf runtime. The reader takes
fields in any order, keeps the last value of a singular field and skips
fields it does not know.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field, fields
from typing import ClassVar

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5
# What a field holds → its wire type.
BYTES, REPEATED_BYTES, INT32, FLOAT = "bytes", "repeated bytes", "int32", "float"
_WIRE_TYPE = {BYTES: _LEN, REPEATED_BYTES: _LEN, INT32: _VARINT, FLOAT: _I32}


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
    """A proto3 message of the kinds above. A subclass is a dataclass with
    one attribute per field and ``SCHEMA``: (attribute, field number, kind)
    in field-number order."""

    SCHEMA: ClassVar[tuple] = ()

    def to_bytes(self) -> bytes:
        out = bytearray()
        for name, number, kind in self.SCHEMA:
            value = getattr(self, name)
            key = encode_varint(number << 3 | _WIRE_TYPE[kind])
            if kind == BYTES and value:
                out.extend(key + encode_varint(len(value)) + value)
            elif kind == REPEATED_BYTES:
                for item in value:
                    out.extend(key + encode_varint(len(item)) + item)
            elif kind == INT32 and value:
                out.extend(key + encode_varint(_int32(value)))
            elif kind == FLOAT:
                raw = struct.pack("<f", value)
                if raw != bytes(4):
                    out.extend(key + raw)
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes):
        msg = cls()
        by_number = {number: (name, kind) for name, number, kind in cls.SCHEMA}
        i = 0
        while i < len(data):
            key, i = decode_varint(data, i)
            number, wire_type = key >> 3, key & 7
            if wire_type == _VARINT:
                value, i = decode_varint(data, i)
            elif wire_type == _LEN:
                length, i = decode_varint(data, i)
                if i + length > len(data):
                    raise ValueError("truncated length-delimited field")
                value, i = bytes(data[i:i + length]), i + length
            elif wire_type in (_I64, _I32):
                width = 8 if wire_type == _I64 else 4
                if i + width > len(data):
                    raise ValueError("truncated fixed-width field")
                value, i = bytes(data[i:i + width]), i + width
            else:
                raise ValueError(f"unsupported wire type {wire_type}")
            name, kind = by_number.get(number, (None, None))
            if name is None or _WIRE_TYPE[kind] != wire_type:
                continue
            if kind == REPEATED_BYTES:
                getattr(msg, name).append(value)
            elif kind == INT32:
                setattr(msg, name, _int32(value))
            elif kind == FLOAT:
                setattr(msg, name, struct.unpack("<f", value)[0])
            else:
                setattr(msg, name, value)
        return msg


def _schema(cls):
    """The dataclass's attributes in declaration order, numbered 1, 2, ...
    (the three messages number their fields so), with the kinds their
    defaults imply."""
    def kind(f):
        if f.default_factory is list:
            return REPEATED_BYTES
        return {bytes: BYTES, int: INT32, float: FLOAT}[type(f.default)]

    cls.SCHEMA = tuple((f.name, number, kind(f))
                       for number, f in enumerate(fields(cls), start=1))
    return cls


@_schema
@dataclass
class EncRangeData(_Message):
    enc_values: bytes = b""           # 1: ElGamal pairs, 64 B stride
    rand_proof: bytes = b""           # 2: RandProofs (128 B each) or one compressed
    range_proof: list = field(default_factory=list)  # 3: one Bulletproof a partition
    range_bits: int = 0               # 4
    check_percentage: float = 0.0     # 5: proto3 float (fixed32)


@_schema
@dataclass
class EncNormData(_Message):
    enc_values: bytes = b""           # 1: SquareRandProofCommitments, 96 B stride
    square_proof: bytes = b""         # 2: SquareRandProofs, 192 B each
    range_proof: list = field(default_factory=list)  # 3: one Bulletproof a partition
    square_range_proof: bytes = b""   # 4: the L2 sum Bulletproof
    range_bits: int = 0               # 5
    l2_range_bits: int = 0            # 6


@_schema
@dataclass
class EncNormDataCompressed(_Message):
    enc_values: bytes = b""           # 1: SquareRandProofCommitments, 96 B stride
    square_proof: bytes = b""         # 2: SquareProofs, 160 B each
    rand_proof: bytes = b""           # 3: one CompressedRandProof (128 B)
    range_proof: list = field(default_factory=list)  # 4
    square_range_proof: bytes = b""   # 5
    range_bits: int = 0               # 6
    l2_range_bits: int = 0            # 7


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
