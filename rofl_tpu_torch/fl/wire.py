"""The protobuf wire format of ``EncNormData``, written and read by hand.

Counterpart of the ``EncNormData`` message of ``rofl_tpu/fl/proto``
(flservice.proto:99-106) and of its length-delimited framing
(``encode_length_delimited`` / ``decode_length_delimited``, as prost frames
params.rs serialize()). The port needs neither ``google.protobuf`` nor
``protoc``: the message is six fields, four ``bytes`` (one repeated) and two
``int32``, encoded as proto3 encodes them, byte-identical to the protobuf
runtime's output. Fields go out in field-number order; a ``bytes`` field that
is empty and an ``int32`` that is 0 are left out, every element of a
repeated field is written. The reader takes fields in any order, keeps the
last value of a singular field and skips fields it does not know.
"""

from __future__ import annotations

from dataclasses import dataclass, field

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


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


@dataclass
class EncNormData:
    enc_values: bytes = b""           # 1: SquareRandProofCommitments, 96 B stride
    square_proof: bytes = b""         # 2: SquareRandProofs, 192 B each
    range_proof: list = field(default_factory=list)  # 3: one Bulletproof a partition
    square_range_proof: bytes = b""   # 4: the L2 sum Bulletproof
    range_bits: int = 0               # 5
    l2_range_bits: int = 0            # 6

    def to_bytes(self) -> bytes:
        out = bytearray()

        def put_bytes(number, value):
            out.extend(encode_varint(number << 3 | _LEN) + encode_varint(len(value)))
            out.extend(value)

        for number, value in ((1, self.enc_values), (2, self.square_proof)):
            if value:
                put_bytes(number, value)
        for value in self.range_proof:
            put_bytes(3, value)
        if self.square_range_proof:
            put_bytes(4, self.square_range_proof)
        for number, value in ((5, self.range_bits), (6, self.l2_range_bits)):
            if value:
                out.extend(encode_varint(number << 3 | _VARINT) + encode_varint(_int32(value)))
        return bytes(out)

    @classmethod
    def from_bytes(cls, data: bytes) -> "EncNormData":
        msg = cls()
        i = 0
        while i < len(data):
            key, i = decode_varint(data, i)
            number, kind = key >> 3, key & 7
            if kind == _VARINT:
                value, i = decode_varint(data, i)
            elif kind == _LEN:
                length, i = decode_varint(data, i)
                if i + length > len(data):
                    raise ValueError("truncated length-delimited field")
                value, i = bytes(data[i:i + length]), i + length
            elif kind in (_I64, _I32):
                i += 8 if kind == _I64 else 4
                continue
            else:
                raise ValueError(f"unsupported wire type {kind}")
            if number == 1 and kind == _LEN:
                msg.enc_values = value
            elif number == 2 and kind == _LEN:
                msg.square_proof = value
            elif number == 3 and kind == _LEN:
                msg.range_proof.append(value)
            elif number == 4 and kind == _LEN:
                msg.square_range_proof = value
            elif number == 5 and kind == _VARINT:
                msg.range_bits = _int32(value)
            elif number == 6 and kind == _VARINT:
                msg.l2_range_bits = _int32(value)
        if i != len(data):
            raise ValueError("truncated field")
        return msg


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
