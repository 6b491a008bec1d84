"""The upload's wire form, read by the benchmark itself: a varint length
prefix, then one protobuf message (EncRangeData or EncNormData of RoFL's
flservice.proto) whose fields are bytes, repeated bytes, int32 and float."""

from __future__ import annotations

import struct

# field number → name, per message
ENC_RANGE_DATA = {1: "enc_values", 2: "rand_proof", 3: "range_proof", 4: "range_bits",
                  5: "check_percentage"}
ENC_NORM_DATA = {1: "enc_values", 2: "square_proof", 3: "range_proof",
                 4: "square_range_proof", 5: "range_bits", 6: "l2_range_bits"}
REPEATED = {"range_proof"}


def _varint(data: bytes, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        if i >= len(data) or shift > 63:
            raise ValueError("truncated varint")
        b = data[i]
        value |= (b & 0x7F) << shift
        i += 1
        if not b & 0x80:
            return value, i
        shift += 7


def parse_upload(data: bytes, fields: dict) -> dict:
    """The fields of a length-delimited message; raises ValueError on bytes
    that are not one whole message of this schema."""
    n, i = _varint(data, 0)
    if i + n != len(data):
        raise ValueError("length prefix does not match the upload")
    out: dict = {name: [] for name in REPEATED if name in fields.values()}
    while i < len(data):
        key, i = _varint(data, i)
        num, wire_type = key >> 3, key & 7
        name = fields.get(num)
        if name is None:
            raise ValueError(f"unknown field {num}")
        if wire_type == 2:
            size, i = _varint(data, i)
            value = data[i:i + size]
            if len(value) != size:
                raise ValueError("truncated field")
            i += size
        elif wire_type == 0:
            value, i = _varint(data, i)
        elif wire_type == 5:
            value = struct.unpack("<f", data[i:i + 4])[0]
            i += 4
        else:
            raise ValueError(f"wire type {wire_type}")
        if name in REPEATED:
            out[name].append(value)
        else:
            out[name] = value
    return out
