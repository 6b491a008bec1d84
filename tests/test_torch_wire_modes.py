"""The hand-written ``EncRangeData`` and ``EncNormDataCompressed`` of the
port (``fl/wire.py``) against the protobuf runtime (``rofl_tpu.fl.proto``):
byte equality of the length-delimited frames, and the frames read back.

``check_percentage`` is a proto3 float: fixed32, left out when its bits are
all zero; 0.0, -0.0, 0.5, 0.7 and 1.0 are held, and 0.7 reads back as the
float32 the runtime gives (0.699999988...), from which the Range modes take
``num = round(d * check_percentage)``. Empty and many ``range_proof``
elements, field lengths 127 / 128 / 16 383 / 16 384 (the varint's width
steps), negative and zero ints. Tolerance: none."""

import pytest

from rofl_tpu.fl import proto as pb
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl import wire

RANGE_CASES = {
    "empty": {},
    "float_zero": dict(check_percentage=0.0, range_bits=8),
    "float_negative_zero": dict(check_percentage=-0.0),
    "float_half": dict(check_percentage=0.5),
    "float_0_7": dict(check_percentage=0.7, range_bits=8),
    "float_one": dict(check_percentage=1.0, range_bits=16),
    "negative_int": dict(range_bits=-3, check_percentage=0.25),
    "len_127": dict(enc_values=b"\x01" * 127, range_proof=[b""]),
    "len_128": dict(rand_proof=b"\x02" * 128, check_percentage=1.0),
    "len_16383": dict(enc_values=b"\x03" * 16383, range_proof=[b"a", b"", b"bc"]),
    "len_16384": dict(rand_proof=b"\x04" * 16384, range_bits=2 ** 31 - 1),
    "many_range_proofs": dict(enc_values=b"\x05" * 64, rand_proof=b"\x06" * 128,
                              range_proof=[bytes([i]) * (i * 37) for i in range(40)],
                              range_bits=8, check_percentage=0.7),
}
COMPRESSED_CASES = {
    "empty": {},
    "ints_only": dict(range_bits=8, l2_range_bits=16),
    "negative_int": dict(l2_range_bits=-1),
    "len_127": dict(enc_values=b"\x01" * 127, range_proof=[b""]),
    "len_128": dict(rand_proof=b"\x02" * 128, square_proof=b"\x03"),
    "len_16383": dict(square_proof=b"\x04" * 16383, range_proof=[b"a", b"", b"bc"]),
    "len_16384": dict(square_range_proof=b"\x05" * 16384, l2_range_bits=2 ** 31 - 1),
    "all": dict(enc_values=b"\x06" * 300, square_proof=b"\x07" * 20000, rand_proof=b"\x08" * 128,
                range_proof=[b"x" * 129] * 16, square_range_proof=b"\x09" * 5, range_bits=300,
                l2_range_bits=1),
}


def runtime_frame(message_type, fields):
    ref = message_type(**{k: v for k, v in fields.items() if k != "range_proof"})
    ref.range_proof.extend(fields.get("range_proof", []))
    return pb.encode_length_delimited(ref)


@pytest.mark.parametrize("case", sorted(RANGE_CASES))
def test_enc_range_data_encodes_as_the_protobuf_runtime(case):
    fields = RANGE_CASES[case]
    want = runtime_frame(pb.EncRangeData, fields)
    assert wire.encode_length_delimited(wire.EncRangeData(**fields).to_bytes()) == want
    got = wire.EncRangeData.from_bytes(wire.decode_length_delimited(want))
    ref = pb.decode_length_delimited(pb.EncRangeData, want)
    assert got.check_percentage == ref.check_percentage
    assert (got.enc_values, got.rand_proof, got.range_proof, got.range_bits) == (
        ref.enc_values, ref.rand_proof, list(ref.range_proof), ref.range_bits)


@pytest.mark.parametrize("case", sorted(COMPRESSED_CASES))
def test_enc_norm_data_compressed_encodes_as_the_protobuf_runtime(case):
    fields = COMPRESSED_CASES[case]
    want = runtime_frame(pb.EncNormDataCompressed, fields)
    assert wire.encode_length_delimited(wire.EncNormDataCompressed(**fields).to_bytes()) == want
    assert wire.EncNormDataCompressed.from_bytes(
        wire.decode_length_delimited(want)) == wire.EncNormDataCompressed(**fields)


@pytest.mark.parametrize("d", [7, 10, 50000])
def test_the_checked_count_after_a_round_trip_is_the_runtimes(d):
    """0.7 comes back as float32; both packages round d times that value
    half to even."""
    frame = runtime_frame(pb.EncRangeData, dict(check_percentage=0.7))
    got = wire.EncRangeData.from_bytes(wire.decode_length_delimited(frame)).check_percentage
    ref = pb.decode_length_delimited(pb.EncRangeData, frame).check_percentage
    assert got == ref != 0.7
    assert P._checked_count(d, got) == int(round(d * ref))
    assert P._checked_count(7, 0.5) == 4 and P._checked_count(5, 0.5) == 2  # half to even


def test_unknown_fields_are_skipped_and_truncation_is_refused():
    frame = runtime_frame(pb.EncRangeData, dict(range_bits=8, check_percentage=0.5))
    payload = wire.decode_length_delimited(frame)
    extra = bytes([9 << 3 | 5]) + b"\x00\x00\x80\x3f" + bytes([10 << 3 | 0, 5])
    assert wire.EncRangeData.from_bytes(payload + extra) == wire.EncRangeData.from_bytes(payload)
    with pytest.raises(ValueError):
        wire.EncRangeData.from_bytes(payload[:-1])
