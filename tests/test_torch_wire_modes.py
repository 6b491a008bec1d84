"""The hand-written ``EncRangeData`` and ``EncNormDataCompressed`` of the
port (``fl/wire.py``) against the protobuf runtime (``rofl_tpu.fl.proto``):
byte equality of the length-delimited frames, and the frames read back.

``check_percentage`` is a proto3 float: fixed32, left out when its bits are
all zero; 0.0, -0.0, 0.5, 0.7 and 1.0 are held, and 0.7 reads back as the
float32 the runtime gives (0.699999988...), from which the Range modes take
``num = round(d * check_percentage)``. Empty and many ``range_proof``
elements, field lengths 127 / 128 / 16 383 / 16 384 (the varint's width
steps), negative and zero ints. Groups (wire types 3 and 4) in a frame are
skipped as the runtime skips them, and refused where it refuses them. A
frame cut short is refused, whatever the JAX package's reader made of it
(its verdicts are in tests/data/torch_port_modes_kat.json). Tolerance:
none."""

import pytest

from rofl_tpu.fl import proto as pb
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl import wire
from test_torch_modes_kat import CUTS, cut_lengths, load_kat

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


# Bytes appended to (or, "_first", put before) a valid EncNormData payload.
# True where the protobuf runtime reads the message and skips them.
GROUP_CASES = {
    "empty_group_31": (b"\xfb\x01\xfc\x01", True),  # the case the JAX package reads
    "group_holding_a_varint": (b"\x0b\x08\x05\x0c", True),
    "group_holding_bytes": (b"\x0b\x12\x03abc\x0c", True),
    "nested_groups": (b"\x0b\x13\x08\x01\x14\x0c", True),
    "group_on_a_known_field": (b"\x2b\x08\x07\x2c", True),  # field 5, range_bits
    "group_first": (b"\x0b\x1d\x00\x00\x80\x3f\x0c", True),
    "groups_100_deep": (b"\x0b" * 100 + b"\x0c" * 100, True),
    "groups_101_deep": (b"\x0b" * 101 + b"\x0c" * 101, False),
    "stray_end_group": (b"\x0c", False),
    "mismatched_end_group": (b"\x0b\x14", False),
    "mismatched_nested_end_group": (b"\x0b\x13\x0c\x14", False),
    "unterminated_group": (b"\x0b\x08\x01", False),
    "group_then_stray_end": (b"\x0b\x0c\x0c", False),
    "truncated_bytes_in_group": (b"\x0b\x12\x05ab\x0c", False),
    "wire_type_6": (b"\x0e", False),
    "wire_type_7": (b"\x0f\x00", False),
    "wire_type_6_in_group": (b"\x0b\x0e\x0c", False),
    "field_0": (b"\x00\x05", False),
    "field_above_2_29": (b"\x80\x80\x80\x80\x10\x01", False),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_groups_read_as_the_protobuf_runtime_reads_them(case):
    extra, runtime_reads = GROUP_CASES[case]
    payload = pb.EncNormData(enc_values=b"\x01" * 96, range_proof=[b"r"], range_bits=8,
                             l2_range_bits=16).SerializeToString()
    data = extra + payload if case.endswith("_first") else payload + extra
    ref = pb.EncNormData()
    try:
        ref.ParseFromString(data)
        reads = True
    except Exception:  # noqa: BLE001 - the runtime's DecodeError
        reads = False
    assert reads == runtime_reads
    if not reads:
        with pytest.raises(ValueError):
            wire.EncNormData.from_bytes(data)
        return
    got = wire.EncNormData.from_bytes(data)
    assert got == wire.EncNormData.from_bytes(payload)
    assert (got.enc_values, got.range_proof, got.range_bits, got.l2_range_bits) == (
        ref.enc_values, list(ref.range_proof), ref.range_bits, ref.l2_range_bits)
    assert got.l2_range_bits == 16


@pytest.mark.parametrize("message", ["EncRangeData", "EncNormData", "EncNormDataCompressed"])
def test_every_envelope_skips_a_group(message):
    ref = getattr(pb, message)(enc_values=b"\x07" * 3, range_bits=9)
    data = b"\xfb\x01\x08\x01\xfc\x01" + ref.SerializeToString() + b"\x1b\x1c"
    check = getattr(pb, message)()
    check.ParseFromString(data)
    got = getattr(wire, message).from_bytes(data)
    assert (got.enc_values, got.range_bits) == (check.enc_values, check.range_bits) == (
        b"\x07" * 3, 9)


KAT = load_kat()


@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("name", sorted(KAT["modes"]))
def test_a_cut_frame_is_refused_whatever_the_jax_reader_made_of_it(name, cut):
    """The port refuses a frame shorter than its length prefix, as prost
    does. The JAX package's reader parses what is there instead, and its
    verdict on each cut frame, recorded in the KAT by the JAX package itself,
    is a refusal too: its protobuf runtime raises on a cut inside a field; a
    cut before the last field reads that field as 0, and then its verifier
    raises (EncRange, EncRangeCompressed: check_percentage 0 leaves no range
    proof to check, and the batch verifier raises on none) or refuses
    (EncL2Compressed: l2_range_bits 0)."""
    case = KAT["modes"][name]
    frame = bytes.fromhex(case["serialized"])
    recorded = KAT["cuts"][name][cut]
    assert recorded["length"] == cut_lengths(frame)[cut] < len(frame)
    assert recorded["jax"] == "refuses" or recorded["jax"].startswith("raises ")
    with pytest.raises(ValueError, match="truncated"):
        P.deserialize(case["enc_type"], frame[:recorded["length"]], FpConfig(*KAT["fp"]), "cpu")
