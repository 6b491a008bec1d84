"""The FL service's 19 messages, written and read by hand in the port
(``rofl_tpu_torch.fl.wire``), against the protobuf runtime
(``rofl_tpu.fl.proto``), both ways: the port's bytes equal the runtime's for
the same values, and each side reads the other's bytes to the same values.

Covered: the schema against the runtime's descriptor (names, numbers, kinds,
oneofs); seeded and ``hypothesis`` values of every message, nested and in
oneofs; empty oneof members and present empty sub-messages (written as
``tag 00``); negative int32 and enum values (ten-byte varints); non-ASCII
strings; packed and unpacked floats; -0.0, subnormals, inf and nan; merges of
a sub-message read twice and a oneof member replaced by another; unknown
fields; and invalid UTF-8, truncations and bad packed lengths, which raise
where the runtime raises. Tolerance: none."""

import numpy as np
import pytest
from google.protobuf import descriptor as D
from google.protobuf.message import DecodeError
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from rofl_tpu.fl import proto as pb
from rofl_tpu_torch.fl import wire

NAMES = ["ModelConfig", "CryptoConfig", "Config", "DataBlock", "MetaFloatBlockMessage",
         "FloatBlock", "ModelParametersMeta", "ModelParameters", "EncRangeData", "EncNormData",
         "EncNormDataCompressed", "WorkerRegisterMessage", "ModelRegisterResponse",
         "StatusMessage", "ErrorMessage", "ModelSelection", "ClientModelMessage",
         "ServerModelData", "TrainRequest", "TrainResponse"]
SCALAR_KIND = {D.FieldDescriptor.TYPE_INT32: wire.INT32, D.FieldDescriptor.TYPE_ENUM: wire.ENUM,
               D.FieldDescriptor.TYPE_UINT32: wire.UINT32, D.FieldDescriptor.TYPE_BOOL: wire.BOOL,
               D.FieldDescriptor.TYPE_FLOAT: wire.FLOAT, D.FieldDescriptor.TYPE_BYTES: wire.BYTES,
               D.FieldDescriptor.TYPE_STRING: wire.STRING}
MAX_INT32 = 2 ** 31 - 1


def runtime_class(name):
    return pb.ModelParametersMeta if name == "ModelParametersMeta" else getattr(pb, name)


def to_runtime(msg, out=None):
    """The runtime's message holding the port message's values."""
    out = runtime_class(type(msg).__name__)() if out is None else out
    for name, _, kind in msg.SCHEMA:
        value = getattr(msg, name)
        if isinstance(kind, type):
            if value is not None:
                getattr(out, name).SetInParent()
                to_runtime(value, getattr(out, name))
        elif kind in (wire.REPEATED_BYTES, wire.REPEATED_FLOAT):
            getattr(out, name).extend(value)
        else:
            setattr(out, name, value)
    return out


def from_runtime(ref, cls):
    """The port's message holding the runtime message's values."""
    values = {}
    for name, _, kind in cls.SCHEMA:
        if isinstance(kind, type):
            values[name] = from_runtime(getattr(ref, name), kind) if ref.HasField(name) else None
        elif kind in (wire.REPEATED_BYTES, wire.REPEATED_FLOAT):
            values[name] = list(getattr(ref, name))
        else:
            values[name] = getattr(ref, name)
    return cls(**values)


def both_ways(msg):
    """The port's bytes are the runtime's, and each side reads the other's
    to the same values."""
    ref = to_runtime(msg)
    data = msg.to_bytes()
    assert data == ref.SerializeToString()
    assert type(msg).from_bytes(data) == msg
    assert from_runtime(runtime_class(type(msg).__name__).FromString(data), type(msg)) == msg
    ours = type(msg).from_bytes(ref.SerializeToString())
    assert ours.to_bytes() == data
    if msg.ONEOF:
        assert ours.which_oneof() == ref.WhichOneof(ref.DESCRIPTOR.oneofs[0].name)
    return data


# -- the schema ----------------------------------------------------------------------


@pytest.mark.parametrize("name", NAMES)
def test_the_schema_is_the_descriptors(name):
    desc = runtime_class(name).DESCRIPTOR
    cls = getattr(wire, name)
    want = []
    for f in sorted(desc.fields, key=lambda f: f.number):
        if f.type == D.FieldDescriptor.TYPE_MESSAGE:
            kind = getattr(wire, f.message_type.name)
        elif f.is_repeated:
            kind = {D.FieldDescriptor.TYPE_BYTES: wire.REPEATED_BYTES,
                    D.FieldDescriptor.TYPE_FLOAT: wire.REPEATED_FLOAT}[f.type]
        else:
            kind = SCALAR_KIND[f.type]
        want.append((f.name, f.number, kind))
    assert list(cls.SCHEMA) == want
    oneofs = [tuple(f.name for f in o.fields) for o in desc.oneofs]
    assert list(cls.ONEOF) == (list(oneofs[0]) if oneofs else [])


# -- values ------------------------------------------------------------------------


def f32(x) -> float:
    return float(np.float32(x))


def random_message(cls, rng, depth=0):
    values = {}
    oneof_pick = rng.choice(list(cls.ONEOF)) if cls.ONEOF else None
    for name, _, kind in cls.SCHEMA:
        if isinstance(kind, type):
            if name in cls.ONEOF and name != oneof_pick:
                continue
            values[name] = random_message(kind, rng, depth + 1) if rng.random() < 0.8 else kind()
        elif kind in (wire.INT32, wire.ENUM):
            values[name] = int(rng.choice([0, 1, -1, MAX_INT32, -MAX_INT32 - 1,
                                           int(rng.integers(-1000, 1000))]))
        elif kind == wire.UINT32:
            values[name] = int(rng.choice([0, 1, 2 ** 32 - 1, int(rng.integers(0, 2 ** 32))]))
        elif kind == wire.BOOL:
            values[name] = bool(rng.random() < 0.5)
        elif kind == wire.FLOAT:
            values[name] = f32(rng.choice([0.0, -0.0, 0.7, 1e-45, np.inf, rng.standard_normal()]))
        elif kind == wire.BYTES:
            values[name] = rng.bytes(int(rng.choice([0, 1, 127, 128, 300])))
        elif kind == wire.STRING:
            values[name] = rng.choice(["", "adam", "sparse_categorical_crossentropy",
                                       "Größe ✓ 学習 🚀", "\x00nul"])
        elif kind == wire.REPEATED_BYTES:
            values[name] = [rng.bytes(int(n)) for n in rng.integers(0, 40, rng.integers(0, 4))]
        else:  # REPEATED_FLOAT
            values[name] = [f32(x) for x in rng.standard_normal(int(rng.choice([0, 1, 5, 40])))]
    return cls(**values)


@pytest.mark.parametrize("name", NAMES)
def test_seeded_values_are_the_runtimes_both_ways(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    for _ in range(25):
        both_ways(random_message(getattr(wire, name), rng))
    both_ways(getattr(wire, name)())  # every field at its default: no bytes
    assert getattr(wire, name)().to_bytes() == b""


def strategy(cls, depth=0):
    kinds = {wire.INT32: st.integers(-MAX_INT32 - 1, MAX_INT32),
             wire.ENUM: st.integers(-MAX_INT32 - 1, MAX_INT32),
             wire.UINT32: st.integers(0, 2 ** 32 - 1), wire.BOOL: st.booleans(),
             wire.FLOAT: st.floats(width=32, allow_nan=False),
             wire.BYTES: st.binary(max_size=40), wire.STRING: st.text(max_size=20),
             wire.REPEATED_BYTES: st.lists(st.binary(max_size=20), max_size=3),
             wire.REPEATED_FLOAT: st.lists(st.floats(width=32, allow_nan=False), max_size=8)}
    plain = {name: kinds[kind] if not isinstance(kind, type)
             else st.one_of(st.none(), strategy(kind, depth + 1))
             for name, _, kind in cls.SCHEMA if name not in cls.ONEOF}
    base = st.fixed_dictionaries(plain)
    if not cls.ONEOF:
        return base.map(lambda v: cls(**v))
    members = [st.just({})] + [
        strategy(kind, depth + 1).map(lambda m, name=name: {name: m})
        for name, _, kind in cls.SCHEMA if name in cls.ONEOF]
    return st.tuples(base, st.one_of(members)).map(lambda t: cls(**t[0], **t[1]))


@pytest.mark.parametrize("name", NAMES)
def test_hypothesis_values_are_the_runtimes_both_ways(name):
    @settings(max_examples=40, deadline=None, database=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(strategy(getattr(wire, name)))
    def check(msg):
        both_ways(msg)

    check()


# -- edge cases ------------------------------------------------------------------------


def test_empty_oneof_members_and_present_empty_messages_are_written():
    done = wire.TrainResponse(done_message=wire.StatusMessage(status=wire.STATUS_OK))
    assert both_ways(done) == bytes.fromhex("1a00")
    empty_block = wire.TrainRequest(params=wire.ModelParameters(param_block=wire.DataBlock()))
    assert both_ways(empty_block) == bytes.fromhex("12021200")
    assert both_ways(wire.StatusMessage(status=wire.STATUS_OK)) == b""  # TerminateModelTraining's OK
    config = wire.TrainResponse(params=wire.ServerModelData(config=wire.Config(
        model_config=wire.ModelConfig())))
    assert both_ways(config) == bytes.fromhex("0a040a020a00")
    ref = pb.TrainResponse()
    ref.params.config.model_config.model_id = 0  # the JAX server marks presence so
    assert ref.SerializeToString() == config.to_bytes()
    for status in (wire.STATUS_NOK, wire.STATUS_LATE, wire.STATUS_DONE):
        both_ways(wire.TrainResponse(done_message=wire.StatusMessage(status=status)))
    assert (wire.STATUS_OK, wire.STATUS_NOK, wire.STATUS_LATE, wire.STATUS_DONE) == (
        pb.STATUS_OK, pb.STATUS_NOK, pb.STATUS_LATE, pb.STATUS_DONE)


def test_negative_ints_are_ten_byte_varints():
    data = both_ways(wire.WorkerRegisterMessage(model_id=-1, client_id=-MAX_INT32 - 1))
    assert data[:11] == b"\x08" + b"\xff" * 9 + b"\x01"
    both_ways(wire.StatusMessage(status=-5))  # an open enum keeps unknown values
    both_ways(wire.MetaFloatBlockMessage(model_id=-3, round_id=MAX_INT32, num_blocks=-1,
                                         num_floats=7))


def test_non_ascii_strings_and_invalid_utf8():
    for text in ("Größe", "学習率 ✓", "🚀" * 40, "a\u0000b"):
        both_ways(wire.ErrorMessage(version=2, msg=text))
        both_ways(wire.ClientModelMessage(config=wire.ModelConfig(optimizer=text, loss=text)))
    for raw in (b"\xc3\x28", b"\xed\xa0\x80", b"\xc0\xaf", b"\xf4\x90\x80\x80", b"\xff", b"ab\x80"):
        data = b"\x12" + bytes([len(raw)]) + raw
        with pytest.raises(DecodeError):
            pb.ErrorMessage.FromString(data)
        with pytest.raises(ValueError):
            wire.ErrorMessage.from_bytes(data)
        nested = b"\x0a" + bytes([len(data)]) + data.replace(b"\x12", b"\x22", 1)  # optimizer
        with pytest.raises(DecodeError):
            pb.ClientModelMessage.FromString(nested)
        with pytest.raises(ValueError):
            wire.ClientModelMessage.from_bytes(nested)
    assert wire.DataBlock.from_bytes(b"\x12\x01\xff").data == b"\xff"  # bytes take any bytes


def test_floats_packed_unpacked_and_special():
    tiny = float(np.finfo(np.float32).smallest_subnormal)
    values = [0.0, -0.0, tiny, -tiny, f32(0.1), float("inf"), float("-inf"), f32(3.4e38)]
    block = wire.FloatBlock(block_number=9, floats=values)
    data = both_ways(block)
    assert data[2:4] == bytes([0x12, 4 * len(values)])  # packed: one length-delimited field
    nan = wire.FloatBlock(floats=[float("nan")]).to_bytes()
    assert nan == pb.FloatBlock(floats=[float("nan")]).SerializeToString()
    for config in (wire.ModelConfig(learning_rate=-0.0, lr_decay=tiny),
                   wire.CryptoConfig(check_percentage=float("nan"))):
        assert config.to_bytes() == to_runtime(config).SerializeToString()
    unpacked = b"\x08\x01" + b"".join(b"\x15" + np.float32(v).tobytes() for v in values[:4])
    mixed = unpacked + b"\x12\x08" + np.array([1.5, -2.0], "<f4").tobytes() + b"\x15" + \
        np.float32(7.0).tobytes()
    for data in (unpacked, mixed):
        ref = pb.FloatBlock.FromString(data)
        got = wire.FloatBlock.from_bytes(data)
        assert got.floats == list(ref.floats) and got.block_number == ref.block_number
        assert got.to_bytes() == ref.SerializeToString()  # written back packed
    with pytest.raises(DecodeError):
        pb.FloatBlock.FromString(b"\x12\x03abc")
    with pytest.raises(ValueError):
        wire.FloatBlock.from_bytes(b"\x12\x03abc")


def test_merges_and_oneof_replacement_are_the_runtimes():
    a = wire.ModelConfig(num_of_clients=3, optimizer="sgd", learning_rate=0.5).to_bytes()
    b = wire.ModelConfig(num_of_clients=4, loss="mse").to_bytes()
    twice = b"\x0a" + bytes([len(a)]) + a + b"\x0a" + bytes([len(b)]) + b
    ref = pb.Config.FromString(twice)
    got = wire.Config.from_bytes(twice)
    assert got == from_runtime(ref, wire.Config)
    assert (got.model_config.num_of_clients, got.model_config.optimizer,
            got.model_config.loss) == (4, "sgd", "mse")
    start = wire.TrainRequest(start_message=wire.WorkerRegisterMessage(model_id=1, client_id=2))
    status = wire.TrainRequest(status_message=wire.StatusMessage(status=wire.STATUS_LATE))
    for data in (start.to_bytes() + status.to_bytes(), status.to_bytes() + start.to_bytes(),
                 start.to_bytes() + wire.TrainRequest(start_message=wire.WorkerRegisterMessage(
                     client_id=9)).to_bytes()):
        ref = pb.TrainRequest.FromString(data)
        got = wire.TrainRequest.from_bytes(data)
        assert got.which_oneof() == ref.WhichOneof("param_message")
        assert got == from_runtime(ref, wire.TrainRequest)
        assert got.to_bytes() == ref.SerializeToString()
    with pytest.raises(ValueError):  # two members set cannot be written
        wire.TrainRequest(start_message=wire.WorkerRegisterMessage(),
                          params=wire.ModelParameters()).to_bytes()


def test_unknown_fields_mismatched_wire_types_and_truncation():
    msg = wire.DataBlock(block_number=5, data=b"xyz")
    data = msg.to_bytes()
    extra = b"\x18\x07" + b"\x25\x00\x00\x80\x3f" + b"\x0a\x01z" + b"\x2b\x08\x01\x2c"
    ref = pb.DataBlock.FromString(data + extra)  # field 1 as bytes: unknown to both
    got = wire.DataBlock.from_bytes(data + extra)
    assert (got.block_number, got.data) == (ref.block_number, ref.data) == (5, b"xyz")
    resp = wire.TrainResponse(params=wire.ServerModelData(model_block=wire.ModelParameters(
        param_block=wire.DataBlock(block_number=1, data=b"\x00" * 130)))).to_bytes()
    for whole, cls in ((data, wire.DataBlock), (resp, wire.TrainResponse)):
        refused = 0
        for cut in range(1, len(whole)):  # inside a field both raise, between fields both read
            try:
                ref = runtime_class(cls.__name__).FromString(whole[:cut])
            except DecodeError:
                refused += 1
                with pytest.raises(ValueError):
                    cls.from_bytes(whole[:cut])
            else:
                assert cls.from_bytes(whole[:cut]) == from_runtime(ref, cls)
        assert refused >= len(whole) - 3
    with pytest.raises(ValueError):
        wire.DataBlock(block_number=-1).to_bytes()
