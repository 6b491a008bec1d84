"""The port's chunked transport helpers, model files and bench logs
(``rofl_tpu_torch.fl.util``, ``fl.logs``) against the JAX package's
(``rofl_tpu.fl.util``, ``fl.logs``): the same chunks, the same reassembly,
model files equal byte for byte (f"{v}" of numpy float32s: -0.0,
subnormals, inf, nan), the same model read back, and the same bench lines
under one patched clock. Tolerance: none."""

import logging
import time

import numpy as np
import pytest

from rofl_tpu.fl import logs as jlogs
from rofl_tpu.fl import util as jutil
from rofl_tpu_torch.fl import logs as tlogs
from rofl_tpu_torch.fl import util as tutil


def test_the_constants_are_the_jax_packages():
    assert (tutil.CHUNK_SIZE, tutil.NUM_FLOATS_PACKET) == (jutil.CHUNK_SIZE,
                                                           jutil.NUM_FLOATS_PACKET) == (1 << 20,
                                                                                        10000)


@pytest.mark.parametrize("size,chunk", [(0, 4), (1, 4), (4, 4), (5, 4), (17, 4),
                                        (3 * (1 << 20) + 1, 1 << 20)])
def test_chunk_bytes_is_the_jax_packages(size, chunk):
    data = np.random.default_rng(size).bytes(size)
    got = tutil.chunk_bytes(data, chunk)
    assert got == jutil.chunk_bytes(data, chunk)
    assert b"".join(got) == data and len(got) == max(1, -(-size // chunk))
    assert tutil.chunk_bytes(b"") == [b""]


def test_data_block_storage_reassembles_as_the_jax_package():
    rng = np.random.default_rng(3)
    blocks = [rng.bytes(int(n)) for n in rng.integers(0, 50, size=7)]
    stores = (tutil.DataBlockStorage(), jutil.DataBlockStorage())
    for s in stores:
        assert not s.is_done() and s.round_id == -1
        s.init(4, len(blocks))
    for i in rng.permutation(len(blocks)):
        got = [s.apply(int(i), blocks[i]) for s in stores]
        assert got == [True, True]
        assert stores[0].is_done() == stores[1].is_done()
    for bad in (-1, len(blocks), 10 ** 6):  # out of range: refused, nothing stored
        assert [s.apply(bad, b"x") for s in stores] == [False, False]
    assert stores[0].is_done() and stores[0].data() == stores[1].data() == b"".join(blocks)
    assert stores[0].round_id == 4
    stores[0].init(-1, 0)
    assert not stores[0].is_done()  # no blocks announced: never done


def special_floats(rng):
    tiny = np.finfo(np.float32).smallest_subnormal
    edges = np.array([0.0, -0.0, 0.1, -0.1, 1 / 3, 1.0, -1.0, 1e-45, tiny, -tiny, tiny * 7,
                      np.finfo(np.float32).tiny, np.finfo(np.float32).max,
                      -np.finfo(np.float32).max, np.inf, -np.inf, np.nan, 1e38, 1e-38,
                      123456789.0, 0.001, 2 ** -7], np.float32)
    normal = rng.standard_normal(200).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -30, 30, size=200).astype(np.float32)
    bits = rng.integers(0, 1 << 32, size=200, dtype=np.uint64).astype(np.uint32).view(np.float32)
    return np.concatenate([edges, normal, bits])


def test_model_files_are_the_jax_packages_byte_for_byte(tmp_path):
    values = special_floats(np.random.default_rng(5))
    tutil.write_model_to_file(str(tmp_path / "port.txt"), values)
    jutil.write_model_to_file(str(tmp_path / "jax.txt"), values)
    port = (tmp_path / "port.txt").read_bytes()
    assert port == (tmp_path / "jax.txt").read_bytes()
    # f"{v}" of a numpy float32: under numpy 2 the float32 widened to a
    # Python float ("0.10000000149011612"), which reads back as the float32
    assert port.startswith(b"0.0\n-0.0\n") and b"\ninf\n-inf\nnan\n" in port
    back = tutil.read_model_from_file(str(tmp_path / "port.txt"))
    np.testing.assert_array_equal(back, jutil.read_model_from_file(str(tmp_path / "jax.txt")))
    np.testing.assert_array_equal(back, values)  # nan == nan here; -0.0 keeps its sign
    assert np.signbit(back[1]) and back.dtype == np.float32


def test_a_model_file_of_the_repo_reads_as_with_the_jax_package():
    path = "models/mnist_dev_intrinsic_5k.txt"
    got = tutil.read_model_from_file(path)
    assert got.dtype == np.float32 and got.shape == (5000,)
    np.testing.assert_array_equal(got, jutil.read_model_from_file(path))


def test_unparsable_lines_are_skipped_as_by_the_jax_reader(tmp_path):
    path = tmp_path / "m.txt"
    path.write_text("1.5\n\n  \nabc\n-2\n1e3\nnan\n0x10\n")
    np.testing.assert_array_equal(tutil.read_model_from_file(str(path)),
                                  jutil.read_model_from_file(str(path)))


def test_bench_lines_are_the_jax_packages(tmp_path, monkeypatch, caplog):
    clock = iter([10.0, 10.0012345, 10.5, 12.25, 12.2500004, 20.0, 20.0, 20.1, 20.3] * 2)
    monkeypatch.setattr(time, "monotonic", lambda: next(clock))
    lines = []
    for logs, name in ((tlogs, "port"), (jlogs, "jax")):
        bench = logs.BenchLogger(str(tmp_path / name), "client3")
        ts = logs.TimeState()
        assert ts.total_ms() == 0.0 and ts.deltas_ms() == []
        for _ in range(5):
            ts.record()
        ts.log_bench_times(bench, 7)
        ts.reset()
        for _ in range(4):
            ts.record()
        ts.log_bench_times_with_bandwidth(bench, 8, 1 << 20, 12345)
        lines.append((tmp_path / name / "client3.bench").read_text())
    assert lines[0] == lines[1]
    assert lines[0].splitlines() == ["7, 1.235, 498.765, 1750.000, 0.000, 2250.000",
                                     "8, 0.000, 100.000, 200.000, 300.000, 1048576, 12345"]
    with caplog.at_level(logging.INFO, logger="rofl_tpu_torch"):
        tlogs.BenchLogger("", "x").log("1, 2.000")  # no log_dir: the logger only
    assert "[BENCH] 1, 2.000" in caplog.text
