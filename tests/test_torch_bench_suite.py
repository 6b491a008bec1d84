"""``rofl_tpu_torch.bench_suite`` against ``rofl_tpu.bench_suite`` on the CPU:
the same benches under the same names, the same options and defaults (but
``--out``, whose JAX default holds tracked files, and the port's
``--device``), the same file names and lines; then one cheap bench of the
port (``addelgamal`` at d = 16, one sample: about 20 s, most of it the
fixed-base tables in plain torch) writes one file of one integer line. No
JAX bench runs."""

import argparse
import datetime as real_datetime
import re
from unittest import mock

import pytest

from rofl_tpu import bench_suite as JB
from rofl_tpu_torch import bench_suite as TB


class StopParsing(Exception):
    pass


def jax_parser() -> argparse.ArgumentParser:
    """The parser ``rofl_tpu.bench_suite.main`` builds, caught as it parses."""
    caught = {}

    def parse_args(self, args=None, namespace=None):
        caught["parser"] = self
        raise StopParsing

    with mock.patch.object(argparse.ArgumentParser, "parse_args", parse_args):
        with pytest.raises(StopParsing):
            JB.main([])
    return caught["parser"]


def options(ap: argparse.ArgumentParser) -> dict:
    return {a.dest: (a.option_strings, a.default, a.nargs, a.type, a.const, type(a).__name__)
            for a in ap._actions if a.dest not in ("help", "out", "device")}


def test_the_same_benches_under_the_same_names(capsys):
    assert list(TB.BENCHES) == list(JB.BENCHES)
    assert len(TB.BENCHES) == 11
    JB.main(["--list"])
    jax_out = capsys.readouterr().out
    assert TB.main(["--list"]) is None
    assert capsys.readouterr().out == jax_out


def test_the_same_options_and_defaults():
    port = TB.parser()
    assert options(port) == options(jax_parser())
    assert port.get_default("out") == "build/bench_suite"
    assert port.get_default("device") == "cuda"
    assert TB.DEFAULT_DIMS == JB.DEFAULT_DIMS == [32768, 131072, 524288]


class FixedDatetime:
    class datetime:
        @staticmethod
        def now():
            return real_datetime.datetime(2026, 3, 4, 5, 6, 7)


@pytest.mark.parametrize("name, parts", [
    ("create-rangeproof", [16, "08", 32768]), ("bench_paper_addelgamal", [16]),
    ("bench_paper_dlog2", [16, 65536, 999]), ("verify-randproof", [16, 1000]),
])
def test_bench_file_names(name, parts, tmp_path, monkeypatch):
    monkeypatch.setattr(JB, "datetime", FixedDatetime)
    monkeypatch.setattr(TB, "datetime", FixedDatetime)
    got = TB._bench_file(str(tmp_path), name, parts)
    assert got == JB._bench_file(str(tmp_path), name, parts)
    assert got.endswith("-(2026-03-04-05-06-07).bench")


def test_record_writes_the_same_lines(tmp_path):
    samples = [0.4, 0.5, 1.5, 2.5, 12.6, 999.5, 12345.678]
    for module, name in ((JB, "jax"), (TB, "port")):
        for ms in samples:
            module._record(str(tmp_path / name), ms)
    assert (tmp_path / "port").read_bytes() == (tmp_path / "jax").read_bytes()


def test_addelgamal_on_the_cpu_writes_one_integer_line(tmp_path, capsys):
    results = TB.main(["--bench", "addelgamal", "--dims", "16", "--samples", "1",
                       "--device", "cpu", "--out", str(tmp_path)])
    (path,) = tmp_path.iterdir()
    assert re.fullmatch(r"bench_paper_addelgamal-16-\(\d{4}(-\d\d){5}\)\.bench", path.name)
    assert re.fullmatch(r"\d+\n", path.read_text())
    assert [(r["name"], r["parts"], len(r["ms"])) for r in results] == [
        ("bench_paper_addelgamal", [16], 1)]
    assert int(path.read_text()) == round(results[0]["ms"][0])


@pytest.mark.parametrize("d", [256, 32768])
def test_l2rangeproof_values_exceed_the_l2_bound_in_both_packages(d, tmp_path):
    """Reference hazard 14: the bench draws values up to 1/64 of the clip
    bound, and at range 8 their squared sum passes the L2 bound (255/128)
    only below d = 256: both benches raise L2NormError before proving."""
    from rofl_tpu.crypto.l2_range_proof import L2NormError as JaxL2NormError
    from rofl_tpu_torch.crypto.l2_range_proof import L2NormError

    with pytest.raises(JaxL2NormError):
        JB.bench_l2rangeproof(JB.Suite(16, 7, 8, str(tmp_path / "jax"), 1), d)
    with pytest.raises(L2NormError):
        TB.bench_l2rangeproof(TB.Suite(16, 7, 8, str(tmp_path / "port"), 1, "cpu"), d)
