"""The port's experiment tooling against the JAX package's, on the CPU: the
YAML writer (``yaml_subset.safe_dump``) against ``yaml.safe_load`` and the
port's reader; ``rofl_tpu_torch.scripts.parse_benchlog``,
``run_e2e_suite.make_config`` / ``parse_logs`` and ``gen_init_models``
against ``scripts/*.py`` (loaded from their files: the JAX scripts are no
package); ``utils/profiling.py``. Outputs are held byte for byte where
the scripts print or write text, as dicts where PyYAML sorts keys, and θ0
within the models KAT's 4 ulps (``tests/test_torch_models.py``)."""

import importlib.util
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from rofl_tpu_torch.fl.yaml_subset import YamlSubsetError, safe_dump, safe_load
from rofl_tpu_torch.scripts import gen_init_models, parse_benchlog, run_e2e_suite
from rofl_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yml"))
MODES = ["Plain", "Range", "l2", "RangeCompressed", "l2Compressed"]
KAT = np.load(ROOT / "tests" / "data" / "torch_port_models_kat.npz")


def jax_script(name):
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- safe_dump -------------------------------------------------------------------

EDGE_VALUES = {
    "float_text": "1.0", "true_text": "true", "null_text": "null", "tilde": "~",
    "hex_text": "0x10", "empty": "", "leading_space": " lead", "trailing_space": "x ",
    "hash": "#x", "inner_hash": "a #b", "colon_space": "a: b", "trailing_colon": "a:",
    "dash": "- x", "date": "2001-12-14", "sexagesimal": "1:30", "yes": "yes", "off": "Off",
    "single_quotes": "'q'", "double_quotes": '"dq"', "backslash": "a\\b", "tab": "a\tb",
    "newline": "a\nb", "accent": "é", "line_separator": " ", "emoji": "\U0001f600",
    "octal_text": "012", "underscore_int": "1_000", "inf_text": ".inf", "bang": "!x",
    "amp": "&x", "star": "*x", "brace": "{a}", "bracket": "[a]", "pipe": "|", "gt": ">",
    "percent": "%x", "at": "@x", "backtick": "`x", "comma": "a, b", "question": "? x",
    "plain_path": "models/mnist_dev_initialized.txt", "plain_words": "a b c",
    "int": 7, "negative": -12, "big": 10**30, "zero_float": 0.0, "negative_zero": -0.0,
    "float": 0.01, "small": 1e-05, "large": 1e16, "inf": math.inf, "minus_inf": -math.inf,
    "nan": math.nan, "true": True, "false": False, "none": None,
    "nested": {"a": {"b": 1, "c": "d"}, "e": 2.5},
}


def read_back(text):
    return yaml.safe_load(text), safe_load(text)


@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_safe_dump_gives_back_every_experiment_file(path):
    doc = yaml.safe_load(path.read_text())
    for got in read_back(safe_dump(doc)):
        assert repr(got) == repr(doc)


@pytest.mark.parametrize("mode", MODES)
def test_safe_dump_gives_back_the_jax_suites_configs(mode, tmp_path):
    jax_suite = jax_script("run_e2e_suite")
    jax_suite.make_config(str(ROOT / "configs" / "example_config.yml"), mode, 4, 3,
                          str(tmp_path / "jax.yml"))
    doc = yaml.safe_load((tmp_path / "jax.yml").read_text())
    for got in read_back(safe_dump(doc)):
        assert repr(got) == repr(doc)
    run_e2e_suite.make_config(str(ROOT / "configs" / "example_config.yml"), mode, 4, 3,
                              str(tmp_path / "port.yml"))
    for got in read_back((tmp_path / "port.yml").read_text()):
        assert got == doc


@pytest.mark.parametrize("key", sorted(EDGE_VALUES))
def test_safe_dump_gives_back_edge_values(key):
    doc = {"section": {f"v_{key}": EDGE_VALUES[key]}, "key with spaces": 1, 1: "one"}
    for got in read_back(safe_dump(doc)):
        assert repr(got) == repr(doc)
    # strings the reader would resolve to something else are quoted
    if isinstance(EDGE_VALUES[key], str) and key not in ("plain_path", "plain_words"):
        assert f'v_{key}: "' in safe_dump(doc)


@pytest.mark.parametrize("doc", [
    {"a": [1, 2]}, {"a": (1,)}, {"a": {1, 2}}, {"a": {}}, {}, [1], "a", {"a": b"x"},
    {"a": {"b": [1]}}, {"a: b": 1}, {"#a": 1}, {" a": 1}, {"1": "a key read as an int"},
    {"a": np.float32(1)},
], ids=repr)
def test_safe_dump_refuses_what_the_subset_cannot_hold(doc):
    with pytest.raises(YamlSubsetError):
        safe_dump(doc)


# -- parse_benchlog --------------------------------------------------------------

BENCHES = {
    "server_model1.bench": "0, 12.5, 300.25, 40.0, 352.75\n1, 10.0, 290.0, 38.5, 338.5\n",
    # 8 columns: round, recv, train, encrypt, send, total, bytes_recv, bytes_sent
    "client0.bench": "0, 1.5, 20.25, 300.0, 4.0, 325.75, 152736, 9000\n\n"
                     "1, 1.25, 18.0, 280.5, 3.5, 303.25, 152736, 9001\n"
                     "round, recv, train\n"
                     "2, 1.0, 17.0, 279.0, 3.0, 300.0, 152736, 9002\n",
    # 7 columns, one round
    "client1.bench": "0, 2.0, 21.0, 310.0, 5.0, 338.0, 152736\n",
    "client2.bench": "0, 1.0, 2.0, 3.0\n1, 2.0, 3.0, 4.0\n",
    "empty.bench": "\n",
    "notes.txt": "0, 1, 2\n",
}


def jax_parse_benchlog(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["parse_benchlog.py", *argv])
    return jax_script("parse_benchlog").main()


def test_parse_benchlog_prints_and_writes_what_the_jax_script_does(tmp_path, monkeypatch,
                                                                   capsys):
    logdir = tmp_path / "logs"
    logdir.mkdir()
    for name, text in BENCHES.items():
        (logdir / name).write_text(text)
    csv_path = str(tmp_path / "table.csv")
    out = {}
    for side, run in (("jax", lambda a: jax_parse_benchlog(a, monkeypatch)),
                      ("port", parse_benchlog.main)):
        assert run([str(logdir)]) == 0
        printed = capsys.readouterr().out
        assert run([str(logdir), "--csv", csv_path]) == 0
        out[side] = (printed, capsys.readouterr().out, Path(csv_path).read_bytes())
    assert out["port"] == out["jax"]
    assert "client0" in out["port"][0] and "server_model1" in out["port"][0]


def test_parse_benchlog_on_an_empty_directory(tmp_path, monkeypatch, capsys):
    rc_jax = jax_parse_benchlog([str(tmp_path)], monkeypatch)
    jax_out = capsys.readouterr()
    rc_port = parse_benchlog.main([str(tmp_path)])
    port_out = capsys.readouterr()
    assert rc_port == rc_jax == 1
    assert (port_out.out, port_out.err) == (jax_out.out, jax_out.err)


# -- run_e2e_suite.parse_logs ----------------------------------------------------

OBSERVER_LOG = """2026-01-01 00:00:00 rofl_tpu_torch.observer INFO observing model 1 at 127.0.0.1:1
2026-01-01 00:00:01 rofl_tpu_torch.observer INFO [EVAL] (0, 2.302585, 0.101562)
2026-01-01 00:00:02 rofl_tpu_torch.observer INFO [EVAL] (1, nan, 0.2)
2026-01-01 00:00:03 rofl_tpu_torch.observer INFO [EVAL] (2, 1.984512, 0.353516)
2026-01-01 00:00:04 rofl_tpu_torch.observer INFO [EVAL] observer done
"""


@pytest.mark.parametrize("observer", [True, False])
def test_parse_logs_reads_what_the_jax_suite_reads(tmp_path, observer):
    for name, text in BENCHES.items():
        (tmp_path / name).write_text(text)
    if observer:
        (tmp_path / "observer.log").write_text(OBSERVER_LOG)
    got = run_e2e_suite.parse_logs(str(tmp_path))
    assert got == jax_script("run_e2e_suite").parse_logs(str(tmp_path))
    assert got[2] == (0.353516 if observer else None)


# -- gen_init_models -------------------------------------------------------------


def ulps(got, want):
    return np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))


def test_gen_init_models_writes_the_committed_files_and_the_flax_init(tmp_path):
    gen_init_models.main(["--out", str(tmp_path), "--full", "--device", "cpu"])
    committed = sorted((ROOT / "models").glob("*_intrinsic_*.txt"))
    assert len(committed) == 7
    for path in committed:
        assert (tmp_path / path.name).read_bytes() == path.read_bytes()
    jax_gen = jax_script("gen_init_models")
    for name, fname in gen_init_models.FULL_FILES:
        text = (tmp_path / fname).read_text()
        got = np.array(text.split(), dtype=np.float32)
        want = KAT[f"theta0/{name}"]
        assert got.shape == want.shape
        assert np.max(ulps(got, want)) <= 4
        jax_gen.write_vec(str(tmp_path / "jax.txt"), got)
        assert (tmp_path / "jax.txt").read_text() == text


# -- profiling -------------------------------------------------------------------


def test_device_trace_is_a_no_op_without_a_directory(tmp_path, monkeypatch):
    monkeypatch.delenv("ROFL_TRACE_DIR", raising=False)
    monkeypatch.chdir(tmp_path)

    def refuse(*args, **kwargs):
        raise AssertionError("the profiler started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with profiling.device_trace(None):
        torch.ones(4).sum()
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("from_env", [False, True])
def test_device_trace_writes_a_trace_with_the_annotation(tmp_path, monkeypatch, from_env):
    logdir = tmp_path / "trace"
    if from_env:
        monkeypatch.setenv("ROFL_TRACE_DIR", str(logdir))
    with profiling.device_trace(None if from_env else str(logdir)):
        with profiling.span("rofl-prove-phase"):
            torch.ones(64).cumsum(0)
    (trace,) = logdir.iterdir()
    assert trace.name == f"trace_{os.getpid()}.json"
    assert "rofl-prove-phase" in trace.read_text()
    assert profiling.spans()[-1].name == "rofl-prove-phase"
