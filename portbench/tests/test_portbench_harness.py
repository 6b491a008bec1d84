"""CPU tests of the benchmark's harness and reference (no card needed).

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import pytest

from portbench import run as R
from portbench.harness import bench as B
from portbench.harness import inputs, roofline
from portbench.reference import curve as C
from portbench.reference import fixed_point as fxp
from portbench.reference.transcript import Transcript


def test_every_file_is_found_by_name_and_parses():
    spec = B.load_benchmark()
    names = {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        cfg = B.config(spec, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"]
    for w in spec["workloads"]:
        assert w["config"] in names
        assert B.traffic(w["traffic"])["loop"] in ("client", "server")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(B.reader(m["name"]))


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_layer():
    spec = B.load_benchmark()
    for w in spec["workloads"]:
        e2e = {m["name"] for m in B.metrics_for(spec, w["name"], trace=False)}
        layers = B.metrics_for(spec, w["name"], trace=True)
        assert "setup_s" in e2e and len(e2e) >= 2 and layers
        assert all(m["moves"] in e2e for m in layers)


def test_fixed_point_sum_by_hand():
    # FpConfig(16, 7), range 8: clip at 127/128; 0.3 -> 38.4 -> 38 units,
    # -0.5 -> -64, 2.0 -> clipped to 127, 1/256 -> 0.5 -> 0 (half to even)
    a = np.array([0.3, -0.5, 2.0, 1 / 256], np.float32)
    b = np.array([0.1, -0.25, -2.0, 3 / 256], np.float32)  # 12.8 -> 13, -32, -127, 1.5 -> 2
    got = fxp.server_sum([a, b], 16, 7, 8)
    want = np.array([38 + 13 + 1, -64 - 32 + 1, 127 - 127 + 1, 0 + 2 + 1], np.float32) / 128
    assert np.array_equal(got, want)
    model = fxp.next_model(np.ones(4, np.float32), got, 2, 1.0)
    assert np.array_equal(model, np.float32(1) + want * np.float32(0.5))


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "rofl_tpu_torch_lookalike", sys)
    assert R.forbidden_modules() == [m for m in R.forbidden_modules()
                                     if m.split(".")[0] in R.FORBIDDEN]
    assert "rofl_tpu_torch_lookalike" not in R.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in R.forbidden_modules()


def test_the_benchmark_loads_no_jax_module():
    code = ("import sys, portbench.run as R, portbench.harness.loops as L; "
            "import portbench.harness.readers, portbench.reference.verify; "
            "from portbench.harness import bench as B; "
            "[B.reader(m['name']) for m in B.load_benchmark()['per_layer']]; "
            "import rofl_tpu_torch.fl.server, rofl_tpu_torch.fl.params; "
            "print(R.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"},
                         cwd=str(B.ROOT))
    assert out.stdout.strip() == "[]"


def test_the_run_refuses_without_a_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert R.main(["--workload", "l2_d50k.client", "--seed", "1", "--seconds", "1"]) != 0


@pytest.mark.parametrize("lanes, group, want_ms", [
    (50000, None, 0.750), (300000, 300000, 0.412), (131618, 131618, 0.192),
    (16 * 65536, 65536, 1.62)])
def test_roofline_arithmetic_matches_the_kernel_table(lanes, group, want_ms):
    """PERF.md's kernel table (rows 5-7): the bounds chip_smoke.py gave."""
    if group is None:
        got, by = roofline.scalar_mul_bound_s(lanes)
    else:
        got, by = roofline.msm_bound_s(lanes, group)
    assert by == "operations"
    assert abs(got * 1e3 - want_ms) / want_ms < 0.006


def test_ristretto_multiples_of_the_basepoint():
    """RFC 9496 A.1: the encodings of B, 2B, 3B; and decode(encode) = id."""
    want = ["e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
            "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
            "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259"]
    b, ok = C.decode(np.frombuffer(bytes.fromhex(want[0]), np.uint8).reshape(1, 32), "cpu")
    assert bool(ok.all())
    two = C.point_double(b)
    three = C.point_add(two, b)
    got = [C.encode(p)[0].tobytes().hex() for p in (b, two, three)]
    assert got == want
    k = C.msm(C.point_cat(b, b), C.scalars_to_bytes([1, 2]))
    assert C.encode(k)[0].tobytes().hex() == want[2]


def test_merlin_simple_vector():
    """merlin's own test: one message, 32 challenge bytes."""
    for device in (None, "cpu"):
        t = Transcript(b"test protocol", 1, device)
        t.append_message(b"some label", b"some data")
        got = bytes(np.asarray(t.challenge_bytes(b"challenge", 32))[0])
        assert got.hex() == "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"


def test_inputs_are_a_function_of_the_seed():
    cfg = {"d": 9, "update_bound": 0.5}
    big = 2**31 + 12345
    assert np.array_equal(inputs.update(cfg, big, 3), inputs.update(cfg, big, 3))
    assert not np.array_equal(inputs.update(cfg, big, 3), inputs.update(cfg, big, 4))
    vecs = inputs.cancelling_blindings(9, 4, big)
    ints = [inputs.limbs_to_ints(v) for v in vecs]
    assert all(sum(col) % C.L == 0 for col in zip(*ints))
    assert inputs.limbs_to_ints(inputs.ints_to_limbs(ints[0])) == ints[0]


def test_result_line_keys_from_a_recorded_line():
    """The keys a result line carries, in the order run.main prints them."""
    line = json.dumps({"correct": True, "attempted": 1, "failed": 0,
                       "metrics": {"prove_s": {"value": 1.0, "unit": "s"}},
                       "device": {"platform": "gpu", "kind": "x", "count": 1,
                                  "memory_peak_bytes": 1},
                       "checks": {"structure": {"value": 0, "limit": 0}}})
    obj = json.loads(line)
    assert list(obj)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(obj)[-1] == "checks"


class _Event:
    def __init__(self, name, start, end, cuda=True, annotation=False):
        import torch

        self._v = (name, start, end - start,
                   torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU,
                   annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_device_trace_summary_by_hand():
    from types import SimpleNamespace

    from portbench.harness import devtrace

    events = [_Event("k1(int)", 100, 200), _Event("k2(int)", 150, 300),
              _Event("k1(int)", 620, 700), _Event("step", 0, 1000, annotation=True),
              _Event("cudaLaunchKernel", 90, 95, cuda=False)]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    spans = [("step", 0, 1000), ("range_verify", 300, 600)]
    s = devtrace.summarize(prof, (0, 1000), spans)
    assert s["busy_s"] == 280e-9 and s["window_s"] == 1000e-9
    assert s["kernel_s"] == {"k1(int)": 180e-9, "k2(int)": 150e-9}
    # gaps: 300-620 inside range_verify, 700-1000 and 0-100 inside step only
    assert s["idle_gaps"] == [["range_verify", 320e-9], ["step", 300e-9], ["step", 100e-9]]
    assert s["device_ops"][0] == ["k1", 180e-9]
    assert devtrace.kernel_seconds(s, r"\bk2\b") == 150e-9
