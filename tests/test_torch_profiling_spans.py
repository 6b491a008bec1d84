"""The port's spans and counters (``rofl_tpu_torch/utils/profiling.py``) on
the CPU, on the paths the benchmark's cells run.

For EncL2 and EncRange at d = 2 (``FpConfig(8, 3)``, ranges of 2 bits, two
chunks, so the chunk-batched prover and verifier run), one client encrypts
and serializes an update, and a server (``fl.server.TrainingState``, its
crypto and verify pools) takes it from two clients in one round, K = 2. The
update carries zero blindings, so the two uploads' ElGamal blindings cancel
and the round extracts 2x plus the accumulator's one unit. The run is made
once with no profiler and once under ``torch.profiler`` with CPU activity:

  (a) with no profiler nothing is recorded but the once-per-process fills,
      and the uploads and the sums are equal, byte for byte, on and off;
  (b) under the profiler every span of the program's table is recorded
      with its parent, and an upload's deserialize, verify and accumulate
      carry its trace id (round, client) across the two pools;
  (c) each span of the profiler's thread has its ``record_function`` range
      in the profiler's events within 1 ms: one clock;
  (d) a second profiler session starts with an empty collector.

A plain-torch encrypt at this size takes 5-20 s on the CPU, a verify 4-10
s; the server's BSGS table is cut to 128 entries (8-bit values, two giant
steps), as a table of 2^16 takes most of a minute to build here.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl import server as S
from rofl_tpu_torch.utils import profiling

torch.set_num_threads(2)
FP = FpConfig(8, 3)
D = 2
UPDATE = np.array([0.125, -0.125], np.float32)
MODES = {"l2": P.ENC_L2_TYPE, "range": P.ENC_RANGE_TYPE}

# span -> the names its parent may have (None: a root)
PARENTS = {
    "encrypt": {None}, "serialize": {None},
    "range_prove": {"encrypt"}, "range_prove.commit": {"range_prove"},
    "range_prove.poly": {"range_prove"}, "range_prove.ipp": {"range_prove"},
    "sigma_prove": {"encrypt"}, "sigma.transcript": {"sigma_prove", "sigma_verify"},
    "server.upload": {None}, "deserialize": {"server.upload"}, "verify": {"server.upload"},
    "accumulate": {"server.upload"}, "sigma_verify": {"verify"}, "range_verify": {"verify"},
    "range_verify.encode": {"range_verify"}, "range_verify.transcript": {"range_verify"},
    "range_verify.msm": {"range_verify"},
    "server.round": {None}, "extract": {"server.round"}, "extract.unity": {"extract"},
    "extract.bsgs": {"extract"}, "extract.decode": {"extract"},
    "server.verify_wait": {"server.round"},
}


def _round(enc_type: int, profiled: bool) -> dict:
    """One encrypt + serialize and one server round of two uploads of it;
    with `profiled`, under the profiler."""
    cfg = P.CryptoConfig(value_range=2, n_partition=2, l2_value_range=2, enc_type=enc_type,
                         fp=FP)
    state = S.TrainingState(S.ServerConfig(
        num_clients=2, num_params=D, num_rounds=1 << 30, enc_type=enc_type, crypto=cfg,
        write_model_file=False, bench_dir=None, device="cpu"))
    state.status = "in_progress"
    state.start_new_round(0)

    async def server_round():
        for client in range(2):
            state.start_update(client, upload)
        await asyncio.gather(*list(state.update_tasks))

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    loop = asyncio.new_event_loop()
    counters_before = dict(profiling.counters())
    t0 = time.time_ns()
    try:
        if profiled:
            prof.__enter__()
        with torch.inference_mode():
            enc = P.encrypt(enc_type, UPDATE, np.zeros((16, D), np.uint32), cfg,
                            np.random.default_rng(7), "cpu")
            upload = enc.serialize()
        loop.run_until_complete(server_round())
    finally:
        if profiled:
            prof.__exit__(None, None, None)
        loop.close()
        state.close()
    return {"upload": upload, "sum": state.rounds[0].extracted, "t0": t0,
            "spans": profiling.spans(), "counters_before": counters_before,
            "counters": dict(profiling.counters()),
            "events": prof.profiler.kineto_results.events() if profiled else None}


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request):
    """The mode's run with no profiler, then under one."""
    kept = S.BSGS_TABLE_SIZE
    S.BSGS_TABLE_SIZE = 128
    try:
        off = _round(MODES[request.param], profiled=False)
        on = _round(MODES[request.param], profiled=True)
    finally:
        S.BSGS_TABLE_SIZE = kept
    return request.param, off, on


def test_no_profiler_records_nothing_and_changes_nothing(runs):
    mode, off, on = runs
    assert not [s for s in off["spans"] if s.start_ns >= off["t0"]]
    assert off["counters"] == off["counters_before"]
    assert off["upload"] == on["upload"]
    want = 2 * UPDATE + np.float32(1 / 8)  # the accumulator's start adds one unit
    assert np.array_equal(off["sum"], want) and np.array_equal(on["sum"], want)


def test_spans_name_the_table_with_their_parents(runs):
    mode, _, on = runs
    spans = on["spans"]
    assert min(s.start_ns for s in spans) >= on["t0"]
    by_id = {s.span_id: s for s in spans}
    assert {s.name for s in spans} == set(PARENTS)
    for s in spans:
        parent = by_id[s.parent_id].name if s.parent_id is not None else None
        assert parent in PARENTS[s.name], (s.name, parent)
    # the L2 update proves and verifies its L-infinity and its L2 range proofs
    per_upload = 2 if mode == "l2" else 1
    assert sum(s.name == "range_prove" for s in spans) == per_upload
    assert sum(s.name == "range_verify" for s in spans) == 2 * per_upload
    assert on["counters"]["host_reads"] > 0


def test_an_upload_keeps_its_trace_id_across_the_pools(runs):
    _, _, on = runs
    spans = on["spans"]
    main = next(s.thread for s in spans if s.name == "encrypt")
    for client in range(2):
        trace = [s for s in spans if s.trace_id == (0, client)]
        (root,) = [s for s in trace if s.name == "server.upload"]
        children = {s.name: s for s in trace if s.parent_id == root.span_id}
        assert set(children) == {"deserialize", "verify", "accumulate"}
        assert children["deserialize"].thread == children["accumulate"].thread
        assert len({main, children["deserialize"].thread, children["verify"].thread}) == 3
        assert all(s.start_ns >= root.start_ns for s in trace)
    (round_span,) = [s for s in spans if s.name == "server.round"]
    assert round_span.trace_id == (0,)
    uploads = [s for s in spans if s.name == "server.upload"]
    assert round_span.start_ns <= min(s.start_ns for s in uploads)


def test_spans_and_the_profilers_events_share_a_clock(runs):
    _, _, on = runs
    ranges = {}
    for e in on["events"]:
        if e.is_user_annotation():
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    main = next(s.thread for s in on["spans"] if s.name == "encrypt")
    checked = 0
    for s in on["spans"]:
        if s.thread != main or s.name == "server.round":  # back-dated: no range
            continue
        near = [max(abs(a - s.start_ns), abs(b - s.end_ns)) for a, b in ranges.get(s.name, [])]
        assert near and min(near) < 1_000_000, s.name
        checked += 1
    assert checked >= 8


def test_a_second_profiler_session_starts_empty():
    with profiling.span("between sessions"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        P.encrypt(P.PLAIN_TYPE, UPDATE, None, P.CryptoConfig(), None, "cpu")
    assert [s.name for s in profiling.spans()] == ["encrypt"]
    assert dict(profiling.counters()) == {}
