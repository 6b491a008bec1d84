"""The port's memoised device tables are made once when several threads ask
for them at the same time, as a server's verification threads do in its
first encrypted round: the fixed-base tables (``FixedBase.table``), the BSGS
table (``bsgs.build_table``) and the Bulletproof generators
(``range_proof.device_bp_gens``). The builders are replaced by slow
counting fakes; 16 threads ask at once, with a short switch interval."""

import sys
import threading
import time

import pytest

from rofl_tpu_torch.crypto import range_proof
from rofl_tpu_torch.ops import bsgs, fixed_base

THREADS = 16


class CountingBuilder:
    def __init__(self):
        self.calls = 0
        self.lock = threading.Lock()

    def __call__(self, *args):
        with self.lock:
            self.calls += 1
        time.sleep(0.05)  # long enough for every thread to miss the cache
        return object()


def ask_at_once(fn) -> list:
    results, barrier = [None] * THREADS, threading.Barrier(THREADS)

    def run(i):
        barrier.wait()
        results[i] = fn()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(THREADS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    return results


def test_a_fixed_base_table_is_built_once(monkeypatch):
    builder = CountingBuilder()
    monkeypatch.setattr(fixed_base, "build_table", builder)
    monkeypatch.setattr(fixed_base.curve, "pack_points", lambda points, device: None)
    base = fixed_base.FixedBase(spec_point=None)
    results = ask_at_once(lambda: base.table("cpu"))
    assert builder.calls == 1 and all(r is results[0] for r in results)


def test_the_bsgs_table_is_built_once(monkeypatch):
    builder = CountingBuilder()
    monkeypatch.setattr(bsgs, "_build_table", builder)
    monkeypatch.setattr(bsgs, "_tables", {})
    results = ask_at_once(lambda: bsgs.build_table(1 << 4, "cpu"))
    assert builder.calls == 1 and all(r is results[0] for r in results)


@pytest.mark.parametrize("shapes", [[(8, 4)], [(8, 4), (8, 2)]])
def test_the_bulletproof_generators_are_made_once_a_shape(monkeypatch, shapes):
    builder = CountingBuilder()
    monkeypatch.setattr(range_proof, "_bp_gens", range_proof.lru_cache(maxsize=16)(builder))
    results = ask_at_once(lambda: [range_proof.device_bp_gens(n, m, "cpu") for n, m in shapes])
    assert builder.calls == len(shapes) and all(r == results[0] for r in results)
