"""Spans and launch shapes recorded from the benchmark's side, in a traced
run only.

A span wraps a function of the program where the layer above reaches it (a
module attribute, looked up at each call): the device is drained on entry
and on exit. Each span is also kept as (name, start, end) on the clock of
the profiler's events (``time.time_ns``), so that the device trace's idle
stretches can be named by the span open at the time. Launch shapes are read
by wrapping the kernel wrappers the same way. Everything is put back when
the recorder is closed.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch


class Recorder:
    def __init__(self, device="cuda"):
        on_card = torch.device(device).type == "cuda"
        self._sync = torch.cuda.synchronize if on_card else (lambda: None)
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.launches: dict[str, list] = defaultdict(list)
        self.intervals: list = []
        self.keep_shapes = True
        self._undo: list = []
        self._lock = threading.Lock()

    def span(self, owner, attr: str, name: str) -> None:
        """Time every call of owner.attr as span `name`."""
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            self._sync()
            t0, w0 = time.perf_counter(), time.time_ns()
            out = fn(*args, **kwargs)
            self._sync()
            dt, w1 = time.perf_counter() - t0, time.time_ns()
            with self._lock:
                self.seconds[name] += dt
                self.calls[name] += 1
                self.intervals.append((name, w0, w1))
            return out

        self._patch(owner, attr, fn, timed)

    @contextlib.contextmanager
    def interval(self, name: str):
        """A labelled stretch of the host's time (a step, a round), kept for
        the trace only."""
        w0 = time.time_ns()
        try:
            yield
        finally:
            with self._lock:
                self.intervals.append((name, w0, time.time_ns()))

    def shapes(self, owner, attr: str, name: str, shape_of) -> None:
        """Record shape_of(*args) of every call of owner.attr under `name`."""
        fn = getattr(owner, attr)

        def counted(*args, **kwargs):
            if self.keep_shapes:
                with self._lock:
                    self.launches[name].append(shape_of(*args, **kwargs))
            return fn(*args, **kwargs)

        self._patch(owner, attr, fn, counted)

    def _patch(self, owner, attr, old, new) -> None:
        setattr(owner, attr, new)
        self._undo.append((owner, attr, old))

    def close(self) -> None:
        while self._undo:
            owner, attr, old = self._undo.pop()
            setattr(owner, attr, old)
