"""Tracing of the port: spans and counters recorded inside the program, and
the Chrome-trace exporter ``device_trace`` (counterpart of
``rofl_tpu.utils.profiling``, on ``torch.profiler``).

``span(name)`` is a context manager, and a decorator. Tracing is on exactly
while a ``torch.profiler`` session runs in the process: no knob of its own.
Off, a span costs one check. On, it records a ``Span`` in memory (times from
``time.time_ns()``, the clock of the profiler's events) and enters
``torch.profiler.record_function(name)``, so that the Chrome trace shows the
program's names over its kernels. A span never synchronises the device: one
that ends at a host read of a device value holds the device time before that
read, and one that ends without a read holds only the launches.

The on/off check reads torch's process-wide flag
(``torch.autograd.profiler._is_profiler_enabled``): the profiler's own
``torch._C._autograd._profiler_enabled()`` reads the calling thread's state,
and the server's pool threads see it off. For the same reason a
``record_function`` range reaches the trace only from the thread that
started the profiler; the spans of every thread reach ``spans()``.

Parents and trace ids live in a ``contextvars.ContextVar``; work handed to a
thread pool keeps them when it runs in a copy of the submitter's context
(``contextvars.copy_context().run``). A root span starts a trace of its own
id, or of the ``trace_id`` it is given.

``count(name, n)`` follows the same rule. The spans and counts of one
profiler session are kept together: the collector starts afresh when a span
or count runs under a profiler after one ran without. ``spans()`` and
``counters()`` read it. The one exception is ``setup_span``: a cache fill or
a kernel build happens once per process, so its span is always recorded, in
a list of its own (``setup_spans()``) that sessions do not reset.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import os
import threading
import time
from types import MappingProxyType
from typing import NamedTuple

import torch
from torch.autograd import profiler as _torch_profiler


class Span(NamedTuple):
    name: str
    span_id: int
    parent_id: int | None
    trace_id: object
    thread: int  # the native thread id, as the profiler's events give it
    start_ns: int
    end_ns: int


_parent: contextvars.ContextVar = contextvars.ContextVar("rofl_span", default=None)
_ids = itertools.count(1)
_lock = threading.Lock()
_spans: list = []
_counts: dict = {}
_setup: list = []
_stale = True  # a span or count ran with no profiler since the session began


def _session() -> list:
    """The current session's span list, started afresh after an untraced
    span or count."""
    global _spans, _counts, _stale
    if _stale:
        with _lock:
            if _stale:
                _spans, _counts, _stale = [], {}, False
    return _spans


def span(name: str, trace_id=None, start_ns: int | None = None):
    """A named stretch of the program, as a context manager or a decorator.
    `trace_id` starts a trace of that id (a root span); `start_ns` back-dates
    the span to a ``time.time_ns()`` instant taken before it could open (such
    a span has no range in the Chrome trace). ``close()`` ends it before its
    block does."""
    if _torch_profiler._is_profiler_enabled:
        return _Span(name, trace_id, start_ns, _session())
    global _stale
    _stale = True
    off = _OFF.get(name)
    if off is None:
        off = _OFF[name] = _Off(name)
    return off


def setup_span(name: str):
    """A span around a once-per-process fill (a generator set, a table, the
    kernels' build), recorded whether or not a profiler runs."""
    return _Span(name, None, None, _setup, _torch_profiler._is_profiler_enabled)


def _traced(name: str, fn):
    @functools.wraps(fn)
    def traced(*args, **kwargs):
        if not _torch_profiler._is_profiler_enabled:
            global _stale
            _stale = True
            return fn(*args, **kwargs)
        with _Span(name, None, None, _session()):
            return fn(*args, **kwargs)

    return traced


class _Off:
    """What ``span`` gives while no profiler runs: one per name, reused."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def close(self) -> None:
        pass

    def __call__(self, fn):
        return _traced(self.name, fn)


_OFF: dict = {}


class _Span:
    __slots__ = ("name", "trace_id", "start_ns", "_into", "_annotate", "_token", "_rf", "_id",
                 "_parent_id", "_trace")

    def __init__(self, name: str, trace_id, start_ns: int | None, into: list,
                 annotate: bool = True):
        self.name = name
        self.trace_id = trace_id
        self.start_ns = start_ns
        self._into = into
        self._annotate = annotate and start_ns is None
        self._token = None

    def __enter__(self):
        parent = _parent.get()
        self._id = next(_ids)
        self._parent_id = parent[0] if parent else None
        self._trace = (self.trace_id if self.trace_id is not None
                       else parent[1] if parent else self._id)
        self._token = _parent.set((self._id, self._trace))
        if self.start_ns is None:
            self.start_ns = time.time_ns()
        self._rf = None
        if self._annotate:
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    def __call__(self, fn):
        return _traced(self.name, fn)

    def close(self) -> None:
        if self._token is None:
            return
        end = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _parent.reset(self._token)
        self._token = None
        self._into.append(Span(self.name, self._id, self._parent_id, self._trace,
                               threading.get_native_id(), self.start_ns, end))


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` of the current session (while a profiler
    runs; nothing otherwise)."""
    if _torch_profiler._is_profiler_enabled:
        _session()
        with _lock:
            _counts[name] = _counts.get(name, 0) + n
    else:
        global _stale
        _stale = True


def spans() -> tuple[Span, ...]:
    """The closed spans of the current (or last) profiler session."""
    return tuple(_spans)


def counters() -> MappingProxyType:
    """The counts of the current (or last) profiler session."""
    with _lock:
        return MappingProxyType(dict(_counts))


def setup_spans() -> tuple[Span, ...]:
    """Every closed ``setup_span`` of the process."""
    return tuple(_setup)


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """Context manager: ``torch.profiler.profile`` written into `logdir` (or
    ``ROFL_TRACE_DIR``) as ``trace_<pid>.json``, the program's spans among
    its ranges; a no-op when neither is set, so hot paths can wrap
    unconditionally."""
    logdir = logdir or os.environ.get("ROFL_TRACE_DIR", "")
    if not logdir:
        yield
        return
    os.makedirs(logdir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
