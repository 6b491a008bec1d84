"""What the readers of the program's own spans and counters share: they are
read through ``rofl_tpu_torch.utils.profiling`` (``spans()``, ``counters()``
and ``setup_spans()``), which a traced run fills while ``torch.profiler``
runs. A program without them (one older than its spans) reads as nothing:
every function returns None there and raises nothing.

Denominators are the session's closed spans: ``encrypt`` (a client step),
``server.upload`` (an upload), ``server.round`` (a round)."""

from __future__ import annotations

DENOMINATORS = {"steps": "encrypt", "uploads": "server.upload", "rounds": "server.round"}


def _profiling(*names):
    """The program's profiling module where it has every function in
    `names`, else None."""
    try:
        from rofl_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if all(callable(getattr(profiling, n, None)) for n in names) else None


def _count(spans, name: str) -> int:
    return sum(1 for s in spans if s.name == name)


def seconds_per(name: str, per: str):
    """Seconds in the program's spans `name` of the traced session, per step,
    upload or round (`per`); None where no such span, or no denominator,
    closed."""
    profiling = _profiling("spans")
    if profiling is None:
        return None
    spans = profiling.spans()
    durations = [s.end_ns - s.start_ns for s in spans if s.name == name]
    n = _count(spans, DENOMINATORS[per])
    if not durations or not n:
        return None
    return sum(durations) / 1e9 / n


def count_per(counter: str, per: str):
    """The program's counter `counter` of the traced session per step,
    upload or round; None where it never counted."""
    profiling = _profiling("spans", "counters")
    if profiling is None:
        return None
    value = profiling.counters().get(counter)
    n = _count(profiling.spans(), DENOMINATORS[per])
    if not value or not n:
        return None
    return value / n


def setup_seconds():
    """Seconds in the process's once-per-process fills (``setup.*`` spans),
    the outermost of nested ones only; None where none ran."""
    profiling = _profiling("setup_spans")
    if profiling is None:
        return None
    spans = profiling.setup_spans()
    ids = {s.span_id for s in spans}
    top = [s.end_ns - s.start_ns for s in spans if s.parent_id not in ids]
    return sum(top) / 1e9 if top else None
