"""What the profiler saw on the card in a traced window: the seconds in which
an operation ran there, the time of each kernel by name, and the longest
stretches in which the card waited, each named by the span that was open on
the host at the time (the recorder's spans, on the same clock as the
profiler's events: nanoseconds since the epoch)."""

from __future__ import annotations

import re
import time

import torch

TRACE_SECONDS = 20.0  # the first seconds of a traced window that the profiler records


class DeviceTrace:
    """``torch.profiler`` (the card's activity only; the host's side is the
    recorder's spans) over the first TRACE_SECONDS of the window: started
    with it, stopped after the first step that ends past them. The
    recorder keeps launch shapes only while the profiler runs, so that
    shapes and device times cover the same launches."""

    def __init__(self, recorder, on_card: bool, seconds: float = TRACE_SECONDS):
        activities = ([torch.profiler.ProfilerActivity.CUDA] if on_card
                      else [torch.profiler.ProfilerActivity.CPU])
        self.prof = torch.profiler.profile(activities=activities)
        self.recorder, self.on_card, self.seconds = recorder, on_card, seconds
        self.window = None
        self.running = False

    def start(self) -> None:
        self.prof.__enter__()
        self.recorder.keep_shapes = True
        self.t0, self.t0_ns = time.perf_counter(), time.time_ns()
        self.running = True

    def after_step(self) -> None:
        if self.running and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if not self.running:
            return
        if self.on_card:
            torch.cuda.synchronize()
        self.window = (self.t0_ns, time.time_ns())
        self.recorder.keep_shapes = False
        self.running = False
        self.prof.__exit__(None, None, None)

    def summary(self) -> dict:
        self.stop()
        return summarize(self.prof, self.window, self.recorder.intervals)


def device_events(prof) -> list:
    """(name, start_ns, end_ns) of every kernel, copy and set on a card."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation():
            start = e.start_ns()
            out.append((e.name(), start, start + e.duration_ns()))
    return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespaces and argument
    list, its template arguments cut to 100 characters."""
    depth, cut, start = 0, len(name), 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif depth == 0 and ch == "(" and i > 0:
            cut = i
            break
        elif depth == 0 and (ch == " " or name.startswith("::", i)):
            start = i + (2 if ch == ":" else 1)
    base = name[start:cut].strip() or name
    return base if len(base) <= 100 else base[:100] + "..."


def summarize(prof, window: tuple, spans: list) -> dict:
    """window: (start_ns, end_ns) of the traced window on the host; spans:
    the recorder's (name, start_ns, end_ns)."""
    lo, hi = window
    device = device_events(prof)
    merged = _merge([(max(s, lo), min(e, hi)) for _, s, e in device if e > lo and s < hi])
    busy_ns = sum(e - s for s, e in merged)
    by_kernel: dict[str, float] = {}
    for name, s, e in device:
        by_kernel[name] = by_kernel.get(name, 0.0) + (e - s) / 1e9
    edges = [lo] + [x for iv in merged for x in iv] + [hi]
    gaps = sorted(((e - s, s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s),
                  reverse=True)
    named_gaps = []
    for dur, s, e in gaps[:10]:
        mid = (s + e) / 2
        inside = [h for h in spans if h[1] <= mid <= h[2]]
        # the innermost span: the latest to open
        label = max(inside, key=lambda h: h[1])[0] if inside else "outside every span"
        named_gaps.append([label, dur / 1e9])
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (hi - lo) / 1e9,
        "kernel_s": by_kernel,
        "device_ops": [[short_name(n), s] for n, s in top],
        "idle_gaps": named_gaps,
        "events": len(device),
        "first_event_after_window_start_s": ((min(s for _, s, _ in device) - lo) / 1e9
                                             if device else None),
    }


def kernel_seconds(summary: dict, pattern: str) -> float:
    """Device seconds of the kernels whose names match `pattern`."""
    rx = re.compile(pattern)
    return sum(s for name, s in summary["kernel_s"].items() if rx.search(name))
