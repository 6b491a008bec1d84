"""Device tracing — counterpart of ``rofl_tpu.utils.profiling``, on
``torch.profiler``: the host's calls and, when a card is present, its kernels
and copies, written as a Chrome trace (chrome://tracing, Perfetto).

Enabled by ``ROFL_TRACE_DIR`` (any process) or by ``--trace`` of
``rofl_tpu_torch.bench_suite``; phases inside a trace are labelled with
``annotate``.
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def device_trace(logdir: str | None = None):
    """Context manager: ``torch.profiler.profile`` written into `logdir` (or
    ``ROFL_TRACE_DIR``) as ``trace_<pid>.json``; a no-op when neither is set,
    so hot paths can wrap unconditionally."""
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


def annotate(name: str):
    """A labelled range in the trace (prove / verify / accumulate / extract)."""
    return torch.profiler.record_function(name)
