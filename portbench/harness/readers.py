"""What the metric readers share: seconds a span took per step, the device's
idle share, and kernels' shares of their rooflines."""

from __future__ import annotations

from . import devtrace, roofline

# The CUDA kernels of the program's MSM (csrc/msm.cu) and ladder
# (csrc/scalar_mul.cu), as the profiler names them.
MSM_KERNELS = r"\bmsm_(recode|bucket|combine)_kernel\b"
SCALAR_MUL_KERNELS = r"\bscalar_mul_kernel\b"


def per_step(run, span: str, per: str = "steps"):
    """Seconds in `span` per step (per upload in a server loop) or per
    round; None where the span never ran."""
    n = run.counts.get(per, 0)
    if not run.span_calls.get(span) or not n:
        return None
    return run.spans[span] / n


def idle_share(run):
    """Percent of the traced window in which no operation ran on the card."""
    t = run.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def msm_roofline(run):
    """Percent: the MSM launches' least time (roofline.msm_bound_s at each
    launch's terms and group) over their kernels' device time."""
    shapes = run.launches.get("msm", [])
    busy = devtrace.kernel_seconds(run.trace, MSM_KERNELS) if run.trace else 0.0
    if not shapes or busy <= 0:
        return None
    return 100.0 * sum(roofline.msm_bound_s(n, g)[0] for n, g in shapes) / busy


def scalar_mul_roofline(run):
    """Percent: the ladder launches' least time (roofline.scalar_mul_bound_s
    at each launch's lanes) over their kernel's device time."""
    lanes = run.launches.get("scalar_mul", [])
    busy = devtrace.kernel_seconds(run.trace, SCALAR_MUL_KERNELS) if run.trace else 0.0
    if not lanes or busy <= 0:
        return None
    return 100.0 * sum(roofline.scalar_mul_bound_s(n)[0] for n in lanes) / busy
