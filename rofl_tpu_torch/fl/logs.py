"""Phase-timing bench logs — counterpart of ``rofl_tpu.fl.logs``, an own
copy, format-compatible with rofl_service logs.rs.

TimeState records wall-clock instants at protocol phase boundaries and emits
CSV lines "round, dt1, dt2, ..., total[, recv, sent]", milliseconds to 3
decimals (logs.rs:42-108). A BenchLogger writes each line to
``<log_dir>/<name>.bench`` and to the ``rofl_tpu_torch`` logger, tagged
BENCH; with no log_dir, to the logger only.
"""

from __future__ import annotations

import logging
import os
import time

BENCH_TAG = "[BENCH]"

logger = logging.getLogger("rofl_tpu_torch")


class BenchLogger:
    def __init__(self, log_dir: str = "benchlog", name: str = "bench"):
        self.path = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.path = os.path.join(log_dir, f"{name}.bench")

    def log(self, line: str):
        logger.info("%s %s", BENCH_TAG, line)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")


class TimeState:
    """Vec<Instant> phase recorder (logs.rs:42-108)."""

    def __init__(self):
        self.instants: list[float] = []

    def reset(self):
        self.instants = []

    def record(self):
        self.instants.append(time.monotonic())

    def deltas_ms(self) -> list[float]:
        return [(b - a) * 1000.0 for a, b in zip(self.instants, self.instants[1:])]

    def total_ms(self) -> float:
        if len(self.instants) < 2:
            return 0.0
        return (self.instants[-1] - self.instants[0]) * 1000.0

    def _fields(self, round_id: int) -> list[str]:
        return [str(round_id)] + [f"{d:.3f}" for d in self.deltas_ms()] + [f"{self.total_ms():.3f}"]

    def log_bench_times(self, bench: BenchLogger, round_id: int):
        bench.log(", ".join(self._fields(round_id)))

    def log_bench_times_with_bandwidth(self, bench: BenchLogger, round_id: int, recv: int,
                                       sent: int):
        bench.log(", ".join(self._fields(round_id) + [str(recv), str(sent)]))
