"""accumulate_s: seconds in Accumulator.accumulate (fl/params.py) an upload, from spans the benchmark
records around the call in a traced run."""

from portbench.harness.readers import per_step


def read(run):
    return per_step(run, "accumulate", "steps")
