"""extract_s: seconds in Accumulator.extract (the unity check and ops/bsgs.py) a round, from spans the benchmark
records around the call in a traced run."""

from portbench.harness.readers import per_step


def read(run):
    return per_step(run, "extract", "rounds")
