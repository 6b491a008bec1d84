"""serialize_s: seconds in the upload's serialize (fl/params.py) a client step, from spans the benchmark
records around the call in a traced run."""

from portbench.harness.readers import per_step


def read(run):
    return per_step(run, "serialize", "steps")
