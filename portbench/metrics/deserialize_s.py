"""deserialize_s: seconds in the upload's deserialize (fl/params.py deserialize) an upload, from spans the benchmark
records around the call in a traced run."""

from portbench.harness.readers import per_step


def read(run):
    return per_step(run, "deserialize", "steps")
