"""sigma_verify_s: seconds in the Σ-proof verifier (crypto/sigma.py) an upload, from spans the benchmark
records around the call in a traced run."""

from portbench.harness.readers import per_step


def read(run):
    return per_step(run, "sigma_verify", "steps")
