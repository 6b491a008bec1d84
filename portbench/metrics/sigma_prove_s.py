"""sigma_prove_s: seconds in the Σ-proofs (crypto/sigma.py rand / square-rand prove) a client step, from spans the benchmark
records around the call in a traced run."""

from portbench.harness.readers import per_step


def read(run):
    return per_step(run, "sigma_prove", "steps")
