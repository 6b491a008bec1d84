"""range_verify_s: seconds in the range-proof verifier (range_proof_vec.py verify_rangeproof, l2_range_proof.py verify_rangeproof_l2) an upload, from spans the benchmark
records around the call in a traced run."""

from portbench.harness.readers import per_step


def read(run):
    return per_step(run, "range_verify", "steps")
