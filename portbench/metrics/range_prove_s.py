"""range_prove_s: seconds in the range proofs (crypto/range_proof_vec.py create_rangeproof, l2_range_proof.py create_rangeproof_l2) a client step, from spans the benchmark
records around the call in a traced run."""

from portbench.harness.readers import per_step


def read(run):
    return per_step(run, "range_prove", "steps")
