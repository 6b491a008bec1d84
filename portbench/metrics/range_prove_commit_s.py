"""range_prove_commit_s: seconds a step in the range provers' first phase, the V commitments, their encodings, the bits and the A and S sums (the program's ``range_prove.commit`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("range_prove.commit", "steps")
