"""sigma_transcript_s.client: seconds a step in the Sigma proofs' batched transcripts, the plain-torch Keccak (the program's ``sigma.transcript`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("sigma.transcript", "steps")
