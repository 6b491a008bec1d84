"""sigma_transcript_s.server: seconds an upload in the Sigma verifiers' batched transcripts, the plain-torch Keccak (the program's ``sigma.transcript`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("sigma.transcript", "uploads")
