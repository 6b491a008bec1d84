"""range_verify_transcript_s: seconds an upload in the range verifiers' host transcripts, challenges, inversions and delta (the program's ``range_verify.transcript`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("range_verify.transcript", "uploads")
