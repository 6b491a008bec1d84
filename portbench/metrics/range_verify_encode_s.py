"""range_verify_encode_s: seconds an upload in the range verifiers' re-shift, padding and encoding of the commitments (the program's ``range_verify.encode`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("range_verify.encode", "uploads")
