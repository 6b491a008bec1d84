"""range_verify_msm_s: seconds an upload in the range verifiers' scalar vectors, decompression, combined MSM and identity check (the program's ``range_verify.msm`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("range_verify.msm", "uploads")
