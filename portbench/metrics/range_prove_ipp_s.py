"""range_prove_ipp_s: seconds a step in the range provers' inner-product arguments (the program's ``range_prove.ipp`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("range_prove.ipp", "steps")
