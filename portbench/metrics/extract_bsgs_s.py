"""extract_bsgs_s: seconds a round in the extract's baby-step giant-step walk (the program's ``extract.bsgs`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("extract.bsgs", "rounds")
