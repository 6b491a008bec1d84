"""setup_tables_s: seconds of the process in its once-per-process fills: the kernels' load, the Bulletproof generators, the fixed-base and BSGS tables (the program's always-on ``setup.*`` spans)."""

from portbench.harness.program_spans import setup_seconds


def read(run):
    return setup_seconds()
