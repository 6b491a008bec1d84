"""verify_wait_s: seconds a round the server waits for its uploads' verification after the extract (the program's ``server.verify_wait`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("server.verify_wait", "rounds")
