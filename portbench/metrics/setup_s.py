"""setup_s: seconds from the start of the process to the first timed step:
imports, the kernels' load, the generators, the inputs and the warm-up."""


def read(run):
    return run.setup_s
