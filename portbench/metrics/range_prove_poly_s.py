"""range_prove_poly_s: seconds a step in the range provers' second phase, the challenges y, z, x, w, the t polynomials and the T commitments (the program's ``range_prove.poly`` spans)."""

from portbench.harness.program_spans import seconds_per


def read(run):
    return seconds_per("range_prove.poly", "steps")
