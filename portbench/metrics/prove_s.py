"""prove_s: the window's seconds over the client steps it completed, a step
being encrypt then serialize of one update."""


def read(run):
    steps = run.counts.get("steps", 0)
    return run.window_s / steps if steps else None
