"""server_uploads_per_s: uploads of the rounds completed in the window over
those rounds' seconds, each round's extract and model update included."""


def read(run):
    return run.counts["steps"] / run.window_s if run.counts.get("steps") else None
