"""device_idle_share.client: percent of the traced window in which no kernel,
copy or set ran on the card (torch.profiler's device events)."""

from portbench.harness.readers import idle_share


def read(run):
    return idle_share(run)
