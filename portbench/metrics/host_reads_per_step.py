"""host_reads_per_step: reads of a device value on the host a step (the program's ``host_reads`` counter): each drains the stream."""

from portbench.harness.program_spans import count_per


def read(run):
    return count_per("host_reads", "steps")
