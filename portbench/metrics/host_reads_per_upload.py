"""host_reads_per_upload: reads of a device value on the host an upload (the program's ``host_reads`` counter): each drains the stream."""

from portbench.harness.program_spans import count_per


def read(run):
    return count_per("host_reads", "uploads")
