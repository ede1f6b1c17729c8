"""Mean ms a pair of the host time of the port's ``loader.wait`` spans: the Trainer's wait
for the prefetch thread's next batch."""

from perfbench.program import host_ms_per_unit


def read(rec):
    return host_ms_per_unit(rec, "loader.wait")
