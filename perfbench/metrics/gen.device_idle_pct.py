"""1 - the device's busy time over the window, %, from the trace of the device alone."""

from perfbench.metrics._common import idle_pct


def read(rec):
    return idle_pct(rec)
