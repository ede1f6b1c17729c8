"""Images finished in the window over the window's seconds (host clock)."""

from perfbench.metrics._common import window_s


def read(rec):
    return sum(r[2] for r in rec.requests) / window_s(rec)
