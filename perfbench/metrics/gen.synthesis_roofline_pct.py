"""The SPADE stack's bound at the cell's shapes over the device time launched inside the
synthesis spans, %."""

from perfbench.metrics._common import roofline_pct


def read(rec):
    return roofline_pct(rec, "synthesis", "synthesis")
