"""The generator's train forward's bound at the cell's shapes (field, synthesis,
mapping) over the device time launched inside the d_fakes spans, %."""

from perfbench.metrics._common import roofline_pct


def read(rec):
    return roofline_pct(rec, "fakes", "d_fakes")
