"""The SIREN and composite's bound at the cell's shapes over the device time launched inside
the field spans, %."""

from perfbench.metrics._common import roofline_pct


def read(rec):
    return roofline_pct(rec, "field", "field")
