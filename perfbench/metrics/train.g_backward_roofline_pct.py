"""The G step backward's bound at the cell's shapes (the generator's backward and the
discriminator's to its input) over the device time launched inside the g_backward spans,
%."""

from perfbench.metrics._common import roofline_pct


def read(rec):
    return roofline_pct(rec, "g_backward", "g_backward")
