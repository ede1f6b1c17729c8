"""Mean ms a batch of the host time of the port's ``synthesis.glue`` spans: K3's operands
(the weights' fold, the weight stream's pack, the padded tables) up to its C call."""

from perfbench.program import host_ms_per_unit


def read(rec):
    return host_ms_per_unit(rec, "synthesis.glue")
