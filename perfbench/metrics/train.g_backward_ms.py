"""Mean ms a pair of the generator step's backward (CUDA events around the g_backward
stage hook)."""

from perfbench.metrics._common import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "g_backward")
