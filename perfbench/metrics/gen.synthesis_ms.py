"""Mean ms a batch of the synthesis stage (CUDA events around the stage hook)."""

from perfbench.metrics._common import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "synthesis")
