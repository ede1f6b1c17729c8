"""Mean ms a pair of the discriminator step (CUDA events around the d_step stage hook,
R1 inside it on its slots)."""

from perfbench.metrics._common import stage_mean_ms


def read(rec):
    return stage_mean_ms(rec, "d_step")
