"""The model's products of every pair of the window over the window (host clock, the
device profiled alone) and the bf16 peak (989 TFLOP/s), %."""

from perfbench.metrics._common import mfu_pct


def read(rec):
    return mfu_pct(rec)
