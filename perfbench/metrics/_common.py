"""Helpers the metric readers share (this file is no metric: no entry of
``BENCHMARK.json`` names it)."""

from __future__ import annotations

from perfbench import flops


def window_s(rec):
    return rec.window_end - rec.window_start


def percentile(values, q: float) -> float:
    """The q-th percentile, linear between the closest ranks (numpy's
    default), of all the values."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def stage_mean_ms(rec, *names):
    """Mean ms a unit of work of the named stages together (CUDA events),
    over every unit of the window; None without stage events."""
    if not rec.stage_ms or not rec.requests:
        return None
    total = sum(sum(rec.stage_ms.get(n, [])) for n in names)
    if not any(rec.stage_ms.get(n) for n in names):
        return None
    return total / len(rec.requests)


def roofline_pct(rec, layer, span):
    """The layer's bound (``perfbench.flops``, a unit of the span) over the
    device time of the activity launched inside the span, in %, from the
    stretch traced with the host's operations."""
    if not rec.spans or layer not in rec.work:
        return None
    sp = rec.spans["spans"].get(span)
    if not sp or sp["device_s"] <= 0:
        return None
    w = rec.work[layer]
    return 100.0 * flops.bound_s(w["flops"], w["bytes"]) * sp["count"] / sp["device_s"]


def mfu_pct(rec):
    """The model's products of every unit of the window over the window on
    the host's clock and the bf16 peak, in % (the window traced on the
    device alone, the host not slowed by the profiler)."""
    if not rec.trace or "model" not in rec.work or not rec.requests or window_s(rec) <= 0:
        return None
    return 100.0 * rec.work["model"]["flops"] * len(rec.requests) / window_s(rec) / flops.PEAK_BF16


def idle_pct(rec):
    """1 - the device's busy time over the window, in %, from the trace of
    the device alone."""
    if not rec.trace or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
