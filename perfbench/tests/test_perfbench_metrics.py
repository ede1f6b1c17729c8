"""The readers on made-up records: a rate counts all the work over all the
window, a p95 counts every unit, a reader with nothing to read says None."""

import pytest

from perfbench import flops, harness
from perfbench.metrics import _common


def rec_of(times, items=8):
    t = 100.0
    reqs = []
    for d in times:
        reqs.append((t, t + d, items))
        t += d
    return harness.Record(setup_s=7.5, window_start=100.0, window_end=t, requests=reqs)


def read(name, rec):
    return harness.reader(name)(rec)


def test_rate_is_all_work_over_all_the_window():
    rec = rec_of([0.1] * 9 + [1.1])  # one slow batch in ten: 80 images in 2.0 s
    assert read("gen_imgs_per_s", rec) == pytest.approx(40.0)
    assert read("gen_imgs_per_s", rec_of([0.5, 0.25, 0.25], items=32)) == pytest.approx(96.0)


def test_p95_counts_every_unit():
    times = [0.010 * (i + 1) for i in range(100)]  # 10 ms ... 1000 ms
    rec = rec_of(times)
    # numpy's linear rule: rank 94.05 of 0..99 -> 950 ms + 0.05 * 10 ms
    assert read("gen_batch_p95_ms", rec) == pytest.approx(950.5)
    assert _common.percentile([3.0], 95) == 3.0


def test_setup_and_absent_sources():
    rec = rec_of([0.1, 0.1])
    assert read("setup_s", rec) == 7.5
    for name in ("gen.synthesis_ms", "gen.synthesis_roofline_pct", "gen.device_idle_pct",
                 "gen.field_roofline_pct", "gen.mfu_pct", "train_peak_gib"):
        assert read(name, rec) is None  # untraced: nothing to read, so no number


def test_traced_readers():
    meta = harness.step_meta(harness.Spec().cell("gen.map3dbn512l.b8").config)
    rec = rec_of([0.08] * 10)
    rec.work = flops.generation(meta, 8)
    rec.stage_ms = {"synthesis": [50.0] * 10, "field": [14.0] * 10}
    rec.trace = {"window_s": 0.8, "busy_s": 0.6}  # the window, the device profiled alone
    rec.spans = {"spans": {"synthesis": {"count": 12, "device_s": 0.624}}}  # the host-traced stretch
    assert read("gen.synthesis_ms", rec) == pytest.approx(50.0)
    assert read("gen.device_idle_pct", rec) == pytest.approx(25.0)
    w = rec.work["synthesis"]
    bound = flops.bound_s(w["flops"], w["bytes"])
    assert read("gen.synthesis_roofline_pct", rec) == pytest.approx(100 * bound / 0.052)
    assert read("gen.field_roofline_pct", rec) is None  # no field span in the trace
    mfu = 100 * rec.work["model"]["flops"] * 10 / 0.8 / flops.PEAK_BF16
    assert read("gen.mfu_pct", rec) == pytest.approx(mfu)


def test_training_readers():
    meta = harness.step_meta(harness.Spec().cell("train.map3dbn.b32").config)
    rec = rec_of([2.0, 2.5, 2.0, 3.5], items=32)  # 128 images in 10 s
    rec.window_peak_bytes = 48 * 2**30
    assert read("train_imgs_per_s", rec) == pytest.approx(12.8)
    assert read("train_peak_gib", rec) == pytest.approx(48.0)
    work = flops.training(meta, 32)
    rec.work = dict(work, model={"flops": 3e13, "bytes": 0.0})
    rec.stage_ms = {"d_step": [800.0, 900.0, 800.0, 1500.0], "g_backward": [700.0] * 4}
    rec.trace = {"window_s": 10.0, "busy_s": 9.0}
    rec.spans = {"spans": {"d_fakes": {"count": 4, "device_s": 2.0},
                           "g_backward": {"count": 4, "device_s": 2.8}}}
    assert read("train.d_step_ms", rec) == pytest.approx(1000.0)
    assert read("train.g_backward_ms", rec) == pytest.approx(700.0)
    assert read("train.device_idle_pct", rec) == pytest.approx(10.0)
    assert read("train.mfu_pct", rec) == pytest.approx(100 * 3e13 * 4 / 10.0 / flops.PEAK_BF16)
    f = work["fakes"]
    assert read("train.fakes_roofline_pct", rec) == pytest.approx(
        100 * flops.bound_s(f["flops"], f["bytes"]) * 4 / 2.0)
    for name in ("train.d_step_ms", "train.mfu_pct", "train.fakes_roofline_pct"):
        assert read(name, rec_of([2.0])) is None  # untraced: nothing to read
