"""The trace reduction on a made-up profiler trace."""

import json

import pytest

from perfbench import trace


def ev(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_reduce(tmp_path):
    events = [
        ev("window", "user_annotation", 0, 1000),
        ev("stage:field", "user_annotation", 100, 100),
        ev("cudaLaunchKernel", "cuda_runtime", 110, 5, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 150, 5, corr=2),
        ev("stage:synthesis", "user_annotation", 300, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 310, 5, corr=3),
        ev("cudaLaunchKernel", "cuda_runtime", 310, 5, tid=2, corr=4),  # autograd's thread
        ev("aten::copy_", "cpu_op", 540, 400),
        ev("field_kernel", "kernel", 120, 200, tid=9, corr=1),
        ev("field_tail", "kernel", 250, 100, tid=9, corr=2),  # overlaps: union counts once
        ev("synthesis_kernel", "kernel", 400, 100, tid=9, corr=3),
        ev("other", "kernel", 520, 30, tid=9, corr=4),
        ev("Memcpy DtoH", "gpu_memcpy", 950, 100, tid=9, corr=5),  # clipped at the window
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = trace.reduce(str(path))
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((230 + 100 + 30 + 50) * 1e-6)
    assert r["spans"]["field"] == {"count": 1, "device_s": pytest.approx(230e-6)}
    assert r["spans"]["synthesis"]["device_s"] == pytest.approx(130e-6)
    assert r["device_ops"][0] == ["field_kernel", pytest.approx(200e-6)]
    gaps = dict((round(s * 1e6), n) for n, s in r["idle_gaps"])
    assert gaps[400] == "aten::copy_"  # 550 -> 950: no launch ends it; the host in a copy
    assert gaps[120] == "launch in stage:field"  # 0 -> 120: ended by the field's launch
    assert r["idle_gaps"][0][1] == pytest.approx(400e-6)


def test_reduce_device_only(tmp_path):
    """A trace of the device alone holds no host range: the window is the
    host's length handed in, from the first device event."""
    events = [ev("k1", "kernel", 1000, 200, tid=9), ev("k2", "kernel", 1100, 300, tid=9),
              ev("Memcpy HtoD", "gpu_memcpy", 2000, 100, tid=9)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = trace.reduce(str(path), window_s=2000e-6)
    assert r["window_s"] == pytest.approx(2000e-6)
    assert r["busy_s"] == pytest.approx(500e-6)
    assert r["device_ops"][0] == ["k2", pytest.approx(300e-6)]


def test_gap_named_by_the_last_op(tmp_path):
    events = [ev("window", "user_annotation", 0, 1000), ev("aten::mul", "cpu_op", 10, 20),
              ev("k", "kernel", 0, 100, tid=9), ev("k", "kernel", 600, 400, tid=9)]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace.reduce(str(path))["idle_gaps"] == [["after aten::mul", pytest.approx(500e-6)]]


def test_union():
    assert trace.union([(3, 4), (0, 2), (1, 2.5)]) == [(0, 2.5), (3, 4)]
    assert trace.length([(0, 1), (0.5, 2)]) == 2
