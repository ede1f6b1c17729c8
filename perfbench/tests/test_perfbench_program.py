"""The port's spans against a made-up device-only profiler trace
(``perfbench.program``): each gap's name, the ``program`` key, the rule for
autograd's and the loader's threads, the launches inside their spans, the
window and busy time as ``perfbench.trace.reduce`` has them, and the readers
of the span metrics."""

import json

import pytest

from perfbench import harness, program, trace
from threedhumangan_tpu_torch.utils.trace import Span

BASE_NS = 1_790_000_000_000_000_000  # the trace's baseTimeNanoseconds
EPOCH_NS = BASE_NS - 123_456_789_000  # wall clock less perf_counter: a clock offset
MAIN, AUTOGRAD, LOADER, DEVICE = 11, 12, 13, 7


def span(sid, name, t0_us, t1_us, tid=MAIN, parent=None, root=1):
    to_ns = lambda t: int(t * 1000) + BASE_NS - EPOCH_NS
    return Span(sid, name, tid, parent, root, to_ns(t0_us), to_ns(t1_us), EPOCH_NS)


def ev(name, cat, ts, dur, tid, corr):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "args": {"correlation": corr}}


SPANS = [
    span(1, "trainer.pair", 0, 1000),
    span(2, "trainer.step", 10, 900, parent=1),
    span(5, "d_step", 100, 300, parent=2),
    span(6, "loader.build", 200, 260, tid=LOADER),
    span(3, "g_backward", 400, 800, parent=2),
    span(4, "launch.thgt_field_bwd", 500, 510, tid=AUTOGRAD),
    span(7, "trainer.stats_pull", 920, 980, parent=1),
]
FIELD = "void (anonymous namespace)::field_kernel<1, false>(int, float const*)"
K3 = "void (anonymous namespace)::synthesis_kernel<(anonymous namespace)::A>()"
EVENTS = [
    ev("cudaLaunchKernel", "cuda_runtime", -5, 2, MAIN, 1),
    ev("k_a", "kernel", 0, 100, DEVICE, 1),
    ev("cudaLaunchKernel", "cuda_runtime", 120, 2, MAIN, 2),  # in d_step
    ev("k_b", "kernel", 150, 100, DEVICE, 2),
    ev("cudaMemcpyAsync", "cuda_runtime", 210, 2, LOADER, 3),  # the loader's copy
    ev("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 280, 10, DEVICE, 3),
    ev("cudaLaunchKernel", "cuda_runtime", 505, 2, AUTOGRAD, 4),  # inside its launch span
    ev(FIELD, "kernel", 600, 100, DEVICE, 4),
    ev("cudaLaunchKernel", "cuda_runtime", 450, 2, AUTOGRAD, 5),  # autograd, no span there
    ev("k_c", "kernel", 750, 10, DEVICE, 5),
    ev("cudaLaunchKernel", "cuda_runtime", 940, 2, MAIN, 6),  # a port kernel, no launch span
    ev(K3, "kernel", 950, 10, DEVICE, 6),
    ev("cudaLaunchKernel", "cuda_runtime", 1010, 2, MAIN, 7),  # between pairs
    ev("k_d", "kernel", 1050, 100, DEVICE, 7),  # cut at the window's end
]
DOC = {"traceEvents": EVENTS, "baseTimeNanoseconds": BASE_NS}


def test_gaps_are_named_by_the_span_open_at_their_launch():
    r = program.reduce(DOC, SPANS, window_s=1100e-6)
    assert [n for n, _ in r["idle_gaps"]] == [
        "span:launch.thgt_field_bwd",  # 290 -> 600: autograd's thread, in its launch span
        "span:trainer.stats_pull",     # 760 -> 950
        program.OUTSIDE,               # 960 -> 1050: launched between pairs
        "span:d_step",                 # 100 -> 150
        "span:g_backward",             # 700 -> 750: autograd's thread, no span: the unit's
        "span:loader.build",           # 250 -> 280: the loader's copy
    ]
    assert [s for _, s in r["idle_gaps"]] == pytest.approx(
        [310e-6, 190e-6, 90e-6, 50e-6, 50e-6, 30e-6])


def test_the_program_key():
    p = program.reduce(DOC, SPANS, window_s=1100e-6)["program"]
    us = 1e-6
    assert p["idle_outside_s"] == pytest.approx(90 * us)
    assert p["d_step"] == {"count": 1, "host_s": pytest.approx(200 * us),
                           "idle_s": pytest.approx(50 * us),
                           "idle_within_s": pytest.approx((50 + 30) * us)}
    assert p["g_backward"]["idle_s"] == pytest.approx(50 * us)
    assert p["g_backward"]["idle_within_s"] == pytest.approx((310 + 50) * us)
    assert p["launch.thgt_field_bwd"]["idle_s"] == pytest.approx(310 * us)
    assert p["loader.build"]["idle_within_s"] == pytest.approx(30 * us)
    step = p["trainer.step"]["idle_within_s"]
    assert step == pytest.approx((50 + 30 + 310 + 50) * us)  # the loader's copy in d_step's time
    assert p["trainer.pair"]["idle_within_s"] - step == pytest.approx(190 * us)
    assert p["trainer.pair"]["host_s"] == pytest.approx(1000 * us)
    total_idle = sum(v["idle_s"] for k, v in p.items() if k != "idle_outside_s")
    assert total_idle + p["idle_outside_s"] == pytest.approx((1100 - 380) * us)


def test_the_autograd_thread_rule():
    """A launch from a thread with no span open, or whose spans are not under
    a unit's root, continues into what the unit's thread had open."""
    threads = program._Threads(SPANS, BASE_NS)
    assert [s.name for s in threads.chain(AUTOGRAD, 450)] == [
        "g_backward", "trainer.step", "trainer.pair"]
    assert [s.name for s in threads.chain(AUTOGRAD, 505)] == [
        "launch.thgt_field_bwd", "g_backward", "trainer.step", "trainer.pair"]
    assert [s.name for s in threads.chain(AUTOGRAD, 505, follow=False)] == [
        "launch.thgt_field_bwd"]
    assert [s.name for s in threads.chain(LOADER, 1010)] == []
    assert [s.name for s in threads.chain(MAIN, 1010)] == []


def test_launches_inside_their_spans():
    r = program.reduce(DOC, SPANS, window_s=1100e-6)
    assert r["launches"] == {"port": 2, "inside_launch_span": 1}


def test_window_and_busy_as_the_trace_reduction_has_them(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(DOC))
    base = trace.reduce(str(path), window_s=1100e-6)
    r = program.reduce(DOC, SPANS, window_s=1100e-6)
    idle = base["window_s"] - base["busy_s"]
    p = r["program"]
    named = sum(v["idle_s"] for k, v in p.items() if k != "idle_outside_s")
    assert named + p["idle_outside_s"] == pytest.approx(idle)
    assert sum(s for _, s in r["idle_gaps"]) == pytest.approx(idle)
    assert program.reduce(DOC, [], window_s=1100e-6)["idle_gaps"] == [
        [program.OUTSIDE, pytest.approx(s)] for _, s in base["idle_gaps"]]


def _record(units=2):
    rec = harness.Record(window_start=1.0, window_end=2.0)
    rec.requests = [(1.0, 1.5, 8)] * units
    return rec


def _at(sid, name, t0_s, t1_s):
    return Span(sid, name, MAIN, None, sid, int(t0_s * 1e9), int(t1_s * 1e9), 0)


@pytest.mark.parametrize("metric,name", [("gen.synthesis_glue_ms", "synthesis.glue"),
                                         ("train.loader_wait_ms", "loader.wait")])
def test_span_readers(monkeypatch, metric, name):
    read = harness.reader(metric)
    monkeypatch.setattr(program, "_TAKEN", [])
    assert read(_record()) is None  # a run without the program's spans
    monkeypatch.setattr(program, "_TAKEN", [
        _at(1, name, 0.5, 0.9),      # before the window
        _at(2, name, 1.1, 1.105),
        _at(3, name, 1.5, 1.515),
        _at(4, "other", 1.2, 1.3),
        _at(5, name, 1.999, 2.5),    # cut at the window's end
    ])
    assert read(_record()) == pytest.approx((5 + 15 + 1) / 2)
    monkeypatch.setattr(program, "_TAKEN", [_at(4, "other", 1.2, 1.3)])
    assert read(_record()) is None
