"""The port's spans (threedhumangan_tpu_torch/utils/trace.py) on the CPU:
nesting, parents and unit roots across the loader's thread, nothing recorded
outside a ``torch.profiler`` session, the ``span:`` ranges of an exported
chrome trace and the clock that maps a span onto its range, the generator's
stage names in the log and in a caller's hook, a two-step ``Trainer`` run's
spans, the ``launch.<entry>`` span around each C entry of the kernel
library, and the ``Trainer``'s memory counters in its log after an
out-of-memory retry."""

import json
import os
import threading
import time
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from threedhumangan_tpu_torch import _build, configs
from threedhumangan_tpu_torch.data import dataset as ds
from threedhumangan_tpu_torch.data.prefetch import prefetch
from threedhumangan_tpu_torch.data.preprocessor import get_preprocessor
from threedhumangan_tpu_torch.models import generator as gen
from threedhumangan_tpu_torch.models.smpl import synthetic_smpl_model
from threedhumangan_tpu_torch.trainers import base_trainer, phase_trainer
from threedhumangan_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def empty_log():
    trace.take()
    yield
    trace.take()


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nesting_parents_and_roots_across_the_loader_thread():
    with _profiled():
        with trace.span("trainer.pair", unit=True):
            with trace.span("inner", unit=True):  # a unit is open: not a root
                with trace.span("leaf"):
                    pass
            it = prefetch(iter(range(3)), depth=1, transform=lambda x: x + 1)
            got = [next(it) for _ in range(3)]
            it.close()
        spans = trace.take()
    assert got == [1, 2, 3]
    by = _by_name(spans)
    (pair,), (inner,), (leaf,) = by["trainer.pair"], by["inner"], by["leaf"]
    main = threading.get_native_id()
    assert pair.parent is None and pair.root == pair.id and pair.tid == main
    assert inner.parent == pair.id and inner.root == pair.id
    assert leaf.parent == inner.id and leaf.root == pair.id
    assert pair.start_ns <= inner.start_ns <= leaf.start_ns <= leaf.end_ns <= inner.end_ns
    waits, builds = by["loader.wait"], by["loader.build"]
    assert len(waits) == 3 and all(w.parent == pair.id and w.tid == main for w in waits)
    # the worker's thread cannot see the profiler; the session the main
    # thread opened records it all the same, under the open unit
    assert len(builds) >= 3
    assert {b.tid for b in builds} != {main} and all(b.parent is None for b in builds)
    assert all(b.root == pair.id for b in builds if b.start_ns < pair.end_ns)
    assert len({s.id for s in spans}) == len(spans)


def test_nothing_is_recorded_outside_a_profiler_session():
    with trace.span("trainer.pair", unit=True):
        with trace.span("leaf"):
            pass
    it = prefetch(iter(range(2)), depth=1)
    assert list(it) == [0, 1]
    assert trace.take() == []
    with _profiled():
        with trace.span("leaf"):
            pass
    with trace.span("after"):
        pass
    assert [s.name for s in trace.take()] == ["leaf"]


def test_spans_show_as_ranges_and_the_anchor_maps_them(tmp_path):
    with _profiled() as prof:
        for i in range(4):
            with trace.span(f"s{i}"):
                torch.ones(64).add_(1)
    spans = trace.take()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    ranges = {e["name"]: e for e in doc["traceEvents"]
              if e.get("ph") == "X" and str(e.get("name", "")).startswith("span:")}
    assert sorted(ranges) == [f"span:s{i}" for i in range(4)]
    base = doc["baseTimeNanoseconds"]
    for s in spans:
        t0, t1 = s.trace_us(base)
        rng = ranges["span:" + s.name]
        assert abs(t0 - float(rng["ts"])) < 1000.0, (s.name, t0, rng["ts"])
        assert abs(t1 - (float(rng["ts"]) + float(rng["dur"]))) < 1000.0


def _nano():
    meta = dict(configs.extract_metadata(configs.MAP3DBN_NANO, 0))
    meta.update(nerf_noise=0, perturb_rays=False)
    g = torch.Generator().manual_seed(0)
    batch = ds.to_tensors(next(ds.iterate_batches(ds.SyntheticSHHQDataset(
        smpl_model=synthetic_smpl_model(num_verts=96, num_faces=64), **meta), 2,
        shuffle=False)), "cpu")
    cond = get_preprocessor(meta)(batch, rotate=True, generator=g)
    return meta, gen.init_generator(meta, g, "cpu"), cond


@pytest.mark.parametrize("train", [False, True])
def test_every_generator_stage_reaches_the_log_and_the_hook(train):
    meta, g, cond = _nano()
    hooked = []

    def hook(name):
        hooked.append(name)
        return torch.profiler.record_function("hook:" + name)

    z = torch.randn(2, meta["latent_dim"], generator=torch.Generator().manual_seed(1))
    with _profiled():
        gen.generator_forward(g, z, cond, meta, stage=hook, train=train)
        spans = trace.take()
    assert hooked and len(set(hooked)) == len(hooked)
    (root,) = [s for s in spans if s.name == "generator.forward"]
    assert root.root == root.id and all(s.root == root.id for s in spans)
    own = {"generator.forward", "synthesis.glue", "synthesis.operands"}
    assert sorted(s.name for s in spans if s.name not in own) == sorted(hooked)
    stage_spans = [s for s in spans if s.name not in own]
    assert all(s.parent == root.id for s in stage_spans)
    assert ("synthesis.glue" in {s.name for s in spans}) == (not train)
    # a new generator builds K3's operands once, inside the glue
    glue = {s.id for s in spans if s.name == "synthesis.glue"}
    built = [s for s in spans if s.name == "synthesis.operands"]
    assert len(built) == (not train) and all(s.parent in glue for s in built)


def _nano_trainer(out, **kw):
    config = configs.get_config(types.SimpleNamespace(config="MAP3DBN_NANO", tune="", variant=0))
    opt = types.SimpleNamespace(**{**dict(output_dir=out, device="cpu", model_save_interval=100,
                                          model_keep_interval=100, sample_interval=0,
                                          n_epochs=10, seed=3, tensorboard=0), **kw})
    return base_trainer.Trainer(0, 1, opt, config)


def test_a_trainer_run_records_its_spans(tmp_path):
    trainer = _nano_trainer(str(tmp_path))
    with _profiled():
        trainer.run(max_steps=2)
        spans = trace.take()
    by = _by_name(spans)
    for name in ("trainer.pair", "trainer.step", "loader.wait", "loader.build",
                 "trainer.stats_pull", "generator.forward", "d_step", "g_backward",
                 "preprocessor.camera"):
        assert name in by, (name, sorted(by))
    pairs = by["trainer.pair"]
    assert len(pairs) == 3  # two pairs, then the one that finds max_steps
    assert len(by["trainer.step"]) == 2 and len(by["trainer.stats_pull"]) == 1
    ids = {p.id for p in pairs}
    assert all(p.root == p.id for p in pairs)
    parent = {s.id: s.parent for s in spans}
    for s in by["trainer.step"] + by["loader.wait"] + by["trainer.stats_pull"]:
        assert s.parent in ids and s.root == s.parent
    for s in by["d_step"] + by["generator.forward"]:
        assert s.root in ids
        up = s.parent
        while up is not None and up not in ids:
            up = parent[up]
        assert up == s.root  # nested under its pair on the main thread


def test_the_library_entries_launch_inside_their_spans():
    calls = []

    def entry(name):
        def fn(*args):
            calls.append((name, args, time.perf_counter_ns()))
            return 0

        return fn

    raw = {name: entry(name) for name in _build.SIGNATURES}
    lib = _build.bind(types.SimpleNamespace(**raw))
    assert raw["thgt_geo"].argtypes is _build.SIGNATURES["thgt_geo"]  # typed, then wrapped
    with _profiled() as prof:
        assert lib.thgt_synthesis(1, 2, 3) == 0
        assert lib.thgt_geo(4) == 0
        spans = trace.take()
    assert [(n, a) for n, a, _ in calls] == [("thgt_synthesis", (1, 2, 3)), ("thgt_geo", (4,))]
    assert [s.name for s in spans] == ["launch.thgt_synthesis", "launch.thgt_geo"]
    for s, (_, _, t) in zip(spans, calls):
        assert s.start_ns <= t <= s.end_ns
    names = {e.name for e in prof.events()}
    assert {"span:launch.thgt_synthesis", "span:launch.thgt_geo"} <= names


def test_an_oom_retry_shows_in_the_trainers_log(tmp_path, monkeypatch):
    real = phase_trainer.train_step_pair
    state = {"failed": False}

    def pair(ts, *a, **k):
        if not state["failed"]:
            state["failed"] = True
            raise torch.cuda.OutOfMemoryError("injected: out of memory")
        return real(ts, *a, **k)

    monkeypatch.setattr(phase_trainer, "train_step_pair", pair)
    trainer = _nano_trainer(str(tmp_path))
    trainer.run(max_steps=1)
    assert state["failed"] and trainer.step == 1
    with open(os.path.join(trainer.output_dir, "metrics.jsonl")) as f:
        (row,) = [json.loads(line) for line in f]
    assert row["step"] == 1
    assert (row["batch_split"], row["oom_retries"], row["remat_synthesis"]) == (2, 1, 1)
