"""What every run of the benchmark shares: the spec, seeds, stage hooks and
the run's record.

``Spec`` reads ``BENCHMARK.json`` and finds, by the names it holds, a cell's
configuration (``perfbench/configs/<config>.json``), its traffic mix
(``perfbench/traffic/<traffic>.json``, whose ``driver`` key names the general
generator in ``perfbench/drivers/``), its limits
(``perfbench/limits/<cell>.json``) and each metric's reader
(``perfbench/metrics/<metric>.py``).  A new cell, configuration, mix or
metric is a new file and a new entry; no file here changes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "perfbench")


def sub_seed(seed: int, *tags) -> int:
    """A 60-bit seed for one use of the run's seed (any whole number)."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).hexdigest()
    return int(digest[:15], 16)


def _int_keys(d):
    """JSON object keys that are whole numbers back to ints (the curriculum
    steps of a config)."""
    return {int(k) if k.lstrip("-").isdigit() else k: v for k, v in d.items()}


def load_config(path: str) -> Dict:
    """The ``config`` dict of a configuration file, as the port takes it."""
    with open(path) as f:
        doc = json.load(f)
    return _int_keys(doc["config"])


def step_meta(config: Dict, step: int = 0) -> Dict:
    """The merged meta at ``step``: the largest curriculum entry <= step
    with every string key (the port's ``extract_metadata``)."""
    meta = {}
    for k in sorted((k for k in config if isinstance(k, int)), reverse=True):
        if k <= step:
            meta.update(config[k])
            break
    meta.update({k: v for k, v in config.items() if not isinstance(k, int)})
    return meta


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    limits: Dict[str, float]
    end_to_end: List[Dict]
    per_layer: List[Dict]
    root: str = ROOT


class Spec:
    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.doc = json.load(f)

    def cell(self, name: str) -> Cell:
        cells = {w["name"]: w for w in self.doc["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
        w = cells[name]
        cfg = {c["name"]: c for c in self.doc["configs"]}[w["config"]]
        with open(os.path.join(self.root, "perfbench", "traffic", w["traffic"] + ".json")) as f:
            traffic = json.load(f)
        with open(os.path.join(self.root, "perfbench", "limits", name + ".json")) as f:
            limits = json.load(f)["limits"]
        applies = lambda m: name in m.get("workloads", [name])
        return Cell(name=name, chips=int(w["chips"]), config_name=cfg["name"],
                    config=load_config(os.path.join(self.root, cfg["file"])),
                    traffic_name=w["traffic"], traffic=traffic, limits=limits,
                    end_to_end=[m for m in self.doc["end_to_end"] if applies(m)],
                    per_layer=[m for m in self.doc["per_layer"] if applies(m)], root=self.root)


def driver(name: str):
    """The general generator of a traffic mix's ``driver`` key."""
    return importlib.import_module(f"perfbench.drivers.{name}")


def reader(metric: str, root: str = ROOT) -> Callable:
    """``read(record)`` of ``perfbench/metrics/<metric>.py``: the metric's
    number, or None where the run holds nothing for it to read."""
    path = os.path.join(root, "perfbench", "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Record:
    """What one run hands the metric readers.  Times in seconds on the host
    clock (``time.perf_counter``); ``requests`` (start, end, items) of every
    unit of work finished in the window; ``stage_ms`` the CUDA-event ms of
    each occurrence of each stage in the window (traced runs); ``trace`` the
    reduction of a device-only profile of the window (``perfbench.trace``:
    busy time, top device operations); ``spans`` the reduction of a stretch
    before it traced with the host's operations too (the device time
    launched inside each stage, the idle gaps by what the host was doing);
    ``work``
    the operations and bytes of a unit by layer (``perfbench.flops``; a
    stage's under its name, ``model`` the mean a unit of the window);
    ``peak_bytes`` the device memory peak, ``window_peak_bytes`` that of the
    window alone; ``checks`` the numbers compared with the reference,
    ``failed`` the compared units that failed outright; ``notes`` what a
    driver reports for setting the limits (``perfbench.calibrate``)."""

    setup_s: float = 0.0
    window_start: float = 0.0
    window_end: float = 0.0
    requests: List[tuple] = dataclasses.field(default_factory=list)
    stage_ms: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    trace: Optional[Dict] = None
    spans: Optional[Dict] = None
    work: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    window_peak_bytes: int = 0
    checks: Dict[str, float] = dataclasses.field(default_factory=dict)
    failed: int = 0
    notes: Dict = dataclasses.field(default_factory=dict)


class Stages:
    """The ``stage(name)`` hook the port's forwards and steps take.  With
    ``events`` on it records a CUDA event pair around each stage; with
    ``ranges`` on, a ``torch.profiler`` range ``stage:<name>``; off, it
    does nothing."""

    def __init__(self):
        self.events_on = self.ranges_on = False
        self.events: Dict[str, list] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        if not (self.events_on or self.ranges_on):
            yield
            return
        import torch

        rng = (torch.profiler.record_function("stage:" + name) if self.ranges_on
               else contextlib.nullcontext())
        with rng:
            if self.events_on:
                s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                s.record()
            yield
            if self.events_on:
                e.record()
                self.events.setdefault(name, []).append((s, e))

    def ms(self) -> Dict[str, List[float]]:
        import torch

        torch.cuda.synchronize()
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.events.items()}


class Profiled:
    """A ``torch.profiler`` session around a window, started and stopped
    outside its clock.  ``host=False`` traces the device's activity alone
    (little cost to the host); ``host=True`` also the host's operations and
    the ``window`` and ``stage:`` ranges.  ``result()`` is the reduced trace."""

    def __init__(self, host: bool):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
        self.host = host
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.rng = torch.profiler.record_function("window") if host else None
        if self.rng is not None:
            self.rng.__enter__()

    def stop(self, window_s: float) -> Dict:
        import tempfile

        import torch

        from perfbench import trace

        if self.rng is not None:
            self.rng.__exit__(None, None, None)
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return trace.reduce(path, window_s=None if self.host else window_s)
        finally:
            os.remove(path)
