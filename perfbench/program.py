"""The port's own spans (``threedhumangan_tpu_torch.utils.trace``) read by
the benchmark: host time by span over a window, and the device's idle named
by the span open where the work that ended each gap was launched.

``spans()`` takes what the port's tracer has recorded in this process (the
readers of ``program_span`` metrics call it; None where the program has no
tracer, as before it had one).  ``reduce(doc, spans, window_s)`` reduces a
``torch.profiler`` chrome trace (its parsed JSON) with the spans of its
session, on the trace's clock (a span's ``trace_us``):

* ``program``: for each span name, its ``count`` (spans starting in the
  window), ``host_s`` (their time inside the window), ``idle_s`` (the idle
  of the window in gaps whose ending launch was issued while that span was
  the innermost one open) and ``idle_within_s`` (the same where the span was
  open at all: the span and its descendants); and ``idle_outside_s``, the
  gaps with no span open;
* ``idle_gaps``: the ten longest gaps, each named ``span:<innermost>`` or
  ``outside the program``;
* ``launches``: of the port's kernels launched in the window (a device
  kernel of ``csrc/``, by name), how many were launched inside a
  ``launch.<entry>`` span of the launching thread, once mapped.

The rule for naming a gap: the work that ends it is the first device event
starting at or after its end; its launch (by correlation id) gives the
thread and time.  Take the innermost span open on that thread then; where the
thread has none, or its outermost open span is not a unit's root, continue
into what the thread holding the open unit's root span had open at that time
(autograd's device thread launches the backward while the step's thread
waits in it).  A gap that no launch ends is named by what that thread had
open at the gap's start.  The window is ``perfbench.trace.reduce``'s.

    python3 -m perfbench.program --workload <name> --seed <n> --seconds <s>

runs a cell traced as ``perfbench.run --trace 1`` does, with each profile of
the run also reduced here (the harness's own profiles do not call
``reduce``), and prints one JSON line: each session's reduction, the traced
window's units and imgs/s, and the cell's per-layer metrics.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import re
import sys
from typing import Dict, List, Optional

from perfbench import trace

PORT_KERNEL = re.compile(r"\(anonymous namespace\)::(bins_kernel|cluster_kernel|field_kernel|"
                         r"geo_kernel|half_block_bwd|half_block_fwd|nn_kernel|rasterize_kernel|"
                         r"raymarch_kernel|synthesis_kernel|wgrad_kernel)\b")
OUTSIDE = "outside the program"
_TAKEN: List = []


def spans() -> Optional[List]:
    """Every span the port's tracer has recorded in this process so far
    (taken from it and kept here); None where the program has no tracer."""
    try:
        from threedhumangan_tpu_torch.utils import trace as port_trace
    except ImportError:
        return None
    _TAKEN.extend(port_trace.take())
    return _TAKEN


def host_ms_per_unit(rec, name: str) -> Optional[float]:
    """Mean ms a unit of the window (``rec.requests``) of the host time of the
    spans ``name`` that started in the window; None where none did."""
    got = spans()
    if not got or not rec.requests:
        return None
    t0, t1 = rec.window_start * 1e9, rec.window_end * 1e9
    inside = [s for s in got if s.name == name and t0 <= s.start_ns < t1]
    if not inside:
        return None
    return sum(min(s.end_ns, t1) - s.start_ns for s in inside) / 1e6 / len(rec.requests)


class _Threads:
    """The spans of each thread, for the chain open at a time."""

    def __init__(self, spans, base_ns: int):
        self.by_id = {}
        per = {}
        for s in spans:
            t0, t1 = s.trace_us(base_ns)
            self.by_id[s.id] = (t0, t1, s)
            per.setdefault(s.tid, []).append((t0, s.id))
        self.starts = {tid: [t for t, _ in sorted(v)] for tid, v in per.items()}
        self.ids = {tid: [i for _, i in sorted(v)] for tid, v in per.items()}
        roots = sorted((t0, sid) for sid, (t0, _, s) in self.by_id.items() if s.root == s.id)
        self.root_starts, self.root_ids = [t for t, _ in roots], [i for _, i in roots]

    def _open(self, sid, t):
        while sid is not None:
            t0, t1, s = self.by_id[sid]
            if t0 <= t < t1:
                return sid
            sid = s.parent if s.parent in self.by_id else None
        return None

    def chain(self, tid, t, follow: bool = True) -> List:
        """The spans open on ``tid`` at ``t``, innermost first, continued
        into the unit's thread by the rule above (``follow``)."""
        out = []
        i = bisect.bisect_right(self.starts.get(tid, []), t) - 1
        sid = self._open(self.ids[tid][i], t) if i >= 0 else None
        while sid is not None:
            out.append(self.by_id[sid][2])
            sid = out[-1].parent if out[-1].parent in self.by_id else None
        if not follow or (out and out[-1].root == out[-1].id):
            return out
        j = bisect.bisect_right(self.root_starts, t) - 1
        root = self._open(self.root_ids[j], t) if j >= 0 else None
        if root is not None and self.by_id[root][2].tid != tid:
            out += self.chain(self.by_id[root][2].tid, t)
        return out


def reduce(doc: Dict, spans, window_s=None, top: int = 10) -> Dict:
    events = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    us = 1e-6
    dev = [e for e in events if e.get("cat") in trace.DEVICE_CATS and "dur" in e]
    if window_s is not None:
        w0 = min((float(e["ts"]) for e in dev), default=0.0)
        w1 = w0 + window_s / us
    else:
        window = [e for e in events
                  if e.get("name") == "window" and e.get("cat") == "user_annotation"]
        if not window:
            raise ValueError("the trace holds no 'window' range")
        w0, w1 = float(window[0]["ts"]), float(window[0]["ts"]) + float(window[0]["dur"])
    busy = trace.union([(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                        for e in dev])
    busy = [(s, e) for s, e in busy if e > s]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
            if edges[i + 1] > edges[i]]
    launch = {e.get("args", {}).get("correlation"): (float(e["ts"]), e.get("tid"))
              for e in events if e.get("cat") in trace.LAUNCH_CATS}
    starts = sorted((float(e["ts"]), e.get("args", {}).get("correlation")) for e in dev)
    start_ts = [t for t, _ in starts]
    threads = _Threads(spans, int(doc.get("baseTimeNanoseconds", 0)))
    unit_tid = {s.tid for s in spans if s.root == s.id}
    prog: Dict[str, Dict] = {}

    def entry(name):
        return prog.setdefault(name, {"count": 0, "host_s": 0.0, "idle_s": 0.0,
                                      "idle_within_s": 0.0})

    for t0, t1, s in threads.by_id.values():
        if w0 <= t0 < w1:
            rec = entry(s.name)
            rec["count"] += 1
            rec["host_s"] += (min(t1, w1) - t0) * us
    outside, named = 0.0, []
    for g0, g1 in gaps:
        i = bisect.bisect_left(start_ts, g1)
        at = launch.get(starts[i][1]) if i < len(starts) else None
        if at is None:  # no launch ends it: what the unit's thread had open as it began
            at = (g0, next(iter(unit_tid), None))
        chain = threads.chain(at[1], at[0])
        idle = (g1 - g0) * us
        if not chain:
            outside += idle
            named.append((OUTSIDE, idle))
            continue
        entry(chain[0].name)["idle_s"] += idle
        for name in {s.name for s in chain}:
            entry(name)["idle_within_s"] += idle
        named.append(("span:" + chain[0].name, idle))
    port = [launch.get(e.get("args", {}).get("correlation")) for e in dev
            if e.get("cat") == "kernel" and PORT_KERNEL.search(e["name"])]
    port = [at for at in port if at is not None and w0 <= at[0] < w1]
    inside = sum(any(s.name.startswith("launch.") for s in threads.chain(tid, t, False)[:1])
                 for t, tid in port)
    named.sort(key=lambda g: -g[1])
    return {"program": dict(prog, idle_outside_s=outside),
            "idle_gaps": [list(g) for g in named[:top]],
            "launches": {"port": len(port), "inside_launch_span": inside}}


def kept_profile(sessions: List[Dict]):
    """``perfbench.harness.Profiled`` whose ``stop`` also appends to
    ``sessions`` its trace reduced by ``reduce`` with the port's spans."""
    import tempfile

    import torch

    from perfbench import harness

    class Kept(harness.Profiled):
        def stop(self, window_s):
            if self.rng is not None:
                self.rng.__exit__(None, None, None)
                self.rng = None
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.prof.__exit__(None, None, None)
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self.prof.export_chrome_trace(path)
                out = trace.reduce(path, window_s=None if self.host else window_s)
                with open(path) as f:
                    doc = json.load(f)
            finally:
                os.remove(path)
            sessions.append(dict(host=self.host, window_s=out["window_s"], busy_s=out["busy_s"],
                                 **reduce(doc, list(spans() or []),
                                          None if self.host else window_s)))
            return out

    return Kept


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="a cell traced, its idle by the port's spans")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = p.parse_args(argv)
    import torch

    from perfbench import harness

    cell = harness.Spec().cell(args.workload)
    drv = harness.driver(cell.traffic["driver"])
    sessions: List[Dict] = []
    drv.Profiled = kept_profile(sessions)
    rec = drv.run(cell, args.seed, args.seconds, True, torch.device("cuda"), 0.0)
    items = sum(r[2] for r in rec.requests)
    metrics = {}
    for m in cell.per_layer:
        value = harness.reader(m["name"], cell.root)(rec)
        if value is not None:
            metrics[m["name"]] = value
    line = json.dumps({"workload": args.workload, "seed": args.seed, "sessions": sessions,
                       "units": len(rec.requests),
                       "window_imgs_per_s": items / (rec.window_end - rec.window_start),
                       "metrics": metrics, "checks": rec.checks, "failed": rec.failed,
                       "device": torch.cuda.get_device_name(0)})
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    # the readers import ``perfbench.program``: run in that module, not in a
    # second copy of it under ``__main__``, so that both hold the same spans
    from perfbench import program

    sys.exit(program.main())
