"""Reduction of a ``torch.profiler`` chrome trace to what the readers need.

Device activity is every kernel, memcpy and memset event.  ``reduce`` gives:

* ``window_s``: the traced window (the ``window`` range the harness records;
  in a trace of the device alone, which holds no host range, the window's
  length on the host's clock, handed in, and every device event of the
  trace is the window's);
* ``busy_s``: the length of the union of the device intervals inside it;
* ``spans``: for each ``stage:<name>`` range, the count of its occurrences and
  the device seconds (union) of the activity launched while it was open, on
  any host thread (a backward's kernels are launched by autograd's device
  thread), matched by the launches' correlation ids;
* ``device_ops``: the ten device operations that took most time, by name;
* ``idle_gaps``: the ten longest gaps between device activity inside the
  window, each named by what the host was doing when it launched the work
  that ended the gap (the stage range and outermost CPU op open at the
  launch, matched by correlation id, so that the host's and the device's
  clocks need not agree); where no launch is found, by what the host was in
  when the gap began (else the last op it had left).
"""

from __future__ import annotations

import bisect
import json
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged [start, end) intervals, sorted."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def length(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def reduce(path: str, top: int = 10, window_s=None) -> Dict:
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    us = 1e-6
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if window_s is not None:
        w0 = min((float(e["ts"]) for e in dev), default=0.0)
        w1 = w0 + window_s / us
    else:
        window = [e for e in events
                  if e.get("name") == "window" and e.get("cat") == "user_annotation"]
        if not window:
            raise ValueError("the trace holds no 'window' range")
        w0 = float(window[0]["ts"])
        w1 = w0 + float(window[0]["dur"])
    clip = lambda s, e: (max(s, w0), min(e, w1))
    dev_iv = [clip(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    busy = union([(s, e) for s, e in dev_iv if e > s])
    by_corr: Dict[int, List[Tuple[float, float]]] = {}
    for e in dev:
        c = e.get("args", {}).get("correlation")
        if c is not None:
            by_corr.setdefault(c, []).append((float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    launches = sorted((float(e["ts"]), e.get("tid"), e.get("args", {}).get("correlation"))
                      for e in events if e.get("cat") in LAUNCH_CATS)
    launch_ts = [t for t, _, _ in launches]
    stages = [e for e in events
              if e.get("cat") == "user_annotation" and str(e.get("name", "")).startswith("stage:")]
    spans: Dict[str, Dict] = {}
    for st in stages:
        s0, s1 = float(st["ts"]), float(st["ts"]) + float(st["dur"])
        iv = []
        for i in range(bisect.bisect_left(launch_ts, s0), bisect.bisect_right(launch_ts, s1)):
            _, _, corr = launches[i]
            if corr in by_corr:
                iv += by_corr[corr]
        rec = spans.setdefault(st["name"][len("stage:"):], {"count": 0, "device_s": 0.0})
        rec["count"] += 1
        rec["device_s"] += length(iv) * us
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"]) * us
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges) - 1, 2):
        if edges[i + 1] > edges[i]:
            gaps.append((edges[i], edges[i + 1]))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in events if e.get("cat") in ("user_annotation", "cpu_op")
                   and e.get("name") != "window"), key=lambda h: (h[0], -h[1]))
    launch_of = {c: t for t, _, c in launches if c is not None}
    starts = sorted((float(e["ts"]), e.get("args", {}).get("correlation")) for e in dev)
    start_ts = [t for t, _ in starts]

    def doing(t):
        stage = op = last = None
        for h0, h1, name in host:
            if h0 > t:
                break
            if h1 > t:
                if name.startswith("stage:"):
                    stage = name
                elif op is None:
                    op = name
            elif not name.startswith("stage:") and (last is None or h1 > last[0]):
                last = (h1, name)
        if op is None and last is not None:
            op = "after " + last[1]
        return " / ".join(x for x in (stage, op) if x) or "host outside any op"

    def gap_name(g0, g1):
        i = bisect.bisect_left(start_ts, g1)
        launch = launch_of.get(starts[i][1]) if i < len(starts) else None
        return "launch in " + doing(launch) if launch is not None else doing(g0)

    return {"window_s": (w1 - w0) * us, "busy_s": length(busy) * us, "spans": spans,
            "device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": [[gap_name(g0, g1), (g1 - g0) * us] for g0, g1 in gaps]}
