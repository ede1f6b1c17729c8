"""The port's spans: named host intervals recorded where the work happens.

``span(name)`` is a context manager around a piece of the port's host work;
``take()`` drains the log and returns the recorded spans, oldest first.  A
span records its name, the OS thread id (``threading.get_native_id``, the
``tid`` of a ``torch.profiler`` trace), its parent (the span open around it
on its thread), its unit's root span (the outermost ``unit=True`` span open
in the process when it opened: ``generator.forward`` for a batch,
``trainer.pair`` for a training pair, so the spans of one batch or pair,
the loader's and autograd's threads included, share that id), and its start
and end from ``time.perf_counter_ns()``.

Spans are recorded only while a ``torch.profiler`` session is active: each
span asks ``torch._C._autograd._profiler_enabled()`` (~60 ns).  That check
reads the calling thread's profiler state, which autograd's threads inherit
and other threads (the prefetch worker) do not, so the thread that first sees
a session opens it for every thread, and closes it when it sees the session
gone (as does ``take()`` on a thread outside any session).  While recording,
a span also opens ``torch.profiler.record_function("span:<name>")`` on
threads that see the session, so it shows in an exported trace.

The clock: at a session's start the tracer takes one anchor, ``time.time_ns()
- time.perf_counter_ns()``, kept on each span as ``epoch_ns``.  A chrome
trace's event times are microseconds after its ``baseTimeNanoseconds`` on
the wall clock, so a span's start in a trace's time is ``(start_ns +
epoch_ns - baseTimeNanoseconds) / 1000`` (``trace_us``).

``staged(hook)`` turns the ``stage`` argument of the port's forwards and
steps into the callable they call: each ``stage(name)`` opens the span
``name`` and inside it the caller's hook, if one was given.

The log is bounded (``LOG_SPANS``): past it, the oldest spans are dropped.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import Callable, List, NamedTuple, Optional

import torch

LOG_SPANS = 1 << 18
_profiling = torch._C._autograd._profiler_enabled


class Span(NamedTuple):
    id: int
    name: str
    tid: int
    parent: Optional[int]
    root: Optional[int]
    start_ns: int
    end_ns: int
    epoch_ns: int

    def trace_us(self, base_ns: int):
        """(start, end) in a chrome trace's microseconds after ``base_ns``."""
        off = self.epoch_ns - base_ns
        return (self.start_ns + off) / 1e3, (self.end_ns + off) / 1e3


class Tracer:
    """The log, the open session and the open unit of one process."""

    def __init__(self, maxlen: int = LOG_SPANS):
        self.log: collections.deque = collections.deque(maxlen=maxlen)
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.session = None  # (tid of the thread that saw it, epoch_ns) while one is open
        self.unit: Optional[int] = None  # id of the open unit root span

    def current(self):
        """The open session, opened or closed by what this thread sees."""
        sess = self.session
        if _profiling():
            if sess is None:
                sess = self.session = (threading.get_native_id(),
                                       time.time_ns() - time.perf_counter_ns())
        elif sess is not None and sess[0] == threading.get_native_id():
            sess = self.session = None
        return sess

    def take(self) -> List[Span]:
        if not _profiling():
            self.session = None
        out = []
        while self.log:
            try:
                out.append(self.log.popleft())
            except IndexError:
                break
        return out


_TRACER = Tracer()


class _Open:
    __slots__ = ("name", "unit", "rec", "rf", "t0")

    def __init__(self, name: str, unit: bool):
        self.name, self.unit, self.rec = name, unit, None

    def __enter__(self):
        tr = _TRACER
        sess = tr.current()
        if sess is None:
            return self
        stack = getattr(tr.local, "stack", None)
        if stack is None:
            stack = tr.local.stack = []
        sid = next(tr.ids)
        if self.unit and tr.unit is None:
            tr.unit = sid
        self.rec = (sid, stack[-1] if stack else None, tr.unit, sess[1])
        stack.append(sid)
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function("span:" + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec is None:
            return False
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        tr = _TRACER
        sid, parent, root, epoch = self.rec
        tr.local.stack.pop()
        if tr.unit == sid:
            tr.unit = None
        tr.log.append(Span(sid, self.name, threading.get_native_id(), parent, root, self.t0, t1,
                           epoch))
        return False


def span(name: str, unit: bool = False) -> _Open:
    """A context manager recording the span ``name``; ``unit`` marks a unit's
    root (it is one where no unit is open yet)."""
    return _Open(name, unit)


def take() -> List[Span]:
    """The recorded spans, oldest first; the log is left empty."""
    return _TRACER.take()


@contextlib.contextmanager
def _staged(name: str, hook: Optional[Callable]):
    with span(name):
        if hook is None:
            yield
        else:
            with hook(name):
                yield


def staged(hook: Optional[Callable] = None) -> Callable:
    """The ``stage(name)`` callable of the port's forwards and steps: the
    span ``name`` around the caller's ``hook(name)`` (none: the span alone).
    A callable this returned comes back as it is."""
    if getattr(hook, "port_spans", False):
        return hook

    def stage(name: str):
        return _staged(name, hook)

    stage.port_spans = True
    return stage
