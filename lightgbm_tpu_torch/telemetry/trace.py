"""Hierarchical host-side span tracing with chrome-trace export.

Copy of ``lightgbm_tpu/telemetry/trace.py``.  ``span("tree/wave")``
contexts nest through a thread-local stack, producing events whose names
are full slash paths; each host span also opens a
``torch.profiler.record_function`` range so the same names line up with
device rows when a ``torch.profiler`` capture is running.

Cost model: when the tracer is disabled (the default) ``span()`` returns
a shared no-op context manager — the entire overhead is one function
call and two attribute reads, so spans can stay compiled into the
boosting loop the way the reference leaves ``FunctionTimer`` timetags
compiled in (common.h:995).  When only ``utils/timer.global_timer`` is
enabled (the ``LGBM_TPU_TIMETAG=1`` compat shim), spans feed the timer's
per-tag accumulators without recording trace events.

Export: ``global_tracer.export_chrome_trace(path)`` writes the
``chrome://tracing`` / Perfetto JSON array format.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List

from ..utils.timer import global_timer

__all__ = ["Tracer", "global_tracer", "span"]


class _NoopSpan:
    """Shared do-nothing context manager for the disabled fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()
_tls = threading.local()


class Tracer:
    """Collects (path, start, duration, thread) span events."""

    MAX_EVENTS = 1 << 20  # hard cap: a forgotten enable() can't eat RAM

    def __init__(self) -> None:
        self.enabled = os.environ.get("LGBM_TPU_TRACE", "0") == "1"
        self._lock = threading.Lock()
        self._events: List[Dict] = []
        self._t0 = time.perf_counter()
        self._dropped = 0

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events = []
            self._dropped = 0
            self._t0 = time.perf_counter()

    def _record(self, path: str, start_s: float, dur_s: float,
                tid: int) -> None:
        ev = {"name": path,
              "ts": (start_s - self._t0) * 1e6,   # chrome trace wants us
              "dur": dur_s * 1e6,
              "ph": "X", "pid": os.getpid(), "tid": tid}
        with self._lock:
            if len(self._events) < self.MAX_EVENTS:
                self._events.append(ev)
            else:
                self._dropped += 1

    def events(self) -> List[Dict]:
        with self._lock:
            return list(self._events)

    def export_chrome_trace(self, path: str) -> int:
        """Write the collected spans as chrome-trace JSON; returns the
        event count written."""
        with self._lock:
            events = list(self._events)
            dropped = self._dropped
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if dropped:
            doc["metadata"] = {"dropped_events": dropped}
        with open(path, "w") as fh:
            json.dump(doc, fh)
        return len(events)


global_tracer = Tracer()


class _Span:
    """Live span: pushes its name on the thread-local path stack, times
    the region, and mirrors it to the torch profiler + global_timer."""

    __slots__ = ("name", "path", "_trace", "_timer", "_t0", "_prof_scope")

    def __init__(self, name: str, trace_on: bool, timer_on: bool) -> None:
        self.name = name
        self._trace = trace_on
        self._timer = timer_on
        self._prof_scope = None

    def __enter__(self):
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        self.path = "/".join(stack + [self.name]) if stack else self.name
        stack.append(self.name)
        if self._timer:
            global_timer.start(self.path)
        if self._trace:
            try:
                import torch
                self._prof_scope = torch.profiler.record_function(self.path)
                self._prof_scope.__enter__()
            except Exception:
                self._prof_scope = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self._prof_scope is not None:
            self._prof_scope.__exit__(*exc)
        if self._timer:
            global_timer.stop(self.path)
        if self._trace:
            global_tracer._record(self.path, self._t0, t1 - self._t0,
                                  threading.get_ident())
        stack = getattr(_tls, "stack", None)
        if stack:
            stack.pop()
        return False


def span(name: str):
    """``with span("tree/grow"):`` — nested scope timer/tracer.

    Near-zero overhead when both the tracer and the timetag timer are
    disabled (returns a shared no-op context manager)."""
    trace_on = global_tracer.enabled
    timer_on = global_timer.enabled
    if not (trace_on or timer_on):
        return _NOOP
    return _Span(name, trace_on, timer_on)
