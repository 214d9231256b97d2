"""Aggregate wall-time tracing (reference include/LightGBM/utils/common.h:931
``Common::Timer`` + common.h:995 RAII ``FunctionTimer``).  Enabled via env
LGBM_TPU_TIMETAG=1 or ``global_timer.enable()``.

Port of lightgbm_tpu/utils/timer.py without the telemetry-registry
publishing (the port has no telemetry subsystem yet); ``FunctionTimer``
can also open a ``torch.profiler.record_function`` range so host spans
line up with device kernels in a profiler trace."""

from __future__ import annotations

import atexit
import collections
import os
import time
from typing import Dict


class Timer:
    def __init__(self) -> None:
        self._acc: Dict[str, float] = collections.defaultdict(float)
        self._count: Dict[str, int] = collections.defaultdict(int)
        self._start: Dict[str, float] = {}
        self.enabled = os.environ.get("LGBM_TPU_TIMETAG", "0") == "1"

    def enable(self) -> None:
        self.enabled = True

    def start(self, name: str) -> None:
        if self.enabled:
            self._start[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        if not self.enabled or name not in self._start:
            return
        dt = time.perf_counter() - self._start.pop(name)
        self._acc[name] += dt
        self._count[name] += 1

    def report(self) -> str:
        lines = [f"{name} = {secs:.6f}s (n={self._count[name]})"
                 for name, secs in sorted(self._acc.items())]
        return "\n".join(lines)

    def print_at_exit(self) -> None:
        if self.enabled and self._acc:
            from .log import _emit
            _emit("[LightGBM-TPU] [Info] time tags:\n" + self.report())


global_timer = Timer()
atexit.register(global_timer.print_at_exit)


class FunctionTimer:
    """``with FunctionTimer("name"):`` — RAII scope timer, optionally also
    emitting a ``torch.profiler.record_function`` range."""

    def __init__(self, name: str, use_profiler_range: bool = False) -> None:
        self.name = name
        self._scope = None
        if use_profiler_range:
            import torch
            self._scope = torch.profiler.record_function(name)

    def __enter__(self):
        global_timer.start(self.name)
        if self._scope is not None:
            self._scope.__enter__()
        return self

    def __exit__(self, *exc):
        if self._scope is not None:
            self._scope.__exit__(*exc)
        global_timer.stop(self.name)
        return False
