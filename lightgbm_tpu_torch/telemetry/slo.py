"""Declarative service-level objectives: the declarations, the metric
ensurers and the slowest-request exemplar ring.

Copy of the part of ``lightgbm_tpu/telemetry/slo.py`` that the serving
stats and the compilers import (``SLO``, ``slo``, ``all_slos``,
``register_metric_ensurer``, ``ensure_metrics``, ``ExemplarRing``),
kept inside the PyTorch port so the port never imports the JAX package.  An
objective is declared NEXT TO the code it bounds and keyed to a
:class:`~lightgbm_tpu_torch.telemetry.metrics.MetricsRegistry` series.
The burn-rate engine that evaluates them (``SloEngine``) comes with the
serving tier (ROADMAP queue 1 item 11b).
"""

from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from .metrics import MetricsRegistry, default_registry

__all__ = ["SLO", "slo", "all_slos", "register_metric_ensurer",
           "ensure_metrics", "ExemplarRing"]


@dataclass(frozen=True)
class SLO:
    """One declared objective.

    ``metric`` is the registry series the SLO is keyed to (the coverage
    lint validates it exists); ``kind`` is ``"ratio"`` (bad events over
    a total, both counters), ``"latency"`` (a windowed histogram whose
    observations must stay under ``threshold_ms``), or ``"gauge_floor"``
    (a gauge that must stay at or above ``floor`` — the fleet
    supervision kind: every evaluation with ANY matching series below
    the floor spends budget, so "no worker alive" burns exactly like
    "every request 5xx"), or ``"gauge_ceiling"`` (the mirror image: a
    gauge that must stay at or below ``ceiling`` — the staleness kind:
    any worker's rounds-behind gauge above the ceiling spends budget).
    ``target`` is the good fraction (0.999
    availability = 0.1% error budget).  For ratio SLOs ``bad_labels``
    selects the bad series of ``metric`` (label values may be fnmatch
    patterns: ``{"code": "5*"}``) and ``total_metric`` names the
    denominator counter.  For latency SLOs every label combination of
    the histogram (e.g. each shape bucket) is evaluated independently —
    one declaration covers the ladder.  Gauge-floor SLOs have a per
    scrape error of 0 or 1, so declare them with a wide budget and low
    burn thresholds (e.g. ``target=0.5, burn_fast=1.9``: a breach means
    essentially EVERY fast-window scrape saw the gauge under its
    floor)."""

    name: str
    metric: str
    kind: str        # "ratio" | "latency" | "gauge_floor" | "gauge_ceiling"
    target: float
    threshold_ms: float = 0.0        # latency kind only
    floor: float = 0.0               # gauge_floor kind only
    ceiling: float = 0.0             # gauge_ceiling kind only
    total_metric: str = ""           # ratio kind denominator
    bad_labels: Mapping[str, str] = field(default_factory=dict)
    labels: Mapping[str, str] = field(default_factory=dict)
    window_fast_s: float = 300.0
    window_slow_s: float = 3600.0
    burn_fast: float = 14.4          # classic page-at thresholds
    burn_slow: float = 6.0
    min_events: float = 0.0          # ratio kind: below this many total
    #                                  events in a window the burn is 0
    #                                  (a 1-in-10 blip on a near-idle
    #                                  tier is noise, not a breach)
    declared_in: str = ""
    note: str = ""

    @property
    def budget(self) -> float:
        return max(1e-9, 1.0 - float(self.target))


_lock = threading.Lock()
_slos: Dict[str, SLO] = {}


def slo(name: str, *, metric: str, kind: str, target: float,
        threshold_ms: float = 0.0, floor: float = 0.0,
        ceiling: float = 0.0, total_metric: str = "",
        bad_labels: Optional[Mapping[str, str]] = None,
        labels: Optional[Mapping[str, str]] = None,
        window_fast_s: float = 300.0, window_slow_s: float = 3600.0,
        burn_fast: float = 14.4, burn_slow: float = 6.0,
        min_events: float = 0.0, note: str = "") -> SLO:
    """Declare (or redeclare) one objective.  Call at module scope next
    to the code whose behavior it bounds; ``declared_in`` records that
    module for diagnostics (the contracts.py convention)."""
    import inspect
    frame = inspect.currentframe()
    declared_in = ""
    if frame is not None and frame.f_back is not None:
        declared_in = frame.f_back.f_globals.get("__name__", "")
    if kind not in ("ratio", "latency", "gauge_floor", "gauge_ceiling"):
        raise ValueError(f"SLO kind must be ratio|latency|gauge_floor|"
                         f"gauge_ceiling, got {kind!r}")
    s = SLO(name=name, metric=metric, kind=kind, target=float(target),
            threshold_ms=float(threshold_ms), floor=float(floor),
            ceiling=float(ceiling), total_metric=total_metric,
            bad_labels=dict(bad_labels or {}), labels=dict(labels or {}),
            window_fast_s=float(window_fast_s),
            window_slow_s=float(window_slow_s),
            burn_fast=float(burn_fast), burn_slow=float(burn_slow),
            min_events=float(min_events),
            declared_in=declared_in, note=note)
    with _lock:
        _slos[name] = s
    return s




def all_slos() -> Dict[str, SLO]:
    with _lock:
        return dict(_slos)






# ---------------------------------------------------------------------------
# Metric ensurers: subsystems register a callable that creates their
# metric families (no series) in a registry, so the coverage lint can
# validate SLO->series keys statically, before any traffic exists.
# ---------------------------------------------------------------------------

_ensurers: List[Callable[[MetricsRegistry], None]] = []


def register_metric_ensurer(fn: Callable[[MetricsRegistry], None]
                            ) -> Callable[[MetricsRegistry], None]:
    with _lock:
        if fn not in _ensurers:
            _ensurers.append(fn)
    return fn


def ensure_metrics(registry: Optional[MetricsRegistry] = None) -> None:
    registry = registry if registry is not None else default_registry()
    with _lock:
        fns = list(_ensurers)
    for fn in fns:
        fn(registry)


# ---------------------------------------------------------------------------
# Exemplar ring: bounded slowest-N requests, dumped alongside breaches
# ---------------------------------------------------------------------------

class ExemplarRing:
    """Keep the N worst exemplars by a score (request latency): a p99
    regression comes with the offending requests attached instead of a
    bare number.  Thread-safe; bounded by a min-heap so steady-state
    cost is O(log N) per offer and memory is N dicts."""

    def __init__(self, capacity: int = 32) -> None:
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._seq = 0                       # heap tie-break, never compared
        self._heap: List[Tuple[float, int, Dict[str, Any]]] = []

    def would_accept(self, score: float) -> bool:
        """Cheap hot-path pre-check: only a score that would survive the
        heap is worth building an exemplar dict for (the serving path
        calls this per request; >99% of requests are not among the N
        slowest)."""
        heap = self._heap           # unlocked snapshot: a stale read can
        #                             only cause one extra offer, never
        #                             a missed one the lock would accept
        return len(heap) < self.capacity or score > heap[0][0]

    def offer(self, score: float, exemplar: Dict[str, Any]) -> None:
        with self._lock:
            self._seq += 1
            item = (float(score), self._seq, dict(exemplar))
            if len(self._heap) < self.capacity:
                heapq.heappush(self._heap, item)
            elif item[0] > self._heap[0][0]:
                heapq.heapreplace(self._heap, item)

    def snapshot(self) -> List[Dict[str, Any]]:
        """Exemplars worst-first."""
        with self._lock:
            items = sorted(self._heap, key=lambda it: -it[0])
        return [dict(e, score=s) for s, _, e in items]

    def clear(self) -> None:
        with self._lock:
            self._heap = []

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)
