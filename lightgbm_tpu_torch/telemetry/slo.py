"""Declarative service-level objectives over the metrics registry.

Copy of ``lightgbm_tpu/telemetry/slo.py`` (pure Python) kept inside the
PyTorch port so the port never imports the JAX package.

An :class:`SLO` is declared NEXT TO the code it bounds (the
``analysis/contracts.py`` pattern: the serving stats module declares the
per-bucket p99 latency objective, ``resilience/admission.py`` the shed
budget, ``serve/compiler.py`` the fallback budget, the HTTP server the
availability target) and keyed to an existing
:class:`~lightgbm_tpu_torch.telemetry.metrics.MetricsRegistry` series — so the
objective, the metric it reads and the code that bumps the metric are
one named thing and cannot drift apart.  The reference's
``analysis/slo_cover.py`` lint-checks that every declared SLO references
a registered series (an SLO keyed to a metric nobody emits would
silently never burn); the port's lints are ROADMAP queue 1 item 12.

Evaluation uses the standard multi-window burn-rate recipe: the error
ratio (bad / total for counter ratios, fraction-over-threshold for
latency windows) is normalized by the error budget ``1 - target`` into
a *burn rate* (1.0 = spending exactly the budget), computed over a fast
and a slow window.  A breach requires BOTH windows to burn hot (the
fast window reacts, the slow window filters blips); a *sustained* fast
burn (``SloEngine.sustain`` consecutive evaluations) flips ``/healthz``
degraded before the slow window confirms.

Counters are lifetime-monotone, so the engine keeps its own sample ring
per SLO — (timestamp, bad, total) pairs appended at every evaluation —
and takes windowed deltas, exactly how a Prometheus ``rate()`` would.
Latency objectives read the existing ``SlidingWindow`` rings (a
recent-tail estimator by construction) and window the *evaluations*:
the fast/slow error ratio is the mean over-threshold fraction of the
scrapes inside each window.
"""

from __future__ import annotations

import fnmatch
import heapq
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from .metrics import (Gauge, MetricsRegistry, WindowedHistogram,
                      default_registry, percentile)

__all__ = ["SLO", "slo", "slo_for", "all_slos", "remove_slo",
           "register_metric_ensurer", "ensure_metrics", "SloEngine",
           "default_engine", "ExemplarRing"]


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


def slo_for(name: str) -> Optional[SLO]:
    with _lock:
        return _slos.get(name)


def all_slos() -> Dict[str, SLO]:
    with _lock:
        return dict(_slos)


def remove_slo(name: str) -> None:
    """Unregister (tests planting temporary SLOs clean up here)."""
    with _lock:
        _slos.pop(name, None)


def set_latency_threshold(name: str, threshold_ms: float) -> SLO:
    """Re-declare a latency SLO's threshold in place (the load-test
    harness tunes the declared objective to the environment under
    test without forking the declaration site)."""
    with _lock:
        cur = _slos.get(name)
        if cur is None:
            raise KeyError(f"no SLO named {name!r}")
        s = replace(cur, threshold_ms=float(threshold_ms))
        _slos[name] = s
    return s


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


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _labels_match(series_labels: Mapping[str, str],
                  selector: Mapping[str, str]) -> bool:
    """Subset match; selector values are fnmatch patterns."""
    for k, pat in selector.items():
        v = series_labels.get(k)
        if v is None or not fnmatch.fnmatchcase(str(v), str(pat)):
            return False
    return True


class SloEngine:
    """Evaluates every declared SLO against one registry.

    ``evaluate()`` appends one sample per SLO and returns the verdict
    report; it is called from the ``/slo`` and ``/healthz`` handlers
    (and by the load-test harness between scrapes), so evaluation
    cadence == scrape cadence, which is exactly the cadence the sample
    rings window over.  Burn-rate gauges land back in the registry so a
    plain ``/metrics`` scrape carries them too."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 sustain: int = 3,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.registry = registry if registry is not None \
            else default_registry()
        self.sustain = int(sustain)
        self._clock = clock
        self._lock = threading.Lock()
        # name -> list[(t, bad, total)] (ratio) / [(t, frac_over)] (latency)
        self._samples: Dict[str, List[tuple]] = {}
        # name -> pooled lifetime observation count at the last
        # evaluation (latency kinds' live-vs-stale-window detector)
        self._latency_counts: Dict[str, int] = {}
        self._fast_streak: Dict[str, int] = {}
        self._last_report: Optional[Dict[str, Any]] = None

    # -- metric reads ------------------------------------------------------
    def _counter_sum(self, name: str, selector: Mapping[str, str]) -> float:
        m = self.registry.get(name)
        if m is None:
            return 0.0
        total = 0.0
        for lbl, val in m.series():
            if _labels_match(lbl, selector) and isinstance(val, (int, float)):
                total += float(val)
        return total

    def _latency_series(self, s: SLO) -> List[Tuple[Dict[str, str],
                                                    List[float], int]]:
        """(labels, window values, lifetime observation count) per
        matching series — the count lets the evaluator tell a live
        window from a stale one."""
        m = self.registry.get(s.metric)
        if not isinstance(m, WindowedHistogram):
            return []
        out = []
        for lbl, summ in m.series():
            if _labels_match(lbl, s.labels):
                count = summ.get("count", 0) if isinstance(summ, dict) else 0
                out.append((lbl, m.values_of(**lbl), int(count)))
        return out

    # -- window math -------------------------------------------------------
    @staticmethod
    def _trim(samples: List[tuple], now: float, keep_s: float) -> None:
        cutoff = now - keep_s
        while len(samples) > 2 and samples[1][0] <= cutoff:
            samples.pop(0)

    @staticmethod
    def _ratio_over(samples: List[tuple], now: float, window: float
                    ) -> Tuple[float, float, float]:
        """(error_ratio, d_bad, d_total) across the samples inside the
        window (oldest in-window sample vs the newest).  No traffic
        DELTA in the window -> zero burn: an idle service spends no
        budget, and the engine's very first sample deliberately judges
        nothing — falling back to the counters' lifetime ratio there
        would page on arbitrarily stale history (a startup burst hours
        ago) the moment a fresh engine takes its first scrape."""
        inside = [s for s in samples if s[0] >= now - window]
        if not inside:
            inside = samples[-1:]
        base = inside[0]
        cur = samples[-1]
        d_bad = cur[1] - base[1]
        d_total = cur[2] - base[2]
        if d_total <= 0:
            return 0.0, max(0.0, d_bad), max(0.0, d_total)
        return max(0.0, d_bad) / d_total, d_bad, d_total

    @staticmethod
    def _latency_over(samples: List[tuple], now: float, window: float
                      ) -> float:
        inside = [s for s in samples if s[0] >= now - window]
        if not inside:
            inside = samples[-1:]
        if not inside:
            return 0.0
        return sum(s[1] for s in inside) / len(inside)

    # -- evaluation --------------------------------------------------------
    def _eval_ratio(self, s: SLO, now: float) -> Dict[str, Any]:
        bad_sel = dict(s.labels)
        bad_sel.update(s.bad_labels)
        bad = self._counter_sum(s.metric, bad_sel)
        total = self._counter_sum(s.total_metric or s.metric, s.labels)
        ring = self._samples.setdefault(s.name, [])
        ring.append((now, bad, total))
        self._trim(ring, now, s.window_slow_s * 1.25)
        rf, dbf, dtf = self._ratio_over(ring, now, s.window_fast_s)
        rs, dbs, dts = self._ratio_over(ring, now, s.window_slow_s)
        low_traffic = False
        if s.min_events > 0:
            # below the traffic floor a window has no statistical power:
            # one bad event on a near-idle tier must not page anyone
            if dtf < s.min_events:
                rf, low_traffic = 0.0, True
            if dts < s.min_events:
                rs, low_traffic = 0.0, True
        return {"error_ratio": {"fast": rf, "slow": rs},
                "burn": {"fast": rf / s.budget, "slow": rs / s.budget},
                "detail": {"bad": bad, "total": total,
                           "window_bad": dbf, "window_total": dtf,
                           "low_traffic": low_traffic}}

    def _eval_latency(self, s: SLO, now: float) -> Dict[str, Any]:
        series = self._latency_series(s)
        per_series = []
        worst_frac = 0.0
        pooled_n = 0
        total_count = 0
        for lbl, vals, count in series:
            total_count += count
            if not vals:
                continue
            over = sum(1 for v in vals if v > s.threshold_ms)
            frac = over / len(vals)
            # the traffic floor, latency edition: a window of one slow
            # request is frac_over=1.0 — below min_events a series is
            # reported but never drives the burn (the ratio kinds'
            # near-idle-blip rule)
            if not (s.min_events > 0 and len(vals) < s.min_events):
                worst_frac = max(worst_frac, frac)
            pooled_n += len(vals)
            per_series.append({"labels": lbl,
                               "p50_ms": round(percentile(vals, 50.0), 4),
                               "p99_ms": round(percentile(vals, 99.0), 4),
                               "frac_over": round(frac, 6),
                               "window": len(vals)})
        # the histogram windows are count-bounded, not time-bounded: a
        # hot window from a past burst would otherwise re-read hot on
        # every scrape and keep the burn lit with ZERO live traffic.
        # No new observations since the last evaluation -> this scrape
        # contributes no burn, and the windowed mean decays as idle
        # scrapes accumulate (the latency twin of the ratio kinds'
        # no-traffic-no-burn rule).
        last_count = self._latency_counts.get(s.name)
        self._latency_counts[s.name] = total_count
        idle = last_count is not None and total_count <= last_count
        ring = self._samples.setdefault(s.name, [])
        ring.append((now, 0.0 if idle else worst_frac))
        self._trim(ring, now, s.window_slow_s * 1.25)
        rf = self._latency_over(ring, now, s.window_fast_s)
        rs = self._latency_over(ring, now, s.window_slow_s)
        return {"error_ratio": {"fast": rf, "slow": rs},
                "burn": {"fast": rf / s.budget, "slow": rs / s.budget},
                "detail": {"threshold_ms": s.threshold_ms,
                           "observations": pooled_n,
                           "series": per_series}}

    def _eval_gauge_floor(self, s: SLO, now: float) -> Dict[str, Any]:
        """Per-scrape binary error: 1.0 while any matching gauge series
        sits below the declared floor, 0.0 otherwise.  No series yet ->
        no data -> no burn (the tier hasn't reported; a fleet booting
        must not page before its first supervision tick), exactly the
        ratio kinds' idle rule."""
        m = self.registry.get(s.metric)
        values: List[float] = []
        if isinstance(m, Gauge):
            for lbl, val in m.series():
                if _labels_match(lbl, s.labels) and \
                        isinstance(val, (int, float)):
                    values.append(float(val))
        frac = 1.0 if values and min(values) < s.floor else 0.0
        ring = self._samples.setdefault(s.name, [])
        ring.append((now, frac))
        self._trim(ring, now, s.window_slow_s * 1.25)
        rf = self._latency_over(ring, now, s.window_fast_s)
        rs = self._latency_over(ring, now, s.window_slow_s)
        return {"error_ratio": {"fast": rf, "slow": rs},
                "burn": {"fast": rf / s.budget, "slow": rs / s.budget},
                "detail": {"floor": s.floor,
                           "value": min(values) if values else None,
                           "series": len(values)}}

    def _eval_gauge_ceiling(self, s: SLO, now: float) -> Dict[str, Any]:
        """Per-scrape binary error: 1.0 while any matching gauge series
        sits ABOVE the declared ceiling (the staleness mirror of
        :meth:`_eval_gauge_floor`; same no-series -> no-burn idle
        rule — a fleet that has not measured staleness yet must not
        page)."""
        m = self.registry.get(s.metric)
        values: List[float] = []
        if isinstance(m, Gauge):
            for lbl, val in m.series():
                if _labels_match(lbl, s.labels) and \
                        isinstance(val, (int, float)):
                    values.append(float(val))
        frac = 1.0 if values and max(values) > s.ceiling else 0.0
        ring = self._samples.setdefault(s.name, [])
        ring.append((now, frac))
        self._trim(ring, now, s.window_slow_s * 1.25)
        rf = self._latency_over(ring, now, s.window_fast_s)
        rs = self._latency_over(ring, now, s.window_slow_s)
        return {"error_ratio": {"fast": rf, "slow": rs},
                "burn": {"fast": rf / s.budget, "slow": rs / s.budget},
                "detail": {"ceiling": s.ceiling,
                           "value": max(values) if values else None,
                           "series": len(values)}}

    def evaluate(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = self._clock() if now is None else float(now)
        burn_g = self.registry.gauge(
            "slo_burn_rate", "error-budget burn rate per declared SLO "
            "(1.0 = spending exactly the budget)", labels=("slo", "window"))
        ok_g = self.registry.gauge(
            "slo_ok", "1 while the SLO is met (no multi-window breach)",
            labels=("slo",))
        verdicts = []
        breached, fast_burning, degraded = [], [], []
        with self._lock:
            for name, s in sorted(all_slos().items()):
                if s.kind == "ratio":
                    ev = self._eval_ratio(s, now)
                elif s.kind == "gauge_floor":
                    ev = self._eval_gauge_floor(s, now)
                elif s.kind == "gauge_ceiling":
                    ev = self._eval_gauge_ceiling(s, now)
                else:
                    ev = self._eval_latency(s, now)
                bf, bs = ev["burn"]["fast"], ev["burn"]["slow"]
                is_fast = bf >= s.burn_fast
                is_breach = is_fast and bs >= s.burn_slow
                streak = self._fast_streak.get(name, 0) + 1 if is_fast else 0
                self._fast_streak[name] = streak
                if is_breach:
                    breached.append(name)
                if is_fast:
                    fast_burning.append(name)
                if streak >= self.sustain:
                    degraded.append(name)
                burn_g.set(bf, slo=name, window="fast")
                burn_g.set(bs, slo=name, window="slow")
                ok_g.set(0.0 if is_breach else 1.0, slo=name)
                verdicts.append({
                    "name": name, "metric": s.metric, "kind": s.kind,
                    "target": s.target, "budget": s.budget,
                    "declared_in": s.declared_in,
                    "burn": {"fast": round(bf, 4), "slow": round(bs, 4)},
                    "burn_thresholds": {"fast": s.burn_fast,
                                        "slow": s.burn_slow},
                    "error_ratio": {k: round(v, 6) for k, v in
                                    ev["error_ratio"].items()},
                    "fast_burning": is_fast,
                    "fast_streak": streak,
                    "breached": is_breach,
                    "ok": not is_breach,
                    "detail": ev["detail"],
                })
            report = {
                "schema": "slo-report-v1",
                "ok": not breached,
                "breached": breached,
                "fast_burning": fast_burning,
                "degraded": degraded,
                "sustain": self.sustain,
                "slos": verdicts,
            }
            self._last_report = report
        return report

    def degraded(self) -> List[str]:
        """SLO names whose fast window has burned hot for ``sustain``
        consecutive evaluations (the /healthz degraded reason)."""
        with self._lock:
            return [n for n, k in self._fast_streak.items()
                    if k >= self.sustain]

    def last_report(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._last_report

    def reset(self) -> None:
        with self._lock:
            self._samples.clear()
            self._latency_counts.clear()
            self._fast_streak.clear()
            self._last_report = None


_default_engine: Optional[SloEngine] = None
_engine_lock = threading.Lock()


def default_engine() -> SloEngine:
    """The process-wide engine over the default registry (the serve
    HTTP server's ``/slo`` and ``/healthz`` evaluate through it)."""
    global _default_engine
    with _engine_lock:
        if _default_engine is None:
            _default_engine = SloEngine()
        return _default_engine
