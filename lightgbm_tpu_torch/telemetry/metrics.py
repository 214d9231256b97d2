"""Process-wide metric primitives and the MetricsRegistry.

One registry of named, labeled series — counters (monotone), gauges
(last value / watermark), and windowed histograms (percentiles over a
bounded ring of recent observations, because an operator wants the
CURRENT tail, not the all-time one).  Everything that used to count
things privately — ``serve/stats.ModelStats``, ``utils/timer``'s time
tags, the per-tree training records — now lands in one place with one
export surface (``telemetry/export.py`` renders Prometheus text and
JSON; the serve HTTP server mounts it at ``/metrics``).

The reference ships ``Common::Timer`` timetags compiled into every layer
(include/LightGBM/utils/common.h:931); this module is the registry those
fragments report into here.

Design constraints:
  * thread-safe — serving bumps counters from request threads while
    ``/metrics`` scrapes concurrently;
  * cheap — a counter bump is one lock + one dict add (the serving hot
    path bumps per micro-batch, not per row);
  * labels are fixed per metric at creation; each label VALUE
    combination is one independent series (Prometheus's data model).

Copy of ``lightgbm_tpu/telemetry/metrics.py`` (pure Python) kept inside
the PyTorch port so the port never imports the JAX package."""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["percentile", "SlidingWindow", "Counter", "Gauge",
           "WindowedHistogram", "MetricsRegistry", "default_registry"]


def percentile(sorted_vals: List[float], p: float) -> float:
    """Nearest-rank percentile over pre-sorted values.

    The single shared implementation (formerly duplicated between
    ``serve/stats.py`` and ``benchmarks/serve_latency.py``) so the
    ``/stats`` endpoint, ``/metrics`` export and the latency benchmark
    can never diverge."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(p / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


class SlidingWindow:
    """Bounded ring of recent float observations (the serving latency
    ring, generalized).  NOT internally locked — the owning metric or
    caller serializes access."""

    __slots__ = ("capacity", "_vals", "_pos", "count", "total")

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = int(capacity)
        self._vals: List[float] = []
        self._pos = 0
        self.count = 0      # lifetime observations (window may be smaller)
        self.total = 0.0    # lifetime sum

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if len(self._vals) < self.capacity:
            self._vals.append(v)
        else:
            self._vals[self._pos] = v
            self._pos = (self._pos + 1) % self.capacity

    def __len__(self) -> int:
        return len(self._vals)

    def sorted_values(self) -> List[float]:
        return sorted(self._vals)

    def percentile(self, p: float) -> float:
        return percentile(self.sorted_values(), p)

    def summary(self, ps: Tuple[float, ...] = (50.0, 99.0)) -> Dict:
        vals = self.sorted_values()
        out = {"window": len(vals), "count": self.count,
               "sum": self.total}
        for p in ps:
            out[f"p{p:g}"] = percentile(vals, p)
        return out


def _label_key(label_names: Tuple[str, ...], labels: Dict[str, str]
               ) -> Tuple[str, ...]:
    if set(labels) != set(label_names):
        raise ValueError(f"metric expects labels {label_names}, "
                         f"got {tuple(labels)}")
    return tuple(str(labels[k]) for k in label_names)


class _Metric:
    """Shared labeled-series plumbing for Counter/Gauge/WindowedHistogram."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = ()) -> None:
        self.name = name
        self.help = help
        self.label_names = tuple(labels)
        self._lock = threading.Lock()
        self._series: Dict[Tuple[str, ...], object] = {}

    def _new_series(self):
        raise NotImplementedError

    def _get(self, labels: Dict[str, str]):
        key = _label_key(self.label_names, labels)
        s = self._series.get(key)
        if s is None:
            s = self._series[key] = self._new_series()
        return s

    def remove_series(self, **labels) -> int:
        """Drop every series whose labels match ``labels`` (a SUBSET of
        the metric's label names — ``model="a"`` drops all buckets of
        model a).  Returns the number of series removed.  This is the
        zoo-eviction path: a bounded model cache must be able to retire
        a tenant's series or the registry ratchets under churn."""
        unknown = set(labels) - set(self.label_names)
        if unknown:
            raise ValueError(f"metric {self.name!r} has no labels "
                             f"{sorted(unknown)} (labels: "
                             f"{self.label_names})")
        want = {k: str(v) for k, v in labels.items()}
        idx = [self.label_names.index(k) for k in want]
        vals = [want[self.label_names[i]] for i in idx]
        with self._lock:
            doomed = [key for key in self._series
                      if all(key[i] == v for i, v in zip(idx, vals))]
            for key in doomed:
                del self._series[key]
        return len(doomed)

    def series(self) -> List[Tuple[Dict[str, str], object]]:
        """[(labels dict, snapshot value)] — value is a float for
        counter/gauge, a summary dict for windowed histograms.  Snapped
        under the metric lock so a concurrent observe can never tear a
        window summary."""
        with self._lock:
            return [(dict(zip(self.label_names, key)), self._snap(s))
                    for key, s in self._series.items()]

    def _snap(self, s):
        return s


class Counter(_Metric):
    kind = "counter"

    def _new_series(self):
        return 0.0

    def inc(self, amount: float = 1.0, **labels) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return float(self._series.get(key, 0.0))


class Gauge(_Metric):
    kind = "gauge"

    def _new_series(self):
        return 0.0

    def set(self, value: float, **labels) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = float(value)

    def max(self, value: float, **labels) -> None:
        """Watermark update: keep the largest value seen (device-memory
        peaks)."""
        key = _label_key(self.label_names, labels)
        with self._lock:
            cur = self._series.get(key)
            if cur is None or value > cur:
                self._series[key] = float(value)

    def add(self, amount: float, **labels) -> None:
        key = _label_key(self.label_names, labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        key = _label_key(self.label_names, labels)
        with self._lock:
            return float(self._series.get(key, 0.0))


class _SeriesHandle:
    """A label-resolved histogram series: ``observe`` skips the per-call
    label validation/key-building of the dict path (the serving tier
    records three windows per request — the handle keeps that at one
    lock + one ring append each).  The handle shares the metric's lock,
    so snapshots stay tear-free."""

    __slots__ = ("_lock", "_win")

    def __init__(self, lock, win: SlidingWindow) -> None:
        self._lock = lock
        self._win = win

    def observe(self, value: float) -> None:
        with self._lock:
            self._win.add(value)


class WindowedHistogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 labels: Tuple[str, ...] = (), window: int = 4096,
                 percentiles: Tuple[float, ...] = (50.0, 99.0)) -> None:
        super().__init__(name, help, labels)
        self.window = int(window)
        self.percentiles = tuple(percentiles)

    def _new_series(self):
        return SlidingWindow(self.window)

    def observe(self, value: float, **labels) -> None:
        with self._lock:
            self._get(labels).add(value)

    def handle(self, **labels) -> _SeriesHandle:
        """Pre-resolve one label set into a hot-path observe handle
        (validates the labels once, here)."""
        with self._lock:
            return _SeriesHandle(self._lock, self._get(labels))

    def window_of(self, **labels) -> SlidingWindow:
        """The underlying ring for one label set (callers who need the
        raw values, e.g. ModelStats.snapshot)."""
        with self._lock:
            return self._get(labels)

    def values_of(self, **labels) -> List[float]:
        """Sorted copy of one label set's current window, taken under
        the metric lock (safe against concurrent observes)."""
        with self._lock:
            return self._get(labels).sorted_values()

    def _snap(self, s: SlidingWindow):
        return s.summary(self.percentiles)


class MetricsRegistry:
    """Thread-safe name -> metric store with get-or-create semantics.

    ``counter``/``gauge``/``histogram`` are idempotent: the first call
    creates, later calls return the same object (and raise if the kind
    or label names conflict — two subsystems silently sharing a
    mistyped metric is a debugging tarpit)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}

    def _get_or_create(self, cls, name: str, help: str,
                       labels: Tuple[str, ...], **kw):
        labels = tuple(labels)
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, labels, **kw)
            elif not isinstance(m, cls) or m.label_names != labels or \
                    any(getattr(m, k) != v for k, v in kw.items()):
                raise ValueError(
                    f"metric {name!r} already registered as {m.kind} with "
                    f"labels {m.label_names}; requested {cls.kind} with "
                    f"{labels} {kw or ''}")
            return m

    def counter(self, name: str, help: str = "",
                labels: Iterable[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, tuple(labels))

    def gauge(self, name: str, help: str = "",
              labels: Iterable[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, tuple(labels))

    def histogram(self, name: str, help: str = "",
                  labels: Iterable[str] = (), window: int = 4096,
                  percentiles: Tuple[float, ...] = (50.0, 99.0)
                  ) -> WindowedHistogram:
        return self._get_or_create(WindowedHistogram, name, help,
                                   tuple(labels), window=window,
                                   percentiles=percentiles)

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def unregister(self, name: str) -> bool:
        with self._lock:
            return self._metrics.pop(name, None) is not None

    def remove_series(self, **labels) -> int:
        """Drop matching label-series from EVERY metric that carries all
        the given label names (metrics without them are untouched).
        Returns total series removed — the registry-wide half of zoo
        eviction (``remove_series(model="tenant-7")``)."""
        removed = 0
        for m in self.collect():
            if set(labels) <= set(m.label_names):
                removed += m.remove_series(**labels)
        return removed

    def clear(self) -> None:
        with self._lock:
            self._metrics.clear()

    def collect(self) -> List[_Metric]:
        """Metrics in registration order (export renders from this)."""
        with self._lock:
            return list(self._metrics.values())

    def snapshot(self) -> Dict[str, Dict]:
        """JSON-ready {name: {kind, help, series: [{labels, value}]}}."""
        out = {}
        for m in self.collect():
            out[m.name] = {
                "kind": m.kind,
                "help": m.help,
                "series": [{"labels": lbl, "value": val}
                           for lbl, val in m.series()],
            }
        return out


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry (training records, serving counters and
    time tags all land here; ``/metrics`` renders it)."""
    return _default
