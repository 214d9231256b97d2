"""Per-model serving counters surfaced on ``/stats`` and ``/metrics``.

Rebased onto :mod:`lightgbm_tpu.telemetry.metrics`: every counter and the
latency ring are labeled series (``model=<name>``) in a
:class:`MetricsRegistry`, so the Prometheus exporter reads the same
numbers the JSON ``/stats`` endpoint reports.  Registry-managed models
(the HTTP server path) share the process-wide default registry; an
anonymous ``ModelStats()`` (e.g. ``Booster.to_predictor()``) gets a
private registry so unrelated predictors never alias each other's
series.

The counters are bumped on every device call (micro-batches, not client
requests, are the expensive unit); latency percentiles come from a
bounded ring of recent batch latencies — a serving dashboard wants the
current tail, not the all-time one.  ``percentile`` is re-exported from
telemetry.metrics (the single shared implementation).

Per-request tracing (fleet observability): ``record_request_timing``
lands each request's queue-wait / device-compute / total split in
``(model, bucket)``-labeled histograms — the series the per-bucket p99
latency SLO declared below is keyed to — and feeds the process-wide
slowest-N exemplar ring, so an SLO breach dumps the offending requests
(id, bucket, split) instead of a bare percentile.

Copy of ``lightgbm_tpu/serve/stats.py`` (pure Python) kept inside the
PyTorch port so the port never imports the JAX package.  Here "device
call" is one call of the compiled predictor on the card (or the CPU).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

from ..telemetry.metrics import (Counter, MetricsRegistry,
                                 WindowedHistogram, default_registry,
                                 percentile)
from ..telemetry.slo import (ExemplarRing, register_metric_ensurer, slo)

__all__ = ["ModelStats", "ExplainTimingStats", "percentile",
           "request_exemplars", "EXEMPLAR_CAPACITY"]

# bounded ring of the slowest requests seen, dumped alongside SLO
# breaches (/slo attaches it whenever something burns)
EXEMPLAR_CAPACITY = 32
_exemplars = ExemplarRing(EXEMPLAR_CAPACITY)


def request_exemplars() -> ExemplarRing:
    """The process-wide slowest-request ring (worst-first snapshot)."""
    return _exemplars


# The per-bucket tail objective, declared next to the code that records
# the series it reads: every (model, bucket) combination of the request
# latency histogram is evaluated independently, so one declaration
# covers the whole SHAPE_BUCKETS ladder.  threshold_ms is the
# environment knob (the load-test harness re-declares it per env via
# slo.set_latency_threshold).
slo("serve/latency_p99", metric="serve_request_latency_ms", kind="latency",
    target=0.99, threshold_ms=500.0, min_events=20,
    note="99% of requests complete under threshold_ms, per shape bucket")

# The explanation lane's tail objective: /explain requests land their
# end-to-end latency in their OWN (model, bucket) histogram so TreeSHAP
# traffic (a much heavier program: (T*L, D) path slots per row) never
# dilutes — nor hides behind — the predict p99 above.  Threshold is an
# environment knob, same as serve/latency_p99.
slo("serve/explain_latency_p99", metric="serve_explain_latency_ms",
    kind="latency", target=0.99, threshold_ms=2000.0, min_events=20,
    note="99% of /explain requests complete under threshold_ms, per "
         "shape bucket")


class ModelStats:
    """Counters for one served model (requests, rows, batches, recompiles,
    per-bucket histogram, p50/p99 latency over a sliding window)."""

    WINDOW = 4096  # batch latencies kept for percentile estimates

    def __init__(self, model: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 prime: bool = True) -> None:
        self.model = model if model is not None else "default"
        self._reg = registry if registry is not None else MetricsRegistry()
        fam = _metric_family(self._reg)
        self._requests = fam.requests
        self._rows = fam.rows
        self._batches = fam.batches
        self._recompiles = fam.recompiles
        self._errors = fam.errors
        self._bucket = fam.bucket
        self._latency = fam.latency
        self._req_latency = fam.req_latency
        self._queue_wait = fam.queue_wait
        self._device = fam.device
        self._explain_latency = fam.explain_latency
        self._explain_requests = fam.explain_requests
        if prime:
            self.prime_series()
        self.last_recompile_requests: tuple = ()
        # per-bucket hot-path handles for the three timing windows
        # (label resolution once per bucket, not once per request)
        self._timing_handles: Dict[str, tuple] = {}

    def prime_series(self) -> None:
        """Touch this model's series so it scrapes as 0 rather than
        being absent until its first request.  ``ModelRegistry`` defers
        this until a first load succeeds, so a failed load never leaves
        phantom ``model=<name>`` series in the shared registry."""
        for c in (self._requests, self._rows, self._batches,
                  self._recompiles, self._errors):
            c.inc(0, model=self.model)

    @property
    def registry(self) -> MetricsRegistry:
        """The registry this model's series live in (the micro-batcher
        parks its saturation gauges next to them)."""
        return self._reg

    def record_request(self, n_rows: int = 1) -> None:
        self._requests.inc(1, model=self.model)

    def record_error(self) -> None:
        self._errors.inc(1, model=self.model)

    def record_batch(self, n_rows: int, bucket: int, latency_ms: float,
                     recompiled: bool, request_ids: tuple = ()) -> None:
        m = self.model
        self._batches.inc(1, model=m)
        self._rows.inc(int(n_rows), model=m)
        self._bucket.inc(1, model=m, bucket=str(int(bucket)))
        if recompiled:
            self._recompiles.inc(1, model=m)
            if request_ids:
                # which requests paid an XLA trace: a p99 exemplar that
                # says "recompile" answers itself
                self.last_recompile_requests = tuple(request_ids)
        self._latency.observe(latency_ms, model=m)

    def record_request_timing(self, n_rows: int, bucket: int,
                              queue_ms: float, device_ms: float,
                              total_ms: float,
                              request_id: Optional[str] = None) -> None:
        """One client request's latency split (micro-batcher or direct
        path): queue wait vs device compute, plus the total, all
        ``(model, bucket)``-labeled — the per-bucket p99 SLO series.
        This is the serving hot path (per request, not per batch), so
        the exemplar dict is only built for requests the slowest-N ring
        would actually keep."""
        m, b = self.model, str(int(bucket))
        handles = self._timing_handles.get(b)
        if handles is None:
            handles = self._timing_handles[b] = (
                self._req_latency.handle(model=m, bucket=b),
                self._queue_wait.handle(model=m, bucket=b),
                self._device.handle(model=m, bucket=b))
        handles[0].observe(total_ms)
        handles[1].observe(queue_ms)
        handles[2].observe(device_ms)
        if _exemplars.would_accept(total_ms):
            _exemplars.offer(total_ms, {
                "request_id": request_id or "-", "model": m,
                "rows": int(n_rows), "bucket": int(bucket),
                "queue_ms": round(queue_ms, 4),
                "device_ms": round(device_ms, 4),
                "total_ms": round(total_ms, 4),
                "recompile": bool(request_id and request_id in
                                  self.last_recompile_requests),
            })

    def record_explain_timing(self, n_rows: int, bucket: int,
                              queue_ms: float, device_ms: float,
                              total_ms: float,
                              request_id: Optional[str] = None) -> None:
        """One /explain request's end-to-end latency, landed in the
        dedicated ``serve_explain_latency_ms`` histogram (the
        ``serve/explain_latency_p99`` SLO series) plus the shared
        slowest-N exemplar ring with a ``lane: explain`` tag."""
        m, b = self.model, str(int(bucket))
        self._explain_requests.inc(1, model=m)
        self._explain_latency.observe(total_ms, model=m, bucket=b)
        if _exemplars.would_accept(total_ms):
            _exemplars.offer(total_ms, {
                "request_id": request_id or "-", "model": m,
                "lane": "explain", "rows": int(n_rows),
                "bucket": int(bucket),
                "queue_ms": round(queue_ms, 4),
                "device_ms": round(device_ms, 4),
                "total_ms": round(total_ms, 4),
            })

    def explain_timing_stats(self) -> "ExplainTimingStats":
        """A stats facade for the explain lane's micro-batcher: same
        registry (the batcher's saturation gauges park next to this
        model's series under a distinct label), but request timings land
        in the explain histogram instead of the predict one."""
        return ExplainTimingStats(self)

    def release(self) -> int:
        """Retire every ``model=<name>`` series this instance created in
        its registry (counters, per-bucket histograms, the batcher's
        saturation gauges).  Called on zoo eviction so a churned tenant
        leaves nothing behind; returns the number of series dropped.
        The instance must not record after release."""
        self._timing_handles.clear()
        return self._reg.remove_series(model=self.model)

    def bucket_timing(self, bucket: int) -> Dict[str, list]:
        """One bucket's raw timing windows (sorted copies) — the
        serve-latency benchmark reads the queue-wait vs device-compute
        split per bucket from here."""
        m, b = self.model, str(int(bucket))
        return {
            "request_latency_ms": self._req_latency.values_of(
                model=m, bucket=b),
            "queue_wait_ms": self._queue_wait.values_of(model=m, bucket=b),
            "device_ms": self._device.values_of(model=m, bucket=b),
        }

    def _timing_summary(self, hist, ps=(50.0, 99.0)) -> Dict:
        vals: list = []
        for lbl, _summ in hist.series():
            if lbl.get("model") == self.model:
                vals.extend(hist.values_of(**lbl))
        vals.sort()
        out = {f"p{p:g}": round(percentile(vals, p), 4) for p in ps}
        out["window"] = len(vals)
        return out

    def snapshot(self) -> Dict:
        m = self.model
        bucket_hist = {}
        for lbl, val in self._bucket.series():
            if lbl.get("model") == m and val:
                bucket_hist[int(lbl["bucket"])] = int(val)
        lat = self._latency.values_of(model=m)
        return {
            "requests": int(self._requests.value(model=m)),
            "rows": int(self._rows.value(model=m)),
            "batches": int(self._batches.value(model=m)),
            "recompiles": int(self._recompiles.value(model=m)),
            "errors": int(self._errors.value(model=m)),
            "bucket_histogram": {str(k): v for k, v in
                                 sorted(bucket_hist.items())},
            "latency_ms": {
                "p50": round(percentile(lat, 50.0), 4),
                "p99": round(percentile(lat, 99.0), 4),
                "window": len(lat),
            },
            # the per-request split (pooled over buckets; the labeled
            # series carry the per-bucket detail on /metrics)
            "request_latency_ms": self._timing_summary(self._req_latency),
            "queue_wait_ms": self._timing_summary(self._queue_wait),
            "device_ms": self._timing_summary(self._device),
            "explain_requests": int(self._explain_requests.value(model=m)),
            "explain_latency_ms": self._timing_summary(
                self._explain_latency),
        }


class ExplainTimingStats:
    """Duck-typed ``stats`` for the explain lane's ``MicroBatcher``:
    exposes the same registry (saturation gauges) and model name, but
    routes ``record_request_timing`` into the explain latency series so
    the two lanes' p99 objectives stay independent."""

    def __init__(self, base: ModelStats) -> None:
        self._base = base
        self.model = f"{base.model}#explain"

    @property
    def registry(self) -> MetricsRegistry:
        return self._base.registry

    def record_request(self, n_rows: int = 1) -> None:
        pass  # request counting is the explain counter's job

    def record_request_timing(self, n_rows: int, bucket: int,
                              queue_ms: float, device_ms: float,
                              total_ms: float,
                              request_id: Optional[str] = None) -> None:
        self._base.record_explain_timing(n_rows, bucket, queue_ms,
                                         device_ms, total_ms, request_id)


class _Family(NamedTuple):
    requests: Counter
    rows: Counter
    batches: Counter
    recompiles: Counter
    errors: Counter
    bucket: Counter
    latency: WindowedHistogram
    req_latency: WindowedHistogram
    queue_wait: WindowedHistogram
    device: WindowedHistogram
    explain_latency: WindowedHistogram
    explain_requests: Counter


def _metric_family(reg: MetricsRegistry) -> _Family:
    """Create (get-or-create) the serving metric families in ``reg``.
    ModelStats binds these per instance; the SLO-coverage ensurer calls
    it standalone so every series an SLO may key to exists in the
    registry before any traffic does."""
    return _Family(
        requests=reg.counter(
            "serve_requests_total", "client-level predict calls",
            labels=("model",)),
        rows=reg.counter(
            "serve_rows_total", "data rows predicted (pre-padding)",
            labels=("model",)),
        batches=reg.counter(
            "serve_batches_total", "device calls (post micro-batching)",
            labels=("model",)),
        recompiles=reg.counter(
            "serve_recompiles_total",
            "device calls at a (signature, bucket) new to the process", labels=("model",)),
        errors=reg.counter(
            "serve_errors_total", "failed predict calls",
            labels=("model",)),
        bucket=reg.counter(
            "serve_batches_by_bucket_total",
            "device calls per shape bucket", labels=("model", "bucket")),
        latency=reg.histogram(
            "serve_batch_latency_ms", "device-call latency",
            labels=("model",), window=ModelStats.WINDOW),
        req_latency=reg.histogram(
            "serve_request_latency_ms",
            "per-request end-to-end latency (queue + device + copy)",
            labels=("model", "bucket"), window=ModelStats.WINDOW),
        queue_wait=reg.histogram(
            "serve_queue_wait_ms",
            "per-request micro-batcher queue wait before dispatch",
            labels=("model", "bucket"), window=ModelStats.WINDOW),
        device=reg.histogram(
            "serve_device_ms",
            "per-request share of the batched device call",
            labels=("model", "bucket"), window=ModelStats.WINDOW),
        explain_latency=reg.histogram(
            "serve_explain_latency_ms",
            "per-request end-to-end /explain latency (queue + device + "
            "copy)", labels=("model", "bucket"),
            window=ModelStats.WINDOW),
        explain_requests=reg.counter(
            "serve_explain_requests_total",
            "client-level explain calls", labels=("model",)),
    )


@register_metric_ensurer
def _ensure_serving_metrics(reg: MetricsRegistry) -> None:
    _metric_family(reg)
    # the batcher's saturation gauges (serve/batcher.py bumps them)
    reg.gauge("serve_queue_rows",
              "rows admitted to the micro-batcher but not yet dispatched",
              labels=("model",))
    reg.gauge("serve_inflight_requests",
              "requests admitted and not yet completed", labels=("model",))


# eagerly materialize the families in the default registry so a scrape
# (or the coverage lint) sees them before the first served request
_ensure_serving_metrics(default_registry())
