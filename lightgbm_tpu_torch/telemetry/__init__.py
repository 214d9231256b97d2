"""lightgbm_tpu_torch.telemetry: observability for training and serving.

Port of ``lightgbm_tpu/telemetry/``:

  * :mod:`.metrics`: the process-wide :class:`MetricsRegistry` of
    counters, gauges and windowed histograms with labeled series;
  * :mod:`.trace`: hierarchical ``span("tree/wave")`` host spans paired
    with ``torch.profiler.record_function``, chrome-trace export;
  * :mod:`.train_record`: the per-run :class:`TrainRecord` (histogram
    passes per tree, per-phase wall time, the device-memory watermark),
    accumulated by ``models/gbdt.py`` and surfaced as
    ``Booster.train_record``;
  * :mod:`.export`: Prometheus text and JSON renderers (the serve HTTP
    server's ``GET /metrics``, the ``profile`` CLI verb's dump);
  * :mod:`.slo`: declared service-level objectives evaluated with
    multi-window burn rates (``GET /slo``, the SLO-aware ``/healthz``);
  * :mod:`.flight`: the training flight recorder, a bounded ring of
    per-iteration events dumped to JSONL.

Master switch: ``enabled()`` / ``enable()`` / ``disable()`` (env
``LGBM_TPU_TELEMETRY=0`` to opt out).  Telemetry-on and telemetry-off
training write the same model text: accumulation only observes.
"""

from ._config import disable, enable, enabled
from .export import (PROMETHEUS_CONTENT_TYPE, render_json,
                     render_prometheus, write_snapshot)
from .flight import FlightRecorder
from .metrics import (Counter, Gauge, MetricsRegistry, SlidingWindow,
                      WindowedHistogram, default_registry, percentile)
from .slo import SLO, SloEngine, all_slos, default_engine, slo
from .trace import Tracer, global_tracer, span
from .train_record import (TrainRecord, collectives_reset,
                           collectives_snapshot, device_memory_peak,
                           last_train_record, note_collective,
                           set_last_train_record)

__all__ = [
    "enable", "disable", "enabled",
    "Counter", "Gauge", "MetricsRegistry", "SlidingWindow",
    "WindowedHistogram", "default_registry", "percentile",
    "Tracer", "global_tracer", "span",
    "TrainRecord", "collectives_reset", "collectives_snapshot",
    "device_memory_peak", "last_train_record", "note_collective",
    "set_last_train_record",
    "PROMETHEUS_CONTENT_TYPE", "render_json", "render_prometheus",
    "write_snapshot",
    "SLO", "SloEngine", "all_slos", "default_engine", "slo",
    "FlightRecorder",
]
