"""Telemetry of the port: the metrics registry (counters, gauges and
windowed histograms) and the SLO declarations over it.

Ports the part of ``lightgbm_tpu/telemetry/`` that checkpointing, the
serving and explain compilers and chunked ingest count into, and the
tracing spans (``trace.py``); the exporters, the flight recorder and the
per-tree training records come with the serving tier (ROADMAP queue 1
item 11b).
"""

from .metrics import (Counter, Gauge, MetricsRegistry, WindowedHistogram,
                      default_registry, percentile)

__all__ = ["Counter", "Gauge", "MetricsRegistry", "WindowedHistogram",
           "default_registry", "percentile"]
