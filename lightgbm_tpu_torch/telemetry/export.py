"""Telemetry export: Prometheus text format and JSON renderers.

Copy of ``lightgbm_tpu/telemetry/export.py`` (pure Python) kept inside
the PyTorch port so the port never imports the JAX package.

``render_prometheus`` turns the process-wide :class:`MetricsRegistry`
plus the last training run's :class:`TrainRecord` into the Prometheus
exposition text format (v0.0.4) — the serve HTTP server mounts it at
``GET /metrics``, so one scrape covers serving counters AND the last
training run's per-phase/per-pass numbers.  ``render_json`` is the same
content as one JSON document (the CI telemetry artifact and the
``profile`` CLI verb's dump).

Windowed histograms are exported as percentile gauges
(``<name>_p50``/``_p99``) plus lifetime ``_count``/``_sum`` — the
window is a recent-tail estimator, not a Prometheus bucket histogram,
and exporting it as one would misrepresent it.
"""

from __future__ import annotations

import json
import re
import time
from typing import Dict, List, Optional

from .metrics import MetricsRegistry, default_registry
from .train_record import TrainRecord, last_train_record

__all__ = ["render_prometheus", "render_json", "write_snapshot",
           "PROMETHEUS_CONTENT_TYPE"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

_PREFIX = "lgbm_tpu_"
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _name(n: str) -> str:
    return _PREFIX + _NAME_RE.sub("_", n)


def _escape(v) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"').replace(
        "\n", r"\n")


def _labels(d: Dict[str, str]) -> str:
    if not d:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"'
                          for k, v in sorted(d.items())) + "}"


def _num(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def _render_registry(registry: MetricsRegistry, out: List[str]) -> None:
    for m in registry.collect():
        series = m.series()
        if m.kind in ("counter", "gauge"):
            n = _name(m.name)
            out.append(f"# HELP {n} {m.help or m.name}")
            out.append(f"# TYPE {n} {m.kind}")
            if not series:
                continue
            for lbl, val in series:
                out.append(f"{n}{_labels(lbl)} {_num(val)}")
        else:  # windowed histogram -> percentile gauges + count/sum
            base = _name(m.name)
            out.append(f"# HELP {base} {m.help or m.name} "
                       f"(windowed percentiles)")
            for lbl, summ in series:
                for k, v in summ.items():
                    out.append(f"{base}_{k}{_labels(lbl)} {_num(v)}")


def _render_train_record(snap: Dict, out: List[str]) -> None:
    def line(suffix: str, value, labels: Optional[Dict] = None,
             typ: str = "gauge", help_: str = "") -> None:
        n = _PREFIX + "train_" + suffix
        if help_:
            out.append(f"# HELP {n} {help_}")
            out.append(f"# TYPE {n} {typ}")
        out.append(f"{n}{_labels(labels or {})} {_num(value)}")

    line("trees_total", snap["num_trees"], typ="counter",
         help_="trees grown by the last training run")
    line("hist_passes_total", snap["hist_passes_total"], typ="counter",
         help_="full-data histogram passes (GrownTree.hist_passes sum; "
               "0 = grower does not track)")
    line("hist_passes_last", snap["hist_passes_last"],
         help_="histogram passes of the last grown tree")
    first = True
    for ph, secs in sorted(snap["phase_seconds"].items()):
        line("phase_seconds_total", secs, {"phase": ph}, "counter",
             "wall seconds per boosting phase" if first else "")
        first = False
    first = True
    for site, rec in sorted(snap["collectives_traced"].items()):
        lbl = {"site": site, "op": rec["op"]}
        line("collectives_traced_total", rec["count"], lbl, "counter",
             "collective calls per call site" if first else "")
        out.append(f"{_PREFIX}train_collectives_traced_bytes_total"
                   f"{_labels(lbl)} {_num(rec['bytes'])}")
        first = False
    first = True
    for ev, cnt in sorted(snap["compile_events"].items()):
        line("compile_events_total", cnt, {"event": ev}, "counter",
             "program compile/retrace events" if first else "")
        first = False
    if snap.get("device_memory_peak_bytes") is not None:
        line("device_memory_peak_bytes", snap["device_memory_peak_bytes"],
             help_="max device memory watermark seen")
    line("elapsed_seconds", snap["elapsed_seconds"],
         help_="wall seconds since the training record was created")


def render_prometheus(registry: Optional[MetricsRegistry] = None,
                      train_record: Optional[TrainRecord] = None) -> str:
    """The /metrics payload: registry series + last TrainRecord."""
    registry = registry if registry is not None else default_registry()
    train_record = (train_record if train_record is not None
                    else last_train_record())
    out: List[str] = []
    _render_registry(registry, out)
    if train_record is not None:
        _render_train_record(train_record.snapshot(), out)
    return "\n".join(out) + "\n"


def render_json(registry: Optional[MetricsRegistry] = None,
                train_record: Optional[TrainRecord] = None) -> Dict:
    registry = registry if registry is not None else default_registry()
    train_record = (train_record if train_record is not None
                    else last_train_record())
    return {
        "schema": "telemetry-snapshot-v1",
        "generated_unix": time.time(),
        "metrics": registry.snapshot(),
        "train_record": (train_record.snapshot()
                         if train_record is not None else None),
    }


def write_snapshot(path: str,
                   registry: Optional[MetricsRegistry] = None,
                   train_record: Optional[TrainRecord] = None) -> None:
    """One JSON telemetry snapshot on disk (CI artifact / profile dump)."""
    with open(path, "w") as fh:
        json.dump(render_json(registry, train_record), fh, indent=2,
                  default=str)
