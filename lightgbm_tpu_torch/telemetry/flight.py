"""Training flight recorder: a bounded ring of per-iteration events.

Port of ``lightgbm_tpu/telemetry/flight.py``.  The recorder keeps one
structured event per boosting iteration (eval losses, the last tree's
best split gain, histogram passes and leaf count, collective bytes,
chunked-ingest host-to-device bytes, the device-memory watermark) in a
``deque(maxlen=...)`` ring, and the engine dumps it to JSONL next to the
final checkpoint on SIGTERM or an uncaught training error (or into an
explicit ``flight_dir`` on success too).  The last event's iteration
therefore matches the checkpoint's iteration: both are flushed at the
same drained boundary.

The recorder is purely observational and on by default, so it must not
stall the card: ``num_leaves`` and the best gain may be device tensors,
kept as they come and pulled in ONE stacked device-to-host copy when the
tape is read or dumped (:func:`..train_record.pull_scalars`), never one
``.item()`` per iteration.  Recorder-on and recorder-off training write
the same model text (tested).

Anomaly detection rides the eval stream: a non-finite loss or a loss
spiking past ``spike_factor`` x its EWMA marks the event, bumps
``flight_anomalies_total{kind}`` and logs a warning.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Any, Dict, List, Optional

from . import _config
from .metrics import default_registry
from .train_record import (collectives_snapshot, device_memory_peak,
                           pull_scalars)
from ..utils.log import log_warning

__all__ = ["FlightRecorder"]

_MEM_SAMPLE_EVERY = 16  # iterations between device-memory watermark reads


def _h2d_bytes() -> float:
    """Chunked-ingest host->HBM byte counter (0 outside chunked runs)."""
    m = default_registry().get("ingest_train_h2d_bytes_total")
    value = getattr(m, "value", None)
    if m is None or value is None:
        return 0.0
    try:
        return float(value())
    except Exception:
        return 0.0


class FlightRecorder:
    """Bounded per-iteration event ring for one training run."""

    def __init__(self, capacity: int = 1024, enabled: bool = True,
                 meta: Optional[Dict[str, Any]] = None,
                 spike_factor: float = 4.0, min_history: int = 5,
                 device=None) -> None:
        self.device = device       # the run's device (memory watermark)
        self.enabled = bool(enabled) and _config.enabled()
        self.capacity = int(capacity)
        self.meta = dict(meta or {})
        self.spike_factor = float(spike_factor)
        self.min_history = int(min_history)
        self._lock = threading.Lock()
        self._ring: "collections.deque" = collections.deque(
            maxlen=self.capacity)
        self._t0 = time.perf_counter()
        self._loss_ewma: Optional[float] = None
        self._loss_n = 0
        self.anomalies: List[Dict[str, Any]] = []
        self._counter = default_registry().counter(
            "flight_anomalies_total",
            "training anomalies flagged by the flight recorder",
            labels=("kind",))

    # -- accumulation (boosting loop) ------------------------------------
    def note_iter(self, iteration: int, hist_passes=None, num_leaves=None,
                  best_gain=None, **extra) -> None:
        """Record one completed boosting iteration.  ``hist_passes`` /
        ``num_leaves`` / ``best_gain`` may be device scalars; they stay
        un-read until :meth:`events` / :meth:`dump` pulls them in one
        stacked copy."""
        if not self.enabled:
            return
        ev: Dict[str, Any] = {
            "iteration": int(iteration),
            "elapsed_s": round(time.perf_counter() - self._t0, 6),
            "unix": time.time(),
            "hist_passes": hist_passes,
            "num_leaves": num_leaves,
            "best_gain": best_gain,
            "collective_bytes": sum(
                rec["bytes"] for rec in collectives_snapshot().values()),
            "h2d_bytes": _h2d_bytes(),
            "anomaly": None,
        }
        if extra:
            ev.update(extra)
        if iteration % _MEM_SAMPLE_EVERY == 1:
            ev["device_memory_peak_bytes"] = device_memory_peak(
                self.device)
        with self._lock:
            self._ring.append(ev)

    def note_eval(self, iteration: int, evals) -> None:
        """Attach the iteration's eval results (``(data_name, metric,
        value, higher_is_better)`` tuples) to its event and run anomaly
        detection on the first metric's stream."""
        if not self.enabled or not evals:
            return
        ev_map = {f"{d} {m}": float(v) for d, m, v, *_ in evals}
        loss = float(evals[0][2])
        anomaly = self._check_loss(loss)
        with self._lock:
            target = None
            for ev in reversed(self._ring):
                if ev["iteration"] == int(iteration):
                    target = ev
                    break
            if target is None:        # eval without a recorded iteration
                target = {"iteration": int(iteration),
                          "elapsed_s": round(
                              time.perf_counter() - self._t0, 6),
                          "anomaly": None}
                self._ring.append(target)
            target["evals"] = ev_map
            target["loss"] = loss
            if anomaly is not None:
                target["anomaly"] = anomaly
        if anomaly is not None:
            self._counter.inc(1, kind=anomaly)
            rec = {"iteration": int(iteration), "kind": anomaly,
                   "loss": loss, "ewma": self._loss_ewma}
            with self._lock:
                self.anomalies.append(rec)
            log_warning(f"flight recorder: {anomaly} at iteration "
                        f"{iteration} (loss={loss!r}, "
                        f"ewma={self._loss_ewma})")

    def _check_loss(self, loss: float) -> Optional[str]:
        import math
        if not math.isfinite(loss):
            return "nan_loss"
        ewma = self._loss_ewma
        n = self._loss_n
        self._loss_n = n + 1
        if ewma is None:
            self._loss_ewma = loss
            return None
        kind = None
        if n >= self.min_history and \
                abs(loss) > self.spike_factor * max(abs(ewma), 1e-12):
            kind = "loss_spike"
        self._loss_ewma = 0.8 * ewma + 0.2 * loss
        return kind

    # -- read-out --------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)

    def events(self) -> List[Dict[str, Any]]:
        """Materialized events (device scalars pulled in one stacked
        copy, converted to plain ints/floats)."""
        with self._lock:
            evs = [dict(e) for e in self._ring]
        lazy_keys = ("hist_passes", "num_leaves", "best_gain")
        pend = [(i, k) for i, ev in enumerate(evs)
                for k in lazy_keys if ev.get(k) is not None]
        vals = pull_scalars([evs[i][k] for i, k in pend])
        for (i, k), v in zip(pend, vals):
            try:
                evs[i][k] = float(v) if k == "best_gain" else int(v)
            except (TypeError, ValueError):
                evs[i][k] = None
        for ev in evs:
            for k in lazy_keys:
                ev.setdefault(k, None)
        return evs

    def snapshot(self) -> Dict[str, Any]:
        return {
            "schema": "flight-record-v1",
            "meta": dict(self.meta),
            "capacity": self.capacity,
            "num_events": len(self),
            "anomalies": list(self.anomalies),
            "events": self.events(),
        }

    def dump(self, path: str, reason: str = "") -> str:
        """Write the tape as JSONL (one event per line, a header line
        first) via an atomic write — the crash path must never leave a
        half-written post-mortem."""
        from ..io_utils import atomic_write_bytes
        snap = self.snapshot()
        header = {"schema": snap["schema"], "meta": snap["meta"],
                  "reason": reason, "capacity": snap["capacity"],
                  "num_events": snap["num_events"],
                  "anomalies": snap["anomalies"]}
        lines = [json.dumps(header, default=str)]
        lines.extend(json.dumps(ev, default=str) for ev in snap["events"])
        atomic_write_bytes(path, ("\n".join(lines) + "\n").encode())
        return path
