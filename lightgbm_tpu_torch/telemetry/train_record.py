"""Per-training-run instrumentation: the ``TrainRecord``.

Port of ``lightgbm_tpu/telemetry/train_record.py``.  A ``TrainRecord``
accumulates one run's numbers as the boosting loop runs:

  * per-tree full-data histogram passes (``GrownTree.hist_passes``) and
    leaf counts, which may be device scalars: they are kept as they come
    and pulled in ONE stacked device-to-host copy when the record is
    read (or every ``_FLUSH_EVERY`` trees), so the loop never waits on
    the card for them;
  * collective count and reduced bytes per call site
    (:func:`note_collective`), which the reference tallies where its jit
    programs are traced.  The port runs no collective yet (ROADMAP queue
    1 item 10), so ``collectives_traced`` reads empty; so does
    ``hist_kernel``, the reference's per-site histogram builds: the
    port's kernel launches are counted in ``ops/histogram_cuda.LAUNCHES``;
  * XLA compile and retrace events, which the reference takes from
    ``jax.monitoring`` listeners.  The port compiles no XLA program, so
    it registers no listener: ``compile_events`` and ``compile_seconds``
    keep their names and read empty;
  * the device-memory watermark: ``torch.cuda.max_memory_allocated`` of
    the run's device (``None`` on the CPU, as the reference's XLA:CPU
    gives none);
  * per-phase wall time (gradients / grow / record / eval).

Accumulation is gated by ``telemetry.enabled()`` and purely
observational: it reads values training already computed, so
telemetry-on and telemetry-off training write the same model text.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Sequence

from . import _config
from .trace import span

__all__ = ["TrainRecord", "note_collective", "collectives_snapshot",
           "collectives_reset", "last_train_record",
           "set_last_train_record", "device_memory_peak", "pull_scalars"]


# ---------------------------------------------------------------------------
# Collective tally (reference :56-90): no port call site yet
# ---------------------------------------------------------------------------

_coll_lock = threading.Lock()
# site -> {"op": str, "count": int, "bytes": int}
_collectives: Dict[str, Dict[str, Any]] = {}


def note_collective(site: str, op: str, value) -> None:
    """Record one collective call of ``op`` at ``site`` over ``value``
    (anything with ``shape`` and ``dtype``)."""
    if not _config.enabled():
        return
    try:
        nbytes = 1
        for d in value.shape:
            nbytes *= int(d)
        nbytes *= value.dtype.itemsize
    except Exception:
        nbytes = 0
    with _coll_lock:
        rec = _collectives.get(site)
        if rec is None:
            rec = _collectives[site] = {"op": op, "count": 0, "bytes": 0}
        rec["count"] += 1
        rec["bytes"] += int(nbytes)


def collectives_snapshot() -> Dict[str, Dict[str, Any]]:
    with _coll_lock:
        return {k: dict(v) for k, v in _collectives.items()}


def collectives_reset() -> None:
    with _coll_lock:
        _collectives.clear()


# ---------------------------------------------------------------------------
# Device scalars and the memory watermark
# ---------------------------------------------------------------------------

def pull_scalars(values: Sequence[Any]) -> List[Any]:
    """``values`` with every tensor replaced by its Python number: the
    tensors of one device are stacked and copied to the host at once
    (one copy per device, not one ``.item()`` each).  Other values pass
    through unchanged."""
    out = list(values)
    groups: Dict[Any, List[int]] = {}
    for i, v in enumerate(out):
        if hasattr(v, "detach") and hasattr(v, "device"):
            groups.setdefault(v.device, []).append(i)
    if groups:
        import torch
        for idx in groups.values():
            # float64 holds every int32 count and float32 gain exactly
            host = torch.stack([out[i].detach().reshape(()).to(
                torch.float64) for i in idx]).cpu().tolist()
            for i, v in zip(idx, host):
                out[i] = v
    return out


def device_memory_peak(device=None) -> Optional[int]:
    """``torch.cuda.max_memory_allocated`` of ``device`` (a CUDA device
    the run uses), or None on the CPU and where CUDA is not up."""
    if device is None:
        return None
    try:
        import torch
        dev = torch.device(device)
        if dev.type != "cuda" or not torch.cuda.is_initialized():
            return None
        return int(torch.cuda.max_memory_allocated(dev))
    except Exception:
        return None


# ---------------------------------------------------------------------------
# TrainRecord
# ---------------------------------------------------------------------------

class _Phase:
    __slots__ = ("_rec", "_name", "_span", "_t0")

    def __init__(self, rec: "TrainRecord", name: str) -> None:
        self._rec = rec
        self._name = name

    def __enter__(self):
        self._span = span("train/" + self._name)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        with self._rec._lock:
            ph = self._rec._phase_s
            ph[self._name] = ph.get(self._name, 0.0) + dt
            cn = self._rec._phase_n
            cn[self._name] = cn.get(self._name, 0) + 1
        return False


class _NoopPhase:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_PHASE = _NoopPhase()

_FLUSH_EVERY = 256  # pending device scalars pulled per stacked copy


class TrainRecord:
    """Accumulates one training run's observability record.

    Created by ``GBDT._init_train`` and surfaced as
    ``Booster.train_record`` (a dict snapshot); the freshest record is
    also published process-wide for the ``/metrics`` exporter.
    ``device`` is the run's device (its memory watermark is read)."""

    def __init__(self, meta: Optional[Dict[str, Any]] = None,
                 device=None) -> None:
        self._lock = threading.Lock()
        self.meta = dict(meta or {})
        self.device = device
        self._t_created = time.perf_counter()
        self._phase_s: Dict[str, float] = {}
        self._phase_n: Dict[str, int] = {}
        # per-tree scalars pending a stacked host pull
        self._pending: List[tuple] = []   # (iteration, class_id, hp, nl)
        self._trees: List[Dict[str, int]] = []
        self._mem_peak: Optional[int] = None
        self._coll_base = collectives_snapshot()

    # -- accumulation (boosting loop) ------------------------------------
    def phase(self, name: str):
        """``with record.phase("grow"):`` adds wall time to the named
        phase and opens a ``train/<name>`` telemetry span."""
        if not _config.enabled():
            return _NOOP_PHASE
        return _Phase(self, name)

    def add_tree(self, iteration: int, class_id: int, hist_passes,
                 num_leaves) -> None:
        """Record one grown tree.  ``hist_passes`` / ``num_leaves`` may be
        device scalars; they are not read here."""
        if not _config.enabled():
            return
        with self._lock:
            self._pending.append((int(iteration), int(class_id),
                                  hist_passes, num_leaves))
            flush = len(self._pending) >= _FLUSH_EVERY
        if flush:
            self._flush()

    def note_memory(self) -> None:
        if not _config.enabled():
            return
        peak = device_memory_peak(self.device)
        if peak is not None:
            with self._lock:
                self._mem_peak = max(peak, self._mem_peak or 0)

    def _flush(self) -> None:
        with self._lock:
            pending, self._pending = self._pending, []
        if not pending:
            return
        flat = pull_scalars([v for p in pending for v in (p[2], p[3])])
        rows = [{"iteration": it, "class_id": cid,
                 "hist_passes": int(flat[2 * i]),
                 "num_leaves": int(flat[2 * i + 1])}
                for i, (it, cid, _, _) in enumerate(pending)]
        with self._lock:
            self._trees.extend(rows)

    # -- snapshot --------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready record; pulls any pending device scalars (one
        stacked copy) and diffs the process-wide tallies against this
        record's baseline."""
        self._flush()
        self.note_memory()  # final watermark: periodic samples miss the tail
        with self._lock:
            trees = list(self._trees)
            phase_s = dict(self._phase_s)
            phase_n = dict(self._phase_n)
            mem_peak = self._mem_peak
            elapsed = time.perf_counter() - self._t_created
        trees.sort(key=lambda r: (r["iteration"], r["class_id"]))
        coll = {}
        for site, rec in collectives_snapshot().items():
            base = self._coll_base.get(site, {"count": 0, "bytes": 0})
            dc = rec["count"] - base["count"]
            if dc > 0:
                coll[site] = {"op": rec["op"], "count": dc,
                              "bytes": rec["bytes"] - base["bytes"]}
        hp = [r["hist_passes"] for r in trees]
        return {
            "schema": "train-record-v1",
            "meta": dict(self.meta),
            "num_trees": len(trees),
            "trees": trees,
            "hist_passes_total": sum(hp),
            "hist_passes_last": hp[-1] if hp else 0,
            "phase_seconds": {k: round(v, 6) for k, v in phase_s.items()},
            "phase_calls": phase_n,
            "collectives_traced": coll,
            # no XLA program is traced or compiled: the reference's
            # per-site builds and jax.monitoring events have no
            # counterpart (module docstring)
            "hist_kernel": {},
            "compile_events": {},
            "compile_seconds": {},
            "device_memory_peak_bytes": mem_peak,
            "elapsed_seconds": round(elapsed, 6),
        }


# ---------------------------------------------------------------------------
# Process-wide "last training run" handle (the /metrics exporter reads it)
# ---------------------------------------------------------------------------

_last_lock = threading.Lock()
_last_record: Optional[TrainRecord] = None


def set_last_train_record(rec: Optional[TrainRecord]) -> None:
    global _last_record
    with _last_lock:
        _last_record = rec


def last_train_record() -> Optional[TrainRecord]:
    with _last_lock:
        return _last_record
