"""Chaos-injection layer: named fault points the recovery test suite
uses to PROVE crash/resume behavior instead of assuming it.

Port of ``lightgbm_tpu/resilience/faults.py``: the same spec, the same
environment variable and the same serve-side and train-side points.  One
change: the reference's ``device_loss`` drives its CPU-fallback backend;
the port has no fallback, so :meth:`FaultPlan.check_device_probe` raises
:class:`~lightgbm_tpu_torch.utils.device.DeviceUnavailableError` and
never pins the CPU.  A fault point arms a fault only: it never changes a
device or a kernel route.

A fault plan is a comma-separated ``key=value`` spec, configured either
through the ``LGBM_TPU_FAULTS`` environment variable (read once per
:func:`FaultPlan.configure` / process start, so subprocess tests can
arm a child) or programmatically via ``faults.configure(...)``:

  crash_at_iter=K    raise :class:`InjectedFault` entering iteration K
                     (simulates an uncaught training error)
  kill_at_iter=K     hard-kill the process (``os._exit(137)``) entering
                     iteration K — no flush, no atexit: the closest
                     host-side analogue to a preempted/OOM-killed
                     worker dying mid-allreduce
  kill_rank=R        restrict kill_at_iter to distributed process R
                     (multi-process chaos: one worker of a collective
                     dies; the others hit a collective timeout)
  device_loss=1      make the device probe
                     (:meth:`FaultPlan.check_device_probe`) report the
                     card as lost: it raises ``DeviceUnavailableError``

Serve-side chaos (the fleet-resilience suite kills and wedges worker
processes deterministically WHILE the load generator drives traffic;
``serve/server.py`` calls :meth:`FaultPlan.check_serve_request` at the
top of every HTTP handler):

  serve_crash_after_n=N  hard-kill the worker (``os._exit(137)``) on the
                     first ``/predict`` request AFTER N have been
                     admitted — the in-flight client sees a connection
                     reset, the supervisor sees a dead process
  serve_hang_ms=T    sleep T ms in EVERY handler (including
                     ``/healthz`` — a wedged process wedges its health
                     probe too, which is exactly what the fleet
                     watchdog keys on)
  serve_drop_conn=K  sever every K-th ``/predict`` connection without a
                     response (simulates a mid-request network reset;
                     the dispatcher's bounded retry path)

Every trigger increments ``faults_injected_total{fault=...}`` in the
telemetry registry (kill_at_iter / serve_crash_after_n necessarily
excepted — the process is gone before any export).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional

from ..telemetry.metrics import default_registry
from ..utils.log import log_warning

__all__ = ["InjectedFault", "FaultPlan", "faults"]

ENV_VAR = "LGBM_TPU_FAULTS"


class InjectedFault(RuntimeError):
    """Raised by an armed ``crash_at_iter`` fault point."""


def _parse_spec(spec: str) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for tok in str(spec).split(","):
        tok = tok.strip()
        if not tok:
            continue
        if "=" not in tok:
            raise ValueError(f"bad fault spec token {tok!r} "
                             f"(want key=value)")
        key, val = tok.split("=", 1)
        out[key.strip()] = int(val)
    return out


class FaultPlan:
    """Process-wide armed faults; thread-safe, cleared between tests."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._plan: Dict[str, int] = {}
        self._serve_predicts = 0  # /predict requests seen (serve chaos)
        self._counter = default_registry().counter(
            "faults_injected_total", "chaos-layer faults triggered",
            labels=("fault",))
        env = os.environ.get(ENV_VAR, "")
        if env:
            try:
                self._plan = _parse_spec(env)
            except ValueError as exc:
                log_warning(f"ignoring {ENV_VAR}={env!r}: {exc}")

    def configure(self, spec) -> "FaultPlan":
        """Arm a plan from a spec string or dict (replaces the current
        plan)."""
        plan = dict(spec) if isinstance(spec, dict) else _parse_spec(spec)
        with self._lock:
            self._plan = {k: int(v) for k, v in plan.items()}
        return self

    def clear(self) -> None:
        with self._lock:
            self._plan = {}
            self._serve_predicts = 0

    def get(self, key: str) -> Optional[int]:
        with self._lock:
            return self._plan.get(key)

    def is_active(self, key: str) -> bool:
        return self.get(key) not in (None, 0)

    def fire(self, name: str) -> None:
        self._counter.inc(1, fault=name)

    # -- fault points --------------------------------------------------------
    def check_train_iter(self, iteration: int) -> None:
        """Called by the boosting loop entering iteration ``iteration``."""
        kill_at = self.get("kill_at_iter")
        if kill_at is not None and iteration == kill_at and \
                self._rank_matches():
            log_warning(f"fault injection: hard-killing the process at "
                        f"iteration {iteration} (no flush)")
            os._exit(137)
        crash_at = self.get("crash_at_iter")
        if crash_at is not None and iteration == crash_at:
            self.fire("crash_at_iter")
            raise InjectedFault(
                f"injected crash entering iteration {iteration}")

    def _rank_matches(self) -> bool:
        rank = self.get("kill_rank")
        if rank is None:
            return True
        try:
            import torch.distributed as dist
            if dist.is_available() and dist.is_initialized():
                return int(dist.get_rank()) == rank
        except Exception:
            pass
        return int(os.environ.get("RANK", 0)) == rank

    def check_serve_request(self, path: str) -> Optional[str]:
        """Called by the HTTP serving layer at the top of every handler.

        Returns ``"drop"`` when the armed plan wants this connection
        severed without a response (the handler closes the socket), or
        ``None`` to proceed.  ``serve_crash_after_n`` never returns —
        the process is gone.
        """
        # production fast path: with nothing armed this is one
        # unlocked dict-emptiness read per request, not four lock
        # acquisitions (faults are armed before traffic starts; a
        # racy read here only delays an injection by one request)
        if not self._plan:
            return None
        hang_ms = self.get("serve_hang_ms")
        if hang_ms:
            # wedge, don't die: EVERY handler (healthz probes included)
            # stalls, which is what distinguishes a hung worker from a
            # crashed one to the supervisor's watchdog
            self.fire("serve_hang_ms")
            import time
            time.sleep(hang_ms / 1e3)
        if path != "/predict":
            return None
        with self._lock:
            self._serve_predicts += 1
            n_seen = self._serve_predicts
        crash_after = self.get("serve_crash_after_n")
        if crash_after is not None and n_seen > crash_after:
            log_warning(f"fault injection: hard-killing the serving "
                        f"process after {crash_after} /predict requests")
            os._exit(137)
        drop_every = self.get("serve_drop_conn")
        if drop_every and n_seen % drop_every == 0:
            self.fire("serve_drop_conn")
            return "drop"
        return None

    def check_device_probe(self) -> None:
        """Called where the card is first resolved; an armed
        ``device_loss`` makes it raise ``DeviceUnavailableError`` (the
        port has no CPU fallback to take)."""
        if self.is_active("device_loss"):
            self.fire("device_loss")
            from ..utils.device import DeviceUnavailableError
            raise DeviceUnavailableError(
                "injected fault: accelerator device lost (device_loss)")


faults = FaultPlan()
