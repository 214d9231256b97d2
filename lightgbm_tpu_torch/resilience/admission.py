"""Serving admission control: typed errors + telemetry for load
shedding, per-request deadlines and shutdown draining.

Copy of ``lightgbm_tpu/resilience/admission.py`` (pure Python) kept
inside the PyTorch port so the port never imports the JAX package.

The micro-batcher (``serve/batcher.py``) enforces the policy; the HTTP
layer (``serve/server.py``) maps the errors to wire semantics:

  :class:`QueueFullError`     -> 503 + ``Retry-After`` (load shed: the
                                 bounded queue is over its row budget;
                                 admitting more would only grow latency
                                 for everyone already queued)
  :class:`DeadlineExceeded`   -> 504 (the request's deadline passed
                                 before a device slot freed up; the
                                 handler thread returns instead of
                                 hanging on the future)
  :class:`ServerClosed`       -> request failed because the batcher was
                                 shut down; queued work is drained and
                                 failed promptly, never left blocking
                                 its caller until a client timeout

Counters (process-wide registry, labeled ``model=<name>``):
``requests_shed_total`` and ``deadline_exceeded_total`` — both exported
through ``GET /metrics`` and consulted by the degraded-mode ``/healthz``.
"""

from __future__ import annotations

from ..telemetry.metrics import Counter, MetricsRegistry, default_registry
from ..telemetry.slo import register_metric_ensurer, slo

__all__ = ["QueueFullError", "DeadlineExceeded", "ServerClosed",
           "shed_counter", "deadline_counter"]

# Shed-budget objective, declared next to the counter it reads: at most
# 1% of client predict calls may be refused by admission control.  A
# sustained higher shed rate means the tier is undersized for its
# traffic, not protecting itself from a blip.
slo("serve/shed_rate", metric="requests_shed_total",
    total_metric="serve_requests_total", kind="ratio", target=0.99,
    min_events=50,
    note="load-shed (503) budget over client predict calls")


class QueueFullError(RuntimeError):
    """Request rejected by admission control; ``retry_after`` is the
    suggested client backoff in seconds (drives ``Retry-After``)."""

    def __init__(self, backlog_rows: int, limit_rows: int,
                 retry_after: float) -> None:
        super().__init__(
            f"request queue is full ({backlog_rows} rows queued, limit "
            f"{limit_rows}); retry in {retry_after:.2f}s")
        self.backlog_rows = int(backlog_rows)
        self.limit_rows = int(limit_rows)
        self.retry_after = float(retry_after)


class DeadlineExceeded(TimeoutError):
    """The request's deadline expired before its batch ran (or before
    its result was collected)."""


class ServerClosed(RuntimeError):
    """The batcher/server shut down while the request was queued."""


def shed_counter() -> Counter:
    return default_registry().counter(
        "requests_shed_total",
        "requests rejected by admission control (503 load shed)",
        labels=("model",))


def deadline_counter() -> Counter:
    return default_registry().counter(
        "deadline_exceeded_total",
        "requests failed by per-request deadline (504)",
        labels=("model",))


@register_metric_ensurer
def _ensure_admission_metrics(reg: MetricsRegistry) -> None:
    """SLO-coverage ensurer: the admission counter families exist in a
    registry before any traffic (or shed) does."""
    reg.counter("requests_shed_total",
                "requests rejected by admission control (503 load shed)",
                labels=("model",))
    reg.counter("deadline_exceeded_total",
                "requests failed by per-request deadline (504)",
                labels=("model",))
