"""Micro-batching queue: coalesce concurrent small requests into one
bucketed device call, with admission control in front of it.

Copy of ``lightgbm_tpu/serve/batcher.py`` (pure Python over numpy) kept
inside the PyTorch port so the port never imports the JAX package.  The
device call it makes is the predictor's, which binds its own card
(``serve/predictor.py``), so the dispatch thread needs no device of its
own.

A single worker thread drains the queue under a max-wait/max-rows
policy: the first waiting request opens a window of ``max_wait_ms``;
every request arriving inside it joins the batch until ``max_batch_rows``
is reached.  One concatenated predict runs, and each waiter gets its row
slice back through a Future — so N concurrent single-row requests cost
one device dispatch on the next bucket up instead of N dispatches.

Requests are grouped by (raw_score, feature-count) inside a window: a
malformed request can only fail its own group, never poison co-batched
traffic with a different shape.

Admission control (resilience/admission.py semantics):

  * ``max_queue_rows`` bounds the backlog; a submit that would exceed it
    is rejected with :class:`QueueFullError` carrying a ``retry_after``
    estimated from the EWMA batch latency — admitting more work than the
    device drains only grows everyone's latency, so shed at the door.
  * a per-request ``deadline`` (monotonic seconds) expires queued work:
    the worker fails expired requests with :class:`DeadlineExceeded`
    instead of spending device time on an answer nobody is waiting for,
    and ``predict`` stops blocking at the deadline either way.
  * ``close()`` drains the queue and fails every pending future with
    :class:`ServerClosed` — a shutdown never leaves a caller blocked
    until its own client timeout.

Observability:

  * ``serve_queue_rows{model}`` / ``serve_inflight_requests{model}``
    gauges track saturation building, not just requests dying — a load
    test watches the backlog grow BEFORE the shed counter moves;
  * each request's ``X-Request-Id`` rides the queue item; ``stats``
    (a :class:`ModelStats`) receives the per-request queue-wait vs
    device-compute split, and the ids propagate into the predictor when
    its ``predict`` accepts ``request_ids`` (recompile attribution).
"""

from __future__ import annotations

import inspect
import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from concurrent.futures import TimeoutError as FutureTimeout
from typing import Callable, Optional

import numpy as np

from ..resilience.admission import (DeadlineExceeded, QueueFullError,
                                    ServerClosed, deadline_counter,
                                    shed_counter)
from ..telemetry.metrics import default_registry

__all__ = ["MicroBatcher", "TenantQueueFull"]

_CLOSE = object()

# queue item slots:
# (X, raw_score, future, deadline, request_id, t_submit, lane)
_X, _RAW, _FUT, _DEADLINE, _RID, _TSUB, _LANE = range(7)


class TenantQueueFull(QueueFullError):
    """Per-tenant quota shed: ONE tenant's lane backlog hit its bound
    while the shared queue still had room — the hot tenant is refused
    before it can crowd out co-batched neighbours (zoo quota
    semantics: per-tenant shed happens BEFORE cross-tenant shed)."""


class MicroBatcher:
    """Thread-safe request coalescer in front of a predict function.

    ``predict_fn(X, raw_score) -> np.ndarray`` must be row-aligned:
    output row i corresponds to input row i (true for every predictor
    path).  ``submit`` returns a Future; ``predict`` blocks on it.
    ``name`` labels the shed/deadline counters and saturation gauges;
    ``stats`` (optional :class:`ModelStats`) receives each request's
    queue-wait vs device-compute timing split.
    """

    def __init__(self, predict_fn: Callable[..., np.ndarray],
                 max_batch_rows: int = 4096,
                 max_wait_ms: float = 2.0,
                 max_queue_rows: int = 0,
                 name: str = "default",
                 stats=None,
                 buckets: Optional[tuple] = None,
                 tenant_queue_rows: int = 0) -> None:
        self._predict_fn = predict_fn
        self._max_rows = int(max_batch_rows)
        self._max_wait = max(0.0, float(max_wait_ms)) / 1e3
        self._max_queue_rows = max(0, int(max_queue_rows))  # 0 = unbounded
        # per-lane (tenant) row bound, checked BEFORE the shared bound
        self._tenant_rows = max(0, int(tenant_queue_rows))
        self._lane_rows: dict = {}
        self.name = str(name)
        self.stats = stats
        self._buckets = tuple(buckets) if buckets is not None else None
        try:
            self._fn_takes_rids = "request_ids" in \
                inspect.signature(predict_fn).parameters
        except (TypeError, ValueError):
            self._fn_takes_rids = False
        self._q: "queue.Queue" = queue.Queue()
        self._closed = False
        self._backlog_rows = 0  # rows admitted but not yet dispatched
        self._ewma_batch_s = 0.05  # device-call latency estimate
        self._state_lock = threading.Lock()  # serializes submit vs close
        self._shed = shed_counter()
        self._deadline = deadline_counter()
        # the saturation gauges live NEXT TO the stats' series (a server
        # with a private metrics registry keeps its saturation private
        # too); without stats they land in the process-wide registry.
        # No zero-init: a gauge series appears on the first submit, so
        # constructing a second batcher can never clobber a live one's
        # reading under the same model label.
        reg = stats.registry if stats is not None and \
            hasattr(stats, "registry") else default_registry()
        self._queue_gauge = reg.gauge(
            "serve_queue_rows",
            "rows admitted to the micro-batcher but not yet dispatched",
            labels=("model",))
        self._inflight_gauge = reg.gauge(
            "serve_inflight_requests",
            "requests admitted and not yet completed", labels=("model",))
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="lgb-tpu-microbatcher")
        self._thread.start()

    # -- client side --------------------------------------------------------
    @property
    def backlog_rows(self) -> int:
        return self._backlog_rows

    def inflight_requests(self) -> int:
        return int(self._inflight_gauge.value(model=self.name))

    def submit(self, X: np.ndarray, raw_score: bool = False,
               deadline: Optional[float] = None,
               request_id: Optional[str] = None,
               lane: Optional[str] = None) -> Future:
        """Queue one request.  ``deadline`` is an absolute
        ``time.monotonic()`` instant after which the request is failed
        with :class:`DeadlineExceeded` rather than dispatched;
        ``request_id`` tags the request's telemetry trail (exemplars,
        recompile attribution).  ``lane`` names the tenant for
        cross-model batchers: it keys the per-tenant quota and tells the
        dispatcher which model lane of the stacked program the rows ride
        (plain per-model batchers leave it None)."""
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        fut: Future = Future()
        rows = int(X.shape[0])
        # the closed/limit checks and the put are one atomic step, so no
        # item can land behind the _CLOSE sentinel or sneak past the
        # queue bound under concurrent submitters
        with self._state_lock:
            if self._closed:
                raise ServerClosed("batcher is closed")
            if lane is not None and self._tenant_rows:
                cur = self._lane_rows.get(lane, 0)
                if cur + rows > self._tenant_rows:
                    # the tenant's own quota sheds first — attributed to
                    # the TENANT's series, not the shared batcher's
                    retry = self._retry_after_locked()
                    self._shed.inc(1, model=lane)
                    raise TenantQueueFull(cur, self._tenant_rows, retry)
            if self._max_queue_rows and \
                    self._backlog_rows + rows > self._max_queue_rows:
                retry = self._retry_after_locked()
                self._shed.inc(1, model=self.name)
                raise QueueFullError(self._backlog_rows,
                                     self._max_queue_rows, retry)
            self._backlog_rows += rows
            if lane is not None:
                self._lane_rows[lane] = self._lane_rows.get(lane, 0) + rows
            self._queue_gauge.set(self._backlog_rows, model=self.name)
            self._inflight_gauge.add(1, model=self.name)
            # the done-callback fires exactly once whichever path settles
            # the future (dispatch, deadline expiry, shutdown drain), so
            # the gauge can never leak under the racy failure paths
            fut.add_done_callback(
                lambda _f: self._inflight_gauge.add(-1, model=self.name))
            self._q.put((X, bool(raw_score), fut, deadline, request_id,
                         time.monotonic(), lane))
        return fut

    def _retry_after_locked(self) -> float:
        """Backoff hint: how long the current backlog takes to drain at
        the EWMA device-call latency (>= one batch window)."""
        batches = max(1.0, self._backlog_rows / max(1, self._max_rows))
        return max(0.05, batches * self._ewma_batch_s + self._max_wait)

    def predict(self, X: np.ndarray, raw_score: bool = False,
                timeout_s: Optional[float] = None,
                request_id: Optional[str] = None,
                lane: Optional[str] = None) -> np.ndarray:
        """Blocking submit; with ``timeout_s`` the call raises
        :class:`DeadlineExceeded` at the deadline instead of hanging the
        calling (handler) thread on a future that is still queued."""
        deadline = None if timeout_s is None else \
            time.monotonic() + float(timeout_s)
        fut = self.submit(X, raw_score, deadline=deadline,
                          request_id=request_id, lane=lane)
        if deadline is None:
            return fut.result()
        try:
            return fut.result(timeout=max(0.0, deadline - time.monotonic()))
        except FutureTimeout:
            exc = DeadlineExceeded(
                f"request did not complete within {float(timeout_s or 0):.3f}s")
            try:
                # mark the future failed so the worker neither batches
                # nor double-counts this request when it dequeues it
                fut.set_exception(exc)
            except InvalidStateError:
                return fut.result()  # completed in the race window
            self._deadline.inc(1, model=self.name)
            raise exc from None

    def close(self, timeout: Optional[float] = 5.0) -> None:
        with self._state_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(_CLOSE)
        self._thread.join(timeout)
        # drain: fail anything the worker left behind rather than leaving
        # its caller blocked until a client-side timeout — and release
        # the queue-gauge accounting, or the process-wide registry keeps
        # reporting phantom queued rows for a batcher that no longer
        # exists
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not _CLOSE:
                with self._state_lock:
                    self._debit_locked(item)
                try:
                    item[_FUT].set_exception(ServerClosed(
                        "batcher closed while the request was queued"))
                except InvalidStateError:
                    pass  # its waiter expired it in the race window

    # -- worker side --------------------------------------------------------
    def _debit_locked(self, item) -> None:
        """Release one item's backlog accounting (shared + per-lane).
        Caller holds ``_state_lock``."""
        rows = int(item[_X].shape[0])
        self._backlog_rows -= rows
        lane = item[_LANE]
        if lane is not None and lane in self._lane_rows:
            left = self._lane_rows[lane] - rows
            if left > 0:
                self._lane_rows[lane] = left
            else:
                del self._lane_rows[lane]
        self._queue_gauge.set(self._backlog_rows, model=self.name)

    def _take(self, item) -> bool:
        """Account one dequeued request; expire it instead of batching it
        when its deadline already passed."""
        with self._state_lock:
            self._debit_locked(item)
        if item[_DEADLINE] is not None and \
                time.monotonic() > item[_DEADLINE]:
            if not item[_FUT].done():
                self._deadline.inc(1, model=self.name)
                item[_FUT].set_exception(DeadlineExceeded(
                    "request expired while queued"))
            return False
        return True

    def _loop(self) -> None:
        while True:
            first = self._q.get()
            if first is _CLOSE:
                return
            if not self._take(first):
                continue
            batch = [first]
            rows = first[_X].shape[0]
            deadline = time.monotonic() + self._max_wait
            stop = False
            while rows < self._max_rows:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    if len(batch) == 1:
                        # uncontended request: dispatch immediately — the
                        # wait window only opens once a second request is
                        # already queued, so sequential traffic pays no
                        # max_wait latency tax
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                if nxt is _CLOSE:
                    stop = True
                    break
                if self._take(nxt):
                    batch.append(nxt)
                    rows += nxt[_X].shape[0]
            self._run(batch)
            if stop:
                return

    def _record_timing(self, group, t_dispatch: float, device_s: float,
                       t_done: float) -> None:
        """Per-request split for one dispatched group: queue wait is the
        time from submit to dispatch, device compute is the group's
        batched call (shared — every co-batched request rode the same
        dispatch)."""
        if self.stats is None:
            return
        from ..models.tree import SHAPE_BUCKETS, bucket_rows
        total_rows = sum(g[_X].shape[0] for g in group)
        # label with the PREDICTOR's ladder when given (a custom-bucket
        # predictor must not report timings under phantom global-ladder
        # buckets it never dispatches)
        bucket = bucket_rows(total_rows, self._buckets
                             if self._buckets is not None else SHAPE_BUCKETS)
        for g in group:
            self.stats.record_request_timing(
                int(g[_X].shape[0]), bucket,
                queue_ms=(t_dispatch - g[_TSUB]) * 1e3,
                device_ms=device_s * 1e3,
                total_ms=(t_done - g[_TSUB]) * 1e3,
                request_id=g[_RID])

    def _run(self, batch) -> None:
        groups: dict = {}
        for item in batch:
            groups.setdefault((item[_RAW], item[_X].shape[1]),
                              []).append(item)
        for (raw, cols), group in groups.items():
            try:
                self._dispatch_group(raw, cols, group)
            except Exception as exc:  # propagate to every waiter in group
                for g in group:
                    try:
                        g[_FUT].set_exception(exc)
                    except InvalidStateError:
                        pass  # its waiter expired it in the race window

    def _dispatch_group(self, raw: bool, cols: int, group) -> None:
        """Run one (raw_score, feature-count) group as a single device
        call and slice results back per request.  The cross-model stack
        batcher (serve/zoo.py) overrides this to form (model-lane,
        bucket) super-batches; everything upstream — window drain,
        deadline expiry, admission accounting — is shared."""
        t0 = time.monotonic()
        X = (group[0][_X] if len(group) == 1 else
             np.concatenate([g[_X] for g in group], axis=0))
        if self._fn_takes_rids:
            out = self._predict_fn(
                X, raw, request_ids=tuple(
                    g[_RID] for g in group if g[_RID]))
        else:
            out = self._predict_fn(X, raw)
        t1 = time.monotonic()
        ofs = 0
        for g in group:
            n = g[_X].shape[0]
            try:
                g[_FUT].set_result(out[ofs:ofs + n])
            except InvalidStateError:
                pass  # its waiter expired it in the race window
            ofs += n
        self._record_timing(group, t0, t1 - t0, time.monotonic())
        # retry-after estimates ride this (reads are unlocked — a
        # slightly stale float is fine)
        self._ewma_batch_s = 0.8 * self._ewma_batch_s + 0.2 * (t1 - t0)
