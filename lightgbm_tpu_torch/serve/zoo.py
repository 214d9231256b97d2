"""Multi-tenant model zoo: bounded admission/eviction over the registry
plus batched cross-model dispatch.

Port of ``lightgbm_tpu/serve/zoo.py`` over the port's
:class:`~.compiler.StackedExecutable`.

**Batched cross-model dispatch** (the hot path).  Tenants whose
predictors share one ``DenseExecutable.signature`` (same tree, node and
leaf envelope, leaf_bits, table shapes) are fused into a
:class:`~.compiler.StackedExecutable`: their lowered tables stacked on a
leading model axis, so ONE program call serves every member's
micro-batch.  The cross-model :class:`_StackBatcher` (a
``MicroBatcher`` whose dispatch hook forms (model-lane, bucket)
super-batches) coalesces per-tenant queues under the same
max-wait/deadline discipline; each tenant's slice of the stacked output
equals its solo dispatch bit for bit (every contraction of the stacked
program is a batched contraction of the same per-slice shape; the zoo
parity tests assert it).

**Bounded admission/eviction.**  ``max_resident`` caps the resident set;
over budget the zoo evicts by traffic-weighted LRU (an exponentially
decayed per-tenant request weight).  A request for a non-resident model
cold loads it on miss through ``source_resolver``, spending the
request's remaining deadline budget, and 504s cleanly past it (the model
stays resident).  ``zoo_evictions_total{reason}`` /
``zoo_cold_loads_total`` count every decision, and eviction releases the
tenant's metric series and (for the last model of a shape) its
compile-key mirror entries.  Every launch runs on the default stream of
the zoo's one device, so an eviction never frees tables a queued launch
still reads.

**Per-tenant quotas**: each tenant's lane backlog is bounded
(``tenant_queue_rows``) and sheds BEFORE the shared queue bound does,
tracked by the ``serve/tenant_quota`` ratio SLO declared below.

Left out: the reference's program contracts (``serve/zoo_stack``
MemoryBudget and the sharded stack's psum contract), which come with
the contract checks and the tree-sharded program (ROADMAP queue 1 items
12 and 10).
"""

from __future__ import annotations

import hashlib
import threading
import time
from concurrent.futures import InvalidStateError
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..models.tree import bucket_rows, pad_rows
from ..resilience.admission import DeadlineExceeded, ServerClosed
from ..telemetry.metrics import default_registry
from ..telemetry.slo import register_metric_ensurer, slo
from ..utils.device import resolve_device
from .batcher import (_FUT, _LANE, _RID, _TSUB, _X, MicroBatcher,
                      TenantQueueFull)
from .compiler import StackedExecutable
from .predictor import _note_dispatch, _on_device, release_compile_keys
from .registry import ModelRegistry

__all__ = ["ModelZoo"]

# ---------------------------------------------------------------------------
# zoo telemetry — never-silent admission decisions + the quota SLO
# ---------------------------------------------------------------------------

def _zoo_metrics(reg):
    return (
        reg.counter("zoo_evictions_total",
                    "models evicted from the zoo, by reason",
                    labels=("reason",)),
        reg.counter("zoo_cold_loads_total",
                    "models cold-loaded on a request miss"),
        reg.histogram("zoo_cold_load_ms",
                      "cold load-on-miss latency (resolve+build+warm)"),
        reg.counter("zoo_stack_batches_total",
                    "fused cross-model stacked calls, by stack group",
                    labels=("group",)),
        reg.counter("zoo_tenant_shed_total",
                    "requests shed by a tenant's own quota (before the "
                    "shared queue bound)", labels=("model",)),
        reg.gauge("zoo_resident_models", "models resident in the zoo"),
    )


@register_metric_ensurer
def _ensure_zoo_metrics(reg) -> None:
    _zoo_metrics(reg)


# Tenant-quota objective: the share of client predict calls refused by a
# PER-TENANT quota (not the shared queue bound — that is serve/shed_rate)
# must stay inside budget; a sustained burn means one tenant's quota is
# sized below its real traffic.
slo("serve/tenant_quota", metric="zoo_tenant_shed_total",
    total_metric="serve_requests_total", kind="ratio", target=0.99,
    min_events=50,
    note="per-tenant quota sheds over client predict calls")


def _sig_digest(sig) -> str:
    """Short stable digest of a shape signature — the operator-facing
    group key (matches ``CompiledPredictor.group_key``)."""
    return hashlib.sha1(repr(sig).encode()).hexdigest()[:12]


# ---------------------------------------------------------------------------
# the cross-model batcher
# ---------------------------------------------------------------------------

class _StackBatcher(MicroBatcher):
    """One shared coalescing queue for every tenant of one stack group.

    Inherits the whole admission/window/deadline discipline of
    :class:`MicroBatcher` (per-tenant quota included — submits carry
    ``lane=<model>``); only the dispatch hook differs: a drained window
    is regrouped into (model-lane, bucket) super-batches, each run as
    ONE stacked launch, each tenant's slice returned bitwise identical
    to solo dispatch.  Lanes whose model left the stack between submit
    and dispatch (membership churn) fall back to their solo predictor —
    correct, just not fused."""

    def __init__(self, zoo: "ModelZoo", sig: tuple, buckets: tuple,
                 **kw) -> None:
        # set before super().__init__: the worker thread starts there
        self._zoo_ref = zoo
        self._member_sig = sig
        self._stack_buckets = tuple(buckets)
        self._group = _sig_digest(sig)
        super().__init__(self._unused_fn, name=f"zoo:{self._group}",
                         buckets=buckets, **kw)

    @staticmethod
    def _unused_fn(X, raw_score):  # dispatch is fully overridden
        raise NotImplementedError

    def _fail(self, items, exc) -> None:
        for it in items:
            try:
                it[_FUT].set_exception(exc)
            except InvalidStateError:
                pass  # its waiter expired it in the race window

    def _dispatch_group(self, raw: bool, cols: int, group) -> None:
        zoo = self._zoo_ref
        stack = zoo.current_stack(self._member_sig)
        lanes: Dict[str, list] = {}
        for it in group:
            lanes.setdefault(it[_LANE], []).append(it)
        per_bucket: Dict[int, list] = {}
        for lane, items in lanes.items():
            if stack is None or lane not in stack.names:
                self._solo_fallback(lane, raw, items)
                continue
            Xl = (items[0][_X] if len(items) == 1 else
                  np.concatenate([it[_X] for it in items], axis=0))
            nb = bucket_rows(Xl.shape[0], self._stack_buckets)
            per_bucket.setdefault(nb, []).append((lane, Xl, items))
        for nb in sorted(per_bucket):
            self._dispatch_stacked(stack, raw, cols, nb, per_bucket[nb])

    def _dispatch_stacked(self, stack: StackedExecutable, raw: bool,
                          cols: int, nb: int, ents: list) -> None:
        """One (stack, bucket) super-batch: every active lane's padded
        block rides one fused call; idle lanes are zero-filled so the
        stacked shape never varies with WHICH tenants happen to be in
        the window."""
        import torch
        from ..telemetry.trace import span
        zoo = self._zoo_ref
        t0 = time.monotonic()
        Xs = np.zeros((stack.width, nb, cols), np.float32)
        for lane, Xl, _items in ents:
            Xs[stack.lane(lane)] = pad_rows(Xl, self._stack_buckets)
        new = _note_dispatch((stack.signature, nb))
        try:
            dev = stack.device
            with _on_device(dev), span(f"serve/zoo_stack/b{nb}"):
                out = stack.predict_raw(torch.as_tensor(
                    Xs, device=dev)).cpu().numpy()
        except Exception as exc:
            for _lane, _Xl, items in ents:
                self._fail(items, exc)
            return
        t1 = time.monotonic()
        zoo._stack_batches.inc(1, group=self._group)
        for j, (lane, Xl, items) in enumerate(ents):
            pred = zoo.peek(lane)
            if pred is None:
                # evicted between dispatch start and slicing: the lane's
                # scores exist but the objective transform is gone with
                # the predictor — a typed 503, never a torn result
                self._fail(items, ServerClosed(
                    f"model '{lane}' was evicted while the request was "
                    f"in flight"))
                continue
            n_l = int(Xl.shape[0])
            res = zoo._finish_raw(pred, out[stack.lane(lane)][:n_l], raw)
            ofs = 0
            for it in items:
                k = int(it[_X].shape[0])
                try:
                    it[_FUT].set_result(res[ofs:ofs + k])
                except InvalidStateError:
                    pass  # its waiter expired it in the race window
                ofs += k
            rids = tuple(it[_RID] for it in items if it[_RID])
            # one new program shape per super-batch: attribute it once,
            # not once per lane
            pred.stats.record_batch(n_l, nb, (t1 - t0) * 1e3,
                                    recompiled=new and j == 0,
                                    request_ids=rids if new else ())
            t_done = time.monotonic()
            for it in items:
                pred.stats.record_request_timing(
                    int(it[_X].shape[0]), nb,
                    queue_ms=(t0 - it[_TSUB]) * 1e3,
                    device_ms=(t1 - t0) * 1e3,
                    total_ms=(t_done - it[_TSUB]) * 1e3,
                    request_id=it[_RID])
        self._ewma_batch_s = 0.8 * self._ewma_batch_s + 0.2 * (t1 - t0)

    def _solo_fallback(self, lane: str, raw: bool, items: list) -> None:
        """Lane left the stack between submit and dispatch: serve it
        through its own predictor (same values, one extra launch)."""
        pred = self._zoo_ref.peek(lane)
        if pred is None:
            self._fail(items, ServerClosed(
                f"model '{lane}' was evicted while the request was "
                f"queued"))
            return
        t0 = time.monotonic()
        X = (items[0][_X] if len(items) == 1 else
             np.concatenate([it[_X] for it in items], axis=0))
        try:
            out = pred.predict(X, raw_score=raw, request_ids=tuple(
                it[_RID] for it in items if it[_RID]))
        except Exception as exc:
            self._fail(items, exc)
            return
        t1 = time.monotonic()
        ofs = 0
        for it in items:
            k = int(it[_X].shape[0])
            try:
                it[_FUT].set_result(out[ofs:ofs + k])
            except InvalidStateError:
                pass
            ofs += k
        nb = bucket_rows(X.shape[0], self._stack_buckets)
        t_done = time.monotonic()
        for it in items:
            pred.stats.record_request_timing(
                int(it[_X].shape[0]), nb,
                queue_ms=(t0 - it[_TSUB]) * 1e3,
                device_ms=(t1 - t0) * 1e3,
                total_ms=(t_done - it[_TSUB]) * 1e3,
                request_id=it[_RID])


# ---------------------------------------------------------------------------
# the zoo
# ---------------------------------------------------------------------------

class ModelZoo:
    """Bounded multi-tenant serving tier over a :class:`ModelRegistry`.

    ``source_resolver`` supplies cold-load sources: either a callable
    ``name -> source`` (path/text/Booster) or a directory path holding
    ``<name>.txt`` model files.  ``max_resident=0`` means unbounded.
    ``stacking`` gates the cross-model fused dispatch; with it off the
    zoo still does admission/eviction over per-model batchers.
    ``device`` as in :class:`ModelRegistry`.
    """

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 max_resident: int = 0,
                 source_resolver=None,
                 stacking: bool = True,
                 batching: bool = True,
                 max_batch_rows: int = 4096,
                 max_wait_ms: float = 2.0,
                 max_queue_rows: int = 0,
                 tenant_queue_rows: int = 0,
                 warmup: bool = False,
                 load_kwargs: Optional[dict] = None,
                 device=None) -> None:
        # the zoo serves on its registry's device; a new registry is
        # built on ``device`` (cuda unless the CPU is asked for)
        self.registry = registry if registry is not None \
            else ModelRegistry(device=device)
        if device is not None and \
                resolve_device(device) != self.registry.device:
            raise ValueError(f"zoo device {device} but the registry "
                             f"serves on {self.registry.device}")
        self.max_resident = max(0, int(max_resident))
        self._resolver = self._as_resolver(source_resolver)
        self._stacking = bool(stacking)
        self._batching = bool(batching)
        self._max_batch_rows = int(max_batch_rows)
        self._max_wait_ms = float(max_wait_ms)
        self._max_queue_rows = int(max_queue_rows)
        self._tenant_queue_rows = int(tenant_queue_rows)
        self._warmup = bool(warmup)
        self._load_kwargs = dict(load_kwargs or {})
        self._lock = threading.Lock()
        # traffic-weighted LRU state: name -> [decayed weight, last touch]
        self._traffic: Dict[str, list] = {}
        self.traffic_tau_s = 60.0
        self._load_locks: Dict[str, threading.Lock] = {}
        self._stacks: Dict[tuple, StackedExecutable] = {}
        self._stack_batchers: Dict[tuple, _StackBatcher] = {}
        self._solo_batchers: Dict[str, MicroBatcher] = {}
        self._closed = False
        reg = default_registry()
        (self._evictions, self._cold_loads, self._cold_ms,
         self._stack_batches, self._tenant_shed,
         self._resident_gauge) = _zoo_metrics(reg)
        for name in self.registry.names():
            self._traffic[name] = [0.0, time.monotonic()]
        self._refresh_stacks()
        self._resident_gauge.set(len(self.registry.names()))

    @staticmethod
    def _as_resolver(source_resolver
                     ) -> Optional[Callable[[str], Any]]:
        if source_resolver is None or callable(source_resolver):
            return source_resolver
        base = str(source_resolver)

        def _from_dir(name: str) -> str:
            import os
            path = os.path.join(base, f"{name}.txt")
            if not os.path.exists(path):
                raise KeyError(f"unknown model '{name}' (no {path})")
            return path
        return _from_dir

    # -- admission ----------------------------------------------------------
    def load(self, name: str, source, **predictor_kwargs):
        """Load/hot-swap ``name`` (registry hot-swap discipline), then
        enforce the resident budget and refresh stack membership."""
        kw = {**self._load_kwargs, **predictor_kwargs}
        pred = self.registry.load(name, source, warmup=self._warmup, **kw)
        with self._lock:
            self._traffic.setdefault(name, [0.0, time.monotonic()])
        self._enforce_budget(exclude=name)
        self._refresh_stacks()
        self._resident_gauge.set(len(self.registry.names()))
        return pred

    def evict(self, name: str, reason: str = "manual") -> bool:
        """Evict ``name`` (never silent: counted by reason).  In-flight
        requests that already resolved the predictor complete normally
        — predictors are immutable — later ones get a typed 503."""
        try:
            ok = self.registry.evict(name, force=True)
        except KeyError:
            ok = False
        if not ok:
            return False
        with self._lock:
            self._traffic.pop(name, None)
            batcher = self._solo_batchers.pop(name, None)
        if batcher is not None:
            batcher.close(timeout=2.0)
        self._evictions.inc(1, reason=reason)
        self._refresh_stacks()
        self._resident_gauge.set(len(self.registry.names()))
        return True

    def _decayed_weight(self, name: str, now: float) -> float:
        w, t = self._traffic.get(name, (0.0, now))
        return w * np.exp(-(now - t) / self.traffic_tau_s)

    def _touch(self, name: str, rows: int) -> None:
        now = time.monotonic()
        with self._lock:
            ent = self._traffic.setdefault(name, [0.0, now])
            ent[0] = ent[0] * np.exp(-(now - ent[1]) /
                                     self.traffic_tau_s) + max(1, rows)
            ent[1] = now

    def _enforce_budget(self, exclude: Optional[str] = None) -> None:
        """Traffic-weighted LRU: while over budget, evict the resident
        with the smallest decayed request weight (hot tenants survive a
        recency blip; cold ones are the cheapest to reload later)."""
        if not self.max_resident:
            return
        while True:
            names = self.registry.names()
            if len(names) <= self.max_resident:
                return
            now = time.monotonic()
            with self._lock:
                candidates = [n for n in names if n != exclude]
                if not candidates:
                    return
                victim = min(candidates,
                             key=lambda n: self._decayed_weight(n, now))
            self.evict(victim, reason="capacity")

    # -- resolution (cold load-on-miss) -------------------------------------
    def peek(self, name: str):
        """Resident predictor or None — never loads."""
        try:
            return self.registry.get(name)
        except KeyError:
            return None

    def resolve(self, name: str, deadline: Optional[float] = None):
        """Resident predictor, or a cold load-on-miss that spends the
        request's remaining deadline budget: past the deadline the
        request 504s cleanly (:class:`DeadlineExceeded`) — if the load
        completed, the model STAYS resident, so only the requester that
        paid the compile is late, not the next one."""
        pred = self.peek(name)
        if pred is not None:
            return pred
        if self._resolver is None:
            raise KeyError(f"unknown model '{name}'")
        with self._lock:
            if self._closed:
                raise ServerClosed("zoo is closed")
            lock = self._load_locks.setdefault(name, threading.Lock())
        with lock:  # single-flight: one compile per missed name
            pred = self.peek(name)
            if pred is None:
                if deadline is not None and time.monotonic() >= deadline:
                    raise DeadlineExceeded(
                        f"deadline spent before cold load of '{name}' "
                        f"could start")
                t0 = time.perf_counter()
                source = self._resolver(name)
                pred = self.load(name, source)
                self._cold_loads.inc(1)
                self._cold_ms.observe((time.perf_counter() - t0) * 1e3)
        if deadline is not None and time.monotonic() > deadline:
            raise DeadlineExceeded(
                f"cold load of '{name}' consumed the request deadline")
        return pred

    # -- continuous-learning lane -------------------------------------------
    def apply_delta(self, name: str, record) -> dict:
        """Registry ``apply_delta`` plus stack maintenance: an
        in-envelope extension splices ONLY this tenant's lane of its
        stacked program (same signature — zero recompiles for every
        co-batched neighbour); a rebuild refreshes membership."""
        res = self.registry.apply_delta(name, record)
        pred = self.peek(name)
        spliced = False
        if pred is not None and pred.stackable:
            sig = pred.signature
            with self._lock:
                stack = self._stacks.get(sig)
                if stack is not None and name in stack.names:
                    self._stacks[sig] = stack.splice(name, pred._dense)
                    spliced = True
        if not spliced:
            self._refresh_stacks()
        return res

    # -- stacking -----------------------------------------------------------
    def current_stack(self, sig: tuple) -> Optional[StackedExecutable]:
        with self._lock:
            return self._stacks.get(sig)

    def _refresh_stacks(self) -> None:
        """Recompute stack membership from the resident set: every
        signature with >= 2 stackable tenants gets one stack (lanes in
        sorted-name order so membership is deterministic).  Unchanged
        memberships keep their existing stack (and its compile keys)."""
        groups: Dict[tuple, List[Tuple[str, Any]]] = {}
        if self._stacking:
            for name in self.registry.names():
                pred = self.peek(name)
                if pred is not None and pred.stackable:
                    groups.setdefault(pred.signature, []).append(
                        (name, pred))
        with self._lock:
            fresh: Dict[tuple, StackedExecutable] = {}
            for sig, members in groups.items():
                if len(members) < 2:
                    continue
                members.sort(key=lambda kv: kv[0])
                names = [n for n, _p in members]
                old = self._stacks.get(sig)
                if old is not None and list(old.names) == names:
                    fresh[sig] = old
                else:
                    fresh[sig] = StackedExecutable(
                        names, [p._dense for _n, p in members])
            # a dissolved or re-shaped stack's program is dead (its
            # compile key embeds the member list width): drop its
            # entries from the dispatch mirror or zoo churn ratchets it
            for sig, old in self._stacks.items():
                new = fresh.get(sig)
                if new is None or new.signature != old.signature:
                    release_compile_keys(old.signature)
            self._stacks = fresh
            # batchers for dissolved groups keep draining via the solo
            # fallback until closed with the zoo

    # -- the hot path -------------------------------------------------------
    def _finish_raw(self, pred, raw_out: np.ndarray,
                    raw_score: bool) -> np.ndarray:
        """Solo-path output contract on a stacked lane's raw scores:
        the RF mean divisor, the single-class squeeze, the objective
        transform — all elementwise/per-row, so slicing before or after
        cannot change a row's bits."""
        out = raw_out
        if pred._avg_div != 1:
            out = out / np.float32(pred._avg_div)
        out = out[:, 0] if pred.num_class == 1 else out
        if raw_score or pred.objective is None:
            return out
        return pred.convert_output(out)

    def _batcher_for(self, name: str, pred):
        if not self._batching:
            return None
        if self._stacking and pred.stackable:
            sig = pred.signature
            with self._lock:
                stack = self._stacks.get(sig)
                if stack is not None and name in stack.names:
                    b = self._stack_batchers.get(sig)
                    if b is None:
                        b = self._stack_batchers[sig] = _StackBatcher(
                            self, sig, pred.buckets,
                            max_batch_rows=self._max_batch_rows,
                            max_wait_ms=self._max_wait_ms,
                            max_queue_rows=self._max_queue_rows,
                            tenant_queue_rows=self._tenant_queue_rows)
                    return b
        with self._lock:
            b = self._solo_batchers.get(name)
            if b is None:
                b = self._solo_batchers[name] = MicroBatcher(
                    lambda Xb, raw, request_ids=(), _n=name:
                    self.registry.get(_n).predict(
                        Xb, raw_score=raw, request_ids=request_ids),
                    max_batch_rows=self._max_batch_rows,
                    max_wait_ms=self._max_wait_ms,
                    max_queue_rows=self._max_queue_rows,
                    name=name, stats=pred.stats, buckets=pred.buckets)
            return b

    def predict(self, name: str, X, raw_score: bool = False,
                timeout_s: Optional[float] = None,
                request_id: Optional[str] = None) -> np.ndarray:
        """One tenant request end to end: resolve (cold load within the
        deadline), quota-checked admission, stacked or solo dispatch."""
        deadline = (time.monotonic() + float(timeout_s)
                    if timeout_s is not None else None)
        pred = self.resolve(name, deadline)
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        self._touch(name, X.shape[0])
        pred.stats.record_request(X.shape[0])
        batcher = self._batcher_for(name, pred)
        if batcher is None:
            t0 = time.monotonic()
            out = pred.predict(X, raw_score=raw_score,
                               request_ids=(request_id,)
                               if request_id else ())
            ms = (time.monotonic() - t0) * 1e3
            pred.stats.record_request_timing(
                X.shape[0], bucket_rows(X.shape[0], pred.buckets),
                queue_ms=0.0, device_ms=ms, total_ms=ms,
                request_id=request_id)
            return out
        lane = name if isinstance(batcher, _StackBatcher) else None
        remaining = (None if deadline is None
                     else max(0.0, deadline - time.monotonic()))
        try:
            return batcher.predict(X, raw_score, timeout_s=remaining,
                                   request_id=request_id, lane=lane)
        except TenantQueueFull:
            self._tenant_shed.inc(1, model=name)
            raise

    # -- introspection ------------------------------------------------------
    def stack_membership(self) -> Dict[str, List[str]]:
        """{group_key: [member names]} for every live stack."""
        with self._lock:
            return {_sig_digest(sig): list(stack.names)
                    for sig, stack in self._stacks.items()}

    def info(self) -> Dict[str, dict]:
        """Registry ``info()`` with per-model stack membership merged in
        (the ``GET /models`` payload: operators see which tenants
        co-batch and in which lane)."""
        base = self.registry.info()
        with self._lock:
            stacks = list(self._stacks.values())
        for name, entry in base.items():
            entry["stack"] = None
            for stack in stacks:
                if name in stack.names:
                    entry["stack"] = {
                        "group": _sig_digest(stack.member_sig),
                        "lane": stack.lane(name),
                        "width": stack.width,
                        "members": list(stack.names),
                    }
                    break
        return base

    def zoo_stats(self) -> dict:
        """The ``/stats`` zoo section: admission + stacking posture."""
        names = self.registry.names()
        now = time.monotonic()
        with self._lock:
            weights = {n: round(float(self._decayed_weight(n, now)), 3)
                       for n in names}
        return {
            "resident": len(names),
            "max_resident": self.max_resident,
            "stacking": self._stacking,
            "groups": self.stack_membership(),
            "traffic_weight": weights,
        }

    def close(self, timeout: Optional[float] = 5.0) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            batchers = (list(self._stack_batchers.values()) +
                        list(self._solo_batchers.values()))
            self._stack_batchers.clear()
            self._solo_batchers.clear()
        for b in batchers:
            b.close(timeout=timeout)
