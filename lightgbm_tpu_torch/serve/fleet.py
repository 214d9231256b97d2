"""Supervised multi-worker serving fleet: N ``PredictionServer``
processes behind one dispatcher, kept alive under faults.

Port of ``lightgbm_tpu/serve/fleet.py`` (pure Python over ``http.client``
and ``subprocess``), with the reference's names, defaults, metric names
and HTTP surface, so one dashboard reads both fleets alike.  The
supervisor and the dispatcher never touch the card: this module imports
no kernel module and calls no ``torch.cuda`` function, so the fleet's
own process holds no CUDA context.  Only the workers hold the card, one
context each, and several workers share one card.
``device_type`` / ``device`` pass through to the workers like any other
worker key (they take ``cuda`` by default).  A worker that cannot reach
the card exits at boot (``DeviceUnavailableError``); the supervisor
counts that exit as any other crash (backoff, then the breaker), and
nothing retries a worker on the CPU.

A single serving process (``serve/server.py``) dies with its host: a
crash or deploy drops every in-flight request.  The fleet tier closes
that gap the way the reference survives rank failure at its Network
layer — independent worker processes, a supervisor that restarts them,
and a front door that routes around the dead:

**Supervision.**  Each worker is a ``python -m lightgbm_tpu_torch serve``
subprocess announcing its bound port through an atomic ``port_file``.
The supervisor runs a liveness + ``/healthz`` watchdog per worker
(process exit is caught within a tick; ``hang_probes`` consecutive
probe timeouts declare a WEDGED worker and kill it), restarts failures
with exponential backoff + jitter, and opens a crash-loop circuit
breaker when ``breaker_failures`` failures land inside
``breaker_window_s``: the worker is quarantined (no restart storm),
fleet ``/healthz`` goes degraded, and after ``breaker_halfopen_s`` the
breaker half-opens with ONE probe restart — ``probe_ok_needed`` clean
health probes close it, another death re-quarantines.

**Dispatching.**  ``/predict`` routes by health-weighted smooth round
robin (an ``ok`` worker gets 4x the weight of a ``degraded`` one;
quarantined/backoff/starting workers get none).  A request's
``deadline_ms`` is decremented by the time already burned in the hop
before being forwarded, so the worker-side deadline reflects what the
CLIENT has left.  Connection-reset failures (refused / reset / EOF
before a status line — classes where the request provably never reached
a predictor) are retried against a DIFFERENT worker inside a
``retry_budget``; a 5xx that came back from a worker is forwarded
verbatim, never retried.  With every worker quarantined the dispatcher
fast-fails 503 + ``Retry-After`` pointing at the next breaker probe.

**Lifecycle.**  Fleet SIGTERM runs a rolling drain: each worker in turn
is removed from dispatch, SIGTERMed (the worker stops accepting, drains
its ``MicroBatcher``, finishes in-flight requests, exits
``128+signum``), and only then does the next worker start draining; the
dispatcher exits ``128+signum`` once all workers stopped.  The same
per-worker discipline gives zero-downtime rolling deploys: ``POST
/models`` swaps one worker at a time (the worker loads + warms the new
version BEFORE its atomic registry swap), checks the worker's post-swap
health, and automatically rolls the worker back to its previous source
on a regression — old or new version answers every request throughout.

**Zoo placement.**  ``placement=hash`` stops replicating the model set
and SHARDS it: a consistent-hash ring (vnodes over the static worker-id
set) assigns each model name one owner, workers boot + sync only their
placed subset (zoo mode is switched on for them, so each worker runs
bounded admission and stacks its co-placed same-shape tenants), and the
dispatcher routes ``/predict`` by the request's ``model`` to the owner.
Re-placement is the ring's routability filter: a dead worker's names
fall to the next node at lookup time — no migration step — and the
per-tick placement sync loads them onto the new owner; when the worker
revives, its names come home and the squatter's stale copies decay out
through the zoo's traffic-weighted LRU (the dispatcher no longer routes
to them).  The delta journal follow tracks the OWNER of the published
model, not every worker.

**Continuous learning.**  With ``publish_dir=`` the supervisor follows
a trainer's delta journal (``publish/delta.py``): every published round
is pushed to each worker over ``POST /models/<name>/delta`` (an
incremental tree append on the worker — zero recompiles inside the
dense shard-padding envelope), per-worker acked rounds are tracked
across respawns, and a worker that fell off the chain (respawn, 409
chain mismatch) is re-anchored by a full reload of the journal's
newest BASE and replayed forward.  ``fleet_model_rounds_behind``
gauges the head-to-worker staleness and the ``fleet/model_staleness``
SLO burns while any worker sits more than one round behind.

**Observability.**  Fleet-level ``/metrics`` renders the fleet's own
registry (``fleet_workers_{alive,quarantined}``,
``fleet_restarts_total{reason}``, ``fleet_retries_total``, dispatcher
response counters, SLO burn gauges) and appends every worker's scrape
re-labeled ``worker="wN"`` under ``lgbm_tpu_worker_*`` names; ``/slo``
evaluates the declared objectives against the fleet registry and
attaches each worker's own ``/slo`` verdict.  The chaos harness judges
kill-under-load recovery from these two endpoints alone.
"""

from __future__ import annotations

import base64
import bisect
import hashlib
import http.client
import json
import os
import random
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..telemetry.metrics import MetricsRegistry
from ..telemetry.slo import SloEngine, register_metric_ensurer, slo
from ..utils.log import log_debug, log_info, log_warning

__all__ = ["FleetSupervisor", "WorkerHandle", "main"]

# Fleet-availability-at-the-supervision-layer objective: the alive-worker
# gauge must never sit below 1.  Gauge-floor error is 0/1 per scrape, so
# the budget is wide and the burn thresholds low: a breach means the
# whole fleet was down for essentially every fast-window scrape.
slo("fleet/workers_alive", metric="fleet_workers_alive",
    kind="gauge_floor", floor=1.0, target=0.5,
    burn_fast=1.9, burn_slow=1.5,
    note="at least one worker serving; burns while the fleet is down")

# Retry-budget objective: bounded connection-reset retries are the
# mechanism that hides worker deaths from clients — but a sustained
# retry rate means workers are churning, not blipping.  At most 5% of
# dispatched /predict responses may have needed a cross-worker retry.
slo("fleet/retry_rate", metric="fleet_retries_total",
    total_metric="serve_predict_responses_total", kind="ratio",
    target=0.95, min_events=50,
    note="cross-worker connection-reset retry budget")

# Continuous-learning freshness objective: while a trainer publishes
# per-round deltas into the followed journal, no worker may serve a
# model more than one published round behind the head.  The
# rounds-behind gauge is maintained by the delta sync loop (it keeps
# aging for a crashed worker as the head advances), so a worker that
# keeps missing its pushes — crash-looping, rejecting the chain —
# burns this budget until re-anchor + replay catches it up.
slo("fleet/model_staleness", metric="fleet_model_rounds_behind",
    kind="gauge_ceiling", ceiling=1.0, target=0.5,
    burn_fast=1.9, burn_slow=1.5,
    note="live-refresh freshness: every worker within one published "
         "round of the delta journal head")


@register_metric_ensurer
def _ensure_fleet_metrics(reg: MetricsRegistry) -> None:
    """SLO-coverage ensurer: the fleet metric families exist in a
    registry before any worker does (declared here, next to the
    supervisor that bumps them, so the lint validates the real
    schema)."""
    reg.gauge("fleet_workers_alive", "workers in the alive state",
              labels=())
    reg.gauge("fleet_workers_quarantined",
              "workers held by an open crash-loop breaker", labels=())
    reg.counter("fleet_restarts_total",
                "worker restarts by trigger (exit/hang/probe)",
                labels=("reason",))
    reg.counter("fleet_retries_total",
                "/predict calls retried on another worker after a "
                "connection reset", labels=())
    reg.gauge("fleet_model_round",
              "last published round acked by each worker",
              labels=("model", "worker"))
    reg.gauge("fleet_model_rounds_behind",
              "delta journal head round minus the worker's acked round",
              labels=("model", "worker"))
    reg.counter("fleet_delta_pushes_total",
                "delta records pushed to workers by outcome "
                "(ok/reanchor/rejected/error)", labels=("outcome",))


# connection-level failure classes that are safe to retry on another
# worker: the request provably never produced a response (refused,
# reset, or the socket closed before a status line).  A read timeout is
# NOT here — the request may have executed.
_RETRYABLE = (ConnectionError, http.client.BadStatusLine)

_WEIGHT_OK = 4
_WEIGHT_DEGRADED = 1


def _ring_hash(s: str) -> int:
    return int(hashlib.sha1(s.encode()).hexdigest()[:8], 16)


class _HashRing:
    """Consistent-hash placement over a STATIC worker-id set.

    The ring never changes shape — liveness is a routability filter at
    lookup time: :meth:`owner` walks clockwise from the name's hash to
    the first vnode whose worker is in ``routable``.  A worker death
    therefore re-places only ITS names (each falls to the next distinct
    node on the ring), and its revival takes exactly those names back —
    the minimal-disruption property replication-by-rendezvous would
    also give, bought here with one sorted array and a bisect."""

    def __init__(self, wids: List[int], vnodes: int = 64) -> None:
        self.vnodes = int(vnodes)
        points = [(_ring_hash(f"w{wid}#{v}"), wid)
                  for wid in wids for v in range(self.vnodes)]
        points.sort()
        self._ring = points
        self._keys = [h for h, _ in points]

    def owner(self, name: str, routable) -> Optional[int]:
        """The routable worker id owning ``name``, or None."""
        if not self._ring or not routable:
            return None
        i = bisect.bisect_right(self._keys, _ring_hash(name))
        for k in range(len(self._ring)):
            wid = self._ring[(i + k) % len(self._ring)][1]
            if wid in routable:
                return wid
        return None


class WorkerHandle:
    """Supervision record for one worker process."""

    def __init__(self, wid: int, port_file: str, log_path: str) -> None:
        self.wid = wid
        self.name = f"w{wid}"
        self.port_file = port_file
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self.port: Optional[int] = None
        self.state = "stopped"   # starting|alive|backoff|quarantined|
        #                          draining|stopped
        self.incarnation = 0
        self.spawn_t = 0.0
        self.last_probe_t = 0.0
        self.last_health = "unknown"
        self.consecutive_probe_failures = 0
        self.probe_ok_streak = 0
        self.probing = False            # half-open breaker probe worker
        self.fail_times: Deque[float] = deque()
        self.backoff_s = 0.0
        self.next_restart_t = 0.0
        self.quarantined_at = 0.0
        self.restarts = 0
        self.current_weight = 0.0       # smooth-WRR scheduling state
        self.synced_incarnation = 0     # last incarnation whose model
        #                                 set was caught up to deploys
        self.placed_gen = 0             # last placement epoch this
        #                                 worker's model set was synced
        #                                 against (hash placement only)
        self.acked_round: Optional[int] = None  # delta-chain position
        #                                 this worker has acked
        self.delta_incarnation = 0      # incarnation acked_round is
        #                                 valid for (a respawn boots
        #                                 from the CLI file: unknown)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "state": self.state, "port": self.port,
            "incarnation": self.incarnation, "restarts": self.restarts,
            "last_health": self.last_health,
            "recent_failures": len(self.fail_times),
            "probing": self.probing,
            "acked_round": self.acked_round,
            "pid": self.proc.pid if self.proc is not None else None,
        }


class FleetSupervisor:
    """Spawn, supervise and front N serving workers.

    ``model_files`` are passed to every worker (registered under their
    basenames; a single file honors ``worker_args['name']``).
    ``worker_args`` are extra ``key=value`` pairs for the worker CLI
    (``max_queue_rows``, ``max_wait_ms``, ...).  ``worker_cmd`` swaps
    the whole worker command line (tests drive stub workers through the
    full supervision/dispatch machinery without a torch process);
    ``per_worker_env`` adds env vars to every spawn of one worker id and
    ``first_spawn_env`` only to its FIRST incarnation (chaos arming: the
    replacement worker boots clean).
    """

    def __init__(self, model_files: List[str], workers: int = 2,
                 host: str = "127.0.0.1", port: int = 0,
                 worker_args: Optional[Dict[str, str]] = None,
                 worker_cmd: Optional[Callable[[int, str], List[str]]]
                 = None,
                 worker_env: Optional[Dict[str, str]] = None,
                 per_worker_env: Optional[Dict[int, Dict[str, str]]] = None,
                 first_spawn_env: Optional[Dict[int, Dict[str, str]]]
                 = None,
                 run_dir: Optional[str] = None,
                 probe_interval_s: float = 1.0,
                 probe_timeout_s: float = 2.0,
                 hang_probes: int = 3,
                 breaker_failures: int = 3,
                 breaker_window_s: float = 30.0,
                 breaker_halfopen_s: float = 5.0,
                 probe_ok_needed: int = 2,
                 backoff_base_s: float = 0.2,
                 backoff_max_s: float = 5.0,
                 backoff_jitter: float = 0.25,
                 retry_budget: int = 1,
                 deadline_ms: float = 0.0,
                 forward_timeout_s: float = 30.0,
                 deploy_timeout_s: float = 120.0,
                 startup_timeout_s: float = 120.0,
                 drain_timeout_s: float = 30.0,
                 publish_dir: Optional[str] = None,
                 publish_model: Optional[str] = None,
                 placement: str = "replicate",
                 placement_vnodes: int = 64,
                 metrics_registry: Optional[MetricsRegistry] = None
                 ) -> None:
        if workers < 1:
            raise ValueError(f"a fleet needs >= 1 worker, got {workers}")
        self._model_files = [os.path.abspath(f) for f in model_files]
        self._current_models: Dict[str, str] = {}
        for f in self._model_files:
            name = os.path.splitext(os.path.basename(f))[0]
            if len(self._model_files) == 1 and worker_args and \
                    worker_args.get("name"):
                name = str(worker_args["name"])
            self._current_models[name] = f
        self._host = host
        self._worker_args = dict(worker_args or {})
        self._worker_cmd = worker_cmd
        self._worker_env = dict(worker_env or {})
        self._per_worker_env = {int(k): dict(v) for k, v in
                                (per_worker_env or {}).items()}
        self._first_spawn_env = {int(k): dict(v) for k, v in
                                 (first_spawn_env or {}).items()}
        if run_dir is None:
            import tempfile
            run_dir = tempfile.mkdtemp(prefix="lgbm-tpu-fleet-")
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._probe_interval_s = float(probe_interval_s)
        self._probe_timeout_s = float(probe_timeout_s)
        self._hang_probes = int(hang_probes)
        self._breaker_failures = int(breaker_failures)
        self._breaker_window_s = float(breaker_window_s)
        self._halfopen_s = float(breaker_halfopen_s)
        self._probe_ok_needed = int(probe_ok_needed)
        self._backoff_base_s = float(backoff_base_s)
        self._backoff_max_s = float(backoff_max_s)
        self._backoff_jitter = float(backoff_jitter)
        self._retry_budget = max(0, int(retry_budget))
        self._deadline_ms = float(deadline_ms)
        self._forward_timeout_s = float(forward_timeout_s)
        self._deploy_timeout_s = float(deploy_timeout_s)
        self._startup_timeout_s = float(startup_timeout_s)
        self._drain_timeout_s = float(drain_timeout_s)

        # continuous-learning lane: follow a trainer's delta journal
        # and keep every worker's serving model within a round of it
        self._journal = None
        self._publish_model: Optional[str] = None
        if publish_dir:
            from ..publish.delta import DeltaJournal
            self._journal = DeltaJournal(os.path.abspath(publish_dir))
            self._publish_model = (str(publish_model) if publish_model
                                   else next(iter(self._current_models)))
        self._journal_head_round: Optional[int] = None
        self._journal_poll_t = 0.0

        self._metrics = metrics_registry if metrics_registry is not None \
            else MetricsRegistry()
        self.slo_engine = SloEngine(registry=self._metrics)
        _ensure_fleet_metrics(self._metrics)
        self._alive_g = self._metrics.gauge(
            "fleet_workers_alive", "workers in the alive state", labels=())
        self._quar_g = self._metrics.gauge(
            "fleet_workers_quarantined",
            "workers held by an open crash-loop breaker", labels=())
        self._restarts = self._metrics.counter(
            "fleet_restarts_total",
            "worker restarts by trigger (exit/hang/probe)",
            labels=("reason",))
        self._retries = self._metrics.counter(
            "fleet_retries_total",
            "/predict calls retried on another worker after a "
            "connection reset", labels=())
        self._model_round_g = self._metrics.gauge(
            "fleet_model_round",
            "last published round acked by each worker",
            labels=("model", "worker"))
        self._rounds_behind_g = self._metrics.gauge(
            "fleet_model_rounds_behind",
            "delta journal head round minus the worker's acked round",
            labels=("model", "worker"))
        self._delta_pushes = self._metrics.counter(
            "fleet_delta_pushes_total",
            "delta records pushed to workers by outcome "
            "(ok/reanchor/rejected/error)", labels=("outcome",))
        self._responses = self._metrics.counter(
            "serve_http_responses_total", "HTTP responses by status code",
            labels=("code",))
        self._predict_responses = self._metrics.counter(
            "serve_predict_responses_total",
            "/predict responses by status code (the availability SLO's "
            "series)", labels=("code",))

        self._lock = threading.RLock()
        self._deploy_lock = threading.Lock()
        self._workers = [
            WorkerHandle(i, os.path.join(run_dir, f"worker-{i}.port"),
                         os.path.join(run_dir, f"worker-{i}.log"))
            for i in range(int(workers))]
        # zoo placement: hash mode shards the model set across workers
        # (one owner per name) instead of replicating it on every one
        if placement not in ("replicate", "hash"):
            raise ValueError(f"placement must be 'replicate' or 'hash', "
                             f"got {placement!r}")
        self.placement = placement
        self._ring = _HashRing([w.wid for w in self._workers],
                               vnodes=placement_vnodes) \
            if placement == "hash" else None
        self._placement_gen = 1
        self._alive_ids: Tuple[int, ...] = ()
        if self._ring is not None and not any(
                k in self._worker_args for k in
                ("zoo", "max_resident", "zoo_dir", "tenant_queue_rows")):
            # placed workers run the zoo tier (bounded admission +
            # cross-model stacking over their placed subset) by default
            self._worker_args["zoo"] = "1"
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._sup_thread: Optional[threading.Thread] = None
        self._httpd = ThreadingHTTPServer((host, int(port)),
                                          _make_fleet_handler(self))
        self._httpd.daemon_threads = True
        self._http_thread: Optional[threading.Thread] = None
        self._active_cv = threading.Condition()
        self._active = 0
        self._draining = False
        self._shut_down = False
        self.signal_received: Optional[int] = None
        self._rng = random.Random(0x5EED ^ os.getpid())

    # -- properties ---------------------------------------------------------
    @property
    def port(self) -> int:
        return int(self._httpd.server_address[1])

    @property
    def host(self) -> str:
        h = self._httpd.server_address[0]
        return h.decode() if isinstance(h, (bytes, bytearray)) else str(h)

    @property
    def metrics_registry(self) -> MetricsRegistry:
        return self._metrics

    def workers(self) -> List[WorkerHandle]:
        return list(self._workers)

    # -- spawning -----------------------------------------------------------
    def _placed_models(self, w: WorkerHandle,
                       routable=None) -> Dict[str, str]:
        """The ``_current_models`` subset the ring places on ``w``
        among ``routable`` workers (default: the alive set plus ``w``
        itself, so a booting worker syncs what it is ABOUT to own).
        Replicate mode: everything."""
        if self._ring is None:
            return dict(self._current_models)
        if routable is None:
            with self._lock:
                routable = {x.wid for x in self._workers
                            if x.state == "alive"} | {w.wid}
        return {n: p for n, p in self._current_models.items()
                if self._ring.owner(n, routable) == w.wid}

    def _boot_models(self, w: WorkerHandle) -> Dict[str, str]:
        """The ``_current_models`` entries a worker CLI spawn registers
        under the right logical name: all of them for a single-model
        fleet (the ``name=`` pin), otherwise those whose
        basename-derived name matches.  Renamed deploy sources are
        caught up over ``POST /models`` once the worker is alive
        (``_sync_models``) — the worker still needs >= 1 CLI file to
        boot, so an all-renamed fleet boots its first entry and lets
        the sync re-register it.

        Hash placement boots only the worker's STATIC share (the ring
        over the full id set — liveness at spawn time is stale by the
        time the worker answers): the placement sync settles the live
        assignment.  A worker whose static share is empty still needs a
        boot file unless a ``zoo_dir`` resolver can cold-load on
        demand."""
        if len(self._current_models) == 1:
            return dict(self._current_models)
        pool = self._current_models
        if self._ring is not None:
            all_ids = {x.wid for x in self._workers}
            pool = {n: p for n, p in pool.items()
                    if self._ring.owner(n, all_ids) == w.wid}
        boot = {n: p for n, p in pool.items()
                if os.path.splitext(os.path.basename(p))[0] == n}
        if not boot and not (self._ring is not None and
                             self._worker_args.get("zoo_dir")):
            src = pool if pool else self._current_models
            n = next(iter(src))
            boot = {n: src[n]}
        return boot

    def _build_cmd(self, w: WorkerHandle) -> List[str]:
        if self._worker_cmd is not None:
            return list(self._worker_cmd(w.wid, w.port_file))
        cmd = [sys.executable, "-m", "lightgbm_tpu_torch", "serve"]
        boot = self._boot_models(w)
        cmd += list(boot.values())
        if len(self._current_models) == 1:
            # pin the registry name so a deploy's renamed file still
            # serves under the logical model name after a respawn
            cmd += [f"name={next(iter(self._current_models))}"]
        for k, v in self._worker_args.items():
            if k not in ("name", "port", "port_file", "host"):
                cmd += [f"{k}={v}"]
        cmd += [f"host={self._host}", "port=0",
                f"port_file={w.port_file}"]
        return cmd

    def _spawn(self, w: WorkerHandle, now: float) -> None:
        try:
            os.unlink(w.port_file)
        except OSError:
            pass
        env = dict(os.environ)
        env.update(self._worker_env)
        env.update(self._per_worker_env.get(w.wid, {}))
        if w.incarnation == 0:
            env.update(self._first_spawn_env.get(w.wid, {}))
        cmd = self._build_cmd(w)
        with open(w.log_path, "ab") as fh:
            w.proc = subprocess.Popen(cmd, env=env, stdout=fh,
                                      stderr=subprocess.STDOUT)
        w.incarnation += 1
        w.spawn_t = now
        w.port = None
        w.consecutive_probe_failures = 0
        w.probe_ok_streak = 0
        with self._lock:
            w.state = "starting"
        log_debug(f"fleet: spawned {w.name} incarnation {w.incarnation} "
                  f"(pid {w.proc.pid})")

    def _read_port_file(self, w: WorkerHandle) -> Optional[int]:
        try:
            with open(w.port_file) as fh:
                return int(fh.read().strip())
        except (OSError, ValueError):
            return None

    # -- supervision --------------------------------------------------------
    def _record_failure(self, w: WorkerHandle, reason: str,
                        now: float) -> None:
        """One restart-worthy failure: open the breaker past K recent
        failures, else schedule a backed-off restart."""
        w.port = None
        w.fail_times.append(now)
        while w.fail_times and \
                w.fail_times[0] < now - self._breaker_window_s:
            w.fail_times.popleft()
        if w.probing or len(w.fail_times) >= self._breaker_failures:
            with self._lock:
                w.state = "quarantined"
            w.quarantined_at = now
            w.probing = False
            log_warning(
                f"fleet: breaker OPEN for {w.name}: "
                f"{len(w.fail_times)} failures in "
                f"{self._breaker_window_s:.0f}s (last: {reason}); "
                f"half-open probe in {self._halfopen_s:.1f}s")
            return
        w.backoff_s = min(self._backoff_max_s,
                          (w.backoff_s * 2.0) if w.backoff_s
                          else self._backoff_base_s)
        delay = w.backoff_s * (1.0 + self._backoff_jitter *
                               self._rng.random())
        w.next_restart_t = now + delay
        with self._lock:
            w.state = "backoff"
        w.restarts += 1
        self._restarts.inc(1, reason=reason)
        log_warning(f"fleet: {w.name} failed ({reason}); restart "
                    f"{w.restarts} in {delay:.2f}s")

    def _kill_worker(self, w: WorkerHandle) -> None:
        if w.proc is not None and w.proc.poll() is None:
            try:
                w.proc.kill()
                w.proc.wait(5.0)
            except (OSError, subprocess.TimeoutExpired):
                pass

    def _sync_models(self, w: WorkerHandle) -> bool:
        """Catch a freshly-alive worker up to the deployed model set:
        every ``_current_models`` entry its CLI spawn could not register
        under the right logical name (renamed deploy sources in a
        multi-model fleet) is loaded over ``POST /models``.  Returns
        True when the worker serves every logical name (retried next
        tick otherwise).

        Hash placement syncs the worker's PLACED subset instead of the
        whole set — including names just re-placed onto it by another
        worker's death.  Names that moved away are not evicted here:
        the dispatcher already routes them elsewhere, so the stale
        copies cool off and fall to the worker zoo's traffic-weighted
        LRU."""
        if self._ring is not None:
            placed = self._placed_models(w)
            try:
                have = self._worker_get_json(w, "/models",
                                             self._probe_timeout_s)
            except Exception:
                return False
            pending = {n: p for n, p in placed.items()
                       if (have.get(n) or {}).get("source") != p}
            ok = True
            for name, path in pending.items():
                try:
                    status, detail = self._worker_post_json(
                        w, "/models", {"name": name, "file": path},
                        self._deploy_timeout_s)
                except Exception as exc:
                    log_warning(f"fleet: {w.name} placement sync "
                                f"'{name}' failed: "
                                f"{type(exc).__name__}: {exc}")
                    ok = False
                    continue
                if status != 200:
                    log_warning(f"fleet: {w.name} rejected placed model "
                                f"'{name}' ({status}): "
                                f"{detail.get('error', detail)}")
                    ok = False
                else:
                    log_info(f"fleet: placed '{name}' on {w.name} "
                             f"({os.path.basename(path)})")
            return ok
        if len(self._current_models) == 1:
            return True   # the spawn's name= pin registers it correctly
        # pending = every entry the CLI spawn registers under the WRONG
        # name (file basename != logical name) — including the fallback
        # boot entry of an all-renamed fleet, which boots under its
        # basename and is re-registered here
        pending = {n: p for n, p in self._current_models.items()
                   if os.path.splitext(os.path.basename(p))[0] != n}
        if not pending:
            return True
        try:
            have = self._worker_get_json(w, "/models",
                                         self._probe_timeout_s)
        except Exception:
            return False
        ok = True
        for name, path in pending.items():
            if (have.get(name) or {}).get("source") == path:
                continue
            try:
                status, detail = self._worker_post_json(
                    w, "/models", {"name": name, "file": path},
                    self._deploy_timeout_s)
            except Exception as exc:
                log_warning(f"fleet: {w.name} model sync '{name}' "
                            f"failed: {type(exc).__name__}: {exc}")
                ok = False
                continue
            if status != 200:
                log_warning(f"fleet: {w.name} rejected synced model "
                            f"'{name}' ({status}): "
                            f"{detail.get('error', detail)}")
                ok = False
            else:
                log_info(f"fleet: {w.name} caught up to deployed "
                         f"'{name}' ({os.path.basename(path)})")
        return ok

    # -- continuous-learning lane (publish/) --------------------------------
    def _journal_target(self, now: float) -> Optional[int]:
        """Throttled journal head poll: the newest published round, or
        None while no journal is followed / the journal is empty.  One
        small read per probe interval, not per worker per tick."""
        if self._journal is None:
            return None
        if self._journal_head_round is not None and \
                now - self._journal_poll_t < self._probe_interval_s:
            return self._journal_head_round
        self._journal_poll_t = now
        try:
            h = self._journal.head()
        except Exception as exc:
            log_warning(f"fleet: delta journal head unreadable: "
                        f"{type(exc).__name__}: {exc}")
            return self._journal_head_round
        if h is not None:
            self._journal_head_round = int(h.round)
        return self._journal_head_round

    def _note_rounds(self, w: WorkerHandle, target: int) -> None:
        """Refresh the per-worker freshness gauges.  Called for DEAD
        workers too: a crashed worker's acked round freezes while the
        head advances, so its rounds-behind gauge keeps aging and the
        staleness SLO burns until re-anchor + replay catches it up."""
        if w.acked_round is None or self._publish_model is None:
            return
        self._model_round_g.set(float(w.acked_round),
                                model=self._publish_model, worker=w.name)
        self._rounds_behind_g.set(float(max(0, target - w.acked_round)),
                                  model=self._publish_model,
                                  worker=w.name)

    def _owns_published(self, w: WorkerHandle) -> bool:
        """Hash placement: only the published model's current OWNER is
        followed by the delta lane — pushing rounds to workers the
        dispatcher never routes the model to would just burn deploy
        bandwidth.  A non-owner's freshness series is dropped (not
        frozen): a dead ex-owner must not burn the staleness SLO while
        the live owner is current."""
        if self._ring is None or self._publish_model is None:
            return True
        with self._lock:
            alive = {x.wid for x in self._workers if x.state == "alive"}
        if self._ring.owner(self._publish_model, alive or {w.wid}) \
                == w.wid:
            return True
        self._model_round_g.remove_series(worker=w.name)
        self._rounds_behind_g.remove_series(worker=w.name)
        return False

    def _anchor_base(self, w: WorkerHandle) -> bool:
        """Re-anchor one worker on the journal's newest BASE by a full
        ``POST /models`` reload (which clears the worker registry's
        chain position), so the next delta replays cleanly from the
        base round."""
        try:
            entry = self._journal.base_entry()
        except Exception:
            return False
        if entry is None:
            return False
        path, base_round = entry
        name = self._publish_model
        try:
            status, detail = self._worker_post_json(
                w, "/models", {"name": name, "file": path},
                self._deploy_timeout_s)
        except Exception as exc:
            log_warning(f"fleet: {w.name} delta re-anchor failed: "
                        f"{type(exc).__name__}: {exc}")
            return False
        if status != 200:
            log_warning(f"fleet: {w.name} rejected re-anchor base for "
                        f"'{name}' ({status}): "
                        f"{detail.get('error', detail)}")
            return False
        w.acked_round = base_round
        w.delta_incarnation = w.incarnation
        log_info(f"fleet: {w.name} re-anchored '{name}' at round "
                 f"{base_round} ({os.path.basename(path)})")
        return True

    def _sync_deltas(self, w: WorkerHandle, now: float) -> None:
        """Push published delta records to one alive worker until it
        serves the journal head round.  A worker with an unknown chain
        position (fresh incarnation) or one that 409s a push (chain
        mismatch after a deploy or a divergent base) is re-anchored by
        a full reload of the newest BASE and replayed forward — the
        fallback the DeltaChainError contract promises."""
        target = self._journal_target(now)
        if target is None or self._publish_model is None:
            return
        if not self._owns_published(w):
            return
        if w.delta_incarnation != w.incarnation or w.acked_round is None:
            # a respawn boots from its CLI model file: position unknown
            if not self._anchor_base(w):
                return
        if w.acked_round >= target:
            self._note_rounds(w, target)
            return
        try:
            records = self._journal.records_after(w.acked_round)
        except Exception as exc:
            log_warning(f"fleet: delta journal chain unreadable: "
                        f"{type(exc).__name__}: {exc}")
            return
        name = self._publish_model
        for rec in records:
            if rec.round <= w.acked_round:
                continue
            try:
                status, detail = self._worker_post_json(
                    w, f"/models/{name}/delta",
                    {"record_b64": base64.b64encode(
                        rec.to_bytes()).decode("ascii")},
                    self._deploy_timeout_s)
            except Exception as exc:
                self._delta_pushes.inc(1, outcome="error")
                log_warning(f"fleet: {w.name} delta push (round "
                            f"{rec.round}) failed: "
                            f"{type(exc).__name__}: {exc}")
                return
            if status == 409:
                # the worker's chain diverged: full reload + replay
                # resumes next tick from the fresh anchor
                self._delta_pushes.inc(1, outcome="reanchor")
                w.acked_round = None
                self._anchor_base(w)
                return
            if status != 200:
                self._delta_pushes.inc(1, outcome="rejected")
                log_warning(f"fleet: {w.name} rejected delta round "
                            f"{rec.round} ({status}): "
                            f"{detail.get('error', detail)}")
                return
            self._delta_pushes.inc(1, outcome="ok")
            w.acked_round = int(rec.round)
            log_debug(f"fleet: {w.name} applied delta round "
                      f"{rec.round} ({detail.get('mode', '?')})")
        self._note_rounds(w, max(target, w.acked_round))

    def _probe_health(self, w: WorkerHandle,
                      timeout: Optional[float] = None) -> Optional[str]:
        """One /healthz probe; the status string, or None when the
        worker is unreachable/hung past the probe timeout."""
        if w.port is None:
            return None
        try:
            payload = self._worker_get_json(
                w, "/healthz", timeout or self._probe_timeout_s)
            return str(payload.get("status", "ok"))
        except Exception:
            return None

    def _tick(self) -> None:
        now = time.monotonic()
        if self._ring is not None:
            # placement epoch: any alive-set change re-places names, so
            # every worker's placed subset is re-synced against the new
            # assignment (death -> the fallen names load onto the next
            # ring node; revival -> the names come home)
            cur = tuple(sorted(w.wid for w in self._workers
                               if w.state == "alive"))
            if cur != self._alive_ids:
                self._alive_ids = cur
                self._placement_gen += 1
                log_info(f"fleet: placement epoch {self._placement_gen} "
                         f"over alive workers "
                         f"{[f'w{i}' for i in cur] or 'none'}")
        for w in self._workers:
            state = w.state
            if state in ("stopped", "draining"):
                continue
            if state in ("starting", "alive") and w.proc is not None and \
                    w.proc.poll() is not None:
                rc = w.proc.poll()
                log_warning(f"fleet: {w.name} exited with code {rc}")
                self._record_failure(w, "exit", now)
                continue
            if state == "starting":
                if w.port is None:
                    w.port = self._read_port_file(w)
                boot_health = (self._probe_health(w)
                               if w.port is not None else None)
                if boot_health is not None:
                    with self._lock:
                        w.state = "alive"
                    w.last_probe_t = now
                    # keep the REAL boot status: a worker that comes up
                    # degraded (shedding load, an SLO burning) must weigh
                    # 1x in dispatch from its first request, not 4x
                    # until the next probe
                    w.last_health = boot_health
                    if self._sync_models(w):
                        w.synced_incarnation = w.incarnation
                        w.placed_gen = self._placement_gen
                    self._sync_deltas(w, now)
                    log_info(f"fleet: {w.name} alive on port {w.port}"
                             + (" (breaker half-open probe)"
                                if w.probing else ""))
                elif now - w.spawn_t > self._startup_timeout_s:
                    log_warning(f"fleet: {w.name} never became healthy "
                                f"within {self._startup_timeout_s:.0f}s")
                    self._kill_worker(w)
                    self._record_failure(w, "hang", now)
                continue
            if state == "backoff":
                if now >= w.next_restart_t:
                    self._spawn(w, now)
                continue
            if state == "quarantined":
                if now - w.quarantined_at >= self._halfopen_s:
                    log_info(f"fleet: breaker half-open for {w.name}; "
                             f"spawning one probe worker")
                    w.probing = True
                    w.restarts += 1
                    self._restarts.inc(1, reason="probe")
                    self._spawn(w, now)
                continue
            if state == "alive" and \
                    now - w.last_probe_t >= self._probe_interval_s:
                w.last_probe_t = now
                status = self._probe_health(w)
                if status is None:
                    w.consecutive_probe_failures += 1
                    if w.consecutive_probe_failures >= self._hang_probes:
                        log_warning(
                            f"fleet: {w.name} failed "
                            f"{w.consecutive_probe_failures} health "
                            f"probes; killing the wedged worker")
                        self._kill_worker(w)
                        self._record_failure(w, "hang", now)
                    continue
                w.consecutive_probe_failures = 0
                w.last_health = status
                # age failures out of the breaker window during stable
                # operation too, and give a clean sheet its base
                # backoff again — an isolated crash a day should not
                # pay the escalated delay of last week's blip
                while w.fail_times and \
                        w.fail_times[0] < now - self._breaker_window_s:
                    w.fail_times.popleft()
                if not w.fail_times and not w.probing:
                    w.backoff_s = 0.0
                if (w.synced_incarnation != w.incarnation or
                        (self._ring is not None and
                         w.placed_gen != self._placement_gen)) and \
                        self._sync_models(w):
                    w.synced_incarnation = w.incarnation
                    w.placed_gen = self._placement_gen
                self._sync_deltas(w, now)
                if w.probing:
                    w.probe_ok_streak += 1
                    if w.probe_ok_streak >= self._probe_ok_needed:
                        w.probing = False
                        w.fail_times.clear()
                        w.backoff_s = 0.0
                        log_info(f"fleet: breaker CLOSED for {w.name} "
                                 f"({w.probe_ok_streak} clean probes)")
        alive = sum(1 for w in self._workers if w.state == "alive")
        quarantined = sum(1 for w in self._workers
                          if w.state == "quarantined")
        self._alive_g.set(float(alive))
        self._quar_g.set(float(quarantined))
        if self._journal is not None:
            # age every worker's freshness gauge against the head —
            # including dead/restarting workers, whose frozen acked
            # round falls behind as the trainer keeps publishing
            target = self._journal_target(now)
            if target is not None:
                for w in self._workers:
                    if self._owns_published(w):
                        self._note_rounds(w, target)

    def _run_supervision(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(min(0.25, self._probe_interval_s))
            self._wake.clear()
            if self._stop.is_set():
                return
            try:
                self._tick()
            except Exception as exc:   # supervision must never die
                log_warning(f"fleet: supervision tick failed: "
                            f"{type(exc).__name__}: {exc}")

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FleetSupervisor":
        now = time.monotonic()
        for w in self._workers:
            self._spawn(w, now)
        deadline = now + self._startup_timeout_s
        while time.monotonic() < deadline:
            self._tick()
            if all(w.state == "alive" for w in self._workers):
                break
            time.sleep(0.05)
        if not all(w.state == "alive" for w in self._workers):
            bad = [w.name for w in self._workers if w.state != "alive"]
            for w in self._workers:
                self._kill_worker(w)
            self._httpd.server_close()
            raise RuntimeError(
                f"fleet startup failed: worker(s) {bad} never became "
                f"healthy within {self._startup_timeout_s:.0f}s (logs in "
                f"{self.run_dir})")
        self._sup_thread = threading.Thread(
            target=self._run_supervision, daemon=True,
            name="lgb-tpu-fleet-supervisor")
        self._sup_thread.start()
        self._http_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="lgb-tpu-fleet-dispatch")
        self._http_thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> rolling drain and exit ``128+signum`` (a
        repeat signal aborts immediately).  Main-thread only."""
        def _on_signal(signum: int, frame) -> None:
            if self.signal_received is not None:
                os._exit(128 + int(signum))
            self.signal_received = int(signum)
            log_warning(f"fleet: received signal {signum}; rolling "
                        f"drain (repeat to abort)")
            threading.Thread(target=self._httpd.shutdown,
                             daemon=True).start()
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)

    def shutdown(self) -> None:
        """Rolling drain: workers leave dispatch one at a time, each
        SIGTERMed and given ``drain_timeout_s`` to finish its in-flight
        requests (the worker-side drain discipline) before the next one
        starts; the dispatcher then stops."""
        if self._shut_down:
            return
        self._shut_down = True
        self._stop.set()
        self._wake.set()
        if self._sup_thread is not None:
            self._sup_thread.join(5.0)
        for w in self._workers:
            with self._lock:
                w.state = "draining"
            proc = w.proc
            if proc is not None and proc.poll() is None:
                try:
                    proc.terminate()
                    proc.wait(self._drain_timeout_s)
                except subprocess.TimeoutExpired:
                    log_warning(f"fleet: {w.name} ignored SIGTERM for "
                                f"{self._drain_timeout_s:.0f}s; killing")
                    self._kill_worker(w)
                except OSError:
                    pass
            with self._lock:
                w.state = "stopped"
        with self._active_cv:
            self._draining = True
        if self._http_thread is not None:
            self._httpd.shutdown()
        deadline = time.monotonic() + 5.0
        with self._active_cv:
            while self._active > 0 and time.monotonic() < deadline:
                self._active_cv.wait(0.2)
        self._httpd.server_close()
        if self._http_thread is not None:
            self._http_thread.join(5.0)

    # -- dispatch -----------------------------------------------------------
    def note_dispatch_failure(self, w: WorkerHandle) -> None:
        """A forward hit a connection failure: wake supervision so the
        dead process is noticed this tick, not next poll."""
        self._wake.set()

    def pick_worker(self, exclude: Tuple[int, ...] = ()
                    ) -> Optional[WorkerHandle]:
        """Health-weighted smooth round-robin over routable workers
        (the nginx algorithm: add each candidate's effective weight,
        pick the largest accumulated weight, subtract the total)."""
        with self._lock:
            cands: List[Tuple[WorkerHandle, float]] = []
            for w in self._workers:
                if w.state != "alive" or w.port is None or \
                        w.wid in exclude:
                    continue
                weight = _WEIGHT_DEGRADED if w.last_health == "degraded" \
                    else _WEIGHT_OK
                cands.append((w, float(weight)))
            if not cands:
                return None
            total = sum(wt for _, wt in cands)
            best: Optional[WorkerHandle] = None
            for w, wt in cands:
                w.current_weight += wt
                if best is None or w.current_weight > best.current_weight:
                    best = w
            assert best is not None
            best.current_weight -= total
            return best

    def _pick_placed(self, name: Optional[str],
                     exclude: Tuple[int, ...] = ()
                     ) -> Optional[WorkerHandle]:
        """Hash placement's router: the ring owner of ``name`` among
        routable workers.  ``exclude`` (connection-reset retries) walks
        to the NEXT ring node — the same fallback order re-placement
        uses, so the retry lands where the model will live next."""
        if name is None:
            name = next(iter(self._current_models), None)
            if name is None:
                return None
        with self._lock:
            routable = {w.wid for w in self._workers
                        if w.state == "alive" and w.port is not None and
                        w.wid not in exclude}
            wid = self._ring.owner(name, routable)
            if wid is None:
                return None
            return next(w for w in self._workers if w.wid == wid)

    def _retry_after_s(self) -> float:
        """Backoff hint while nothing is routable: time to the next
        restart attempt or breaker half-open probe."""
        now = time.monotonic()
        horizons = []
        for w in self._workers:
            if w.state == "backoff":
                horizons.append(max(0.0, w.next_restart_t - now))
            elif w.state == "quarantined":
                horizons.append(max(0.0, w.quarantined_at +
                                    self._halfopen_s - now))
            elif w.state == "starting":
                horizons.append(self._probe_interval_s)
        return max(1.0, min(horizons)) if horizons else 1.0

    def dispatch_predict(self, body: bytes, rid: str
                         ) -> Tuple[int, bytes, Dict[str, str]]:
        """Route one /predict body; returns (status, body, headers).
        Connection-reset failures retry against a different worker
        within the retry budget; worker responses (including 5xx) are
        forwarded verbatim."""
        t0 = time.monotonic()
        base_deadline = 0.0
        req: Optional[Dict[str, Any]] = None
        if self._ring is not None or self._deadline_ms > 0 or \
                b"deadline_ms" in body:
            # hash placement must parse the body regardless of deadline
            # config: routing is BY the request's model name
            try:
                req = json.loads(body)
                base_deadline = float(req.get("deadline_ms") or
                                      self._deadline_ms)
            except (ValueError, TypeError, AttributeError):
                req = None   # malformed body: forward raw, worker 400s
        route_model: Optional[str] = None
        if self._ring is not None and req is not None and \
                req.get("model"):
            route_model = str(req["model"])
        tried: List[int] = []
        attempts = 0
        last_err = "no routable worker"
        while attempts <= self._retry_budget:
            w = self._pick_placed(route_model, exclude=tuple(tried)) \
                if self._ring is not None \
                else self.pick_worker(exclude=tuple(tried))
            if w is None:
                if not tried:
                    # nothing routable at all (every worker quarantined
                    # or restarting): fast-fail with a backoff hint
                    retry_after = self._retry_after_s()
                    payload = json.dumps({
                        "error": "no serving worker available "
                                 "(fleet degraded)",
                        "retry_after_s": retry_after}).encode()
                    return 503, payload, {
                        "Retry-After": str(max(1, int(-(-retry_after
                                                        // 1))))}
                break   # reset with no alternate worker left
            port = w.port
            if port is None:
                # the worker died between pick_worker and the connect
                # (supervision nulls the port without the dispatch
                # lock): not a dispatched attempt — skip it, burn
                # neither retry budget nor the retry counter
                tried.append(w.wid)
                continue
            if attempts:
                # a cross-worker retry is actually dispatching now that
                # an alternate routable worker exists
                self._retries.inc(1)
                log_debug(f"fleet: retrying /predict on {w.name} after "
                          f"{last_err}")
            payload_bytes = body
            if req is not None and base_deadline > 0:
                remaining = base_deadline - (time.monotonic() - t0) * 1e3
                if remaining <= 1.0:
                    return 504, json.dumps({
                        "error": "deadline exhausted in the dispatch "
                                 "hop"}).encode(), {}
                req["deadline_ms"] = remaining
                payload_bytes = json.dumps(req).encode()
            conn = None
            try:
                conn = http.client.HTTPConnection(
                    self._host, port, timeout=self._forward_timeout_s)
                conn.request("POST", "/predict", payload_bytes, {
                    "Content-Type": "application/json",
                    "Content-Length": str(len(payload_bytes)),
                    "X-Request-Id": rid})
                resp = conn.getresponse()
                data = resp.read()
                headers = {}
                for key in ("Retry-After", "X-Request-Id"):
                    v = resp.getheader(key)
                    if v:
                        headers[key] = v
                return resp.status, data, headers
            except TimeoutError as exc:
                # connect/read timeout: the request MAY have executed on
                # the worker (a wedged device call, serve_hang_ms chaos)
                # — never retried, surfaced as a gateway timeout rather
                # than a dispatcher bug
                self.note_dispatch_failure(w)
                return 504, json.dumps({
                    "error": f"worker {w.name} timed out after "
                             f"{self._forward_timeout_s:.0f}s in the "
                             f"forward hop: {type(exc).__name__}"
                }).encode(), {}
            except _RETRYABLE as exc:
                tried.append(w.wid)
                attempts += 1
                last_err = f"{type(exc).__name__}: {exc}"
                self.note_dispatch_failure(w)
            finally:
                if conn is not None:
                    try:
                        conn.close()
                    except Exception:
                        pass
        payload = json.dumps({
            "error": f"worker connection failed and the retry budget "
                     f"({self._retry_budget}) is spent: {last_err}"
        }).encode()
        return 502, payload, {}

    # -- worker HTTP helpers ------------------------------------------------
    def _worker_get_text(self, w: WorkerHandle, path: str,
                         timeout: float) -> str:
        if w.port is None:
            raise ConnectionError(f"{w.name} has no port")
        conn = http.client.HTTPConnection(self._host, w.port,
                                          timeout=timeout)
        try:
            conn.request("GET", path)
            resp = conn.getresponse()
            data = resp.read().decode()
            if resp.status != 200:
                raise RuntimeError(f"{w.name}{path} -> {resp.status}")
            return data
        finally:
            conn.close()

    def _worker_get_json(self, w: WorkerHandle, path: str,
                         timeout: float) -> Dict[str, Any]:
        out = json.loads(self._worker_get_text(w, path, timeout))
        return out if isinstance(out, dict) else {"payload": out}

    def _worker_post_json(self, w: WorkerHandle, path: str,
                          payload: Dict[str, Any], timeout: float
                          ) -> Tuple[int, Dict[str, Any]]:
        if w.port is None:
            raise ConnectionError(f"{w.name} has no port")
        body = json.dumps(payload).encode()
        conn = http.client.HTTPConnection(self._host, w.port,
                                          timeout=timeout)
        try:
            conn.request("POST", path, body,
                         {"Content-Type": "application/json",
                          "Content-Length": str(len(body))})
            resp = conn.getresponse()
            data = resp.read()
            try:
                parsed = json.loads(data)
            except ValueError:
                parsed = {"raw": data.decode(errors="replace")}
            return resp.status, parsed
        finally:
            conn.close()

    # -- rolling deploy -----------------------------------------------------
    def deploy(self, name: str, path: str) -> Dict[str, Any]:
        """Zero-downtime rolling model deploy: one worker at a time
        loads + warms the new version (the worker's registry swap is
        atomic, so it serves old-version traffic until the instant the
        warm predictor is ready), then its post-swap health is checked —
        a regression rolls THAT worker back to its previous source and
        aborts the roll.  Workers not currently alive are skipped; they
        boot the new version on their next respawn once the roll
        completes."""
        path = os.path.abspath(path)
        report: Dict[str, Any] = {"model": name, "file": path,
                                  "deployed": [], "skipped": [],
                                  "rolled_back": []}
        with self._deploy_lock:
            if self._ring is not None:
                with self._lock:
                    alive = {w.wid for w in self._workers
                             if w.state == "alive" and
                             w.port is not None}
                owner = self._ring.owner(name, alive)
            for w in list(self._workers):
                if w.state != "alive" or w.port is None or \
                        (self._ring is not None and w.wid != owner):
                    # hash placement deploys to the name's OWNER only;
                    # everyone else picks the version up on re-placement
                    report["skipped"].append(w.name)
                    continue
                before = self._probe_health(w) or "unreachable"
                prev: Optional[str] = None
                try:
                    models = self._worker_get_json(
                        w, "/models", self._probe_timeout_s)
                    prev = (models.get(name) or {}).get("source")
                except Exception:
                    prev = None
                try:
                    status, detail = self._worker_post_json(
                        w, "/models", {"name": name, "file": path},
                        self._deploy_timeout_s)
                except Exception as exc:
                    report["verdict"] = "aborted"
                    report["error"] = (f"{w.name} unreachable during "
                                       f"swap: {type(exc).__name__}: "
                                       f"{exc}")
                    return report
                if status != 200:
                    # the worker's load failed BEFORE any swap (corrupt
                    # file, bad params): its old version is untouched —
                    # abort the roll, nothing to roll back
                    report["verdict"] = "aborted"
                    report["error"] = (f"{w.name} rejected the new "
                                       f"version ({status}): "
                                       f"{detail.get('error', detail)}")
                    return report
                after = self._probe_health(w)
                if after is None or (after == "degraded" and
                                     before == "ok"):
                    log_warning(f"fleet: {w.name} health regressed "
                                f"after swapping '{name}' "
                                f"({before} -> {after}); rolling back")
                    if prev:
                        try:
                            self._worker_post_json(
                                w, "/models", {"name": name,
                                               "file": prev},
                                self._deploy_timeout_s)
                            report["rolled_back"].append(w.name)
                        except Exception as exc:
                            report["rollback_error"] = \
                                f"{type(exc).__name__}: {exc}"
                    report["verdict"] = "rolled_back"
                    report["error"] = (f"{w.name} post-swap health "
                                       f"regressed ({before} -> "
                                       f"{after})")
                    return report
                report["deployed"].append(w.name)
                log_info(f"fleet: {w.name} now serves '{name}' from "
                         f"{os.path.basename(path)}")
            # future respawns boot the rolled-out version (new logical
            # names included — a respawned worker must serve every
            # model the fleet's clients can name)
            self._current_models[name] = path
            report["verdict"] = "deployed"
            return report

    # -- aggregated observability ------------------------------------------
    def health(self) -> Dict[str, Any]:
        """Fleet ``/healthz``: ``ok`` only while every worker is alive
        and individually healthy; otherwise ``degraded`` with reasons
        (still 200 — the tier answers as long as one worker does)."""
        self.slo_engine.evaluate()
        reasons: List[str] = []
        table: Dict[str, Any] = {}
        alive = 0
        for w in self._workers:
            table[w.name] = w.snapshot()
            if w.state == "alive":
                alive += 1
                if w.last_health == "degraded":
                    reasons.append(f"{w.name} reports degraded health")
            elif w.state == "quarantined":
                reasons.append(f"{w.name} quarantined (crash-loop "
                               f"breaker open)")
            elif w.state in ("starting", "backoff"):
                reasons.append(f"{w.name} restarting ({w.state})")
        for name in self.slo_engine.degraded():
            reasons.append(f"slo_fast_burn: {name}")
        out: Dict[str, Any] = {
            "status": "degraded" if reasons else "ok",
            "fleet": True,
            "workers_alive": alive,
            "workers_total": len(self._workers),
            "workers": table,
        }
        if reasons:
            out["reasons"] = reasons
        return out

    def slo_report(self) -> Dict[str, Any]:
        """Fleet ``/slo``: the declared objectives evaluated against
        the FLEET registry (dispatcher responses, worker gauges, retry
        counters), with each worker's own ``/slo`` verdict attached —
        one scrape answers both "is the tier meeting its SLOs" and
        "which worker is burning"."""
        fleet_rep = self.slo_engine.evaluate()
        workers: Dict[str, Any] = {}
        for w in self._workers:
            if w.state != "alive" or w.port is None:
                workers[w.name] = {"unreachable": True, "state": w.state}
                continue
            try:
                workers[w.name] = self._worker_get_json(
                    w, "/slo", self._probe_timeout_s)
            except Exception:
                workers[w.name] = {"unreachable": True,
                                   "state": w.state}
        return {"schema": "fleet-slo-report-v1",
                "ok": bool(fleet_rep.get("ok")),
                "fleet": fleet_rep,
                "workers": workers}

    def metrics_text(self) -> str:
        """Fleet ``/metrics``: the fleet registry (supervision gauges,
        restart/retry counters, dispatcher response codes, SLO burn
        gauges) plus every reachable worker's scrape re-exported as
        ``lgbm_tpu_worker_*`` with a ``worker`` label — one scrape
        carries the whole tier."""
        from .loadgen import parse_prometheus
        from ..telemetry.export import _labels, _num, render_prometheus
        self.slo_engine.evaluate()   # burn gauges refresh pre-render
        lines = [render_prometheus(registry=self._metrics).rstrip("\n")]
        for w in list(self._workers):
            if w.state != "alive" or w.port is None:
                continue
            try:
                text = self._worker_get_text(w, "/metrics", 2.0)
            except Exception:
                continue
            for name, series in sorted(parse_prometheus(text).items()):
                wname = name.replace("lgbm_tpu_", "lgbm_tpu_worker_", 1)
                for lbl, val in series:
                    lbl2 = dict(lbl)
                    lbl2["worker"] = w.name
                    lines.append(f"{wname}{_labels(lbl2)} {_num(val)}")
        return "\n".join(lines) + "\n"

    def proxy_get(self, path: str) -> Dict[str, Any]:
        """Per-worker fan-out of a worker JSON endpoint (``/models``,
        ``/stats``)."""
        out: Dict[str, Any] = {}
        for w in list(self._workers):
            if w.state != "alive" or w.port is None:
                out[w.name] = {"unreachable": True, "state": w.state}
                continue
            try:
                out[w.name] = self._worker_get_json(
                    w, path, self._probe_timeout_s)
            except Exception as exc:
                out[w.name] = {"unreachable": True,
                               "error": f"{type(exc).__name__}"}
        return out

    def placement_table(self) -> Optional[Dict[str, Any]]:
        """The live worker -> placed-models map (hash placement only,
        None otherwise): every ``_current_models`` name resolved
        through the ring against the routable set — the assignment the
        dispatcher is using RIGHT NOW, dead workers already routed
        around."""
        if self._ring is None:
            return None
        with self._lock:
            routable = {w.wid for w in self._workers
                        if w.state == "alive" and w.port is not None}
        table: Dict[str, List[str]] = {w.name: [] for w in self._workers}
        unplaced: List[str] = []
        for n in sorted(self._current_models):
            wid = self._ring.owner(n, routable)
            if wid is None:
                unplaced.append(n)
            else:
                table[f"w{wid}"].append(n)
        out: Dict[str, Any] = {"mode": "hash",
                               "vnodes": self._ring.vnodes,
                               "epoch": self._placement_gen,
                               "workers": table}
        if unplaced:
            out["unplaced"] = unplaced
        return out

    def workers_table(self) -> Dict[str, Any]:
        out = {"workers": {w.name: w.snapshot()
                           for w in self._workers},
               "breaker": {"failures": self._breaker_failures,
                           "window_s": self._breaker_window_s,
                           "halfopen_s": self._halfopen_s}}
        pl = self.placement_table()
        if pl is not None:
            out["placement"] = pl
        return out

    # -- dispatcher handler accounting --------------------------------------
    def _enter(self) -> bool:
        with self._active_cv:
            if self._draining:
                return False
            self._active += 1
            return True

    def _exit(self) -> None:
        with self._active_cv:
            self._active -= 1
            if self._active <= 0:
                self._active_cv.notify_all()


def _make_fleet_handler(fleet: FleetSupervisor):
    class FleetHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            log_debug("fleet: " + fmt % args)

        def _reply(self, code: int, payload: Dict[str, Any],
                   extra_headers: Optional[Dict[str, str]] = None
                   ) -> None:
            body = json.dumps(payload).encode()
            self._reply_raw(code, body, extra_headers)

        def _reply_raw(self, code: int, body: bytes,
                       extra_headers: Optional[Dict[str, str]] = None,
                       content_type: str = "application/json") -> None:
            fleet._responses.inc(1, code=str(int(code)))
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            try:
                self.wfile.write(body)
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass   # the client went away mid-write

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, fleet.health())
            elif self.path == "/slo":
                self._reply(200, fleet.slo_report())
            elif self.path == "/workers":
                self._reply(200, fleet.workers_table())
            elif self.path == "/metrics":
                from ..telemetry.export import PROMETHEUS_CONTENT_TYPE
                self._reply_raw(200, fleet.metrics_text().encode(),
                                content_type=PROMETHEUS_CONTENT_TYPE)
            elif self.path in ("/models", "/stats"):
                out = fleet.proxy_get(self.path)
                if self.path == "/models":
                    pl = fleet.placement_table()
                    if pl is not None:
                        # the worker -> placed-models aggregation rides
                        # the same payload under a non-worker key
                        out["_placement"] = pl
                self._reply(200, out)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path == "/predict":
                self._post_predict()
            elif self.path == "/models":
                self._post_models()
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _post_predict(self) -> None:
            rid = self.headers.get("X-Request-Id") or \
                f"fleet-{os.getpid():x}-{threading.get_ident():x}-" \
                f"{time.monotonic_ns():x}"
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length > 0 else b""

            def reply(code: int, payload: bytes,
                      headers: Dict[str, str]) -> None:
                fleet._predict_responses.inc(1, code=str(int(code)))
                headers = dict(headers)
                headers.setdefault("X-Request-Id", rid)
                self._reply_raw(code, payload, headers)

            if not fleet._enter():
                reply(503, json.dumps(
                    {"error": "fleet is draining"}).encode(),
                    {"Retry-After": "1"})
                return
            try:
                status, data, headers = fleet.dispatch_predict(body, rid)
            except Exception as exc:   # dispatcher bug, not worker's
                reply(500, json.dumps(
                    {"error": f"{type(exc).__name__}: {exc}"}).encode(),
                    {})
                return
            finally:
                fleet._exit()
            reply(status, data, headers)

        def _post_models(self) -> None:
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length)) if length \
                    else {}
            except (ValueError, UnicodeDecodeError) as exc:
                self._reply(400, {"error": f"bad JSON body: {exc}"})
                return
            name, path = req.get("name"), req.get("file")
            if not name or not path:
                self._reply(400, {"error": "body needs 'name' and "
                                           "'file'"})
                return
            report = fleet.deploy(str(name), str(path))
            code = 200 if report.get("verdict") == "deployed" else 409
            self._reply(code, report)

    return FleetHandler


# keys the fleet CLI consumes itself; everything else passes through to
# the worker command lines
_FLEET_KEYS = {
    "workers", "host", "port", "retry_budget", "deadline_ms",
    "probe_interval_s", "probe_timeout_s", "hang_probes",
    "breaker_failures", "breaker_window_s", "breaker_halfopen_s",
    "backoff_base_s", "backoff_max_s", "drain_timeout_s",
    "startup_timeout_s", "run_dir", "publish_dir", "publish_model",
    "placement", "vnodes",
}


def main(argv: List[str]) -> int:
    """``python -m lightgbm_tpu_torch serve-fleet model.txt [workers=4]
    [port=8080] [key=value ...]``.

    Fleet keys: workers (2), host, port (8080), retry_budget (1),
    deadline_ms (0), probe_interval_s (1.0), probe_timeout_s (2.0),
    hang_probes (3), breaker_failures (3), breaker_window_s (30),
    breaker_halfopen_s (5), backoff_base_s (0.2), backoff_max_s (5),
    drain_timeout_s (30), startup_timeout_s (120), run_dir,
    publish_dir (follow a trainer's delta journal and live-refresh
    every worker), publish_model (logical name the deltas apply to;
    defaults to the first model), placement (replicate | hash — hash
    shards the model set across workers by consistent hash: the
    dispatcher routes /predict by the request's model to its owner,
    workers boot/sync only their placed subset in zoo mode, a dead
    worker's names fall to the next ring node), vnodes (64).  Every
    other ``key=value`` passes through to the worker serve processes
    (``max_queue_rows``, ``max_wait_ms``, ``device_type`` / ``device``
    (``cuda`` by default: one CUDA context a worker), ``deadline_ms``
    stays fleet-side, ...).  SIGTERM runs a rolling drain and exits
    ``128+signum``.
    """
    from ..utils.log import log_fatal
    files = [a for a in argv if "=" not in a]
    kv = {k: v for k, v in (a.split("=", 1) for a in argv if "=" in a)}
    if not files:
        log_fatal("serve-fleet needs at least one model file: "
                  "python -m lightgbm_tpu_torch serve-fleet model.txt "
                  "[workers=4 port=8080 ...]")
    worker_args = {k: v for k, v in kv.items() if k not in _FLEET_KEYS}
    fleet = FleetSupervisor(
        files,
        workers=int(kv.get("workers", 2)),
        host=kv.get("host", "127.0.0.1"),
        port=int(kv.get("port", 8080)),
        worker_args=worker_args,
        run_dir=kv.get("run_dir"),
        probe_interval_s=float(kv.get("probe_interval_s", 1.0)),
        probe_timeout_s=float(kv.get("probe_timeout_s", 2.0)),
        hang_probes=int(kv.get("hang_probes", 3)),
        breaker_failures=int(kv.get("breaker_failures", 3)),
        breaker_window_s=float(kv.get("breaker_window_s", 30.0)),
        breaker_halfopen_s=float(kv.get("breaker_halfopen_s", 5.0)),
        backoff_base_s=float(kv.get("backoff_base_s", 0.2)),
        backoff_max_s=float(kv.get("backoff_max_s", 5.0)),
        retry_budget=int(kv.get("retry_budget", 1)),
        deadline_ms=float(kv.get("deadline_ms", 0.0)),
        drain_timeout_s=float(kv.get("drain_timeout_s", 30.0)),
        startup_timeout_s=float(kv.get("startup_timeout_s", 120.0)),
        publish_dir=kv.get("publish_dir"),
        publish_model=kv.get("publish_model"),
        placement=kv.get("placement", "replicate"),
        placement_vnodes=int(kv.get("vnodes", 64)))
    fleet.start()
    try:
        fleet.install_signal_handlers()
    except ValueError:
        pass   # not the main thread
    log_info(f"fleet: dispatching on http://{fleet.host}:{fleet.port} "
             f"({len(fleet.workers())} workers, run dir "
             f"{fleet.run_dir})")
    try:
        # the dispatcher already serves on its own thread; the main
        # thread just waits for a signal-driven drain
        while fleet.signal_received is None:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    sig = fleet.signal_received
    fleet.shutdown()
    log_info("fleet: drained")
    return 0 if sig is None else 128 + int(sig)
