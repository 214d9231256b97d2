"""Dependency-free JSON inference endpoint over ``http.server``.

Port of ``lightgbm_tpu/serve/server.py``.  The server runs on one device:
``cuda`` unless the caller asks for the CPU (``device="cpu"``, or
``device_type=cpu`` on the command line); without a card it raises
``DeviceUnavailableError``.  The reference reports ``degraded`` while it
serves on its CPU fallback; the port has no fallback, so ``/healthz``
names the device it serves on instead.  A program that fails on the card
fails its request with a 500: nothing reroutes to the plain path.

Endpoints:
  GET  /healthz  -> {"status": "ok"|"degraded", "models": [...],
                    "device": ..., "device_name": ...} — degraded (with
                    "reasons") while admission control shed requests in
                    the last minute, or while an SLO's fast burn window
                    has run hot for several consecutive evaluations;
                    still 200
  GET  /models   -> per-model info (trees, classes, buckets, version)
  GET  /stats    -> per-model counters (requests/rows/batches/recompiles/
                    bucket histogram/p50/p99 latency + queue-wait vs
                    device-compute split) plus live batcher saturation
                    (queue rows, in-flight requests)
  GET  /metrics  -> Prometheus text format: the process-wide telemetry
                    registry (serving counters, time tags, SLO burn-rate
                    gauges) plus the last training run's TrainRecord
  GET  /slo      -> declared-SLO verdicts: multi-window burn rates per
                    objective, breach flags, and — whenever something is
                    burning — the slowest-request exemplar ring
  POST /predict  -> {"rows": [[...], ...]} or {"row": [...]}, optional
                    "model" (required only with >1 loaded), "raw_score";
                    returns {"model", "num_rows", "predictions",
                    "request_id"}.  An ``X-Request-Id`` header is
                    propagated through the micro-batcher into the
                    predictor (and echoed back); absent one, the server
                    assigns one
  POST /explain  -> the /predict body; returns per-row SHAP contributions
                    through the dense TreeSHAP program on the serving
                    device.  A model that program does not lower (past
                    its depth or table budget, or
                    ``tpu_explain_compiler=walk``) is explained by the
                    float64 host walk, as ``Booster.predict(
                    pred_contrib=True)`` does; a dense result that fails
                    its additivity check answers 500
  POST /models   -> {"name": ..., "file": ...} loads or atomically
                    hot-swaps a model from a model_text file
  POST /models/<name>/delta
                 -> {"record_b64": ...} appends a published training
                    delta (publish/delta.py wire record, base64) to the
                    serving model without a full reload; 409 on a chain
                    mismatch tells the caller to full-reload + replay

Each HTTP request runs on its own thread (ThreadingHTTPServer); /predict
routes through a per-model :class:`MicroBatcher`, so concurrent small
requests coalesce into one bucketed device call.  Started by the CLI
verb ``python -m lightgbm_tpu_torch serve model.txt [key=value ...]``.

Lifecycle: the CLI installs SIGTERM/SIGINT handlers that run the same
drain discipline training's ``PreemptionGuard`` gives checkpoints —
stop accepting, fail queued batcher futures with :class:`ServerClosed`,
let in-flight requests finish writing their responses, exit
``128+signum`` (a repeat signal aborts immediately).  The signal
handler only sets flags and stops the accept loop from a helper thread;
the drain and the CUDA teardown run on the main thread.  ``port_file=``
announces the bound port to a supervisor via an atomic write, so
``port=0`` workers are discoverable without stdout parsing.  The chaos layer's serve-side fault points
(``serve_crash_after_n`` / ``serve_hang_ms`` / ``serve_drop_conn``,
``resilience/faults.py``) hook the top of every handler.
"""

from __future__ import annotations

import itertools
import json
import os
import signal
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np

from .batcher import MicroBatcher
from .registry import ModelRegistry
from .stats import request_exemplars
from ..resilience.admission import (DeadlineExceeded, QueueFullError,
                                    ServerClosed)
from ..resilience.faults import faults
from ..telemetry.metrics import default_registry
from ..telemetry.slo import (SloEngine, default_engine,
                             register_metric_ensurer, slo)
from ..utils.device import resolve_device
from ..utils.log import log_debug, log_info, log_warning

__all__ = ["PredictionServer", "main"]

# /healthz reports "degraded" while sheds happened inside this window —
# the tier is up but actively refusing some traffic
SHED_DEGRADED_WINDOW_S = 60.0

# Availability objective, declared next to the handler that serves the
# responses it counts: at most 0.1% of /predict responses may be 5xx
# (sheds, deadline expiries and server errors all land there).  Keyed
# to the PREDICT-only counter, not the all-endpoints one — a tier
# scraped every second by probes/Prometheus would otherwise pad the
# denominator with its own monitoring 200s and hide a total /predict
# outage inside the diluted ratio.
slo("serve/availability", metric="serve_predict_responses_total",
    kind="ratio", target=0.999,
    total_metric="serve_predict_responses_total",
    bad_labels={"code": "5*"}, min_events=50,
    note="non-5xx response ratio over /predict traffic")

# monotonically unique server-assigned request ids (requests that arrive
# without an X-Request-Id header still get a trace handle)
_REQ_SEQ = itertools.count(1)
_REQ_PREFIX = f"srv-{os.getpid():x}"


def _gen_request_id() -> str:
    return f"{_REQ_PREFIX}-{next(_REQ_SEQ):x}"


def _http_response_counter():
    return default_registry().counter(
        "serve_http_responses_total", "HTTP responses by status code",
        labels=("code",))


def _predict_response_counter():
    return default_registry().counter(
        "serve_predict_responses_total",
        "/predict responses by status code (the availability SLO's "
        "series — monitoring-endpoint traffic excluded)",
        labels=("code",))


def _explain_response_counter():
    # the explain lane's own series: /explain errors must not dilute
    # (or hide inside) the /predict availability SLO's denominator
    return default_registry().counter(
        "serve_explain_responses_total",
        "/explain responses by status code", labels=("code",))


@register_metric_ensurer
def _ensure_http_metrics(reg) -> None:
    """SLO-coverage ensurer for the counters the availability SLO above
    reads — declared here, next to the handler that bumps them, so the
    lint validates the REAL schema and not a copy that could drift."""
    reg.counter("serve_http_responses_total",
                "HTTP responses by status code", labels=("code",))
    reg.counter("serve_predict_responses_total",
                "/predict responses by status code (the availability "
                "SLO's series — monitoring-endpoint traffic excluded)",
                labels=("code",))
    reg.counter("serve_explain_responses_total",
                "/explain responses by status code", labels=("code",))


class PredictionServer:
    """Registry + HTTP front end + per-model micro-batchers.

    Admission control: ``max_queue_rows`` bounds each model's batcher
    backlog (an over-limit submit is shed with 503 + ``Retry-After``);
    ``deadline_ms`` (server default, per-request override in the JSON
    body) fails slow requests with 504 instead of hanging the handler
    thread.  Both ride the micro-batcher queue and are inert with
    ``batching=False`` (the direct-dispatch debug path has no queue to
    bound or expire).  ``/healthz`` reports ``degraded`` while sheds
    happened recently, or an SLO fast-burn has been sustained
    (``slo_engine.sustain`` consecutive hot evaluations).

    ``device`` is the registry's unless given (``registry=None`` builds
    one on ``device``); a device the registry does not serve on raises
    ``ValueError``, and ``cuda`` without a card raises
    ``DeviceUnavailableError``."""

    def __init__(self, registry: Optional[ModelRegistry] = None,
                 host: str = "127.0.0.1",
                 port: int = 8080, max_batch_rows: int = 4096,
                 max_wait_ms: float = 2.0, batching: bool = True,
                 max_queue_rows: int = 0,
                 deadline_ms: float = 0.0,
                 slo_engine: Optional[SloEngine] = None,
                 zoo=None, device=None) -> None:
        # zoo mode (serve/zoo.py): admission/eviction + cross-model
        # stacked dispatch replace the per-model batcher path; the zoo's
        # registry IS the server's registry
        self._zoo = zoo
        if zoo is not None:
            registry = zoo.registry
        if registry is None:
            registry = ModelRegistry(device=device)
        self.device = registry.device if device is None \
            else resolve_device(device)
        if self.device != registry.device:
            raise ValueError(f"server device {self.device} but the "
                             f"registry serves on {registry.device}")
        self.registry = registry
        self._batching = batching
        self._batch_opts = (max_batch_rows, max_wait_ms)
        self._max_queue_rows = int(max_queue_rows)
        self._deadline_ms = float(deadline_ms)  # 0 = no default deadline
        self._batchers: Dict[str, MicroBatcher] = {}
        # /explain coalesces in its OWN batchers: phi batches are
        # (rows, K*(F+1)) wide, so mixing them into the /predict queue
        # would let a handful of explain rows starve the predict
        # latency budget they share a window with
        self._explain_batchers: Dict[str, MicroBatcher] = {}
        self._batchers_lock = threading.Lock()
        self._last_shed_t = 0.0
        self.slo_engine = slo_engine if slo_engine is not None \
            else default_engine()
        self._responses = _http_response_counter()
        self._predict_responses = _predict_response_counter()
        self._explain_responses = _explain_response_counter()
        # drain bookkeeping: in-flight /predict handlers are counted so
        # a graceful shutdown can wait for their responses to be written
        self._active_cv = threading.Condition()
        self._active_predicts = 0
        self._draining = False
        self.signal_received: Optional[int] = None
        handler = _make_handler(self)
        # http.server's default listen backlog is 5: a fan-out wave (N
        # clients scoring N zoo tenants in the same instant) overflows
        # it, and the dropped SYNs come back ~1s later via retransmit —
        # a latency cliff no queue metric ever sees.  Size the backlog
        # for burst arrival instead.
        server_cls = type("_ZooHTTPServer", (ThreadingHTTPServer,),
                          {"request_queue_size": 128})
        self._httpd = server_cls((host, port), handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def host(self) -> str:
        # server_address is typed (str | bytes, int); ours is always str
        host = self._httpd.server_address[0]
        return host.decode() if isinstance(host, (bytes, bytearray)) \
            else str(host)

    def _predict(self, name: Optional[str], X: np.ndarray,
                 raw_score: bool,
                 deadline_ms: Optional[float] = None,
                 request_id: Optional[str] = None) -> np.ndarray:
        if deadline_ms is None:
            deadline_ms = self._deadline_ms
        timeout_s = float(deadline_ms) / 1e3 if deadline_ms and \
            deadline_ms > 0 else None
        if self._zoo is not None:
            # zoo path: per-tenant admission, cold load-on-miss inside
            # the deadline, stacked or solo dispatch (serve/zoo.py).  A
            # nameless request still resolves the single resident model.
            resolved = name if name is not None \
                else self.registry.get(None).stats.model
            return self._zoo.predict(resolved, X, raw_score=raw_score,
                                     timeout_s=timeout_s,
                                     request_id=request_id)
        pred = self.registry.get(name)  # resolves None -> the single model
        pred.stats.record_request(X.shape[0])
        if not self._batching:
            # direct-dispatch path: no queue, so the split is all device
            t0 = time.monotonic()
            out = pred.predict(X, raw_score=raw_score,
                               request_ids=(request_id,) if request_id
                               else ())
            dt_ms = (time.monotonic() - t0) * 1e3
            from ..models.tree import bucket_rows
            pred.stats.record_request_timing(
                int(X.shape[0]), bucket_rows(int(X.shape[0]), pred.buckets),
                queue_ms=0.0, device_ms=dt_ms, total_ms=dt_ms,
                request_id=request_id)
            return out
        # key by the RESOLVED model name: a nameless request to a
        # single-model server and an explicit-name request must share
        # one batcher (two batchers under one name would clobber each
        # other's saturation gauges and split the coalescing window)
        key = pred.stats.model
        with self._batchers_lock:
            batcher = self._batchers.get(key)
            if batcher is None:
                # the closure re-resolves the registry per batch (by the
                # RESOLVED name, so loading a second model later never
                # breaks this batcher's dispatch) and a hot-swap
                # redirects batched traffic without a restart
                batcher = MicroBatcher(
                    lambda Xb, raw, request_ids=(), _n=key:
                        self.registry.get(_n).predict(
                            Xb, raw_score=raw, request_ids=request_ids),
                    max_batch_rows=self._batch_opts[0],
                    max_wait_ms=self._batch_opts[1],
                    max_queue_rows=self._max_queue_rows,
                    name=key, stats=pred.stats, buckets=pred.buckets)
                self._batchers[key] = batcher
        return batcher.predict(X, raw_score=raw_score, timeout_s=timeout_s,
                               request_id=request_id)

    def _explain(self, name: Optional[str], X: np.ndarray,
                 deadline_ms: Optional[float] = None,
                 request_id: Optional[str] = None) -> np.ndarray:
        """Dispatch one /explain request: per-row SHAP contributions in
        the host ``pred_contrib`` layout.  Same admission machinery as
        :meth:`_predict` but through the explain lane's own batchers and
        latency series — the two lanes share a process, not a queue.

        Zoo mode dispatches directly against the resident predictor:
        stacked cross-model launches only fuse same-shape PREDICTION
        programs, and a non-resident tenant gets 404 rather than a cold
        load (an explain burst must never evict serving models)."""
        if deadline_ms is None:
            deadline_ms = self._deadline_ms
        timeout_s = float(deadline_ms) / 1e3 if deadline_ms and \
            deadline_ms > 0 else None
        resolved_name = name
        if self._zoo is not None and name is None:
            resolved_name = self.registry.get(None).stats.model
        pred = self.registry.get(resolved_name)
        if not self._batching or self._zoo is not None:
            t0 = time.monotonic()
            out = pred.explain(X, request_ids=(request_id,) if request_id
                               else ())
            dt_ms = (time.monotonic() - t0) * 1e3
            from ..models.tree import bucket_rows
            pred.stats.record_explain_timing(
                int(X.shape[0]), bucket_rows(int(X.shape[0]), pred.buckets),
                queue_ms=0.0, device_ms=dt_ms, total_ms=dt_ms,
                request_id=request_id)
            return out
        key = pred.stats.model
        with self._batchers_lock:
            batcher = self._explain_batchers.get(key)
            if batcher is None:
                batcher = MicroBatcher(
                    lambda Xb, raw, request_ids=(), _n=key:
                        self.registry.get(_n).explain(
                            Xb, request_ids=request_ids),
                    max_batch_rows=self._batch_opts[0],
                    max_wait_ms=self._batch_opts[1],
                    max_queue_rows=self._max_queue_rows,
                    name=f"{key}:explain",
                    stats=pred.stats.explain_timing_stats(),
                    buckets=pred.buckets)
                self._explain_batchers[key] = batcher
        return batcher.predict(X, raw_score=False, timeout_s=timeout_s,
                               request_id=request_id)

    def device_name(self) -> str:
        """The card's name (``torch.cuda.get_device_name``), or ``cpu``."""
        if self.device.type == "cuda":
            import torch
            return torch.cuda.get_device_name(self.device)
        return "cpu"

    def health(self) -> dict:
        """``/healthz`` payload: ``ok``, or ``degraded`` with reasons
        while admission control shed requests in the last minute, or an
        SLO's fast burn window has run hot for ``slo_engine.sustain``
        consecutive evaluations — still 200 (the tier answers), but a
        reason for an operator to look.  It names the device served on
        (the reference's CPU-fallback reason has no counterpart: the
        port never falls back)."""
        reasons = []
        if self._last_shed_t and \
                time.monotonic() - self._last_shed_t < SHED_DEGRADED_WINDOW_S:
            reasons.append("shedding: request queue hit its limit in the "
                           f"last {int(SHED_DEGRADED_WINDOW_S)}s")
        report = self.slo_engine.evaluate()
        for name in report["degraded"]:
            v = next((s for s in report["slos"] if s["name"] == name), None)
            burn = v["burn"]["fast"] if v else 0.0
            reasons.append(f"slo_fast_burn: {name} has burned at "
                           f"{burn:.1f}x budget for "
                           f"{self.slo_engine.sustain}+ evaluations")
        out = {"status": "degraded" if reasons else "ok",
               "models": self.registry.names(),
               "device": str(self.device),
               "device_name": self.device_name()}
        if reasons:
            out["reasons"] = reasons
        return out

    def slo_report(self) -> dict:
        """``/slo`` payload: verdicts per declared objective; breaches
        and fast burns carry the slowest-request exemplar ring so a tail
        regression arrives with the offending requests attached."""
        report = self.slo_engine.evaluate()
        if report["breached"] or report["fast_burning"]:
            report["exemplars"] = request_exemplars().snapshot()
        return report

    def models_info(self) -> dict:
        """``/models`` payload: registry info, with per-model stack
        membership merged in when the zoo is on.  Stays a name->dict
        mapping either way — the fleet supervisor's model sync reads it
        as one."""
        return self._zoo.info() if self._zoo is not None \
            else self.registry.info()

    def stats_payload(self) -> dict:
        """``/stats`` payload: per-model counters plus live batcher
        saturation — a load test can watch the backlog build, not just
        requests die.  Zoo mode adds a ``_zoo`` section (resident count,
        stack groups, traffic weights); existing consumers key by model
        name, so the extra entry is inert to them."""
        out = self.registry.stats()
        with self._batchers_lock:
            batchers = list(self._batchers.values()) \
                + list(self._explain_batchers.values())
        for b in batchers:
            entry = out.setdefault(b.name, {})
            entry["saturation"] = {
                "queue_rows": int(b.backlog_rows),
                "inflight_requests": b.inflight_requests(),
                "max_queue_rows": self._max_queue_rows,
            }
        if self._zoo is not None:
            out["_zoo"] = self._zoo.zoo_stats()
        return out

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "PredictionServer":
        """Serve on a background thread (tests / embedding)."""
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="lgb-tpu-serve")
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self._httpd.serve_forever()

    def _enter_predict(self) -> bool:
        """Admit one /predict handler; False while draining (the caller
        replies 503 instead of racing the batcher teardown)."""
        with self._active_cv:
            if self._draining:
                return False
            self._active_predicts += 1
            return True

    def _exit_predict(self) -> None:
        with self._active_cv:
            self._active_predicts -= 1
            if self._active_predicts <= 0:
                self._active_cv.notify_all()

    def drain(self, timeout: float = 30.0) -> None:
        """Graceful shutdown in the strict order a rolling restart
        needs: (1) stop accepting — new /predict requests get an
        immediate 503 and the accept loop stops; (2) drain the
        micro-batchers — queued futures fail with
        :class:`ServerClosed`, the in-flight device batch completes and
        settles its futures; (3) wait for in-flight handler threads to
        write their responses; (4) close the sockets.  Every admitted
        request therefore gets exactly one terminal response — a result
        or a typed 5xx — never a hang."""
        with self._active_cv:
            self._draining = True
        self._httpd.shutdown()   # no-op if serve_forever already returned
        with self._batchers_lock:
            batchers = list(self._batchers.values()) \
                + list(self._explain_batchers.values())
            self._batchers, self._explain_batchers = {}, {}
        for b in batchers:
            b.close()
        if self._zoo is not None:
            self._zoo.close()
        deadline = time.monotonic() + max(0.0, timeout)
        with self._active_cv:
            while self._active_predicts > 0:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    log_warning(f"serve: drain timed out with "
                                f"{self._active_predicts} request(s) "
                                f"still in flight")
                    break
                self._active_cv.wait(remaining)
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(5.0)

    def shutdown(self) -> None:
        self.drain(timeout=5.0)

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> drain-and-exit, the serving twin of
        training's ``PreemptionGuard``: the handler only flags the
        signal and stops the accept loop (from a helper thread —
        ``shutdown()`` called inside the handler would deadlock the
        main-thread ``serve_forever``); ``main`` then drains and exits
        ``128+signum``.  A repeat signal aborts immediately instead of
        waiting out the drain.  Main-thread only (``signal.signal``'s
        constraint); embedded servers use :meth:`drain` directly."""
        def _on_signal(signum: int, frame) -> None:
            if self.signal_received is not None:
                os._exit(128 + int(signum))
            self.signal_received = int(signum)
            log_warning(f"serve: received signal {signum}; draining "
                        f"in-flight requests (repeat to abort)")
            threading.Thread(target=self._httpd.shutdown,
                             daemon=True).start()
        signal.signal(signal.SIGTERM, _on_signal)
        signal.signal(signal.SIGINT, _on_signal)


def _error_code(exc: BaseException) -> int:
    """400 for a request the model cannot take (a wrong row width, a
    ragged row list, a corrupt model or delta), 500 for anything else: a
    program that failed on the device (lowering, extending or running)
    fails its request, it is not rerouted."""
    return 400 if isinstance(exc, (ValueError, TypeError)) else 500


def _make_handler(server: PredictionServer):
    class ServeHandler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route access logs to debug
            log_debug("serve: " + fmt % args)

        def _reply(self, code: int, payload: dict,
                   extra_headers: Optional[Dict[str, str]] = None) -> None:
            body = json.dumps(payload).encode()
            server._responses.inc(1, code=str(int(code)))
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in (extra_headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _read_json(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                return {}
            return json.loads(self.rfile.read(length).decode())

        def _chaos(self) -> bool:
            """Armed serve-side fault points fire here (top of every
            handler).  True = the connection was severed; stop."""
            if faults.check_serve_request(self.path) == "drop":
                try:
                    self.connection.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
                self.close_connection = True
                return True
            return False

        def do_GET(self):
            if self._chaos():
                return
            if self.path == "/healthz":
                self._reply(200, server.health())
            elif self.path == "/models":
                self._reply(200, server.models_info())
            elif self.path == "/stats":
                self._reply(200, server.stats_payload())
            elif self.path == "/slo":
                self._reply(200, server.slo_report())
            elif self.path == "/metrics":
                # Prometheus text: serving counters (registry-managed
                # models label themselves into the default metrics
                # registry) + the last training run's TrainRecord
                from ..telemetry.export import (PROMETHEUS_CONTENT_TYPE,
                                                render_prometheus)
                body = render_prometheus().encode()
                server._responses.inc(1, code="200")
                self.send_response(200)
                self.send_header("Content-Type", PROMETHEUS_CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self._chaos():
                return
            try:
                req = self._read_json()
            except (ValueError, UnicodeDecodeError) as exc:
                self._reply(400, {"error": f"bad JSON body: {exc}"})
                return
            if self.path == "/predict":
                self._predict(req)
            elif self.path == "/explain":
                self._explain(req)
            elif self.path == "/models":
                self._load_model(req)
            elif self.path.startswith("/models/") and \
                    self.path.endswith("/delta"):
                self._apply_delta(req, self.path[len("/models/"):
                                                 -len("/delta")])
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def _predict(self, req: dict) -> None:
            # per-request trace handle: propagate the caller's id (or
            # assign one) server -> batcher -> predictor, echo it back
            rid = self.headers.get("X-Request-Id") or _gen_request_id()
            rid_hdr = {"X-Request-Id": rid}

            def reply(code: int, payload: dict,
                      headers: Optional[Dict[str, str]] = None) -> None:
                # the availability SLO's series: /predict responses
                # only, so monitoring scrapes never pad the denominator
                server._predict_responses.inc(1, code=str(int(code)))
                self._reply(code, payload, headers or rid_hdr)

            # drain gate + in-flight accounting: an admitted request is
            # guaranteed a written response before sockets close
            if not server._enter_predict():
                reply(503, {"error": "server is draining"},
                      {"Retry-After": "1", **rid_hdr})
                return
            try:
                self._predict_admitted(req, reply, rid)
            finally:
                server._exit_predict()

        def _predict_admitted(self, req: dict, reply, rid: str) -> None:
            rid_hdr = {"X-Request-Id": rid}
            name = req.get("model")
            rows = req.get("rows")
            if rows is None and "row" in req:
                rows = [req["row"]]
            if not isinstance(rows, list) or not rows:
                reply(400, {"error": "body needs 'rows' (list of "
                                     "feature lists) or 'row'"})
                return
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None:
                if isinstance(deadline_ms, bool) or \
                        not isinstance(deadline_ms, (int, float)):
                    reply(400, {"error": "deadline_ms must be a "
                                         "number of milliseconds"})
                    return
                deadline_ms = float(deadline_ms)
            try:
                X = np.asarray(rows, np.float32)
                if X.ndim != 2:
                    raise ValueError(f"rows must be 2-D, got shape {X.shape}")
                out = server._predict(name, X, bool(req.get("raw_score")),
                                      deadline_ms=deadline_ms,
                                      request_id=rid)
            except KeyError as exc:
                reply(404, {"error": str(exc.args[0])})
                return
            except QueueFullError as exc:
                # load shed: admission control refused the request; tell
                # the client when the backlog should have drained
                server._last_shed_t = time.monotonic()
                reply(503, {"error": str(exc),
                            "retry_after_s": exc.retry_after},
                      {"Retry-After":
                       str(max(1, int(-(-exc.retry_after // 1)))),
                       **rid_hdr})
                return
            except DeadlineExceeded as exc:
                reply(504, {"error": str(exc)})
                return
            except ServerClosed as exc:
                reply(503, {"error": str(exc)})
                return
            except Exception as exc:
                try:
                    server.registry.get(name).stats.record_error()
                except KeyError:
                    pass
                reply(_error_code(exc),
                      {"error": f"{type(exc).__name__}: {exc}"})
                return
            reply(200, {"model": name, "num_rows": int(X.shape[0]),
                        "predictions": np.asarray(out).tolist(),
                        "request_id": rid})

        def _explain(self, req: dict) -> None:
            """``POST /explain``: same body shape as /predict (``rows``
            or ``row``, optional ``model``/``deadline_ms``), answers
            per-row SHAP contributions — for each class, one value per
            feature plus a trailing expected-value column (the host
            ``pred_contrib`` layout).  Shares the drain gate and error
            ladder with /predict but counts into its own response
            series and latency SLO."""
            rid = self.headers.get("X-Request-Id") or _gen_request_id()
            rid_hdr = {"X-Request-Id": rid}

            def reply(code: int, payload: dict,
                      headers: Optional[Dict[str, str]] = None) -> None:
                server._explain_responses.inc(1, code=str(int(code)))
                self._reply(code, payload, headers or rid_hdr)

            if not server._enter_predict():
                reply(503, {"error": "server is draining"},
                      {"Retry-After": "1", **rid_hdr})
                return
            try:
                self._explain_admitted(req, reply, rid)
            finally:
                server._exit_predict()

        def _explain_admitted(self, req: dict, reply, rid: str) -> None:
            rid_hdr = {"X-Request-Id": rid}
            name = req.get("model")
            rows = req.get("rows")
            if rows is None and "row" in req:
                rows = [req["row"]]
            if not isinstance(rows, list) or not rows:
                reply(400, {"error": "body needs 'rows' (list of "
                                     "feature lists) or 'row'"})
                return
            deadline_ms = req.get("deadline_ms")
            if deadline_ms is not None:
                if isinstance(deadline_ms, bool) or \
                        not isinstance(deadline_ms, (int, float)):
                    reply(400, {"error": "deadline_ms must be a "
                                         "number of milliseconds"})
                    return
                deadline_ms = float(deadline_ms)
            try:
                X = np.asarray(rows, np.float32)
                if X.ndim != 2:
                    raise ValueError(f"rows must be 2-D, got shape {X.shape}")
                out = server._explain(name, X, deadline_ms=deadline_ms,
                                      request_id=rid)
            except KeyError as exc:
                reply(404, {"error": str(exc.args[0])})
                return
            except QueueFullError as exc:
                server._last_shed_t = time.monotonic()
                reply(503, {"error": str(exc),
                            "retry_after_s": exc.retry_after},
                      {"Retry-After":
                       str(max(1, int(-(-exc.retry_after // 1)))),
                       **rid_hdr})
                return
            except DeadlineExceeded as exc:
                reply(504, {"error": str(exc)})
                return
            except ServerClosed as exc:
                reply(503, {"error": str(exc)})
                return
            except Exception as exc:
                try:
                    server.registry.get(name).stats.record_error()
                except KeyError:
                    pass
                reply(_error_code(exc),
                      {"error": f"{type(exc).__name__}: {exc}"})
                return
            reply(200, {"model": name, "num_rows": int(X.shape[0]),
                        "contributions": np.asarray(out).tolist(),
                        "request_id": rid})

        def _apply_delta(self, req: dict, name: str) -> None:
            """``POST /models/<name>/delta``: append a published delta's
            trees to the serving model without a full reload.  The wire
            record rides base64 inside the JSON body (``record_b64``) so
            the one-body-shape-per-POST read above stands.  409 = chain
            mismatch (the caller's typed signal to fall back to a full
            reload + replay); 404 = unknown model."""
            import base64
            b64 = req.get("record_b64")
            if not name or not isinstance(b64, str) or not b64:
                self._reply(400, {"error": "body needs 'record_b64' (the "
                                           "delta record, base64)"})
                return
            try:
                raw = base64.b64decode(b64.encode("ascii"), validate=True)
            except (ValueError, UnicodeEncodeError) as exc:
                self._reply(400, {"error": f"bad record_b64: {exc}"})
                return
            from ..publish.delta import DeltaChainError
            try:
                # zoo mode: an in-envelope delta splices only this
                # tenant's stacked lane (zero recompiles for neighbours)
                out = server._zoo.apply_delta(name, raw) \
                    if server._zoo is not None \
                    else server.registry.apply_delta(name, raw)
            except KeyError as exc:
                self._reply(404, {"error": str(exc.args[0])})
                return
            except DeltaChainError as exc:
                self._reply(409, {"error": str(exc)})
                return
            except Exception as exc:
                self._reply(_error_code(exc),
                            {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._reply(200, out)

        def _load_model(self, req: dict) -> None:
            name, path = req.get("name"), req.get("file")
            if not name or not path:
                self._reply(400, {"error": "body needs 'name' and 'file'"})
                return
            # optional lowering knobs ride the same body, so a reload
            # can reproduce the serving config of the entry it replaces
            kwargs = {}
            try:
                for key, cast in (("num_iteration", int), ("shard", int),
                                  ("leaf_bits", int), ("compiler", str)):
                    if req.get(key) is not None:
                        kwargs[key] = cast(req[key])
            except (TypeError, ValueError) as exc:
                self._reply(400, {"error": f"bad lowering knob: {exc}"})
                return
            try:
                # zoo mode: admission goes through the zoo so the budget
                # is enforced and stack membership refreshes
                pred = server._zoo.load(str(name), str(path), **kwargs) \
                    if server._zoo is not None \
                    else server.registry.load(str(name), str(path), **kwargs)
            except OSError as exc:      # the named file cannot be read
                self._reply(400, {"error": f"{type(exc).__name__}: {exc}"})
                return
            except Exception as exc:
                self._reply(_error_code(exc),
                            {"error": f"{type(exc).__name__}: {exc}"})
                return
            self._reply(200, {"model": name, **pred.info()})

    return ServeHandler


def _parse_bool(v, default: bool) -> bool:
    """Accept the repo's config bool spellings (true/false/1/0)."""
    if v is None:
        return default
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "on"):
        return True
    if s in ("false", "0", "no", "off"):
        return False
    raise ValueError(f"expected a boolean (true/false/1/0), got {v!r}")


def main(argv: List[str]) -> int:
    """``python -m lightgbm_tpu_torch serve <model.txt> [key=value ...]``.

    Keys: host (127.0.0.1), port (8080), name (single model's registry
    name), warmup (1), batching (1), max_batch (4096), max_wait_ms (2.0),
    max_queue_rows (0 = unbounded; over-limit requests are shed with 503
    + Retry-After), deadline_ms (0 = none; slow requests fail with 504),
    slo_latency_ms (re-declares the serve/latency_p99 threshold for this
    deployment), explain_slo_latency_ms (same for the /explain lane's
    serve/explain_latency_p99), num_iteration (-1: all), port_file
    (announce the bound port by atomic write: a supervisor's discovery
    channel for port=0 workers), device_type / device (cuda by default;
    cpu serves the plain path).  Multiple model files register under
    their basenames.

    Zoo keys (any of them switches on zoo mode, serve/zoo.py):
    zoo (0; force-enable), max_resident (0 = unbounded; over budget the
    zoo evicts by traffic-weighted LRU), zoo_dir (cold load-on-miss
    directory — requests for <name> load <zoo_dir>/<name>.txt inside
    their deadline, so a zoo server can start with NO model files),
    tenant_queue_rows (0 = no per-tenant quota; a tenant over its own
    backlog bound is shed before the shared queue bound), stacking (1;
    fuse same-lowering-shape tenants into one stacked launch per
    (stack, bucket) super-batch).

    SIGTERM/SIGINT drain the server (stop accepting, fail queued
    futures with ServerClosed, finish in-flight requests) and exit
    ``128+signum``; a repeat signal aborts immediately.
    """
    from ..basic import device_from
    from ..utils.log import log_fatal
    files = [a for a in argv if "=" not in a]
    kv = {k: v for k, v in
          (a.split("=", 1) for a in argv if "=" in a)}
    # the device first: without a card (and without device_type=cpu)
    # the verb raises before any model is read
    device = device_from(kv)
    if kv.get("model"):
        files.append(kv["model"])
    max_resident = int(kv.get("max_resident", 0))
    tenant_rows = int(kv.get("tenant_queue_rows", 0))
    zoo_mode = _parse_bool(kv.get("zoo"), False) or max_resident > 0 \
        or bool(kv.get("zoo_dir")) or tenant_rows > 0
    if not files and not kv.get("zoo_dir"):
        log_fatal("serve needs at least one model file: "
                  "python -m lightgbm_tpu_torch serve model.txt "
                  "[port=8080 ...] (or zoo_dir=<dir> to cold-load models "
                  "on demand)")
    if kv.get("slo_latency_ms"):
        from ..telemetry.slo import set_latency_threshold
        set_latency_threshold("serve/latency_p99",
                              float(kv["slo_latency_ms"]))
    if kv.get("explain_slo_latency_ms"):
        from ..telemetry.slo import set_latency_threshold
        set_latency_threshold("serve/explain_latency_p99",
                              float(kv["explain_slo_latency_ms"]))
    registry = ModelRegistry(device=device)
    n_iter = int(kv.get("num_iteration", -1))
    load_kwargs = {} if n_iter < 0 else {"num_iteration": n_iter}
    zoo = None
    if zoo_mode:
        from .zoo import ModelZoo
        zoo = ModelZoo(
            registry=registry, max_resident=max_resident,
            source_resolver=kv.get("zoo_dir") or None,
            stacking=_parse_bool(kv.get("stacking"), True),
            batching=_parse_bool(kv.get("batching"), True),
            max_batch_rows=int(kv.get("max_batch", 4096)),
            max_wait_ms=float(kv.get("max_wait_ms", 2.0)),
            max_queue_rows=int(kv.get("max_queue_rows", 0)),
            tenant_queue_rows=tenant_rows,
            warmup=_parse_bool(kv.get("warmup"), True),
            load_kwargs=load_kwargs)
    seen = set()
    for path in files:
        name = (kv["name"] if len(files) == 1 and kv.get("name") else
                os.path.splitext(os.path.basename(path))[0])
        if name in seen:
            log_fatal(f"two model files share the registry name '{name}' "
                      f"(names come from basenames); rename one file or "
                      f"serve them from separate processes")
        seen.add(name)
        if zoo is not None:
            zoo.load(name, path)
        else:
            registry.load(name, path,
                          warmup=_parse_bool(kv.get("warmup"), True),
                          **load_kwargs)
    srv = PredictionServer(
        registry, host=kv.get("host", "127.0.0.1"),
        port=int(kv.get("port", 8080)),
        max_batch_rows=int(kv.get("max_batch", 4096)),
        max_wait_ms=float(kv.get("max_wait_ms", 2.0)),
        batching=_parse_bool(kv.get("batching"), True),
        max_queue_rows=int(kv.get("max_queue_rows", 0)),
        deadline_ms=float(kv.get("deadline_ms", 0.0)),
        zoo=zoo)
    if kv.get("port_file"):
        # atomic announce AFTER the bind: a supervisor polling this file
        # can only ever read a complete, live port
        from ..io_utils import atomic_write_bytes
        atomic_write_bytes(kv["port_file"], f"{srv.port}\n".encode())
    try:
        srv.install_signal_handlers()
    except ValueError:
        pass  # not the main thread (embedded run); signals stay default
    log_info(f"serve: listening on http://{srv.host}:{srv.port} "
             f"on {srv.device_name()} "
             f"(models: {', '.join(registry.names())})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        log_info("serve: shutting down")
        srv.shutdown()
        return 0
    if srv.signal_received is not None:
        # accept loop already stopped by the handler; finish the drain
        srv.drain()
        log_info(f"serve: drained after signal {srv.signal_received}")
        return 128 + int(srv.signal_received)
    return 0
