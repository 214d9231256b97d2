"""In-process synthetic load generator for the HTTP serving tier.

Copy of ``lightgbm_tpu/serve/loadgen.py`` (pure Python over numpy and
``http.client``) kept inside the PyTorch port so the port never imports
the JAX package.

Drives the REAL server (``serve/server.py``) over real sockets —
``http.client`` connections, JSON bodies, the full handler → batcher →
predictor path — with either of the two canonical load models:

  * **open loop** (``target_qps > 0``): requests depart on a schedule
    drawn once up front (uniform or Poisson arrivals at the target
    rate) regardless of completions, so an overloaded tier shows queue
    growth and sheds instead of the generator politely slowing down
    (the coordinated-omission trap closed-loop benchmarks fall into);
  * **closed loop** (``target_qps = 0``): each worker fires
    back-to-back, measuring the tier's ceiling.

The request-shape mix rides the ``SHAPE_BUCKETS`` ladder: each bucket
size gets a weight, bodies are pre-encoded once per bucket (the
generator must not spend its CPU budget on ``json.dumps``), and every
request carries an ``X-Request-Id`` so server-side exemplars can name
the offending load-test request on a breach.

The generator reports only CLIENT-side observations (codes, client
latency, achieved rate).  The load-test harness's pass/breach verdict
comes exclusively from ``/metrics`` + ``/slo`` scrapes — the
``scrape_*`` / ``parse_prometheus`` helpers here are that path.
"""

from __future__ import annotations

import http.client
import json
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..telemetry.metrics import percentile

__all__ = ["LoadSpec", "LoadResult", "LoadGenerator", "parse_prometheus",
           "metric_sum", "scrape_metrics", "scrape_json"]


@dataclass
class LoadSpec:
    """One load rung.  ``bucket_mix`` maps rows-per-request to weight;
    ``target_qps=0`` switches to closed-loop."""

    duration_s: float = 5.0
    target_qps: float = 0.0
    workers: int = 2
    features: int = 4
    bucket_mix: Dict[int, float] = field(default_factory=lambda: {4096: 1.0})
    arrival: str = "uniform"           # "uniform" | "poisson"
    model: Optional[str] = None        # /predict "model" field
    deadline_ms: float = 0.0           # per-request deadline (0 = none)
    seed: int = 0
    timeout_s: float = 30.0            # per-connection connect/read timeout


@dataclass
class LoadResult:
    """Client-side view of one rung (the verdict does NOT use this —
    it reads the server's own /metrics + /slo)."""

    requests_sent: int = 0
    rows_sent: int = 0
    by_code: Dict[int, int] = field(default_factory=dict)
    errors: int = 0
    connect_errors: int = 0            # connection-level failures (a
    #                                    worker restart mid-request);
    #                                    counted as failed requests,
    #                                    never abort a worker thread
    elapsed_s: float = 0.0
    latencies_ms: List[float] = field(default_factory=list)
    late_departures: int = 0           # open loop: schedule slips

    @property
    def achieved_qps(self) -> float:
        return self.requests_sent / self.elapsed_s if self.elapsed_s else 0.0

    @property
    def achieved_rows_per_s(self) -> float:
        return self.rows_sent / self.elapsed_s if self.elapsed_s else 0.0

    def summary(self) -> Dict[str, Any]:
        lat = sorted(self.latencies_ms)
        return {
            "requests_sent": self.requests_sent,
            "rows_sent": self.rows_sent,
            "elapsed_s": round(self.elapsed_s, 3),
            "achieved_qps": round(self.achieved_qps, 2),
            "achieved_rows_per_s": round(self.achieved_rows_per_s, 1),
            "by_code": {str(k): v for k, v in sorted(self.by_code.items())},
            "errors": self.errors,
            "connect_errors": self.connect_errors,
            "late_departures": self.late_departures,
            "client_p50_ms": round(percentile(lat, 50.0), 3),
            "client_p99_ms": round(percentile(lat, 99.0), 3),
        }


class LoadGenerator:
    """Drive one :class:`LoadSpec` against a running server."""

    def __init__(self, host: str, port: int, spec: LoadSpec) -> None:
        self.host, self.port = host, int(port)
        self.spec = spec
        rng = np.random.RandomState(spec.seed)
        # one pre-encoded body per bucket size: the generator's hot loop
        # is socket I/O, not serialization
        self._bodies: Dict[int, bytes] = {}
        for rows in spec.bucket_mix:
            X = rng.randn(int(rows), spec.features).astype(np.float32)
            req: Dict[str, Any] = {"rows": X.tolist()}
            if spec.model:
                req["model"] = spec.model
            if spec.deadline_ms:
                req["deadline_ms"] = spec.deadline_ms
            self._bodies[int(rows)] = json.dumps(req).encode()
        sizes = sorted(spec.bucket_mix)
        w = np.asarray([spec.bucket_mix[s] for s in sizes], np.float64)
        self._sizes = sizes
        self._weights = w / w.sum()
        self._rng = rng

    def _schedule(self) -> Optional[np.ndarray]:
        """Departure offsets for open loop (None = closed loop)."""
        s = self.spec
        if s.target_qps <= 0:
            return None
        n = max(1, int(s.target_qps * s.duration_s))
        if s.arrival == "poisson":
            gaps = self._rng.exponential(1.0 / s.target_qps, n)
            return np.cumsum(gaps)
        return np.arange(n) / s.target_qps

    def run(self) -> LoadResult:
        s = self.spec
        res = LoadResult()
        lock = threading.Lock()
        stop_at = [0.0]                # filled once t0 is known
        sched = self._schedule()
        cursor = [0]                   # next schedule slot (open loop)
        # per-request row sizes drawn up front (deterministic under seed)
        draw_n = len(sched) if sched is not None else \
            int(max(64, s.duration_s * 2000))
        sizes = self._rng.choice(self._sizes, size=draw_n, p=self._weights)

        def new_conn() -> http.client.HTTPConnection:
            return http.client.HTTPConnection(self.host, self.port,
                                              timeout=s.timeout_s)

        def worker(wid: int) -> None:
            conn = new_conn()
            sent = rows = errors = conn_errors = late = 0
            codes: Dict[int, int] = {}
            lats: List[float] = []
            while True:
                now = time.perf_counter()
                if now >= stop_at[0]:
                    break
                if sched is not None:
                    with lock:
                        i = cursor[0]
                        if i >= len(sched):
                            break
                        cursor[0] = i + 1
                    depart = t0 + sched[i]
                    delay = depart - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                    elif delay < -0.05:
                        late += 1
                else:
                    with lock:
                        i = cursor[0]
                        cursor[0] = i + 1
                    if i >= len(sizes):
                        i = i % len(sizes)
                nrows = int(sizes[i % len(sizes)])
                body = self._bodies[nrows]
                rid = f"load-{wid}-{sent}"
                t_req = time.perf_counter()
                code: Optional[int] = None
                # one bounded reconnect: a worker restart mid-request
                # severs the keep-alive connection; the SECOND attempt
                # runs on a fresh socket, and a second failure counts
                # as a failed request (connect_errors) rather than
                # aborting the generator thread or burning the slot in
                # a reconnect storm
                for attempt in (0, 1):
                    try:
                        conn.request("POST", "/predict", body, {
                            "Content-Type": "application/json",
                            "Content-Length": str(len(body)),
                            "X-Request-Id": rid})
                        r = conn.getresponse()
                        r.read()
                        code = r.status
                        break
                    except Exception:
                        try:
                            conn.close()
                        except Exception:
                            pass
                        conn = new_conn()
                if code is None:
                    errors += 1
                    conn_errors += 1
                    sent += 1       # a failed request, not a non-event
                    continue
                lats.append((time.perf_counter() - t_req) * 1e3)
                codes[code] = codes.get(code, 0) + 1
                sent += 1
                if code == 200:
                    rows += nrows
            try:
                conn.close()
            except Exception:
                pass
            with lock:
                res.requests_sent += sent
                res.rows_sent += rows
                res.errors += errors
                res.connect_errors += conn_errors
                res.late_departures += late
                res.latencies_ms.extend(lats)
                for c, k in codes.items():
                    res.by_code[c] = res.by_code.get(c, 0) + k

        t0 = time.perf_counter()
        stop_at[0] = t0 + s.duration_s
        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(max(1, s.workers))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        res.elapsed_s = time.perf_counter() - t0
        return res


# ---------------------------------------------------------------------------
# Scrape helpers: the verdict path (server-side numbers only)
# ---------------------------------------------------------------------------

_LINE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_RE = re.compile(r'(\w+)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> Dict[str, List[Tuple[Dict[str, str],
                                                        float]]]:
    """Prometheus exposition text -> {name: [(labels, value), ...]}."""
    out: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _LINE_RE.match(line)
        if not m:
            continue
        labels = {k: v.replace(r'\"', '"').replace(r"\\", "\\")
                  for k, v in _LABEL_RE.findall(m.group("labels") or "")}
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        out.setdefault(m.group("name"), []).append((labels, value))
    return out


def metric_sum(parsed: Dict[str, List[Tuple[Dict[str, str], float]]],
               name: str, **labels) -> float:
    """Sum of a metric's series whose labels contain ``labels``."""
    total = 0.0
    for lbl, val in parsed.get(name, ()):
        if all(lbl.get(k) == str(v) for k, v in labels.items()):
            total += val
    return total


def scrape_metrics(host: str, port: int) -> str:
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", "/metrics")
        r = conn.getresponse()
        body = r.read().decode()
        if r.status != 200:
            raise RuntimeError(f"/metrics returned {r.status}")
        return body
    finally:
        conn.close()


def scrape_json(host: str, port: int, path: str) -> Dict[str, Any]:
    conn = http.client.HTTPConnection(host, int(port), timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read().decode()
        if r.status != 200:
            raise RuntimeError(f"{path} returned {r.status}")
        return json.loads(body)
    finally:
        conn.close()
