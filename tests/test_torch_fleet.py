"""The port's serving fleet (``lightgbm_tpu_torch/serve/fleet.py``) held
against the JAX package's, on the CPU.

- The nine stub-worker tests of ``tests/test_fleet.py``, with their
  assertions unchanged, against the port's ``FleetSupervisor``: plain
  Python subprocesses that import neither package drive the whole
  spawn / port-file / watchdog / breaker / retry / deploy / drain
  machinery.
- In process, the same inputs through ``lightgbm_tpu.serve.fleet`` and
  the port's module: the hash ring's owners, the smooth weighted round
  robin's picks, the ``Retry-After`` hint, the boot model sets and
  worker command lines (equal but for the module name) and the
  ``/metrics`` re-labelling of a worker's scrape.
- Real ``python -m lightgbm_tpu_torch serve`` workers on the CPU
  (``device_type=cpu``): ``/predict`` through the dispatcher bitwise the
  port's ``Booster.predict`` and within rtol 1e-6 of the reference's
  (the tolerance of ``tests/test_torch_serve.py``), a delta journal
  followed to its head, a rolling deploy, the ``serve-fleet`` verb and
  its SIGTERM drain, and the device rule: without ``device_type`` on a
  machine without a card every worker exits at boot, the breaker
  quarantines it and the fleet answers only 503.
- The reference's real-worker acceptance tests (``tests/test_fleet.py``
  and ``tests/test_publish.py``'s live refresh), ``slow`` / ``chaos`` as
  there, with port workers on the CPU.
"""

import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.serve.fleet as ref_fleet
import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.serve.fleet as port_fleet
from lightgbm_tpu_torch.serve.fleet import FleetSupervisor
from lightgbm_tpu_torch.serve.loadgen import metric_sum, parse_prometheus

# many small tensor ops per test and several test processes: one
# intra-op thread each (the workers get OMP_NUM_THREADS=1 too)
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1}
WORKER_ENV = {"PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}

# Minimal worker: answers the fleet's HTTP surface with deterministic
# bodies, honors the chaos knobs through env vars, drains on SIGTERM
# and exits 143 — every supervision path exercised without torch.
STUB_WORKER = r'''
import json, os, signal, sys, threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

PORT_FILE = sys.argv[1]
WID = os.environ.get("STUB_WID", "?")
CRASH_AFTER = int(os.environ.get("STUB_CRASH_AFTER", "0"))
EXIT_FLAG = os.environ.get("STUB_EXIT_FLAG", "")
STATUS = int(os.environ.get("STUB_STATUS", "200"))
DROP_FIRST = int(os.environ.get("STUB_DROP_FIRST", "0"))
MODELS_STATUS = int(os.environ.get("STUB_MODELS_STATUS", "200"))

if EXIT_FLAG and os.path.exists(EXIT_FLAG):
    sys.exit(7)          # crash-loop while the flag file exists

count = [0]
dropped = [0]
models = {}

class H(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    def log_message(self, *a): pass
    def _reply(self, code, payload):
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)
    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"status": "ok", "worker": WID})
        elif self.path == "/models":
            self._reply(200, {n: {"source": p} for n, p in models.items()})
        elif self.path == "/slo":
            self._reply(200, {"schema": "slo-report-v1", "ok": True,
                              "worker": WID})
        elif self.path == "/stats":
            self._reply(200, {"requests": count[0]})
        elif self.path == "/metrics":
            body = ("lgbm_tpu_stub_requests_total %d\n"
                    % count[0]).encode()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self._reply(404, {"error": "nope"})
    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        req = json.loads(self.rfile.read(n)) if n else {}
        if self.path == "/predict":
            count[0] += 1
            if CRASH_AFTER and count[0] > CRASH_AFTER:
                os._exit(137)
            if DROP_FIRST and dropped[0] < DROP_FIRST:
                dropped[0] += 1
                import socket as _s
                try:
                    self.connection.shutdown(_s.SHUT_RDWR)
                except OSError:
                    pass
                self.close_connection = True
                return
            if STATUS != 200:
                self._reply(STATUS, {"error": "injected 5xx"})
                return
            self._reply(200, {"worker": WID, "n": count[0],
                              "deadline_ms": req.get("deadline_ms"),
                              "predictions":
                                  [0.5] * len(req.get("rows", []))})
        elif self.path == "/models":
            if MODELS_STATUS != 200:
                self._reply(MODELS_STATUS, {"error": "injected load "
                                                     "failure"})
                return
            models[req["name"]] = req["file"]
            self._reply(200, {"model": req["name"]})
        else:
            self._reply(404, {"error": "nope"})

srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
srv.daemon_threads = True

def _term(signum, frame):
    threading.Thread(target=srv.shutdown, daemon=True).start()

signal.signal(signal.SIGTERM, _term)
tmp = PORT_FILE + ".tmp"
with open(tmp, "w") as fh:
    fh.write(str(srv.server_address[1]))
os.replace(tmp, PORT_FILE)
srv.serve_forever()
sys.exit(143)
'''


def _stub_fleet(tmp_path, workers=2, per_worker_env=None,
                first_spawn_env=None, **kw):
    stub = tmp_path / "stub_worker.py"
    if not stub.exists():
        stub.write_text(STUB_WORKER)
    dummy_model = tmp_path / "model.txt"
    if not dummy_model.exists():
        dummy_model.write_text("stub")
    per_env = {int(k): dict(v) for k, v in (per_worker_env or {}).items()}
    for i in range(workers):
        per_env.setdefault(i, {})
        per_env[i].setdefault("STUB_WID", str(i))
    defaults = dict(
        probe_interval_s=0.1, probe_timeout_s=1.0, hang_probes=3,
        breaker_failures=3, breaker_window_s=10.0,
        breaker_halfopen_s=0.5, probe_ok_needed=2,
        backoff_base_s=0.05, backoff_max_s=0.3,
        startup_timeout_s=60.0, drain_timeout_s=10.0,
        run_dir=str(tmp_path / "fleet-run"))
    defaults.update(kw)
    return FleetSupervisor(
        [str(dummy_model)], workers=workers,
        worker_cmd=lambda wid, port_file: [sys.executable, str(stub),
                                           port_file],
        per_worker_env=per_env, first_spawn_env=first_spawn_env,
        **defaults)


def _post(host, port, path, payload, headers=None, timeout=30):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        body = json.dumps(payload).encode()
        conn.request("POST", path, body, {
            "Content-Type": "application/json",
            "Content-Length": str(len(body)), **(headers or {})})
        r = conn.getresponse()
        data = r.read()
        return r.status, json.loads(data) if data else {}, \
            dict(r.getheaders())
    finally:
        conn.close()


def _get(host, port, path, timeout=30):
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        data = r.read()
        return r.status, data
    finally:
        conn.close()


def _get_json(host, port, path, timeout=30):
    status, data = _get(host, port, path, timeout=timeout)
    return status, json.loads(data)


def _scrape(fleet):
    status, data = _get(fleet.host, fleet.port, "/metrics")
    assert status == 200
    return parse_prometheus(data.decode())


def _wait_for(predicate, timeout=20.0, interval=0.05, desc="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out waiting for {desc}")


# ---------------------------------------------------------------------------
# tier-1: stub workers through the full supervision/dispatch machinery
# ---------------------------------------------------------------------------

def test_fleet_round_robin_and_deadline_decrement(tmp_path):
    """Health-weighted round-robin spreads traffic over both workers,
    the dispatch hop decrements deadline_ms before forwarding, and the
    X-Request-Id is echoed end to end."""
    fleet = _stub_fleet(tmp_path, workers=2).start()
    try:
        seen = set()
        for i in range(8):
            status, body, headers = _post(
                fleet.host, fleet.port, "/predict",
                {"rows": [[1.0, 2.0]], "deadline_ms": 5000},
                headers={"X-Request-Id": f"rr-{i}"})
            assert status == 200, body
            seen.add(body["worker"])
            assert 0 < body["deadline_ms"] < 5000
            assert headers.get("X-Request-Id") == f"rr-{i}"
        assert seen == {"0", "1"}, "round-robin never reached a worker"
        status, health = _get_json(fleet.host, fleet.port, "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["workers_alive"] == 2
    finally:
        fleet.shutdown()


def test_fleet_crash_restart_under_traffic(tmp_path):
    """A worker hard-killed mid-stream costs the client NOTHING: the
    reset request is retried on the other worker, the supervisor
    restarts the dead one, and the fleet metrics record both."""
    fleet = _stub_fleet(
        tmp_path, workers=2,
        first_spawn_env={0: {"STUB_CRASH_AFTER": "3"}}).start()
    try:
        for i in range(20):
            status, body, _ = _post(fleet.host, fleet.port, "/predict",
                                    {"rows": [[1.0]]})
            assert status == 200, (i, body)
        _wait_for(lambda: all(w.state == "alive"
                              for w in fleet.workers()),
                  desc="both workers alive again")
        parsed = _scrape(fleet)
        assert metric_sum(parsed, "lgbm_tpu_fleet_restarts_total") >= 1
        assert metric_sum(parsed, "lgbm_tpu_fleet_retries_total") >= 1
        assert metric_sum(parsed, "lgbm_tpu_fleet_workers_alive") == 2
        # replacement worker boots WITHOUT the first-spawn chaos env
        for i in range(10):
            status, _, _ = _post(fleet.host, fleet.port, "/predict",
                                 {"rows": [[1.0]]})
            assert status == 200
    finally:
        fleet.shutdown()


def test_fleet_crash_loop_breaker_and_half_open(tmp_path):
    """K failures in the window open the breaker: the worker is
    quarantined instead of restart-storming, /predict fast-fails 503 +
    Retry-After, /healthz goes degraded; once the fault clears, the
    half-open probe restores the worker and closes the breaker."""
    flag = tmp_path / "crash.flag"
    fleet = _stub_fleet(
        tmp_path, workers=1,
        per_worker_env={0: {"STUB_EXIT_FLAG": str(flag)}}).start()
    try:
        flag.write_text("on")          # every respawn now dies at boot
        w = fleet.workers()[0]
        assert w.proc is not None
        w.proc.kill()                  # trigger the first failure
        _wait_for(lambda: w.state == "quarantined",
                  desc="breaker open")
        assert len(w.fail_times) >= 3  # K failures, then no storm
        restarts_at_open = w.restarts
        status, body, headers = _post(fleet.host, fleet.port,
                                      "/predict", {"rows": [[1.0]]})
        assert status == 503
        assert "Retry-After" in headers
        status, health = _get_json(fleet.host, fleet.port, "/healthz")
        assert health["status"] == "degraded"
        assert any("breaker" in r for r in health["reasons"])
        parsed = _scrape(fleet)
        assert metric_sum(parsed,
                          "lgbm_tpu_fleet_workers_quarantined") == 1
        assert metric_sum(parsed, "lgbm_tpu_fleet_workers_alive") == 0

        flag.unlink()                  # fault cleared: half-open probe
        _wait_for(lambda: w.state == "alive" and not w.probing and
                  len(w.fail_times) == 0,
                  desc="breaker closed after a clean probe")
        assert w.restarts <= restarts_at_open + 2   # probe, not storm
        status, body, _ = _post(fleet.host, fleet.port, "/predict",
                                {"rows": [[1.0]]})
        assert status == 200 and body["worker"] == "0"
    finally:
        fleet.shutdown()


def test_fleet_5xx_forwarded_never_retried(tmp_path):
    """A 5xx that REACHED a predictor is the worker's answer — the
    dispatcher forwards it verbatim and spends no retry budget on it."""
    fleet = _stub_fleet(
        tmp_path, workers=2,
        per_worker_env={0: {"STUB_STATUS": "500"}}).start()
    try:
        codes = []
        for _ in range(8):
            status, _, _ = _post(fleet.host, fleet.port, "/predict",
                                 {"rows": [[1.0]]})
            codes.append(status)
        assert 500 in codes and 200 in codes, codes
        parsed = _scrape(fleet)
        assert metric_sum(parsed, "lgbm_tpu_fleet_retries_total") == 0
    finally:
        fleet.shutdown()


def test_fleet_dropped_connection_retried_on_other_worker(tmp_path):
    """A connection severed before any response (the serve_drop_conn
    class) is retried against a DIFFERENT worker inside the budget —
    the client sees one 200, the fleet counts one retry."""
    fleet = _stub_fleet(
        tmp_path, workers=2,
        per_worker_env={0: {"STUB_DROP_FIRST": "1"},
                        1: {"STUB_WID": "1"}}).start()
    try:
        outcomes = []
        for _ in range(6):
            status, body, _ = _post(fleet.host, fleet.port, "/predict",
                                    {"rows": [[1.0]]})
            outcomes.append((status, body.get("worker")))
        assert all(s == 200 for s, _ in outcomes), outcomes
        parsed = _scrape(fleet)
        assert metric_sum(parsed, "lgbm_tpu_fleet_retries_total") >= 1
    finally:
        fleet.shutdown()


def test_fleet_metrics_and_slo_aggregate_worker_scrapes(tmp_path):
    """Fleet /metrics carries the supervision series AND each worker's
    scrape re-labeled worker=wN; /slo wraps the fleet verdict with the
    per-worker reports."""
    fleet = _stub_fleet(tmp_path, workers=2).start()
    try:
        _post(fleet.host, fleet.port, "/predict", {"rows": [[1.0]]})
        parsed = _scrape(fleet)
        assert metric_sum(parsed, "lgbm_tpu_fleet_workers_alive") == 2
        assert metric_sum(
            parsed, "lgbm_tpu_serve_predict_responses_total",
            code="200") >= 1
        per_worker = parsed.get("lgbm_tpu_worker_stub_requests_total",
                                [])
        assert {lbl.get("worker") for lbl, _ in per_worker} == \
            {"w0", "w1"}
        # declared fleet SLOs evaluate against the fleet registry
        assert metric_sum(parsed, "lgbm_tpu_slo_burn_rate",
                          slo="fleet/workers_alive", window="fast") == 0
        status, slo_rep = _get_json(fleet.host, fleet.port, "/slo")
        assert status == 200
        assert slo_rep["schema"] == "fleet-slo-report-v1"
        assert slo_rep["ok"] is True
        assert set(slo_rep["workers"]) == {"w0", "w1"}
        names = {s["name"] for s in slo_rep["fleet"]["slos"]}
        assert {"fleet/workers_alive", "fleet/retry_rate"} <= names
    finally:
        fleet.shutdown()


def test_fleet_rolling_deploy_stub_order_and_abort(tmp_path):
    """The roll walks workers in order; a worker that rejects the new
    version aborts the roll with the already-swapped workers reported
    (its own old version was never touched — registry load fails before
    any swap)."""
    new_file = tmp_path / "model_v2.txt"
    new_file.write_text("stub v2")
    fleet = _stub_fleet(tmp_path, workers=2).start()
    try:
        status, report, _ = _post(fleet.host, fleet.port, "/models",
                                  {"name": "m", "file": str(new_file)})
        assert status == 200, report
        assert report["verdict"] == "deployed"
        assert report["deployed"] == ["w0", "w1"]
    finally:
        fleet.shutdown()

    fleet = _stub_fleet(tmp_path, workers=2,
                        per_worker_env={
                            1: {"STUB_MODELS_STATUS": "500"}}).start()
    try:
        status, report, _ = _post(fleet.host, fleet.port, "/models",
                                  {"name": "m", "file": str(new_file)})
        assert status == 409
        assert report["verdict"] == "aborted"
        assert report["deployed"] == ["w0"]
        assert "w1" in report["error"]
    finally:
        fleet.shutdown()


def test_fleet_deploy_survives_worker_respawn(tmp_path):
    """A deployed version whose file name does not spell the logical
    model name must still be served by a crash-restarted worker: the
    supervisor records the deploy in _current_models (new names too)
    and catches the respawned worker up over POST /models — without
    this, the first crash after a deploy serves 404s for the deployed
    name."""
    stub = tmp_path / "stub_worker.py"
    stub.write_text(STUB_WORKER)
    model_a = tmp_path / "m_a.txt"
    model_a.write_text("stub a")
    model_b = tmp_path / "m_b.txt"
    model_b.write_text("stub b")
    v2 = tmp_path / "m_a_v2.txt"      # renamed source: basename-derived
    v2.write_text("stub a v2")        # name "m_a_v2" != logical "m_a"
    fleet = FleetSupervisor(
        [str(model_a), str(model_b)], workers=2,
        worker_cmd=lambda wid, port_file: [sys.executable, str(stub),
                                           port_file],
        per_worker_env={0: {"STUB_WID": "0"}, 1: {"STUB_WID": "1"}},
        probe_interval_s=0.1, backoff_base_s=0.05, backoff_max_s=0.3,
        breaker_failures=5, breaker_window_s=10.0,
        startup_timeout_s=60.0, drain_timeout_s=10.0,
        run_dir=str(tmp_path / "fleet-run")).start()
    try:
        status, report, _ = _post(fleet.host, fleet.port, "/models",
                                  {"name": "m_a", "file": str(v2)})
        assert status == 200 and report["verdict"] == "deployed", report
        # kill w0; the respawned stub boots with an empty model table
        w0 = fleet.workers()[0]
        first_pid = w0.proc.pid
        w0.proc.kill()
        _wait_for(lambda: w0.state == "alive" and
                  w0.proc.pid != first_pid and
                  w0.synced_incarnation == w0.incarnation,
                  desc="w0 respawned and model-synced")
        status, models = _get_json(fleet.host, fleet.port, "/models")
        assert status == 200
        assert models["w0"].get("m_a", {}).get("source") == str(v2), \
            models["w0"]
    finally:
        fleet.shutdown()


def test_fleet_shutdown_is_a_rolling_drain(tmp_path):
    """shutdown() SIGTERMs workers one at a time; each drains and exits
    143 (128+SIGTERM), and the dispatcher socket closes last."""
    fleet = _stub_fleet(tmp_path, workers=2).start()
    port = fleet.port
    procs = [w.proc for w in fleet.workers()]
    fleet.shutdown()
    for p in procs:
        assert p is not None and p.poll() == 143, \
            f"worker exit code {p.poll() if p else None}"
    with pytest.raises(OSError):
        _get(fleet.host, port, "/healthz", timeout=2)
    fleet.shutdown()   # idempotent


# ---------------------------------------------------------------------------
# in process: the same inputs through the reference's module and the port's
# ---------------------------------------------------------------------------

def _pair(tmp_path, files, **kw):
    """One unstarted supervisor of each package over the same model
    files and run directory (their dispatch sockets bound, no worker
    spawned)."""
    kw.setdefault("run_dir", str(tmp_path / "run"))
    return (ref_fleet.FleetSupervisor(files, **kw),
            port_fleet.FleetSupervisor(files, **kw))


def _close(*fleets):
    for f in fleets:
        f._httpd.server_close()


@pytest.mark.parametrize("vnodes", [8, 64])
def test_hash_ring_owner_matches_reference(vnodes):
    rng = np.random.RandomState(vnodes)
    names = [f"tenant-{rng.randint(1 << 30)}" for _ in range(200)] + \
        ["m", "model", "headline"]
    wids = list(range(5))
    ref = ref_fleet._HashRing(wids, vnodes=vnodes)
    port = port_fleet._HashRing(wids, vnodes=vnodes)
    assert port._ring == ref._ring
    subsets = [set(), {0}, {4}, {1, 3}, {0, 2, 4}, set(wids)] + \
        [set(np.flatnonzero(rng.rand(5) < 0.5).tolist()) for _ in range(6)]
    for routable in subsets:
        for name in names:
            assert port.owner(name, routable) == ref.owner(name, routable)


def _set_workers(fleet, states):
    """Put the handles in the given (state, port, health) states."""
    for w, (state, port, health) in zip(fleet.workers(), states):
        w.state, w.port, w.last_health = state, port, health


def test_pick_worker_sequence_matches_reference(tmp_path):
    (tmp_path / "m.txt").write_text("stub")
    ref, port = _pair(tmp_path, [str(tmp_path / "m.txt")], workers=5)
    try:
        phases = [
            [("alive", 1, "ok"), ("alive", 2, "degraded"),
             ("backoff", None, "ok"), ("alive", 4, "ok"),
             ("quarantined", None, "unknown")],
            [("alive", 1, "degraded"), ("alive", 2, "degraded"),
             ("alive", 3, "ok"), ("starting", None, "unknown"),
             ("alive", 5, "ok")],
            [("alive", 1, "ok"), ("alive", None, "ok"),
             ("draining", 3, "ok"), ("alive", 4, "ok"),
             ("alive", 5, "degraded")],
        ]
        excludes = [(), (), (0,), (), (1, 3), (), (4,), (0, 1, 2, 3, 4)]
        seqs = []
        for fleet in (ref, port):
            seq = []
            for states in phases:
                _set_workers(fleet, states)
                for i in range(24):
                    w = fleet.pick_worker(exclude=excludes[i % len(excludes)])
                    seq.append(None if w is None else w.wid)
            seqs.append(seq)
        assert seqs[1] == seqs[0]
        assert len(set(seqs[0])) == 6   # every worker and a None
    finally:
        _close(ref, port)


def test_retry_after_matches_reference(tmp_path, monkeypatch):
    (tmp_path / "m.txt").write_text("stub")
    ref, port = _pair(tmp_path, [str(tmp_path / "m.txt")], workers=3,
                      breaker_halfopen_s=7.5, probe_interval_s=0.4)
    try:
        monkeypatch.setattr(time, "monotonic", lambda: 1000.0)
        cases = [
            [("backoff", 1003.25, 0.0), ("quarantined", 0.0, 996.0),
             ("alive", 0.0, 0.0)],
            [("quarantined", 0.0, 999.0), ("quarantined", 0.0, 995.0),
             ("stopped", 0.0, 0.0)],
            [("starting", 0.0, 0.0), ("backoff", 1000.5, 0.0),
             ("alive", 0.0, 0.0)],
            [("alive", 0.0, 0.0)] * 3,
            [("backoff", 990.0, 0.0), ("quarantined", 0.0, 980.0),
             ("draining", 0.0, 0.0)],
        ]
        for case in cases:
            got = []
            for fleet in (ref, port):
                for w, (state, restart_t, quarantined_at) in zip(
                        fleet.workers(), case):
                    w.state = state
                    w.next_restart_t = restart_t
                    w.quarantined_at = quarantined_at
                got.append(fleet._retry_after_s())
            assert got[1] == got[0], case
    finally:
        monkeypatch.undo()
        _close(ref, port)


@pytest.mark.parametrize("placement", ["replicate", "hash"])
@pytest.mark.parametrize("files,args", [
    (["model.txt"], {}),
    (["model.txt"], {"name": "headline", "max_wait_ms": "0.5"}),
    (["a.txt", "b.txt", "c.txt", "tenant3.txt", "tenant4.txt"],
     {"device_type": "cpu", "warmup": "0"}),
    (["a.txt", "b.txt", "c.txt"], {"zoo_dir": "/models", "port": "9"}),
])
def test_boot_models_and_build_cmd_match_reference(tmp_path, placement,
                                                   files, args):
    paths = [str(tmp_path / f) for f in files]
    for p in paths:
        open(p, "w").write("stub")
    ref, port = _pair(tmp_path, paths, workers=3, placement=placement,
                      worker_args=args)
    try:
        if len(files) > 1:
            # a deploy that renamed one source: the boot sets and the
            # model syncs must go on naming it by its logical name
            renamed = str(tmp_path / "b_v2.txt")
            for fleet in (ref, port):
                fleet._current_models["b"] = renamed
        for wr, wp in zip(ref.workers(), port.workers()):
            assert port._boot_models(wp) == ref._boot_models(wr)
            cmd_r, cmd_p = ref._build_cmd(wr), port._build_cmd(wp)
            assert cmd_r[1:3] == ["-m", "lightgbm_tpu"]
            assert cmd_p[1:3] == ["-m", "lightgbm_tpu_torch"]
            assert cmd_p[:1] + cmd_p[3:] == cmd_r[:1] + cmd_r[3:]
    finally:
        _close(ref, port)


SCRAPE = """# HELP lgbm_tpu_serve_requests_total requests
# TYPE lgbm_tpu_serve_requests_total counter
lgbm_tpu_serve_requests_total{model="headline"} 17
lgbm_tpu_serve_requests_total{model="tenant \\"1\\""} 3
# TYPE lgbm_tpu_serve_latency_ms histogram
lgbm_tpu_serve_latency_ms_bucket{model="headline",le="0.5"} 2
lgbm_tpu_serve_latency_ms_bucket{model="headline",le="+Inf"} 17
lgbm_tpu_serve_latency_ms_sum{model="headline"} 12.75
lgbm_tpu_serve_latency_ms_count{model="headline"} 17
lgbm_tpu_slo_burn_rate{slo="serve/availability",window="fast"} 0.25
lgbm_tpu_process_up 1
"""


def test_metrics_text_relabel_matches_reference(tmp_path):
    (tmp_path / "m.txt").write_text("stub")
    ref, port = _pair(tmp_path, [str(tmp_path / "m.txt")], workers=3)
    try:
        texts = []
        for fleet in (ref, port):
            _set_workers(fleet, [("alive", 1, "ok"),
                                 ("backoff", None, "ok"),
                                 ("alive", 3, "degraded")])
            fleet._worker_get_text = \
                lambda w, path, timeout, name=None: SCRAPE.replace(
                    "17", str(10 + w.wid))
            fleet._alive_g.set(2.0)
            fleet._restarts.inc(1, reason="exit")
            fleet._predict_responses.inc(3, code="200")
            texts.append(fleet.metrics_text())
        relabelled = [[ln for ln in t.splitlines()
                       if ln.startswith("lgbm_tpu_worker_")] for t in texts]
        assert relabelled[1] == relabelled[0]
        assert len(relabelled[0]) == 2 * 8   # w0 and w2, 8 series each
        assert any('worker="w2"' in ln and " 12" in ln
                   for ln in relabelled[0])
        # the fleet registry's own families and its objectives' burn
        # gauges (the packages may declare other objectives beside them,
        # and the process's last training run renders too)
        def own(text):
            out = []
            for ln in text.splitlines():
                name = ln.split(" ")[2] if ln.startswith("#") else ln
                if name.startswith(("lgbm_tpu_fleet_", "lgbm_tpu_serve_")) \
                        or 'slo="fleet/' in ln:
                    out.append(ln)
            return out
        assert own(texts[1]) == own(texts[0])
        assert len(own(texts[0])) > 20
        assert any(ln.startswith("lgbm_tpu_fleet_restarts_total")
                   for ln in own(texts[0]))
    finally:
        _close(ref, port)


# ---------------------------------------------------------------------------
# real port workers on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fleet_booster(binary_data):
    X, y = binary_data
    p = {**SMALL, "objective": "binary"}
    return lt.train(p, lt.Dataset(X, y), 6, device="cpu")


def _real_fleet(tmp_path, model_file, workers=2, **kw):
    defaults = dict(
        worker_env=dict(WORKER_ENV),
        worker_args={"warmup": "0", "max_wait_ms": "0.5",
                     "device_type": "cpu"},
        probe_interval_s=0.25, probe_timeout_s=5.0,
        breaker_failures=3, breaker_window_s=20.0,
        breaker_halfopen_s=1.0,
        backoff_base_s=0.2, backoff_max_s=1.0,
        startup_timeout_s=180.0, drain_timeout_s=30.0,
        forward_timeout_s=60.0,
        run_dir=str(tmp_path / "fleet-run"))
    defaults.update(kw)
    return FleetSupervisor([model_file], workers=workers, **defaults)


def _predictions(body):
    return np.asarray(body["predictions"], np.float32)


def test_real_fleet_predict_bitwise_booster(tmp_path, fleet_booster):
    """Two ``device_type=cpu`` workers: /predict through the dispatcher
    across bucket boundaries equals the port's ``Booster.predict``
    bitwise (the body is forwarded verbatim, floats never re-encoded)
    and the reference's within rtol 1e-6; both workers answer."""
    model_file = str(tmp_path / "model.txt")
    fleet_booster.save_model(model_file)
    ref = lgb.Booster(model_file=model_file)
    fleet = _real_fleet(tmp_path, model_file).start()
    try:
        rng = np.random.RandomState(0)
        for n in (1, 7, 8, 9, 511, 513):
            Xq = rng.randn(n, 6).astype(np.float32)
            status, body, _ = _post(fleet.host, fleet.port, "/predict",
                                    {"rows": Xq.tolist()}, timeout=120)
            assert status == 200, body
            np.testing.assert_array_equal(_predictions(body),
                                          fleet_booster.predict(Xq))
            np.testing.assert_allclose(_predictions(body), ref.predict(Xq),
                                       rtol=1e-6)
        served = [metric_sum(_scrape(fleet),
                             "lgbm_tpu_worker_serve_requests_total",
                             worker=w.name) for w in fleet.workers()]
        assert all(s > 0 for s in served), served
        status, health = _get_json(fleet.host, fleet.port, "/healthz")
        assert health["status"] == "ok" and health["workers_alive"] == 2
    finally:
        fleet.shutdown()


def test_real_fleet_follows_delta_journal(tmp_path, binary_data):
    """The fleet follows a delta journal: the port's ``DeltaJournal``
    holds a BASE at round 3 and then rounds 4-6; both workers are
    anchored and replayed to round 6 with ``fleet_model_rounds_behind``
    0, and every answer on the way equals the in-process prediction of
    one published round."""
    from lightgbm_tpu_torch.models.model_text import model_to_string
    from lightgbm_tpu_torch.publish import DeltaJournal
    X, y = binary_data
    p = {**SMALL, "objective": "binary"}
    g = lt.train(p, lt.Dataset(X, y), 6, device="cpu")._gbdt
    jdir = str(tmp_path / "journal")
    j = DeltaJournal(jdir)
    base_text = model_to_string(g, num_iteration=3)
    model_file = str(tmp_path / "model.txt")
    with open(model_file, "w") as fh:
        fh.write(base_text)
    j.write_base(base_text, 3)
    Xq = X[:4].astype(np.float32)
    refs = {r: lt.Booster(model_str=model_to_string(g, num_iteration=r),
                          device="cpu").predict(Xq)
            for r in (3, 4, 5, 6)}
    assert len({v.tobytes() for v in refs.values()}) == 4
    fleet = _real_fleet(tmp_path, model_file, publish_dir=jdir).start()
    try:
        _wait_for(lambda: all(w.acked_round == 3
                              for w in fleet.workers()),
                  timeout=60.0, desc="both workers anchored at round 3")
        for r in (4, 5, 6):
            j.append_delta(model_to_string(g, start_iteration=r - 1,
                                           num_iteration=1), r)
            for _ in range(3):
                status, body, _ = _post(fleet.host, fleet.port,
                                        "/predict", {"rows": Xq.tolist()},
                                        timeout=60)
                assert status == 200, body
                got = _predictions(body)
                match = [k for k, v in refs.items()
                         if np.array_equal(got, v)]
                assert match, f"an answer of no published round: {got}"
                time.sleep(0.1)
        _wait_for(lambda: all(w.acked_round == 6
                              for w in fleet.workers()),
                  timeout=60.0, desc="both workers at round 6")
        behind = fleet.metrics_registry.get("fleet_model_rounds_behind")
        _wait_for(lambda: max(behind.value(model="model", worker=w.name)
                              for w in fleet.workers()) == 0.0,
                  timeout=15.0, desc="rounds-behind gauges at 0")
        parsed = _scrape(fleet)
        assert metric_sum(parsed, "lgbm_tpu_fleet_model_rounds_behind") \
            == 0
        assert metric_sum(parsed, "lgbm_tpu_fleet_delta_pushes_total",
                          outcome="ok") >= 6
        for _ in range(4):
            status, body, _ = _post(fleet.host, fleet.port, "/predict",
                                    {"rows": Xq.tolist()}, timeout=60)
            assert status == 200
            np.testing.assert_array_equal(_predictions(body), refs[6])
    finally:
        fleet.shutdown()


def test_real_fleet_rolling_deploy_serves_new_model(tmp_path, binary_data,
                                                    fleet_booster):
    """``POST /models`` rolls a second model over both workers in order;
    the fleet then answers with it, bitwise its ``Booster.predict``."""
    X, y = binary_data
    p = {**SMALL, "objective": "regression"}
    b2 = lt.train(p, lt.Dataset(X, X[:, 0]), 4, device="cpu")
    model_file = str(tmp_path / "model.txt")
    v2_file = str(tmp_path / "model_v2.txt")
    fleet_booster.save_model(model_file)
    b2.save_model(v2_file)
    fleet = _real_fleet(tmp_path, model_file).start()
    try:
        status, report, _ = _post(fleet.host, fleet.port, "/models",
                                  {"name": "model", "file": v2_file},
                                  timeout=120)
        assert status == 200, report
        assert report["verdict"] == "deployed"
        assert report["deployed"] == ["w0", "w1"]
        Xq = X[:9].astype(np.float32)
        for _ in range(4):   # both workers, round robin
            status, body, _ = _post(fleet.host, fleet.port, "/predict",
                                    {"rows": Xq.tolist()}, timeout=60)
            assert status == 200
            np.testing.assert_array_equal(_predictions(body),
                                          b2.predict(Xq))
        status, models = _get_json(fleet.host, fleet.port, "/models")
        assert all(models[w]["model"]["source"] == v2_file
                   for w in ("w0", "w1")), models
    finally:
        fleet.shutdown()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _wait_http(port, proc, timeout=120.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"serve-fleet exited {proc.returncode}")
        try:
            return _get_json("127.0.0.1", port, "/healthz", timeout=5)
        except (OSError, ValueError):
            time.sleep(0.1)
    raise AssertionError("serve-fleet never answered /healthz")


def test_serve_fleet_cli_sigterm_exits_143(tmp_path, binary_data,
                                           fleet_booster):
    """``python -m lightgbm_tpu_torch serve-fleet model.txt workers=2
    device_type=cpu port=<free>``: the device key reaches the workers,
    /predict answers bitwise the port's Booster, and SIGTERM drains
    every worker and exits 128 + 15."""
    X, _ = binary_data
    model_file = str(tmp_path / "model.txt")
    fleet_booster.save_model(model_file)
    port = _free_port()
    env = {**os.environ, **WORKER_ENV, "PYTHONUNBUFFERED": "1"}
    with open(tmp_path / "fleet.log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "lightgbm_tpu_torch", "serve-fleet",
             model_file, "workers=2", "device_type=cpu", f"port={port}",
             "warmup=0", f"run_dir={tmp_path / 'run'}"],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        status, health = _wait_http(port, proc)
        assert health["workers_alive"] == 2
        status, body, _ = _post("127.0.0.1", port, "/predict",
                                {"rows": X[:5].tolist()}, timeout=60)
        assert status == 200
        np.testing.assert_array_equal(_predictions(body),
                                      fleet_booster.predict(X[:5]))
        status, models = _get_json("127.0.0.1", port, "/models")
        assert {models[w]["model"]["device"] for w in ("w0", "w1")} == \
            {"cpu"}, models
        pids = [w["pid"] for w in health["workers"].values()]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 128 + signal.SIGTERM
        for pid in pids:
            with pytest.raises(OSError):   # every worker drained and gone
                os.kill(pid, 0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)


def _start_unchecked(fleet):
    """``start()`` without its gate that every worker answer within
    ``startup_timeout_s`` (it raises otherwise): spawn each worker and
    run the supervision and dispatch threads, the state a started fleet
    is in once its workers lose the card."""
    now = time.monotonic()
    for w in fleet.workers():
        fleet._spawn(w, now)
    fleet._sup_thread = threading.Thread(target=fleet._run_supervision,
                                         daemon=True)
    fleet._sup_thread.start()
    fleet._http_thread = threading.Thread(target=fleet._httpd.serve_forever,
                                          daemon=True)
    fleet._http_thread.start()
    return fleet


def test_fleet_without_card_never_falls_back(tmp_path, fleet_booster):
    """Workers started without ``device_type`` on a machine without a
    card: each exits at boot with ``DeviceUnavailableError`` (no CPU
    retry), the breaker quarantines it, and the fleet answers /predict
    only 503 + Retry-After while /healthz is not ok."""
    if torch.cuda.is_available():
        pytest.skip("checks the card-less rule")
    model_file = str(tmp_path / "model.txt")
    fleet_booster.save_model(model_file)
    fleet = _real_fleet(tmp_path, model_file,
                        worker_args={"warmup": "0"},
                        probe_interval_s=0.1, backoff_base_s=0.05,
                        backoff_max_s=0.2, breaker_window_s=600.0,
                        breaker_halfopen_s=600.0)
    codes, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            try:
                status, _, headers = _post(fleet.host, fleet.port,
                                           "/predict", {"rows": [[0.0] * 6]},
                                           timeout=30)
                codes.append((status, "Retry-After" in headers))
            except OSError:
                pass
            time.sleep(0.05)

    _start_unchecked(fleet)
    th = threading.Thread(target=client, daemon=True)
    th.start()
    try:
        _wait_for(lambda: all(w.state == "quarantined"
                              for w in fleet.workers()),
                  timeout=240.0, desc="both workers quarantined")
        for w in fleet.workers():
            assert w.restarts == 2 and len(w.fail_times) == 3, w.snapshot()
            log = open(w.log_path).read()
            assert log.count("DeviceUnavailableError") >= 3, log[-2000:]
        status, health = _get_json(fleet.host, fleet.port, "/healthz")
        assert health["status"] != "ok" and health["workers_alive"] == 0
        parsed = _scrape(fleet)
        assert metric_sum(parsed, "lgbm_tpu_fleet_workers_quarantined") \
            == 2
        assert metric_sum(parsed, "lgbm_tpu_fleet_restarts_total",
                          reason="exit") == 4
        time.sleep(0.3)
    finally:
        stop.set()
        th.join(30)
        fleet.shutdown()
    assert codes and all(c == (503, True) for c in codes), codes[:10]


# ---------------------------------------------------------------------------
# slow/chaos: the reference's acceptance runs with real port workers
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_fleet_parity_with_direct_predictor(tmp_path, binary_data,
                                            fleet_booster):
    """Acceptance: predictions routed through the dispatcher are
    bit-identical to a direct single-worker PredictionServer and to
    Booster.predict, across bucket boundaries."""
    from lightgbm_tpu_torch.serve import ModelRegistry, PredictionServer
    X, _ = binary_data
    model_file = str(tmp_path / "model.txt")
    fleet_booster.save_model(model_file)
    reg = ModelRegistry(device="cpu")
    reg.load("model", model_file, warmup=False)
    direct = PredictionServer(reg, port=0, max_wait_ms=0.5).start()
    fleet = _real_fleet(tmp_path, model_file, workers=2).start()
    try:
        rng = np.random.RandomState(0)
        for n in (1, 7, 8, 9, 511, 513):
            Xq = rng.randn(n, X.shape[1]).astype(np.float32)
            ref = fleet_booster.predict(Xq).tolist()
            st_f, body_f, _ = _post(fleet.host, fleet.port, "/predict",
                                    {"rows": Xq.tolist()}, timeout=120)
            st_d, body_d, _ = _post(direct.host, direct.port,
                                    "/predict", {"rows": Xq.tolist()},
                                    timeout=120)
            assert st_f == 200 and st_d == 200
            assert body_f["predictions"] == ref, f"n={n}: fleet drift"
            assert body_d["predictions"] == ref, f"n={n}: direct drift"
    finally:
        fleet.shutdown()
        direct.shutdown()


@pytest.mark.slow
@pytest.mark.chaos
def test_fleet_chaos_under_load(tmp_path, fleet_booster):
    """Acceptance: a 4-worker fleet under loadgen traffic survives
    repeated worker kills — every client request gets a terminal
    response, the fleet returns to full strength, and the verdict
    (availability SLO met after the recovery window, restarts recorded)
    is read from fleet /metrics + /slo scrapes only."""
    from lightgbm_tpu_torch.serve.loadgen import LoadGenerator, LoadSpec
    model_file = str(tmp_path / "model.txt")
    fleet_booster.save_model(model_file)
    fleet = _real_fleet(tmp_path, model_file, workers=4).start()
    try:
        spec = LoadSpec(duration_s=6.0, target_qps=40.0, workers=2,
                        features=6, bucket_mix={8: 1.0}, seed=3,
                        timeout_s=30.0)
        gen = LoadGenerator(fleet.host, fleet.port, spec)
        kills = []

        def killer():
            for i in (0, 2):
                time.sleep(1.5)
                w = fleet.workers()[i]
                if w.proc is not None and w.proc.poll() is None:
                    w.proc.kill()
                    kills.append(w.name)

        kt = threading.Thread(target=killer, daemon=True)
        kt.start()
        client = gen.run()
        kt.join(20)
        assert len(kills) == 2
        terminal = sum(client.by_code.values()) + client.connect_errors
        assert terminal == client.requests_sent
        assert client.by_code.get(200, 0) > 0
        _wait_for(lambda: all(w.state == "alive"
                              for w in fleet.workers()),
                  timeout=60.0, desc="fleet back to 4 alive workers")
        parsed = _scrape(fleet)
        assert metric_sum(parsed, "lgbm_tpu_fleet_restarts_total") >= 2
        assert metric_sum(parsed, "lgbm_tpu_fleet_workers_alive") == 4
        total = metric_sum(parsed,
                           "lgbm_tpu_serve_predict_responses_total")
        bad = sum(metric_sum(parsed,
                             "lgbm_tpu_serve_predict_responses_total",
                             code=c) for c in ("500", "502", "503",
                                               "504"))
        assert total > 0
        assert bad / total <= 0.05, (bad, total)
        status, slo_rep = _get_json(fleet.host, fleet.port, "/slo")
        assert status == 200 and slo_rep["ok"] is True, slo_rep
    finally:
        fleet.shutdown()


@pytest.mark.slow
@pytest.mark.chaos
def test_fleet_breaker_quarantines_crash_looping_worker(tmp_path,
                                                        fleet_booster):
    """Acceptance: a worker armed to crash on (almost) every request —
    serve_crash_after_n on EVERY incarnation — opens the breaker within
    K failures instead of restart-storming, while the healthy worker
    keeps answering."""
    model_file = str(tmp_path / "model.txt")
    fleet_booster.save_model(model_file)
    fleet = _real_fleet(
        tmp_path, model_file, workers=2,
        breaker_halfopen_s=300.0,   # keep it open for the assertion
        per_worker_env={1: {"LGBM_TPU_FAULTS":
                            "serve_crash_after_n=1"}}).start()
    try:
        w1 = fleet.workers()[1]
        deadline = time.monotonic() + 120.0
        while w1.state != "quarantined" and time.monotonic() < deadline:
            status, _, _ = _post(fleet.host, fleet.port, "/predict",
                                 {"rows": [[0.0] * 6]}, timeout=60)
            assert status in (200, 502), status
            time.sleep(0.05)
        assert w1.state == "quarantined", w1.snapshot()
        assert w1.restarts <= 3, w1.snapshot()
        parsed = _scrape(fleet)
        assert metric_sum(parsed,
                          "lgbm_tpu_fleet_workers_quarantined") == 1
        status, health = _get_json(fleet.host, fleet.port, "/healthz")
        assert health["status"] == "degraded"
        status, _, _ = _post(fleet.host, fleet.port, "/predict",
                             {"rows": [[0.0] * 6]}, timeout=60)
        assert status == 200
    finally:
        fleet.shutdown()


@pytest.mark.slow
@pytest.mark.chaos
def test_fleet_rolling_deploy_zero_5xx_under_load(tmp_path, binary_data,
                                                  fleet_booster):
    """Acceptance: hot-swapping a model version across the fleet under
    live loadgen traffic serves ZERO 5xx attributable to the deploy —
    old or new version answers every request during the roll — and the
    fleet serves the new version afterwards."""
    from lightgbm_tpu_torch.serve.loadgen import LoadGenerator, LoadSpec
    X, y = binary_data
    p = {**SMALL, "objective": "binary"}
    b2 = lt.train(p, lt.Dataset(X, y), 9, device="cpu")
    model_file = str(tmp_path / "model.txt")
    v2_file = str(tmp_path / "model_v2.txt")
    fleet_booster.save_model(model_file)
    b2.save_model(v2_file)
    fleet = _real_fleet(tmp_path, model_file, workers=2).start()
    try:
        spec = LoadSpec(duration_s=5.0, target_qps=30.0, workers=2,
                        features=6, bucket_mix={8: 1.0}, seed=5)
        gen = LoadGenerator(fleet.host, fleet.port, spec)
        deploy_result = {}

        def deployer():
            time.sleep(1.5)
            status, report, _ = _post(
                fleet.host, fleet.port, "/models",
                {"name": "model", "file": v2_file}, timeout=120)
            deploy_result["status"] = status
            deploy_result["report"] = report

        dt = threading.Thread(target=deployer, daemon=True)
        dt.start()
        client = gen.run()
        dt.join(120)
        assert deploy_result.get("status") == 200, deploy_result
        assert deploy_result["report"]["verdict"] == "deployed"
        assert deploy_result["report"]["deployed"] == ["w0", "w1"]
        bad_client = sum(v for c, v in client.by_code.items()
                         if c >= 500)
        assert bad_client == 0 and client.connect_errors == 0, \
            client.summary()
        parsed = _scrape(fleet)
        bad = sum(metric_sum(parsed,
                             "lgbm_tpu_serve_predict_responses_total",
                             code=c) for c in ("500", "502", "503",
                                               "504"))
        assert bad == 0
        ref = b2.predict(X[:1]).tolist()
        status, body, _ = _post(fleet.host, fleet.port, "/predict",
                                {"rows": X[:1].tolist()}, timeout=60)
        assert status == 200 and body["predictions"] == ref
    finally:
        fleet.shutdown()


@pytest.mark.slow
@pytest.mark.chaos
def test_fleet_live_refresh_kill_mid_publish(tmp_path, binary_data):
    """Acceptance (``tests/test_publish.py``'s): a 2-worker fleet
    following a delta journal under live traffic, with one worker
    KILLED mid-publish, (a) serves every response from some published
    round — never a torn mix of rounds, (b) converges both workers to
    the journal head with delta pushes (not just respawn reloads), and
    (c) re-meets the ``fleet/model_staleness`` SLO after recovery."""
    from lightgbm_tpu_torch.models.model_text import model_to_string
    from lightgbm_tpu_torch.publish import DeltaJournal
    X, y = binary_data
    p = {**SMALL, "objective": "binary"}
    full = lt.train(p, lt.Dataset(X, y), 6, device="cpu")
    g = full._gbdt
    jdir = str(tmp_path / "journal")
    j = DeltaJournal(jdir)
    base_text = model_to_string(g, num_iteration=3)
    model_file = str(tmp_path / "model.txt")
    with open(model_file, "w") as fh:
        fh.write(base_text)
    j.write_base(base_text, 3)
    Xq = X[:4].astype(np.float32)
    refs = {r: lt.Booster(model_str=model_to_string(
                g, num_iteration=r), device="cpu").predict(Xq).tolist()
            for r in (3, 4, 5, 6)}
    assert len({tuple(v) for v in refs.values()}) == 4
    fleet = _real_fleet(tmp_path, model_file, workers=2,
                        breaker_failures=5, publish_dir=jdir)
    fleet.start()
    try:
        _wait_for(lambda: all(w.acked_round == 3
                              for w in fleet.workers()),
                  timeout=60.0,
                  desc="both workers anchored at the base round")
        stop = threading.Event()
        responses, mixes = [], []

        def poller():
            while not stop.is_set():
                try:
                    status, body = _post(fleet.host, fleet.port,
                                         "/predict",
                                         {"rows": Xq.tolist()},
                                         timeout=60)[0:2]
                except Exception:
                    continue
                if status != 200:
                    continue
                preds = body["predictions"]
                rounds = [r for r, v in refs.items() if v == preds]
                responses.append(rounds[0] if rounds else None)
                if not rounds:
                    mixes.append(preds)
                time.sleep(0.02)

        pt = threading.Thread(target=poller, daemon=True)
        pt.start()
        for r in (4, 5, 6):
            j.append_delta(model_to_string(g, start_iteration=r - 1,
                                           num_iteration=1), r)
            if r == 5:
                w0 = fleet.workers()[0]
                if w0.proc is not None and w0.proc.poll() is None:
                    w0.proc.kill()
            time.sleep(0.8)
        _wait_for(lambda: all(w.state == "alive" and w.acked_round == 6
                              for w in fleet.workers()),
                  timeout=90.0,
                  desc="both workers recovered and caught up to round 6")
        stop.set()
        pt.join(10)
        assert not mixes, f"responses matched NO published round: " \
                          f"{mixes[:2]}"
        assert len(responses) > 0 and None not in responses
        assert len(set(responses)) >= 2, set(responses)
        reg = fleet.metrics_registry
        pushes = reg.get("fleet_delta_pushes_total")
        assert pushes is not None and pushes.value(outcome="ok") >= 3
        for _ in range(6):
            status, body = _post(fleet.host, fleet.port, "/predict",
                                 {"rows": Xq.tolist()}, timeout=60)[0:2]
            assert status == 200 and body["predictions"] == refs[6]
        behind = reg.get("fleet_model_rounds_behind")
        assert behind is not None
        _wait_for(lambda: max(behind.value(model="model", worker=w.name)
                              for w in fleet.workers()) == 0.0,
                  timeout=15.0, desc="rounds-behind gauges back to 0")
        report = fleet.slo_engine.evaluate()
        stale = next(s for s in report["slos"]
                     if s["name"] == "fleet/model_staleness")
        assert stale["breached"] is False, stale
    finally:
        fleet.shutdown()
