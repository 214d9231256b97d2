"""The port's SLO engine (``telemetry/slo.py`` ``SloEngine``) and its
serving endpoints, held against the JAX package.

The reference's burn-rate math (ratio, latency per bucket, gauge floor;
the idle rule; multi-window breach and sustained fast burn), the
exemplar ring, ``GET /slo`` with ``X-Request-Id`` propagation,
``/healthz`` degrading on a sustained fast burn, and the availability
objective counting 5xx.  One case feeds the same series into both
packages' engines and compares the verdicts.  Servers run with
``device="cpu"``.
"""

import importlib
import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.telemetry.metrics import MetricsRegistry
from lightgbm_tpu_torch.telemetry.slo import (ExemplarRing, SloEngine,
                                              remove_slo, slo)

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

# the modules themselves (each package's ``telemetry.slo`` attribute is
# the ``slo()`` function)
jmetrics = importlib.import_module("lightgbm_tpu.telemetry.metrics")
jslo = importlib.import_module("lightgbm_tpu.telemetry.slo")
tmetrics = importlib.import_module("lightgbm_tpu_torch.telemetry.metrics")
tslo = importlib.import_module("lightgbm_tpu_torch.telemetry.slo")


class _Clock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t


def _verdict(report, name):
    return next(s for s in report["slos"] if s["name"] == name)


def test_ratio_slo_burn_math():
    reg = MetricsRegistry()
    bad = reg.counter("t_bad_total", labels=())
    total = reg.counter("t_total", labels=())
    slo("test/ratio", metric="t_bad_total", total_metric="t_total",
        kind="ratio", target=0.99, window_fast_s=60, window_slow_s=600,
        burn_fast=10.0, burn_slow=5.0)
    try:
        clk = _Clock()
        eng = SloEngine(registry=reg, sustain=2, clock=clk)
        total.inc(100)
        v = _verdict(eng.evaluate(), "test/ratio")
        assert v["ok"] and v["burn"]["fast"] == 0.0
        clk.t = 10.0
        bad.inc(25)
        total.inc(125)
        r = eng.evaluate()
        v = _verdict(r, "test/ratio")
        assert v["error_ratio"]["fast"] == pytest.approx(0.2)
        assert v["burn"]["fast"] == pytest.approx(20.0)
        assert v["breached"] and "test/ratio" in r["breached"]
        clk.t = 20.0
        bad.inc(25)
        total.inc(125)
        assert "test/ratio" in eng.evaluate()["degraded"]
        assert "test/ratio" in eng.degraded()
        clk.t = 90.0
        total.inc(10000)
        v = _verdict(eng.evaluate(), "test/ratio")
        assert v["burn"]["fast"] < 10.0 and not v["fast_burning"]
        assert eng.degraded() == []
    finally:
        remove_slo("test/ratio")


def test_ratio_slo_idle_service_does_not_burn():
    reg = MetricsRegistry()
    reg.counter("t2_bad_total")
    reg.counter("t2_total")
    slo("test/idle", metric="t2_bad_total", total_metric="t2_total",
        kind="ratio", target=0.999)
    try:
        eng = SloEngine(registry=reg, clock=_Clock())
        for _ in range(3):
            r = eng.evaluate()
        v = _verdict(r, "test/idle")
        assert v["ok"] and v["burn"]["fast"] == 0.0
    finally:
        remove_slo("test/idle")


def test_latency_slo_per_bucket_series():
    reg = MetricsRegistry()
    h = reg.histogram("t_lat_ms", labels=("model", "bucket"))
    for _ in range(50):
        h.observe(5.0, model="m", bucket="64")
        h.observe(80.0, model="m", bucket="4096")
    slo("test/lat", metric="t_lat_ms", kind="latency", target=0.9,
        threshold_ms=50.0, burn_fast=5.0, burn_slow=3.0)
    try:
        clk = _Clock()
        eng = SloEngine(registry=reg, clock=clk)
        v = _verdict(eng.evaluate(), "test/lat")
        series = {tuple(sorted(s["labels"].items())): s
                  for s in v["detail"]["series"]}
        fast = series[(("bucket", "64"), ("model", "m"))]
        slow = series[(("bucket", "4096"), ("model", "m"))]
        assert fast["frac_over"] == 0.0 and slow["frac_over"] == 1.0
        assert slow["p99_ms"] == pytest.approx(80.0)
        assert v["burn"]["fast"] == pytest.approx(10.0) and v["breached"]
        g = reg.get("slo_burn_rate")
        assert any(lbl == {"slo": "test/lat", "window": "fast"} and val > 0
                   for lbl, val in g.series())
        # idle scrapes contribute no burn: the breach clears
        for clk.t in (60.0, 120.0, 180.0, 240.0, 330.0, 400.0):
            r = eng.evaluate()
        v = _verdict(r, "test/lat")
        assert v["burn"]["fast"] < 5.0 and not v["breached"]
    finally:
        remove_slo("test/lat")


def test_gauge_floor_slo_burns_while_below_floor():
    reg = MetricsRegistry()
    g = reg.gauge("t_workers_alive")
    slo("test/floor", metric="t_workers_alive", kind="gauge_floor",
        floor=1.0, target=0.5, window_fast_s=60, window_slow_s=600,
        burn_fast=1.9, burn_slow=1.5)
    try:
        clk = _Clock()
        eng = SloEngine(registry=reg, sustain=2, clock=clk)
        v = _verdict(eng.evaluate(), "test/floor")
        assert v["ok"] and v["detail"]["value"] is None
        g.set(2.0)
        clk.t = 10.0
        assert _verdict(eng.evaluate(), "test/floor")["ok"]
        g.set(0.0)
        for clk.t in (20.0, 30.0, 40.0, 50.0, 60.0, 70.0, 80.0, 90.0):
            r = eng.evaluate()
        v = _verdict(r, "test/floor")
        assert v["burn"]["fast"] > 1.9 and v["breached"]
        assert v["detail"]["value"] == 0
        g.set(2.0)
        for clk.t in (100.0, 110.0, 160.0, 230.0):
            r = eng.evaluate()
        v = _verdict(r, "test/floor")
        assert not v["breached"] and v["burn"]["fast"] < 1.9
    finally:
        remove_slo("test/floor")


def test_exemplar_ring_keeps_worst_n():
    ring = ExemplarRing(capacity=4)
    for i in range(100):
        ring.offer(float(i), {"request_id": f"r{i}"})
    snap = ring.snapshot()
    assert [e["score"] for e in snap] == [99.0, 98.0, 97.0, 96.0]
    assert snap[0]["request_id"] == "r99" and len(ring) == 4


def test_engine_verdicts_equal_reference():
    """The same counters, histogram and gauge series, evaluated at the
    same instants by both packages' engines: the same verdicts."""
    plants = [
        dict(name="test/x_ratio", metric="x_bad_total",
             total_metric="x_total", kind="ratio", target=0.99,
             window_fast_s=60, window_slow_s=600, burn_fast=10.0,
             burn_slow=5.0, bad_labels={"code": "5*"}, min_events=5),
        dict(name="test/x_lat", metric="x_lat_ms", kind="latency",
             target=0.9, threshold_ms=50.0, burn_fast=5.0, burn_slow=3.0),
        dict(name="test/x_floor", metric="x_alive", kind="gauge_floor",
             floor=1.0, target=0.5, burn_fast=1.9, burn_slow=1.5),
        dict(name="test/x_ceiling", metric="x_behind",
             kind="gauge_ceiling", ceiling=2.0, target=0.5,
             burn_fast=1.9, burn_slow=1.5),
    ]
    reports = {}
    for pkg, mmod, smod in (("port", tmetrics, tslo),
                            ("reference", jmetrics, jslo)):
        reg = mmod.MetricsRegistry()
        bad = reg.counter("x_bad_total", labels=("code",))
        total = reg.counter("x_total")
        lat = reg.histogram("x_lat_ms", labels=("bucket",))
        alive = reg.gauge("x_alive")
        behind = reg.gauge("x_behind")
        for p in plants:
            smod.slo(**{k: v for k, v in p.items() if k != "name"},
                     name=p["name"])
        try:
            clk = _Clock()
            eng = smod.SloEngine(registry=reg, sustain=2, clock=clk)
            rng = np.random.RandomState(3)
            out = []
            for step in range(12):
                clk.t = 15.0 * step
                total.inc(40)
                bad.inc(int(rng.randint(0, 6)),
                        code=("503" if step % 2 else "500"))
                bad.inc(1, code="404")
                for v in rng.gamma(2.0, 20.0, 16):
                    lat.observe(float(v), bucket=str(8 ** (step % 3)))
                alive.set(float(step % 4 != 0))
                behind.set(float(step % 5))
                rep = eng.evaluate()
                out.append([_verdict(rep, p["name"]) for p in plants])
            reports[pkg] = out
        finally:
            for p in plants:
                smod.remove_slo(p["name"])
    assert json.dumps(reports["port"], sort_keys=True) == \
        json.dumps(reports["reference"], sort_keys=True)
    assert any(v["breached"] for step in reports["port"] for v in step)


# -- the HTTP surface ---------------------------------------------------------

def _mk_server(tmp_path, **kw):
    from lightgbm_tpu_torch.serve.registry import ModelRegistry
    from lightgbm_tpu_torch.serve.server import PredictionServer
    rng = np.random.RandomState(0)
    X = rng.randn(400, 5).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    bst = lt.train(p, lt.Dataset(X, y), 5, device="cpu")
    mf = os.path.join(str(tmp_path), "m.txt")
    bst.save_model(mf)
    reg = ModelRegistry(device="cpu")
    reg.load("m", mf, warmup=False)
    return PredictionServer(reg, port=0, **kw).start(), X


def _get(port, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return r.status, json.loads(r.read().decode())


def _predict(port, rows, rid=None, model=None):
    payload = {"rows": rows}
    if model:
        payload["model"] = model
    headers = {"Content-Type": "application/json"}
    if rid:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=json.dumps(payload).encode(),
                                 headers=headers)
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.status, dict(r.headers), json.loads(r.read().decode())


def test_server_slo_endpoint_and_request_id(tmp_path):
    srv, X = _mk_server(tmp_path)
    try:
        status, headers, out = _predict(srv.port, X[:3].tolist(), "e2e-42")
        assert status == 200 and headers["X-Request-Id"] == "e2e-42"
        assert out["request_id"] == "e2e-42"
        out2 = _predict(srv.port, X[:3].tolist())[2]
        assert out2["request_id"].startswith("srv-")
        code, rep = _get(srv.port, "/slo")
        assert code == 200 and rep["schema"] == "slo-report-v1"
        names = {s["name"] for s in rep["slos"]}
        assert {"serve/latency_p99", "serve/availability",
                "serve/shed_rate"} <= names
        code, health = _get(srv.port, "/healthz")
        assert code == 200 and health["status"] in ("ok", "degraded")
        _predict(srv.port, X[:2].tolist(), model="m")
        code, stats = _get(srv.port, "/stats")
        assert list(stats) == ["m"]
        assert stats["m"]["saturation"]["inflight_requests"] == 0
        assert stats["m"]["request_latency_ms"]["window"] >= 2
        assert stats["m"]["queue_wait_ms"]["window"] >= 2
    finally:
        srv.shutdown()


def test_healthz_degrades_on_sustained_fast_burn(tmp_path):
    from lightgbm_tpu_torch.serve.stats import request_exemplars
    slo("test/hot", metric="serve_request_latency_ms", kind="latency",
        target=0.99, threshold_ms=1e-6, burn_fast=1.0, burn_slow=1.0)
    try:
        eng = SloEngine(sustain=2)
        request_exemplars().clear()
        srv, X = _mk_server(tmp_path, slo_engine=eng)
        try:
            for i in range(3):
                _predict(srv.port, X[:3].tolist(), f"hot-{i}")
            _get(srv.port, "/slo")
            health = _get(srv.port, "/healthz")[1]
            assert health["status"] == "degraded"
            assert any("slo_fast_burn: test/hot" in r
                       for r in health["reasons"])
            rep = _get(srv.port, "/slo")[1]
            assert rep["exemplars"]
            assert any(e["request_id"].startswith("hot-")
                       for e in rep["exemplars"])
        finally:
            srv.shutdown()
    finally:
        remove_slo("test/hot")


def test_availability_counts_5xx(tmp_path):
    """A program failure (500) lands in the /predict availability
    series and burns the ``serve/availability`` objective; a 404 on
    another path lands only in the all-endpoints counter."""
    from lightgbm_tpu_torch.telemetry.metrics import default_registry
    srv, X = _mk_server(tmp_path)
    try:
        http_c = default_registry().get("serve_http_responses_total")
        pred_c = default_registry().get("serve_predict_responses_total")
        h404 = http_c.value(code="404")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope",
                                   timeout=30)
        assert err.value.code == 404
        assert http_c.value(code="404") == h404 + 1
        pred = srv.registry.get("m")

        def broken(*a, **k):
            raise RuntimeError("device program failed")
        pred.predict_raw = broken
        p500 = pred_c.value(code="500")
        eng = SloEngine(sustain=1)
        eng.evaluate()
        for _ in range(60):
            with pytest.raises(urllib.error.HTTPError) as err:
                _predict(srv.port, X[:2].tolist())
            assert err.value.code == 500
        assert pred_c.value(code="500") == p500 + 60
        v = _verdict(eng.evaluate(), "serve/availability")
        assert v["burn"]["fast"] > 0 and v["fast_burning"]
    finally:
        srv.shutdown()


def test_fallback_batches_counter_measures_traffic():
    from lightgbm_tpu_torch.serve.compiler import FALLBACK_BATCHES
    from lightgbm_tpu_torch.telemetry.metrics import default_registry
    rng = np.random.RandomState(0)
    X = rng.randn(300, 5).astype(np.float32)
    y = (X[:, 0] > 0).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 7, "verbosity": -1}
    bst = lt.train(p, lt.Dataset(X, y), 5, device="cpu")
    pred = bst.to_predictor(warmup=False, compiler="walk")
    c = default_registry().counter(FALLBACK_BATCHES,
                                   labels=("reason", "model"))
    before = c.value(reason="forced_walk", model="default")
    pred.predict(X[:3])
    pred.predict(X[:3])
    assert c.value(reason="forced_walk", model="default") == before + 2
