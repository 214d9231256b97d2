"""The port's serving tier held against the JAX package, on the CPU.

``lightgbm_tpu_torch.serve`` (``device="cpu"``): the bucketed predictor
answers bitwise as the port's ``Booster.predict``; the micro-batcher
under concurrent submitters, and a bad request that fails only its own
group; the registry's atomic hot swap and a failed load that leaves the
old version serving; a drain that gives every request exactly one
terminal response; the HTTP server end to end (``/predict`` bitwise the
port's ``Booster.predict`` and within rtol 1e-6 of the reference's on the
same model text: ROADMAP queue 3 item 9 explains why not bitwise),
``/explain``, 503 load shedding, 504 deadlines, a 500 (never a reroute)
when the program fails or a dense explanation fails its additivity check, the chaos layer's dropped connection; and the
device rule: without a card and without ``device="cpu"`` every entry
point raises ``DeviceUnavailableError``.  The CLI ``serve`` subprocess
and its SIGTERM drain are ``slow``, as the reference's are.
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.serve import (MicroBatcher, ModelRegistry,
                                      PredictionServer)
from lightgbm_tpu_torch.utils.device import DeviceUnavailableError

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1}
NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the card-less rule")


@pytest.fixture(scope="module")
def booster(binary_data):
    X, y = binary_data
    p = {**SMALL, "objective": "binary"}
    return lt.train(p, lt.Dataset(X, y), 15, device="cpu")


@pytest.fixture(scope="module")
def model_file(booster, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("serve") / "model.txt")
    booster.save_model(path)
    return path


@pytest.fixture(scope="module")
def predictor(booster):
    return booster.to_predictor(warmup=True)


def _post(conn, path, payload, headers=False):
    conn.request("POST", path, json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    out = (resp.status, json.loads(resp.read()))
    return out + (dict(resp.getheaders()),) if headers else out


def _get(conn, path):
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _conn(srv, timeout=60):
    return http.client.HTTPConnection("127.0.0.1", srv.port,
                                      timeout=timeout)


# -- the predictor ------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 7, 8, 9, 511, 513])
def test_bucket_parity(n, booster, predictor):
    Xs = np.random.RandomState(n).randn(n, 6)
    np.testing.assert_array_equal(predictor.predict(Xs), booster.predict(Xs))
    np.testing.assert_array_equal(predictor.predict(Xs, raw_score=True),
                                  booster.predict(Xs, raw_score=True))


def test_zero_recompiles_after_warmup(predictor):
    r0 = predictor.stats.snapshot()["recompiles"]
    rng = np.random.RandomState(0)
    for n in (1, 2, 3, 5, 9, 63, 65, 511, 513, 4096):
        predictor.predict(rng.randn(n, predictor.num_features))
    assert predictor.stats.snapshot()["recompiles"] == r0


# -- the micro-batcher --------------------------------------------------------

def test_batcher_concurrent_submitters(booster, predictor):
    rng = np.random.RandomState(7)
    inputs = [rng.randn(1 + (i * 13) % 40, 6) for i in range(24)]
    refs = [booster.predict(Xs) for Xs in inputs]
    mb = MicroBatcher(lambda X, raw: predictor.predict(X, raw_score=raw),
                      max_wait_ms=5.0)
    try:
        outs = [None] * len(inputs)

        def worker(lo, hi):
            for i in range(lo, hi):
                outs[i] = mb.predict(inputs[i], timeout_s=60)

        threads = [threading.Thread(target=worker, args=(i * 3, i * 3 + 3))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        for out, ref in zip(outs, refs):
            np.testing.assert_array_equal(out, ref)
    finally:
        mb.close()


def test_batcher_bad_request_does_not_poison_batch(predictor):
    mb = MicroBatcher(lambda X, raw: predictor.predict(X, raw_score=raw),
                      max_wait_ms=20.0)
    try:
        good = mb.submit(np.zeros((2, 6), np.float32))
        bad = mb.submit(np.zeros((2, 9), np.float32))   # wrong width
        assert good.result(timeout=30).shape == (2,)
        with pytest.raises(ValueError, match="features"):
            bad.result(timeout=30)
    finally:
        mb.close()


# -- the registry -------------------------------------------------------------

def test_registry_basics(booster):
    reg = ModelRegistry(device="cpu")
    with pytest.raises(KeyError):
        reg.get()
    reg.load("a", booster, warmup=False)
    assert reg.get() is reg.get("a")
    reg.load("b", booster, warmup=False)
    with pytest.raises(KeyError):
        reg.get()
    info = reg.info()
    assert set(info) == {"a", "b"} and info["a"]["version"] == 1
    assert info["a"]["device"] == "cpu"
    assert reg.evict("a") and not reg.evict("a")
    assert reg.names() == ["b"]


@pytest.mark.parametrize("compiler", ["auto", "dense"])
def test_registry_hot_swap_atomic(binary_data, compiler):
    """Readers racing a rollout see exactly one version's output; stats
    carry over the swaps."""
    X, y = binary_data
    p = {**SMALL, "objective": "binary"}
    b1 = lt.train(p, lt.Dataset(X, y), 5, device="cpu")
    b2 = lt.train(p, lt.Dataset(X, y), 9, device="cpu")
    Xq = np.random.RandomState(11).randn(9, 6)
    reg = ModelRegistry(device="cpu")
    reg.load("m", b1, warmup=False, compiler=compiler)
    ref1 = reg.get("m").predict(Xq)
    reg.load("m", b2, warmup=False, compiler=compiler)
    ref2 = reg.get("m").predict(Xq)
    assert not np.array_equal(ref1, ref2)
    before = reg.stats()["m"]["batches"]
    bad = []
    stop = threading.Event()

    def reader():
        while not stop.is_set():
            out = reg.get("m").predict(Xq)
            if not (np.array_equal(out, ref1) or np.array_equal(out, ref2)):
                bad.append(out)

    readers = [threading.Thread(target=reader) for _ in range(4)]
    for t in readers:
        t.start()
    for i in range(6):
        reg.load("m", b1 if i % 2 == 0 else b2, warmup=False,
                 compiler=compiler)
    stop.set()
    for t in readers:
        t.join(60)
    assert not bad, "a hot swap produced mixed-version outputs"
    assert reg.stats()["m"]["batches"] > before
    assert reg.info()["m"]["version"] == 8


def test_registry_failed_load_leaves_old_serving(tmp_path, binary_data,
                                                 model_file):
    from lightgbm_tpu_torch.models.model_text import ModelCorruptError
    X, _ = binary_data
    with open(model_file) as fh:
        text = fh.read()
    corrupt = str(tmp_path / "corrupt.txt")
    with open(corrupt, "w") as fh:
        fh.write(text[: len(text) // 3])
    reg = ModelRegistry(device="cpu")
    reg.load("m", model_file, warmup=False)
    ref = reg.get("m").predict(X[:5])
    batches = reg.stats()["m"]["batches"]
    with pytest.raises(ModelCorruptError):
        reg.load("m", corrupt, warmup=False)
    np.testing.assert_array_equal(reg.get("m").predict(X[:5]), ref)
    info = reg.info()["m"]
    assert info["version"] == 1 and info["source"] == model_file
    assert reg.stats()["m"]["batches"] == batches + 1
    reg2 = ModelRegistry(device="cpu")
    with pytest.raises(ModelCorruptError):
        reg2.load("x", corrupt, warmup=False)
    assert reg2.names() == [] and reg2.stats() == {}


def _slow_registry(model_file, delay):
    reg = ModelRegistry(device="cpu")
    reg.load("model", model_file, warmup=True)
    pred = reg.get("model")
    orig = pred.predict

    def slow_predict(X, raw_score=False, request_ids=()):
        time.sleep(delay)
        return orig(X, raw_score=raw_score, request_ids=request_ids)
    pred.predict = slow_predict
    return reg


def test_shutdown_drain_exactly_one_terminal_response(binary_data,
                                                      model_file):
    """Requests racing ``shutdown()`` each get one terminal response: a
    result, or a typed 5xx from the draining path, never a hang."""
    X, _ = binary_data
    reg = _slow_registry(model_file, delay=0.15)
    srv = PredictionServer(reg, port=0, max_wait_ms=0.5,
                           max_batch_rows=1).start()
    row = X[0].tolist()
    results = []
    lock = threading.Lock()

    def hit():
        conn = _conn(srv)
        try:
            out = _post(conn, "/predict", {"rows": [row]})
        except Exception as exc:      # severed mid-drain: terminal too
            out = ("conn_error", type(exc).__name__)
        with lock:
            results.append(out)
        conn.close()

    threads = [threading.Thread(target=hit) for _ in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.2)
    srv.shutdown()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    statuses = [r[0] for r in results]
    assert len(statuses) == 8
    assert all(s in (200, 503, 504, "conn_error") for s in statuses)
    assert statuses.count(200) >= 1


# -- HTTP end to end ----------------------------------------------------------

def test_serve_http_end_to_end(tmp_path, binary_data, booster, model_file):
    X, y = binary_data
    reg = ModelRegistry(device="cpu")
    reg.load("model", model_file, warmup=True)
    srv = PredictionServer(reg, port=0, max_wait_ms=0.5).start()
    try:
        conn = _conn(srv)
        status, health = _get(conn, "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["models"] == ["model"] and health["device"] == "cpu"
        status, models = _get(conn, "/models")
        assert status == 200 and models["model"]["num_trees"] == 15
        recompiles0 = _get(conn, "/stats")[1]["model"]["recompiles"]
        text = open(model_file).read()
        ref = lgb.Booster(model_str=text)
        for n in (1, 7, 64, 600):
            status, body = _post(conn, "/predict", {"rows": X[:n].tolist()})
            assert status == 200 and body["num_rows"] == n
            got = np.asarray(body["predictions"], np.float32)
            np.testing.assert_array_equal(got, booster.predict(X[:n]))
            np.testing.assert_allclose(got, ref.predict(X[:n]), rtol=1e-6,
                                       atol=1e-7)
        for _ in range(50):
            assert _post(conn, "/predict", {"row": X[3].tolist()})[0] == 200
        stats = _get(conn, "/stats")[1]["model"]
        assert stats["recompiles"] == recompiles0
        assert stats["requests"] >= 54
        assert stats["saturation"]["queue_rows"] == 0
        # /explain: the pred_contrib layout of the port's Booster
        status, body = _post(conn, "/explain", {"rows": X[:4].tolist()})
        assert status == 200
        np.testing.assert_allclose(
            np.asarray(body["contributions"]),
            booster.predict(X[:4], pred_contrib=True), rtol=1e-5,
            atol=1e-6)
        # the observability endpoints
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        metrics = resp.read().decode()
        assert resp.status == 200
        from lightgbm_tpu_torch.serve.loadgen import (metric_sum,
                                                      parse_prometheus)
        parsed = parse_prometheus(metrics)
        assert metric_sum(parsed, "lgbm_tpu_serve_predict_responses_total",
                          code="200") >= 54
        status, slo = _get(conn, "/slo")
        assert status == 200 and slo["schema"] == "slo-report-v1"
        # error paths
        assert _post(conn, "/predict", {})[0] == 400
        assert _post(conn, "/predict", {"rows": [[1.0, 2.0]]})[0] == 400
        assert _post(conn, "/predict", {"rows": [X[0].tolist()],
                                        "model": "nope"})[0] == 404
        assert _get(conn, "/bogus")[0] == 404
        # a hot swap over HTTP
        p = {**SMALL, "objective": "binary"}
        b2 = lt.train(p, lt.Dataset(X, y), 7, device="cpu")
        model2 = str(tmp_path / "model2.txt")
        b2.save_model(model2)
        status, info = _post(conn, "/models", {"name": "model",
                                               "file": model2})
        assert status == 200 and info["num_trees"] == 7
        _, body = _post(conn, "/predict", {"row": X[0].tolist()})
        assert np.float32(body["predictions"][0]) == b2.predict(X[:1])[0]
    finally:
        srv.shutdown()


def test_program_failure_is_a_500_not_a_reroute(binary_data, model_file):
    """A device program that fails fails its request with a 500; the
    server never answers from another path."""
    X, _ = binary_data
    reg = ModelRegistry(device="cpu")
    reg.load("model", model_file, warmup=False)
    pred = reg.get("model")

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")
    pred.predict_raw = broken
    srv = PredictionServer(reg, port=0, max_wait_ms=0.5).start()
    try:
        status, body = _post(_conn(srv), "/predict",
                             {"rows": X[:3].tolist()})
        assert status == 500 and "illegal memory access" in body["error"]
        assert reg.stats()["model"]["errors"] >= 1
    finally:
        srv.shutdown()


def test_load_and_delta_failures_on_the_device_are_500(tmp_path,
                                                       binary_data,
                                                       model_file):
    """``POST /models`` and ``POST /models/<name>/delta`` answer 500 when
    lowering or extending the program fails on the device; an unreadable
    file stays a 400 and a corrupt record a 409, as in the reference."""
    import base64
    X, _ = binary_data
    reg = ModelRegistry(device="cpu")
    reg.load("model", model_file, warmup=False)
    srv = PredictionServer(reg, port=0, max_wait_ms=0.5).start()
    try:
        conn = _conn(srv)
        missing = str(tmp_path / "missing.txt")
        assert _post(conn, "/models", {"name": "model",
                                       "file": missing})[0] == 400
        bad = base64.b64encode(b"not a record").decode("ascii")
        assert _post(conn, "/models/model/delta",
                     {"record_b64": bad})[0] == 409

        def oom(*a, **k):
            raise RuntimeError("CUDA out of memory")
        reg.load = oom
        reg.apply_delta = oom
        status, body = _post(conn, "/models", {"name": "model",
                                               "file": model_file})
        assert status == 500 and "out of memory" in body["error"]
        status, body = _post(conn, "/models/model/delta",
                             {"record_b64": bad})
        assert status == 500 and "out of memory" in body["error"]
        assert _post(conn, "/predict", {"rows": X[:2].tolist()})[0] == 200
    finally:
        srv.shutdown()


def test_explain_additivity_failure_is_a_500(binary_data, model_file,
                                             monkeypatch):
    """A dense TreeSHAP result whose rows do not sum to the raw score
    fails its /explain request with a 500; the host walk does not answer
    it."""
    from lightgbm_tpu_torch.explain import dense_shap as tds
    from lightgbm_tpu_torch.explain.compiler import EXPLAIN_FALLBACK_BATCHES
    from lightgbm_tpu_torch.telemetry.metrics import default_registry

    def walk_batches():
        return sum(v for _l, v in default_registry().counter(
            EXPLAIN_FALLBACK_BATCHES, labels=("reason", "model")).series())
    X, _ = binary_data
    real = tds._unwound_contribs
    monkeypatch.setattr(tds, "_unwound_contribs",
                        lambda *a: 2.0 * real(*a))
    reg = ModelRegistry(device="cpu")
    reg.load("model", model_file, warmup=False)
    walked = walk_batches()
    srv = PredictionServer(reg, port=0, max_wait_ms=0.5).start()
    try:
        status, body = _post(_conn(srv), "/explain",
                             {"rows": X[:3].tolist()})
        assert status == 500, body
        assert "ExplainAdditivityError" in body["error"]
        assert reg.get("model").info()["explain_compiler"] == "dense"
        assert walk_batches() == walked
    finally:
        srv.shutdown()


def test_load_shed_503_and_degraded_healthz(binary_data, model_file):
    X, _ = binary_data
    reg = _slow_registry(model_file, delay=0.3)
    srv = PredictionServer(reg, port=0, max_wait_ms=0.5, max_batch_rows=4,
                           max_queue_rows=4).start()
    try:
        row = X[0].tolist()
        results = []
        lock = threading.Lock()

        def hit():
            conn = _conn(srv)
            out = _post(conn, "/predict", {"rows": [row]}, headers=True)
            with lock:
                results.append(out)
            conn.close()

        threads = [threading.Thread(target=hit) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        statuses = [r[0] for r in results]
        assert statuses.count(200) >= 1 and statuses.count(503) >= 1
        shed = next(r for r in results if r[0] == 503)
        assert "queue is full" in shed[1]["error"]
        assert int(shed[2]["Retry-After"]) >= 1
        status, health = _get(_conn(srv), "/healthz")
        assert status == 200 and health["status"] == "degraded"
        assert any("shedding" in r for r in health["reasons"])
    finally:
        srv.shutdown()


def test_deadline_504(binary_data, model_file):
    X, _ = binary_data
    reg = _slow_registry(model_file, delay=0.5)
    srv = PredictionServer(reg, port=0, max_wait_ms=0.5,
                           max_batch_rows=1).start()
    try:
        row = X[0].tolist()
        occupier = threading.Thread(target=lambda: _post(
            _conn(srv), "/predict", {"rows": [row]}))
        occupier.start()
        time.sleep(0.15)
        conn = _conn(srv)
        status, body = _post(conn, "/predict",
                             {"rows": [row], "deadline_ms": 100})
        assert status == 504, body
        occupier.join(60)
        assert _post(conn, "/predict", {"rows": [row]})[0] == 200
    finally:
        srv.shutdown()


def test_chaos_drop_connection(binary_data, model_file):
    """The serve-side fault point severs every 2nd /predict connection
    without a response; the others answer."""
    from lightgbm_tpu_torch.resilience.faults import faults
    X, _ = binary_data
    reg = ModelRegistry(device="cpu")
    reg.load("model", model_file, warmup=False)
    srv = PredictionServer(reg, port=0, max_wait_ms=0.5).start()
    faults.configure("serve_drop_conn=2")
    try:
        outcomes = []
        for _ in range(4):
            try:
                outcomes.append(_post(_conn(srv, timeout=10), "/predict",
                                      {"row": X[0].tolist()})[0])
            except (http.client.HTTPException, OSError):
                outcomes.append("dropped")
        assert outcomes == [200, "dropped", 200, "dropped"]
    finally:
        faults.clear()
        srv.shutdown()


# -- the device rule ----------------------------------------------------------

@NO_CARD
def test_entry_points_raise_without_a_card(model_file):
    from lightgbm_tpu_torch.cli import main as port_main
    from lightgbm_tpu_torch.serve import ModelZoo
    from lightgbm_tpu_torch.serve.predictor import CompiledPredictor
    for build in (lambda: ModelRegistry(), lambda: PredictionServer(port=0),
                  lambda: ModelZoo(),
                  lambda: CompiledPredictor(model_file),
                  lambda: PredictionServer(ModelRegistry(device="cpu"),
                                           port=0, device="cuda"),
                  lambda: port_main(["serve", model_file, "port=0"]),
                  lambda: port_main(["task=serve",
                                     f"input_model={model_file}",
                                     "port=0"])):
        with pytest.raises(DeviceUnavailableError):
            build()


def test_device_loss_fault_raises_and_never_pins_the_cpu():
    from lightgbm_tpu_torch.resilience.faults import faults
    faults.configure({"device_loss": 1})
    try:
        with pytest.raises(DeviceUnavailableError, match="device_loss"):
            ModelRegistry(device="cuda")
        assert ModelRegistry(device="cpu").device.type == "cpu"
    finally:
        faults.clear()


# -- the CLI (subprocesses) ---------------------------------------------------

def _spawn(argv, port_file):
    env = {**os.environ, "PYTHONPATH": REPO, "PYTHONUNBUFFERED": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "lightgbm_tpu_torch", *argv,
         f"port_file={port_file}"], cwd=REPO, env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        try:
            with open(port_file) as fh:
                return proc, int(fh.read().strip())
        except (OSError, ValueError):
            if proc.poll() is not None:
                break
            time.sleep(0.05)
    proc.kill()
    proc.wait(30)
    raise AssertionError("port_file never appeared")


@pytest.mark.slow
@pytest.mark.parametrize("verb", ["serve", "task=serve"])
def test_serve_cli_subprocess_sigterm_exits_143(tmp_path, booster,
                                                binary_data, model_file,
                                                verb):
    """``python -m lightgbm_tpu_torch serve model.txt device_type=cpu``
    (or ``task=serve input_model=...``) announces its port, answers
    /predict bitwise as the port's Booster, and on SIGTERM drains and
    exits 128 + 15."""
    X, _ = binary_data
    argv = ([verb, model_file] if verb == "serve" else
            [verb, f"input_model={model_file}"])
    proc, port = _spawn(argv + ["port=0", "warmup=0", "device_type=cpu"],
                        str(tmp_path / "serve.port"))
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        status, body = _post(conn, "/predict", {"rows": X[:5].tolist()})
        assert status == 200
        np.testing.assert_array_equal(
            np.asarray(body["predictions"], np.float32),
            booster.predict(X[:5]))
        assert _get(conn, "/healthz")[1]["device"] == "cpu"
        conn.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 128 + signal.SIGTERM
        with pytest.raises(OSError):
            late = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            late.request("GET", "/healthz")
            late.getresponse()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
