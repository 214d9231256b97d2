"""The port's flight recorder, train record and telemetry export, held
against the JAX package.

* the reference's ``tests/test_flight.py`` cases: recorder on and off
  write the same text, the ring is bounded, anomalies are flagged, a
  SIGTERM or an injected crash leaves a tape whose last event is the
  checkpoint's iteration, an explicit ``flight_dir`` gets the tape on
  success;
* the recorder keeps the best gain on the device until the tape is read
  (no host read per iteration);
* the train-record and Prometheus-render cases of
  ``tests/test_telemetry.py``, ``/metrics`` end to end, telemetry on and
  off writing the same text, ``profile telemetry_out=``;
* the two packages' tapes of one quantized run agree on iteration,
  ``num_leaves`` and ``best_gain`` (times excluded), and the chunked
  ``train_streamed`` writes its tape into ``flight_dir``.
"""

import http.client
import json
import os
import signal

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch import telemetry
from lightgbm_tpu_torch.telemetry.flight import FlightRecorder

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

PARAMS = {"objective": "binary", "num_leaves": 15, "verbosity": -1,
          "metric": "binary_logloss", "seed": 3}
SMALL = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1}


@pytest.fixture(autouse=True)
def _telemetry_enabled():
    was = telemetry.enabled()
    telemetry.enable()
    yield
    (telemetry.enable if was else telemetry.disable)()


def _data(n=600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = (X[:, 0] + 0.4 * rng.randn(n) > 0).astype(float)
    return X, y


def _train(params, X, y, rounds, **kw):
    return lt.train(params, lt.Dataset(X, y), rounds, device="cpu", **kw)


def _read_tape(path):
    with open(path) as fh:
        lines = [json.loads(ln) for ln in fh]
    assert lines[0]["schema"] == "flight-record-v1"
    return lines[0], lines[1:]


# -- the flight recorder ------------------------------------------------------

def test_flight_recorder_bit_identical_on_off():
    X, y = _data()
    on = _train(PARAMS, X, y, 10)
    off = _train({**PARAMS, "flight_recorder": False}, X, y, 10)
    assert on.model_to_string() == off.model_to_string()
    np.testing.assert_array_equal(on.predict(X), off.predict(X))
    assert len(on._gbdt.flight) == 10
    assert len(off._gbdt.flight) == 0 and not off._gbdt.flight.enabled


def test_flight_keeps_device_scalars_until_read():
    """The best gain stays a tensor in the ring (no host read per
    iteration) and becomes a float when the tape is read."""
    X, y = _data()
    fr = _train(PARAMS, X, y, 3)._gbdt.flight
    raw = [ev["best_gain"] for ev in fr._ring]
    assert all(isinstance(g, torch.Tensor) for g in raw)
    evs = fr.events()
    assert [type(e["best_gain"]) for e in evs] == [float] * 3
    assert [e["best_gain"] for e in evs] == [float(g) for g in raw]


def test_flight_ring_is_bounded_and_events_structured():
    X, y = _data()
    bst = _train({**PARAMS, "flight_events": 6}, X, y, 15,
                 valid_sets=[lt.Dataset(X, y)])
    fr = bst._gbdt.flight
    assert len(fr) == 6
    evs = fr.events()
    assert [e["iteration"] for e in evs] == list(range(10, 16))
    last = evs[-1]
    assert last["num_leaves"] >= 1 and isinstance(last["num_leaves"], int)
    assert isinstance(last["best_gain"], float)
    assert "valid_0 binary_logloss" in last["evals"]
    assert last["loss"] == pytest.approx(
        last["evals"]["valid_0 binary_logloss"])
    assert last["anomaly"] is None


def test_flight_anomaly_detection_nan_and_spike():
    from lightgbm_tpu_torch.telemetry.metrics import default_registry
    fr = FlightRecorder(capacity=64, min_history=2)
    c = default_registry().get("flight_anomalies_total")
    base_nan, base_spike = c.value(kind="nan_loss"), \
        c.value(kind="loss_spike")
    for i in range(1, 6):
        fr.note_iter(i)
        fr.note_eval(i, [("train", "l2", 0.5, False)])
    fr.note_iter(6)
    fr.note_eval(6, [("train", "l2", 50.0, False)])
    fr.note_iter(7)
    fr.note_eval(7, [("train", "l2", float("nan"), False)])
    assert [a["kind"] for a in fr.anomalies] == ["loss_spike", "nan_loss"]
    assert c.value(kind="nan_loss") == base_nan + 1
    assert c.value(kind="loss_spike") == base_spike + 1
    evs = fr.events()
    assert [evs[-2]["anomaly"], evs[-1]["anomaly"]] == \
        ["loss_spike", "nan_loss"]


def test_sigterm_flight_dump_matches_checkpoint_iteration(tmp_path):
    from lightgbm_tpu_torch.resilience.checkpoint import (
        TrainingPreempted, load_checkpoint, resolve_checkpoint)
    X, y = _data()
    ck = str(tmp_path / "ck")

    def killer(env):
        if env.iteration == 5:
            os.kill(os.getpid(), signal.SIGTERM)
    killer.before_iteration = True
    with pytest.raises(TrainingPreempted):
        _train({**PARAMS, "checkpoint_dir": ck}, X, y, 40,
               valid_sets=[lt.Dataset(X, y)], callbacks=[killer])
    header, events = _read_tape(os.path.join(ck, "flight.jsonl"))
    assert header["reason"] == "preempted"
    ckpt = load_checkpoint(resolve_checkpoint(ck))
    assert events[-1]["iteration"] == ckpt.iteration
    assert "evals" in events[-1] and "collective_bytes" in events[-1]


def test_injected_crash_dumps_flight_tape(tmp_path):
    from lightgbm_tpu_torch.resilience.faults import InjectedFault, faults
    X, y = _data()
    ck = str(tmp_path / "ck")
    faults.configure("crash_at_iter=4")
    try:
        with pytest.raises(InjectedFault):
            _train({**PARAMS, "checkpoint_dir": ck}, X, y, 20)
    finally:
        faults.clear()
    header, events = _read_tape(os.path.join(ck, "flight.jsonl"))
    assert header["reason"] == "crash"
    assert events[-1]["iteration"] == 4


def test_explicit_flight_dir_dumps_on_success(tmp_path):
    X, y = _data()
    fd = str(tmp_path / "tape")
    _train({**PARAMS, "flight_dir": fd}, X, y, 6)
    header, events = _read_tape(os.path.join(fd, "flight.jsonl"))
    assert header["reason"] == "completed"
    assert [e["iteration"] for e in events] == list(range(1, 7))


def test_chunked_train_streamed_writes_its_tape(tmp_path):
    from lightgbm_tpu_torch.ingest import (ArraySource, StreamedDataset,
                                           train_streamed)
    X, y = _data(2048, 3, seed=4)
    p = {"objective": "binary", "verbosity": -1, "num_leaves": 7,
         "tpu_speculative_ramp": False, "tpu_exact_endgame": False,
         "tree_grow_mode": "wave", "flight_dir": str(tmp_path / "fl")}
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=p)
    train_streamed(p, sd, 3, device="cpu")
    header, events = _read_tape(str(tmp_path / "fl" / "flight.jsonl"))
    assert header["reason"] == "completed"
    assert header["meta"]["ingest_mode"] == "chunked"
    assert [e["iteration"] for e in events] == [1, 2, 3]
    assert all(e["h2d_bytes"] > 0 for e in events)
    with pytest.raises(NotImplementedError, match="publish_dir"):
        train_streamed({**p, "publish_dir": str(tmp_path / "pub")}, sd, 2,
                       device="cpu")


SLICE = dict(objective="binary", num_leaves=15, verbosity=-1,
             tpu_histogram_impl="pallas", tree_grow_mode="wave",
             use_quantized_grad=True, stochastic_rounding=False)


def test_tapes_agree_with_reference():
    """One quantized run in each package (the slice configuration, whose
    text is byte-identical): the tapes agree on iteration, num_leaves
    and best_gain."""
    rng = np.random.RandomState(0)
    X = rng.randn(6000, 6)
    X[rng.rand(6000, 6) < 0.05] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = (x0 + x1 ** 2 + 0.3 * rng.randn(6000) > 0.8).astype(float)
    port = lt.train(SLICE, lt.Dataset(X, y), 5, device="cpu")
    ref = lgb.train(SLICE, lgb.Dataset(X, y), 5)
    assert port.model_to_string() == ref.model_to_string()
    keys = ("iteration", "num_leaves", "best_gain")
    got = [{k: e[k] for k in keys} for e in port._gbdt.flight.events()]
    want = [{k: e[k] for k in keys} for e in ref._gbdt.flight.events()]
    assert got == want and len(got) == 5


# -- the train record and the exporters ---------------------------------------

def _train_binary(n=400, trees=5, seed=0, extra=None):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6)
    y = (X[:, 0] * 2 + X[:, 1] + 0.5 * rng.randn(n) > 0).astype(np.float64)
    p = {**SMALL, "objective": "binary", **(extra or {})}
    return lt.train(p, lt.Dataset(X, y), trees, device="cpu"), X


def test_train_record_accumulates():
    bst, _ = _train_binary(trees=5)
    rec = bst.train_record
    assert rec is telemetry.last_train_record()
    snap = rec.snapshot()
    assert snap["schema"] == "train-record-v1" and snap["num_trees"] == 5
    assert [r["iteration"] for r in snap["trees"]] == list(range(5))
    for ph in ("gradients", "grow", "record"):
        assert snap["phase_seconds"].get(ph, 0) > 0
        assert snap["phase_calls"][ph] == 5
    assert snap["meta"]["objective"] == "binary"
    assert all(r["num_leaves"] >= 1 for r in snap["trees"])
    # no XLA program: the compile fields keep their names and read empty;
    # the CPU has no device-memory watermark
    assert snap["compile_events"] == {} and snap["compile_seconds"] == {}
    assert snap["device_memory_peak_bytes"] is None


def test_train_record_wave_hist_passes():
    bst, _ = _train_binary(n=600, trees=3,
                           extra={"tree_grow_mode": "wave",
                                  "num_leaves": 13})
    snap = bst.train_record.snapshot()
    hp = [r["hist_passes"] for r in snap["trees"]]
    assert len(hp) == 3 and all(p >= 1 for p in hp)
    assert hp[-1] == int(bst._gbdt.last_hist_passes)
    assert snap["hist_passes_total"] == sum(hp)
    assert snap["hist_passes_last"] == hp[-1]


def test_training_bit_identical_with_telemetry_disabled():
    telemetry.disable()
    try:
        bst_off, X = _train_binary(trees=4, seed=3)
        txt_off = bst_off.model_to_string()
    finally:
        telemetry.enable()
    bst_on, _ = _train_binary(trees=4, seed=3)
    assert bst_on.model_to_string() == txt_off
    assert bst_off.train_record.snapshot()["num_trees"] == 0
    assert bst_on.train_record.snapshot()["num_trees"] == 4


def test_prometheus_render_covers_registry_and_train_record():
    _train_binary(trees=3, seed=5)
    txt = telemetry.render_prometheus()
    assert "# TYPE lgbm_tpu_train_trees_total counter" in txt
    assert "lgbm_tpu_train_trees_total 3" in txt
    assert 'lgbm_tpu_train_phase_seconds_total{phase="grow"}' in txt
    doc = telemetry.render_json()
    assert doc["schema"] == "telemetry-snapshot-v1"
    assert doc["train_record"]["num_trees"] == 3


def test_metrics_endpoint_e2e():
    from lightgbm_tpu_torch.serve import ModelRegistry, PredictionServer
    bst, X = _train_binary(trees=4, seed=7)
    reg = ModelRegistry(device="cpu")
    reg.load("telem_model", bst, warmup=False)
    srv = PredictionServer(reg, port=0, batching=False).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                          timeout=60)
        conn.request("POST", "/predict",
                     json.dumps({"rows": X[:3].tolist()}),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 200
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Content-Type").startswith("text/plain")
        body = resp.read().decode()
        assert 'lgbm_tpu_serve_requests_total{model="telem_model"} 1' \
            in body
        assert 'lgbm_tpu_serve_rows_total{model="telem_model"} 3' in body
        assert 'lgbm_tpu_serve_batch_latency_ms_p50{model="telem_model"}' \
            in body
        assert "lgbm_tpu_train_trees_total 4" in body
    finally:
        srv.shutdown()


def test_profile_cli_verb_telemetry_out(tmp_path):
    """``profile telemetry_out= host_trace_out=`` writes the telemetry
    snapshot and the host span trace where asked."""
    from lightgbm_tpu_torch.cli import main as cli_main
    from lightgbm_tpu_torch.utils.timer import global_timer
    rng = np.random.RandomState(0)
    X = rng.randn(200, 4)
    y = (X[:, 0] > 0).astype(np.float64)
    data = tmp_path / "train.csv"
    np.savetxt(data, np.column_stack([y, X]), delimiter=",", fmt="%.6f")
    out, spans_out = tmp_path / "t.json", tmp_path / "spans.json"
    try:
        rc = cli_main([
            "profile", f"data={data}", "task=train", "objective=binary",
            "num_leaves=4", "min_data_in_leaf=5", "num_iterations=3",
            "header=false", "verbosity=-1", "device_type=cpu",
            f"output_model={tmp_path / 'model.txt'}",
            f"profile_dir={tmp_path / 'prof'}", "torch_trace=0",
            f"telemetry_out={out}", f"host_trace_out={spans_out}"])
    finally:
        telemetry.global_tracer.disable()
        telemetry.global_tracer.clear()
        global_timer.enabled = False
    assert rc == 0
    dump = json.loads(out.read_text())
    assert dump["schema"] == "telemetry-snapshot-v1"
    assert dump["train_record"]["num_trees"] == 3
    spans = json.loads(spans_out.read_text())
    assert any(e["name"].startswith("train/") for e in spans["traceEvents"])
    assert (tmp_path / "model.txt").exists()
