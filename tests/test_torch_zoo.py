"""The port's model zoo (``serve/zoo.py``) on the CPU.

The reference's ``tests/test_zoo.py`` cases that are not about jaxprs or
tree sharding (``tpu_predict_shard`` over several cards is ROADMAP queue
1 item 10), on ``device="cpu"``:

* a tenant served through the stacked cross-model program answers
  bitwise as its solo predictor, across bucket boundaries, with
  quantized leaves, in one concurrent super-batch, and beside a walk
  tenant that never stacks; and within rtol 1e-6 of the reference's
  ``ModelZoo`` loaded from the same model files, on the same rows (the
  two packages' float rounding differs, ROADMAP queue 3 item 9);
* one compile key per (stack, bucket);
* an in-envelope delta splices one lane: no new compile key, the
  co-tenant's answers unchanged;
* cold load on a miss and counted capacity eviction; eviction under
  traffic gives correct answers or typed errors, never a torn one; the
  per-tenant quota sheds before the shared queue; churn keeps the
  compile keys and the metric series bounded; ``info`` / ``zoo_stats``;
* the server in zoo mode over HTTP.

The parity cases, the delta splice and the HTTP case also hold the
answers against the reference's zoo.
"""

import http.client
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu.serve.zoo import ModelZoo as RefZoo
from lightgbm_tpu_torch.publish.delta import DeltaJournal
from lightgbm_tpu_torch.resilience.admission import (DeadlineExceeded,
                                                     QueueFullError,
                                                     ServerClosed)
from lightgbm_tpu_torch.serve.batcher import TenantQueueFull
from lightgbm_tpu_torch.serve.predictor import compile_key_count
from lightgbm_tpu_torch.serve.registry import ModelRegistry
from lightgbm_tpu_torch.serve.zoo import ModelZoo
from lightgbm_tpu_torch.telemetry.metrics import default_registry

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

SMALL = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1}
BOUNDARY_NS = (1, 7, 8, 9, 63, 64, 65)


def _train_variant(binary_data, seed, rounds=5, **extra):
    """One tenant: the same features and per-seed label noise, so the
    ensembles differ and the lowered table shapes coincide."""
    X, y = binary_data
    yv = np.asarray(y, np.float64)
    if seed:
        rng = np.random.RandomState(seed)
        yv = np.where(rng.rand(len(yv)) < 0.08, 1.0 - yv, yv)
    p = {**SMALL, "objective": "binary", **extra}
    return lt.train(p, lt.Dataset(X, yv), rounds, device="cpu")


def _model_dir(tmp_path, binary_data, names, **extra):
    d = tmp_path / "models"
    d.mkdir(exist_ok=True)
    for i, name in enumerate(names):
        _train_variant(binary_data, seed=i, **extra).save_model(
            str(d / f"{name}.txt"))
    return str(d)


def _zoo(**kw):
    kw.setdefault("stacking", True)
    return ModelZoo(device="cpu", **kw)


def _solo():
    return ModelRegistry(device="cpu")


def _ref_zoo(model_dir, names, **kwargs):
    """The reference's zoo over the same model files, stacking on."""
    ref = RefZoo(stacking=True, batching=False)
    for n in names:
        ref.load(n, os.path.join(model_dir, f"{n}.txt"), **kwargs)
    return ref


def _assert_matches_reference(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def _series_total() -> int:
    return sum(len(m.series()) for m in default_registry().collect())


@pytest.mark.parametrize("kwargs", [{}, {"leaf_bits": 8}],
                         ids=["dense", "quantized-leaf8"])
def test_stacked_parity_bitwise(tmp_path, binary_data, kwargs):
    X, _ = binary_data
    names = ["m0", "m1", "m2"]
    d = _model_dir(tmp_path, binary_data, names)
    zoo = _zoo(batching=True, max_wait_ms=1.0)
    try:
        for n in names:
            zoo.load(n, os.path.join(d, f"{n}.txt"), **kwargs)
        groups = zoo.stack_membership()
        assert groups and sorted(sum(groups.values(), [])) == names
        solo = _solo()
        for n in names:
            solo.load(n, os.path.join(d, f"{n}.txt"), warmup=False,
                      **kwargs)
        ref = _ref_zoo(d, names, **kwargs)
        assert sorted(sum(ref.stack_membership().values(), [])) == names
        rng = np.random.RandomState(0)
        for rows in BOUNDARY_NS:
            Xq = rng.randn(rows, X.shape[1]).astype(np.float32)
            for n in names:
                for raw in (False, True):
                    got = zoo.predict(n, Xq, raw_score=raw)
                    np.testing.assert_array_equal(
                        got, solo.get(n).predict(Xq, raw_score=raw))
                    _assert_matches_reference(
                        got, ref.predict(n, Xq, raw_score=raw))
        ref.close()
    finally:
        zoo.close()


def test_stacked_parity_concurrent_super_batch(tmp_path, binary_data):
    X, _ = binary_data
    names = ["m0", "m1", "m2", "m3"]
    d = _model_dir(tmp_path, binary_data, names)
    zoo = _zoo(batching=True, max_wait_ms=25.0)
    solo = _solo()
    try:
        for n in names:
            zoo.load(n, os.path.join(d, f"{n}.txt"))
            solo.load(n, os.path.join(d, f"{n}.txt"), warmup=False)
        rng = np.random.RandomState(1)
        queries = {n: rng.randn(5 + i, X.shape[1]).astype(np.float32)
                   for i, n in enumerate(names)}
        for n in names:
            zoo.predict(n, queries[n])
        batches0 = sum(v for _l, v in default_registry().get(
            "zoo_stack_batches_total").series())
        results, errs = {}, []

        def hit(n):
            try:
                results[n] = zoo.predict(n, queries[n], timeout_s=30)
            except Exception as exc:  # noqa: BLE001 - asserted below
                errs.append((n, exc))
        threads = [threading.Thread(target=hit, args=(n,)) for n in names]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not errs
        ref = _ref_zoo(d, names)
        for n in names:
            np.testing.assert_array_equal(results[n],
                                          solo.get(n).predict(queries[n]))
            _assert_matches_reference(results[n],
                                      ref.predict(n, queries[n]))
        ref.close()
        batches = sum(v for _l, v in default_registry().get(
            "zoo_stack_batches_total").series()) - batches0
        assert 1 <= batches < len(names), "the window never coalesced"
    finally:
        zoo.close()


def test_walk_tenant_serves_but_never_stacks(tmp_path, binary_data):
    X, _ = binary_data
    d = _model_dir(tmp_path, binary_data, ["m0", "m1"])
    zoo = _zoo(batching=True, max_wait_ms=1.0)
    try:
        zoo.load("m0", os.path.join(d, "m0.txt"))
        zoo.load("m1", os.path.join(d, "m1.txt"))
        zoo.load("w0", os.path.join(d, "m0.txt"), compiler="walk")
        info = zoo.info()
        assert not info["w0"]["stackable"] and info["w0"]["stack"] is None
        assert sorted(sum(zoo.stack_membership().values(), [])) == \
            ["m0", "m1"]
        solo = _solo()
        solo.load("ref", os.path.join(d, "m0.txt"), warmup=False,
                  compiler="walk")
        Xq = X[:9].astype(np.float32)
        np.testing.assert_array_equal(zoo.predict("w0", Xq),
                                      solo.get("ref").predict(Xq))
    finally:
        zoo.close()


def test_one_compile_key_per_stack_bucket(tmp_path, binary_data):
    X, _ = binary_data
    names = ["m0", "m1", "m2"]
    d = _model_dir(tmp_path, binary_data, names)
    zoo = _zoo(batching=True, max_wait_ms=1.0)
    try:
        for n in names:
            zoo.load(n, os.path.join(d, f"{n}.txt"))
        rng = np.random.RandomState(2)
        before = compile_key_count()
        for n in names:                 # the 8-row bucket
            zoo.predict(n, rng.randn(5, X.shape[1]))
        assert compile_key_count() == before + 1
        for n in names:                 # the 64-row bucket
            zoo.predict(n, rng.randn(33, X.shape[1]))
        assert compile_key_count() == before + 2
    finally:
        zoo.close()


def test_apply_delta_splices_one_lane_zero_recompiles(tmp_path,
                                                      binary_data):
    """``shard=4`` pads the 1-tree base to capacity 4 on the one device:
    the delta splices tenant a's lane only, with no new compile key, and
    tenant b answers as before."""
    X, y = binary_data
    jdir = tmp_path / "journal"
    p = {**SMALL, "objective": "binary", "publish_dir": str(jdir),
         "publish_every": 1}
    bst = lt.train(p, lt.Dataset(X, y), 2, device="cpu")
    mfile = str(tmp_path / "model.txt")
    bst.save_model(mfile)
    j = DeltaJournal(str(jdir))
    base_path, base_round = j.base_entry()
    zoo = _zoo(batching=True, max_wait_ms=1.0)
    try:
        zoo.load("a", base_path, shard=4)
        zoo.load("b", base_path, shard=4)
        pa, pb = zoo.peek("a"), zoo.peek("b")
        assert pa.stackable and pa.info()["dense"]["capacity"] == 4
        sig = pa.signature
        stack_before = zoo.current_stack(sig)
        assert stack_before.width == 2
        rng = np.random.RandomState(3)
        queries = [rng.randn(n, X.shape[1]).astype(np.float32)
                   for n in (1, 7, 9)]
        b_before = [zoo.predict("b", Xq) for Xq in queries]
        for Xq in queries:
            zoo.predict("a", Xq)
        (rec,) = j.records_after(base_round)
        cold = _solo()
        cold.load("cold", mfile, warmup=False, num_iteration=rec.round)
        a_refs = [cold.get("cold").predict(Xq) for Xq in queries]
        keys = compile_key_count()
        recompiles = pb.stats.snapshot()["recompiles"]
        assert zoo.apply_delta("a", rec)["mode"] == "extend"
        stack_after = zoo.current_stack(sig)
        assert stack_after is not stack_before
        assert stack_after.signature == stack_before.signature
        for Xq, ref in zip(queries, a_refs):
            np.testing.assert_array_equal(zoo.predict("a", Xq), ref)
        for Xq, ref in zip(queries, b_before):
            np.testing.assert_array_equal(zoo.predict("b", Xq), ref)
        assert compile_key_count() == keys
        assert zoo.peek("b").stats.snapshot()["recompiles"] == recompiles
        # the reference's zoo, folding the same journal record
        from lightgbm_tpu.publish.delta import DeltaJournal as RefJournal
        ref = RefZoo(stacking=True, batching=False)
        ref.load("a", base_path, shard=4)
        ref.load("b", base_path, shard=4)
        (ref_rec,) = RefJournal(str(jdir)).records_after(base_round)
        assert ref.apply_delta("a", ref_rec)["mode"] == "extend"
        for Xq in queries:
            for n in ("a", "b"):
                _assert_matches_reference(zoo.predict(n, Xq),
                                          ref.predict(n, Xq))
        ref.close()
    finally:
        zoo.close()


def test_cold_load_on_miss_and_capacity_eviction(tmp_path, binary_data):
    X, _ = binary_data
    d = _model_dir(tmp_path, binary_data, ["m0", "m1", "m2"])
    zoo = _zoo(max_resident=2, source_resolver=d, batching=False)
    try:
        evi = default_registry().get("zoo_evictions_total")
        cold = default_registry().get("zoo_cold_loads_total")
        evi_0 = sum(v for lbl, v in evi.series()
                    if lbl.get("reason") == "capacity")
        cold_0 = sum(v for _lbl, v in cold.series())
        Xq = X[:4].astype(np.float32)
        assert zoo.predict("m0", Xq).shape == (4,)
        zoo.predict("m1", Xq)
        zoo.predict("m0", Xq)               # m0 hotter than m1
        zoo.predict("m2", Xq)               # evicts the coldest: m1
        assert sorted(zoo.registry.names()) == ["m0", "m2"]
        assert sum(v for _lbl, v in cold.series()) == cold_0 + 3
        assert sum(v for lbl, v in evi.series()
                   if lbl.get("reason") == "capacity") == evi_0 + 1
        with pytest.raises(KeyError, match="nope"):
            zoo.predict("nope", Xq)
        assert zoo.predict("m1", Xq).shape == (4,)
    finally:
        zoo.close()


def test_eviction_under_traffic_never_torn(tmp_path, binary_data):
    X, _ = binary_data
    names = [f"m{i}" for i in range(6)]
    d = _model_dir(tmp_path, binary_data, names, rounds=3)
    zoo = _zoo(max_resident=3, source_resolver=d, batching=True,
               max_wait_ms=1.0)
    solo = _solo()
    Xq = np.random.RandomState(4).randn(5, X.shape[1]).astype(np.float32)
    refs = {}
    for n in names:
        solo.load(n, os.path.join(d, f"{n}.txt"), warmup=False)
        refs[n] = solo.get(n).predict(Xq)
    torn, ok = [], [0]
    stop = time.monotonic() + 1.5
    lock = threading.Lock()

    def worker(wid):
        r = np.random.RandomState(wid)
        while time.monotonic() < stop:
            n = names[min(int(r.zipf(1.5)) - 1, 5)]
            try:
                got = zoo.predict(n, Xq, timeout_s=10.0)
            except (ServerClosed, DeadlineExceeded, QueueFullError,
                    KeyError):
                continue
            except Exception as exc:  # noqa: BLE001 - asserted below
                with lock:
                    torn.append((n, repr(exc)))
                continue
            with lock:
                if np.array_equal(got, refs[n]):
                    ok[0] += 1
                else:
                    torn.append((n, "wrong bytes"))
    threads = [threading.Thread(target=worker, args=(w,)) for w in range(6)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not torn, torn[:5]
        assert ok[0] > 20
        evi = default_registry().get("zoo_evictions_total")
        assert sum(v for lbl, v in evi.series()
                   if lbl.get("reason") == "capacity") > 0
    finally:
        zoo.close()


def test_tenant_quota_sheds_before_shared_queue(tmp_path, binary_data):
    X, _ = binary_data
    d = _model_dir(tmp_path, binary_data, ["m0", "m1"])
    zoo = _zoo(batching=True, max_wait_ms=1.0, tenant_queue_rows=4,
               max_queue_rows=1024)
    try:
        zoo.load("m0", os.path.join(d, "m0.txt"))
        zoo.load("m1", os.path.join(d, "m1.txt"))
        shed = default_registry().get("zoo_tenant_shed_total")
        shed_0 = sum(v for lbl, v in shed.series()
                     if lbl.get("model") == "m0")
        with pytest.raises(TenantQueueFull):
            zoo.predict("m0", np.zeros((8, X.shape[1]), np.float32))
        assert sum(v for lbl, v in shed.series()
                   if lbl.get("model") == "m0") == shed_0 + 1
        assert zoo.predict("m1", np.zeros((3, X.shape[1]),
                                          np.float32)).shape == (3,)
    finally:
        zoo.close()


def test_churn_keeps_compile_keys_and_series_bounded(tmp_path,
                                                     binary_data):
    X, _ = binary_data
    d = _model_dir(tmp_path, binary_data, ["m0", "m1"])
    Xq = np.zeros((3, X.shape[1]), np.float32)

    def one_lap():
        zoo = _zoo(batching=True, max_wait_ms=1.0)
        try:
            zoo.load("churn-a", os.path.join(d, "m0.txt"))
            zoo.load("churn-b", os.path.join(d, "m1.txt"))
            zoo.predict("churn-a", Xq)
            zoo.predict("churn-b", Xq)
            assert zoo.evict("churn-a") and zoo.evict("churn-b")
        finally:
            zoo.close()

    one_lap()
    keys_1, series_1 = compile_key_count(), _series_total()
    for _ in range(3):
        one_lap()
    assert compile_key_count() == keys_1
    assert _series_total() == series_1


def test_evict_releases_stack_and_member_keys(tmp_path, binary_data):
    X, _ = binary_data
    d = _model_dir(tmp_path, binary_data, ["m0", "m1"])
    before = compile_key_count()
    zoo = _zoo(batching=True, max_wait_ms=1.0)
    try:
        zoo.load("m0", os.path.join(d, "m0.txt"))
        zoo.load("m1", os.path.join(d, "m1.txt"))
        zoo.predict("m0", np.zeros((3, X.shape[1]), np.float32))
        assert compile_key_count() > before
        assert zoo.evict("m0") and zoo.stack_membership() == {}
        assert zoo.evict("m1")
        assert compile_key_count() == before
    finally:
        zoo.close()


def test_info_reports_group_and_stack_membership(tmp_path, binary_data):
    d = _model_dir(tmp_path, binary_data, ["m0", "m1"])
    zoo = _zoo(batching=False, max_resident=8)
    try:
        zoo.load("m0", os.path.join(d, "m0.txt"))
        zoo.load("m1", os.path.join(d, "m1.txt"))
        info = zoo.info()
        for n in ("m0", "m1"):
            ent = info[n]
            assert ent["stackable"] is True
            assert ent["group_key"] == zoo.peek(n).group_key
            assert ent["stack"]["members"] == ["m0", "m1"]
            assert ent["stack"]["lane"] == ("m0", "m1").index(n)
            assert ent["stack"]["group"] in zoo.stack_membership()
        zs = zoo.zoo_stats()
        assert zs["resident"] == 2 and zs["max_resident"] == 8
        assert sorted(sum(zs["groups"].values(), [])) == ["m0", "m1"]
        assert set(zs["traffic_weight"]) == {"m0", "m1"}
    finally:
        zoo.close()


def test_server_zoo_mode_over_http(tmp_path, binary_data):
    """``PredictionServer(zoo=...)``: a cold load on a miss inside the
    request, stacked answers equal to solo, ``/stats`` carries ``_zoo``."""
    from lightgbm_tpu_torch.serve.server import PredictionServer
    X, _ = binary_data
    d = _model_dir(tmp_path, binary_data, ["m0", "m1"])
    zoo = _zoo(source_resolver=d, batching=True, max_wait_ms=1.0)
    srv = PredictionServer(zoo=zoo, port=0).start()
    solo = _solo()
    ref = _ref_zoo(d, ["m0", "m1"])
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        for n in ("m0", "m1", "m0"):
            solo.load(n, os.path.join(d, f"{n}.txt"), warmup=False)
            body = json.dumps({"rows": X[:6].tolist(), "model": n})
            conn.request("POST", "/predict", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            out = json.loads(resp.read())
            assert resp.status == 200, out
            got = np.asarray(out["predictions"], np.float32)
            np.testing.assert_array_equal(
                got, solo.get(n).predict(X[:6]).astype(np.float32))
            _assert_matches_reference(got, ref.predict(n, X[:6]))
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["_zoo"]["resident"] == 2
        assert sorted(sum(stats["_zoo"]["groups"].values(), [])) == \
            ["m0", "m1"]
    finally:
        ref.close()
        srv.shutdown()
