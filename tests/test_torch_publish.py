"""The port's continuous-learning lane held against the JAX package.

* the delta wire format and the journal: the same records give the same
  bytes in both packages' ``publish.delta``, and both refuse the same
  torn, forged or out-of-order records with ``DeltaChainError``;
* a quantized run with ``publish_dir`` (the configuration of
  ``test_torch_slice.py::test_quantized_training_matches_reference``)
  writes journal files byte-identical to the reference's, name for name,
  and each package's subscriber folds the other's journal to the same
  model text;
* the trainer-side publisher: cadence, the completion flush, the restart
  re-anchor, compaction;
* the serving side: a predictor grown round by round through
  ``ModelRegistry.apply_delta`` answers bitwise as a cold load of the
  same round; a delta inside the shard padding's envelope adds no compile
  key and a delta past it rebuilds; the registry's chain guards; the
  server's ``POST /models/<name>/delta`` (409 on a chain mismatch).

Everything runs with ``device="cpu"``.
"""

import base64
import http.client
import json
import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.publish import delta as jdelta
from lightgbm_tpu.publish import subscriber as jsub
from lightgbm_tpu.models.model_text import model_to_string as j_to_string
from lightgbm_tpu_torch.models.model_text import model_to_string
from lightgbm_tpu_torch.publish import delta as tdelta
from lightgbm_tpu_torch.publish import subscriber as tsub
from lightgbm_tpu_torch.publish.delta import (DeltaChainError, DeltaJournal,
                                              DeltaRecord, chain_fingerprint,
                                              fingerprint_text)
from lightgbm_tpu_torch.publish.publisher import DeltaPublisher
from lightgbm_tpu_torch.serve.predictor import compile_key_count
from lightgbm_tpu_torch.serve.registry import ModelInUseError, ModelRegistry

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

SMALL = {"num_leaves": 7, "min_data_in_leaf": 5, "verbosity": -1}
DELTA_MODS = {"port": tdelta, "reference": jdelta}


def _train(data, rounds, publish_dir=None, every=1, **extra):
    X, y = data
    p = {**SMALL, "objective": "binary", **extra}
    if publish_dir is not None:
        p["publish_dir"] = str(publish_dir)
        p["publish_every"] = every
    return lt.train(p, lt.Dataset(X, y, params=p), rounds, device="cpu")


def _cold(text_or_path, **kw):
    reg = ModelRegistry(device="cpu")
    reg.load("m", text_or_path, warmup=False, **kw)
    return reg


# ---------------------------------------------------------------------------
# wire format and journal, both packages
# ---------------------------------------------------------------------------

def _record(mod, payload="tree text", base_round=1, round=2):
    parent = mod.fingerprint_text("base")
    return mod.DeltaRecord(base_round=base_round, round=round,
                           parent_fp=parent,
                           fp=mod.chain_fingerprint(parent, payload),
                           num_tree_per_iteration=1, payload=payload)


def test_record_bytes_equal_reference():
    for payload in ("fragment é text", "Tree=0\nnum_leaves=2\n"):
        ours = _record(tdelta, payload).to_bytes()
        assert ours == _record(jdelta, payload).to_bytes()
        assert tdelta.DeltaRecord.from_bytes(ours) == _record(tdelta,
                                                              payload)
        assert jdelta.DeltaRecord.from_bytes(ours) == _record(jdelta,
                                                              payload)


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_record_wire_guards(pkg):
    mod = DELTA_MODS[pkg]
    rec = _record(mod)
    raw = rec.to_bytes()
    with pytest.raises(mod.DeltaChainError, match="truncated"):
        mod.DeltaRecord.from_bytes(raw[:10])
    with pytest.raises(mod.DeltaChainError, match="magic"):
        mod.DeltaRecord.from_bytes(b"X" * len(raw))
    with pytest.raises(mod.DeltaChainError, match="torn"):
        mod.DeltaRecord.from_bytes(raw[:-3])
    flipped = bytearray(raw)
    flipped[-1] ^= 0xFF
    with pytest.raises(mod.DeltaChainError, match="crc"):
        mod.DeltaRecord.from_bytes(bytes(flipped))
    forged = mod.DeltaRecord(base_round=1, round=2, parent_fp=rec.parent_fp,
                             fp=rec.fp, num_tree_per_iteration=1,
                             payload="tampered")
    with pytest.raises(mod.DeltaChainError, match="fingerprint"):
        mod.DeltaRecord.from_bytes(forged.to_bytes())
    bad = mod.DeltaRecord(base_round=3, round=3, parent_fp=rec.parent_fp,
                          fp=mod.chain_fingerprint(rec.parent_fp, "x"),
                          num_tree_per_iteration=1, payload="x")
    with pytest.raises(mod.DeltaChainError, match="non-monotonic"):
        mod.DeltaRecord.from_bytes(bad.to_bytes())


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_journal_chain_guards(pkg, tmp_path):
    """Chain, append guards, the torn-tail fallback, gap detection and
    compaction; the port's journal directory equals the reference's."""
    mod = DELTA_MODS[pkg]
    j = mod.DeltaJournal(str(tmp_path / "j"))
    assert j.head() is None
    with pytest.raises(mod.DeltaChainError, match="empty"):
        j.append_delta("x", 1)
    fp0 = j.write_base("base text", 2)
    r3 = j.append_delta("round 3 trees", 3)
    r4 = j.append_delta("round 4 trees", 4)
    assert r3.parent_fp == fp0 and r4.parent_fp == r3.fp
    with pytest.raises(mod.DeltaChainError, match="non-monotonic"):
        j.append_delta("x", 4)
    h = j.head()
    assert h.round == 4 and h.fp == r4.fp
    base_text, base_round, records = j.chain()
    assert (base_text, base_round) == ("base text", 2)
    assert [r.round for r in j.records_after(3)] == [4]
    # a torn tail entry: head falls back to the newest intact one
    with open(os.path.join(j.directory, "DELTA.00004"), "wb") as fh:
        fh.write(r4.to_bytes()[:-5])
    assert j.head().round == 3
    with pytest.raises(mod.DeltaChainError, match="torn"):
        j.chain()
    with open(os.path.join(j.directory, "DELTA.00004"), "wb") as fh:
        fh.write(r4.to_bytes())
    os.unlink(os.path.join(j.directory, "DELTA.00003"))
    with pytest.raises(mod.DeltaChainError, match="chain gap"):
        j.chain()
    j.compact("folded", 4)
    assert sorted(os.listdir(j.directory)) == ["BASE.00004.txt", "HEAD"]
    assert j.chain_length() == 0


def test_journal_written_by_either_package_reads_in_the_other(tmp_path):
    for writer, reader in ((tdelta, jdelta), (jdelta, tdelta)):
        d = str(tmp_path / writer.__name__.split(".")[0])
        w = writer.DeltaJournal(d)
        w.write_base("base", 1)
        w.append_delta("two", 2)
        w.append_delta("three", 3)
        text, rnd, recs = reader.DeltaJournal(d).chain()
        assert (text, rnd) == ("base", 1)
        assert [r.to_bytes() for r in recs] == \
            [r.to_bytes() for r in w.chain()[2]]


# ---------------------------------------------------------------------------
# training with publish_dir: byte-identical journals, cross folds
# ---------------------------------------------------------------------------

N, F, ROUNDS = 6000, 6, 5


def _slice_data(seed=0, n=N):
    """``test_torch_slice.py``'s binary rows."""
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = (x0 + x1 ** 2 + 0.3 * rng.randn(n) > 0.8).astype(float)
    return X, y


SLICE = dict(objective="binary", num_leaves=15, verbosity=-1,
             tpu_histogram_impl="pallas", tree_grow_mode="wave",
             use_quantized_grad=True, stochastic_rounding=False)


@pytest.fixture(scope="module")
def journals(tmp_path_factory):
    """The quantized slice configuration trained with ``publish_dir``
    (every 2 rounds) in both packages."""
    X, y = _slice_data()
    root = tmp_path_factory.mktemp("journals")
    out = {}
    for pkg, mod in (("port", lt), ("reference", lgb)):
        d = str(root / pkg)
        p = {**SLICE, "publish_dir": d, "publish_every": 2}
        kw = {"device": "cpu"} if pkg == "port" else {}
        bst = mod.train(p, mod.Dataset(X, y), ROUNDS, **kw)
        out[pkg] = (d, bst.model_to_string())
    return out


def test_quantized_journal_files_equal_reference(journals):
    (pd, ptext), (rd, rtext) = journals["port"], journals["reference"]
    assert ptext == rtext
    names = sorted(os.listdir(pd))
    assert names == sorted(os.listdir(rd)) == [
        "BASE.00002.txt", "DELTA.00004", "DELTA.00005", "HEAD"]
    for name in names:
        with open(os.path.join(pd, name), "rb") as a, \
                open(os.path.join(rd, name), "rb") as b:
            assert a.read() == b.read(), name


def test_each_subscriber_folds_the_others_journal(journals):
    """The port folds the reference's journal, and the reference the
    port's, to the text a cold load of the final model writes."""
    (pd, ptext), (rd, _) = journals["port"], journals["reference"]
    cold_port = lt.Booster(model_str=ptext, device="cpu").model_to_string()
    cold_ref = lgb.Booster(model_str=ptext).model_to_string()
    g, rnd = tsub.load_journal(rd, device="cpu")
    assert rnd == ROUNDS and model_to_string(g) == cold_port
    jg, jrnd = jsub.load_journal(pd)
    assert jrnd == ROUNDS and j_to_string(jg) == cold_ref
    assert cold_port == cold_ref


def test_load_journal_needs_a_device_without_a_card(journals):
    """The folded model predicts, so it resolves its device as every
    entry point does: without a card, the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from lightgbm_tpu_torch.utils.device import DeviceUnavailableError
    with pytest.raises(DeviceUnavailableError):
        tsub.load_journal(journals["port"][0])


# ---------------------------------------------------------------------------
# the publisher
# ---------------------------------------------------------------------------

def test_publisher_cadence_and_completion_flush(tmp_path, binary_data):
    X, _ = binary_data
    jdir = tmp_path / "journal"
    bst = _train(binary_data, 5, publish_dir=jdir, every=2)
    names = sorted(n for n in os.listdir(jdir) if n != "HEAD")
    # rounds 2 and 4 on the cadence, round 5 by the completion flush
    assert names == ["BASE.00002.txt", "DELTA.00004", "DELTA.00005"]
    g, rnd = tsub.load_journal(str(jdir), device="cpu")
    assert rnd == 5 and len(g.models) == 5
    folded = lt.Booster(model_str=model_to_string(g), device="cpu")
    np.testing.assert_array_equal(folded.predict(X[:64]),
                                  bst.predict(X[:64]))
    # run directives stay out of the model text
    assert "publish_dir" not in bst.model_to_string()


def test_publisher_restart_reanchors_and_compacts(tmp_path, binary_data):
    X, y = binary_data
    p = {**SMALL, "objective": "binary"}
    b3 = lt.train(p, lt.Dataset(X, y), 3, device="cpu")
    jdir = str(tmp_path / "journal")
    p1 = DeltaPublisher(jdir)
    assert p1.publish(b3._gbdt)
    b5 = lt.train(p, lt.Dataset(X, y), 2, init_model=b3, device="cpu")
    assert p1.publish(b5._gbdt) and not p1.publish(b5._gbdt)
    j = DeltaJournal(jdir)
    assert j.head().round == 5 and j.chain_length() == 1
    # a restarted trainer re-anchors with a fresh BASE at its own round
    p2 = DeltaPublisher(jdir)
    assert p2.publish(b5._gbdt)
    assert j.head().kind == "base" and j.head().round == 5
    pub = DeltaPublisher(str(tmp_path / "j2"), compact_after=2)
    b = lt.train(p, lt.Dataset(X, y), 1, device="cpu")
    pub.publish(b._gbdt)
    for _ in range(3):
        b = lt.train(p, lt.Dataset(X, y), 1, init_model=b, device="cpu")
        pub.publish(b._gbdt)
    assert pub.journal.chain_length() < 2 and pub.journal.head().round == 4


# ---------------------------------------------------------------------------
# the serving side
# ---------------------------------------------------------------------------

def _journal_and_model(tmp_path, data, rounds=5, **extra):
    jdir = tmp_path / "journal"
    bst = _train(data, rounds, publish_dir=jdir, every=1, **extra)
    mfile = str(tmp_path / "model.txt")
    bst.save_model(mfile)
    return DeltaJournal(str(jdir)), mfile


@pytest.mark.parametrize("kwargs", [
    {"shard": 4},                      # dense, appends in the envelope
    {"compiler": "walk"},              # no dense tables: rebuilds
    {"shard": 4, "leaf_bits": 8},      # quantized leaf codes
], ids=["dense-shard4", "walk", "quantized-leaf8"])
def test_delta_parity_bitwise_with_cold_load(tmp_path, binary_data,
                                             kwargs):
    X, _ = binary_data
    j, mfile = _journal_and_model(tmp_path, binary_data, rounds=5)
    base_path, base_round = j.base_entry()
    reg = _cold(base_path, **kwargs)
    rng = np.random.RandomState(0)
    queries = [rng.randn(n, X.shape[1]).astype(np.float32)
               for n in (1, 7, 9, 63)]
    for rec in j.records_after(base_round):
        assert reg.apply_delta("m", rec)["round"] == rec.round
        cold = _cold(mfile, num_iteration=rec.round, **kwargs)
        for Xq in queries:
            np.testing.assert_array_equal(reg.get("m").predict(Xq),
                                          cold.get("m").predict(Xq))


def test_delta_parity_multiclass(tmp_path, multiclass_data):
    X, y = multiclass_data
    jdir = tmp_path / "journal"
    p = {**SMALL, "objective": "multiclass", "num_class": 3,
         "publish_dir": str(jdir), "publish_every": 1}
    bst = lt.train(p, lt.Dataset(X, y), 3, device="cpu")
    mfile = str(tmp_path / "model.txt")
    bst.save_model(mfile)
    j = DeltaJournal(str(jdir))
    base_path, base_round = j.base_entry()
    reg = _cold(base_path, shard=8)
    for rec in j.records_after(base_round):
        assert rec.num_tree_per_iteration == 3
        reg.apply_delta("m", rec)
    got = reg.get("m").predict(X[:32])
    assert got.shape == (32, 3)
    np.testing.assert_array_equal(got, _cold(mfile, shard=8).get(
        "m").predict(X[:32]))


def test_zero_recompiles_inside_shard_envelope(tmp_path, binary_data):
    """A delta inside the envelope splices rows into the padding: the
    signature is unchanged, and serving the grown model adds no compile
    key (process-wide or in ``/stats``)."""
    X, _ = binary_data
    j, _ = _journal_and_model(tmp_path, binary_data, rounds=2)
    base_path, base_round = j.base_entry()
    reg = ModelRegistry(device="cpu")
    reg.load("m", base_path, warmup=True, shard=4)
    p1 = reg.get("m")
    assert p1.info()["dense"]["capacity"] == 4
    sig = p1.signature
    r0, k0 = p1.stats.snapshot()["recompiles"], compile_key_count()
    (rec,) = j.records_after(base_round)
    assert reg.apply_delta("m", rec)["mode"] == "extend"
    p2 = reg.get("m")
    assert p2 is not p1 and p2.num_trees == 2 and p2.signature == sig
    rng = np.random.RandomState(1)
    for n in (1, 7, 8, 9, 63, 600):
        p2.predict(rng.randn(n, X.shape[1]))
    assert p2.stats.snapshot()["recompiles"] == r0
    assert compile_key_count() == k0


def test_extend_past_envelope_rebuilds(tmp_path, binary_data):
    X, _ = binary_data
    j, mfile = _journal_and_model(tmp_path, binary_data, rounds=6)
    base_path, base_round = j.base_entry()
    reg = _cold(base_path, shard=4)
    modes = [reg.apply_delta("m", rec)["mode"]
             for rec in j.records_after(base_round)]
    assert modes[0] == "extend" and "rebuild" in modes
    np.testing.assert_array_equal(
        reg.get("m").predict(X[:16]),
        _cold(mfile, shard=4).get("m").predict(X[:16]))


def test_extend_refuses_train_attached_predictor(binary_data):
    from lightgbm_tpu_torch.serve.predictor import CompiledPredictor
    X, y = binary_data
    Xw = np.hstack([X, np.zeros((X.shape[0], 2))])   # unused columns
    p = {**SMALL, "objective": "binary"}
    bst = lt.train(p, lt.Dataset(Xw, y), 2, device="cpu")
    pred = CompiledPredictor(bst)
    assert pred._used is not None
    with pytest.raises(ValueError, match="train-set-attached"):
        pred.extended(bst._gbdt.models[:1])


def test_registry_chain_guards(tmp_path, binary_data):
    X, y = binary_data
    j, mfile = _journal_and_model(tmp_path, binary_data, rounds=3)
    base_path, base_round = j.base_entry()
    recs = j.records_after(base_round)
    reg = _cold(base_path, shard=4)
    with pytest.raises(DeltaChainError, match="re-anchor"):
        reg.apply_delta("m", recs[1])          # a skipped round
    reg.apply_delta("m", recs[0])
    assert reg.round_of("m") == recs[0].round
    assert reg.apply_delta("m", recs[0])["mode"] == "noop"   # replayed
    assert reg.apply_delta("m", recs[1].to_bytes())["round"] == \
        recs[1].round
    with pytest.raises(KeyError):
        reg.apply_delta("ghost", recs[0])
    # a divergent base: the right round count, the wrong fingerprint
    p = {**SMALL, "objective": "binary", "learning_rate": 0.31}
    other = lt.train(p, lt.Dataset(X, y), 1, device="cpu")
    ofile = str(tmp_path / "other.txt")
    other.save_model(ofile)
    with pytest.raises(DeltaChainError, match="fingerprint"):
        _cold(ofile).apply_delta("m", recs[0])
    reg.load("m", mfile, warmup=False)     # a full reload re-anchors
    assert reg.round_of("m") is None


def test_evict_guard_and_inflight_readers(tmp_path, binary_data):
    _, mfile = _journal_and_model(tmp_path, binary_data, rounds=2)
    X, _ = binary_data
    reg = _cold(mfile)
    with pytest.raises(ModelInUseError, match="force=True"):
        reg.evict("m")
    pred = reg.get("m")
    assert reg.evict("m", force=True) and reg.names() == []
    assert pred.predict(X[:8]).shape == (8,)   # a held reference serves
    reg.load("a", mfile, warmup=False)
    reg.load("b", mfile, warmup=False)
    assert reg.evict("b") and reg.names() == ["a"]
    assert reg.evict("missing") is False


def test_engine_refuses_init_model_plus_resume(tmp_path, binary_data):
    from lightgbm_tpu_torch.resilience.checkpoint import CheckpointError
    X, y = binary_data
    p = {**SMALL, "objective": "binary",
         "checkpoint_dir": str(tmp_path / "ckpt")}
    warm = lt.train(p, lt.Dataset(X, y), 2, device="cpu")
    with pytest.raises(CheckpointError, match="init_model and resume_from"):
        lt.train({**p, "resume": "latest"}, lt.Dataset(X, y), 4,
                 init_model=warm, device="cpu")


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        body = json.dumps(payload).encode()
        conn.request("POST", path, body,
                     {"Content-Type": "application/json",
                      "Content-Length": str(len(body))})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_delta_endpoint(tmp_path, binary_data):
    from lightgbm_tpu_torch.serve.server import PredictionServer
    X, _ = binary_data
    j, mfile = _journal_and_model(tmp_path, binary_data, rounds=3)
    base_path, base_round = j.base_entry()
    recs = j.records_after(base_round)
    reg = _cold(base_path, shard=4)
    srv = PredictionServer(reg, port=0, max_wait_ms=0.5).start()
    try:
        def b64(rec):
            return base64.b64encode(rec.to_bytes()).decode("ascii")

        status, body = _post(srv.port, "/models/m/delta",
                             {"record_b64": b64(recs[0])})
        assert status == 200 and body["round"] == recs[0].round, body
        assert body["mode"] == "extend"
        status, body = _post(srv.port, "/models/m/delta",
                             {"record_b64": b64(recs[0])})
        assert status == 200 and body["mode"] == "noop"
        gap = DeltaRecord(base_round=recs[1].round + 3,
                          round=recs[1].round + 4, parent_fp=recs[1].fp,
                          fp=chain_fingerprint(recs[1].fp, "x"),
                          num_tree_per_iteration=1, payload="x")
        assert _post(srv.port, "/models/m/delta",
                     {"record_b64": b64(gap)})[0] == 409
        assert _post(srv.port, "/models/ghost/delta",
                     {"record_b64": b64(recs[1])})[0] == 404
        assert _post(srv.port, "/models/m/delta", {})[0] == 400
        assert _post(srv.port, "/models/m/delta",
                     {"record_b64": "!!"})[0] == 400
        status, body = _post(srv.port, "/models/m/delta",
                             {"record_b64": b64(recs[1])})
        assert status == 200 and body["round"] == 3
        status, body = _post(srv.port, "/predict",
                             {"rows": X[:5].tolist()})
        assert status == 200
        np.testing.assert_array_equal(
            np.asarray(body["predictions"], np.float32),
            _cold(mfile).get("m").predict(X[:5]).astype(np.float32))
    finally:
        srv.shutdown()


def test_fingerprint_helpers_equal_reference():
    assert fingerprint_text("abc é") == jdelta.fingerprint_text("abc é")
    assert chain_fingerprint("f" * 64, "p") == \
        jdelta.chain_fingerprint("f" * 64, "p")
    assert DeltaRecord is tdelta.DeltaRecord
