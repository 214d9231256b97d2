"""Chunked streamed training of the port held against the JAX package.

The same seeded data and params go through ``lightgbm_tpu.ingest.
train_streamed`` (the reference's chunked grower) and through
``lightgbm_tpu_torch.ingest.train_streamed`` on the CPU (the kernels'
plain versions, chunk by chunk), and through the port's in-core
``train``.  Both packages pin the chunked grower's envelope (wave
grower, the taper tail: endgame and speculative ramp off, round-half-up
quantization) and ``tpu_histogram_impl=pallas``, which the reference's
in-core run needs for its Pallas kernels (interpret mode here) and which
is in both packages' params dump.

* Quantized: the port's streamed text is byte-identical to the
  reference's streamed text and to the port's in-core text: serial
  order (W = 1), W = 4, the default wave, 16 quantization levels,
  regression, bagging with feature_fraction, GOSS, DART, multiclass,
  chunk boundaries at 2048 / 2049 rows; one case holds the reference's
  in-core run through its Pallas kernels in interpret mode.
* Exact: the port's fixed-point sums add across chunks, so its streamed
  text equals its in-core text byte for byte; against the reference
  (which sums f32 chunk histograms) the tree structure is the same and
  the predictions agree within rtol 1e-5.
* The envelope's typed errors (``max_bin`` > 255 included), the engine's
  routing and its refusals, resume mid-stream and the fingerprint check.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ingest import ArraySource as RefArraySource
from lightgbm_tpu.ingest import StreamedDataset as RefStreamedDataset
from lightgbm_tpu.ingest import train_streamed as ref_train_streamed
from lightgbm_tpu_torch.ingest import (ArraySource, StreamedDataset,
                                       StreamedEnvelopeError, train_streamed)

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

STRUCTURE = ("num_leaves", "split_feature", "threshold", "decision_type",
             "left_child", "right_child", "leaf_count", "internal_count")


def _data(n=3001, f=6, seed=7, task="binary"):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    raw = X[:, 0] + 0.5 * X[:, 1] + rng.randn(n) * 0.5
    if task == "binary":
        y = (raw > 0).astype(np.float64)
    elif task == "mc":
        y = np.digitize(raw, [-0.5, 0.5]).astype(np.float64)
    else:
        y = raw
    return X, y


# the chunked grower's envelope, pinned for every run
_PIN = {"verbosity": -1, "num_leaves": 15, "learning_rate": 0.2,
        "max_bin": 63, "min_data_in_leaf": 5, "enable_bundle": False,
        "seed": 3, "tree_grow_mode": "wave", "tpu_exact_endgame": False,
        "tpu_speculative_ramp": False, "stochastic_rounding": False,
        "tpu_histogram_impl": "pallas"}


def _port(params, X, y, rounds, chunk_rows=512):
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=chunk_rows),
                         params=params)
    return train_streamed(params, sd, rounds, device="cpu")


def _ref(params, X, y, rounds, chunk_rows=512):
    sd = RefStreamedDataset(RefArraySource(X, y, chunk_rows=chunk_rows),
                            params=params)
    return ref_train_streamed(params, sd, rounds)


def _incore(params, X, y, rounds):
    return lt.train(params, lt.Dataset(X.copy(), label=y.copy()), rounds,
                    device="cpu")


def _tree_fields(text):
    out, cur = [], None
    for line in text.splitlines():
        if line.startswith("Tree="):
            cur = {}
            out.append(cur)
        elif cur is not None and "=" in line:
            k, v = line.split("=", 1)
            if k in STRUCTURE:
                cur[k] = v
    return out


# ---------------------------------------------------------------------------
# quantized: byte-identical to the reference's streamed text and to the
# port's in-core text
# ---------------------------------------------------------------------------

QUANTIZED = {
    # W = 1 is the true sequential best-first order
    "serial_order": dict(tpu_wave_size=1),
    "wave": dict(tpu_wave_size=4),
    "default_wave": dict(),
    "quantized_16bins": dict(num_grad_quant_bins=16, tpu_wave_size=4),
    "regression": dict(objective="regression", tpu_wave_size=4),
    "bagging_feature_fraction": dict(tpu_wave_size=4, bagging_fraction=0.7,
                                     bagging_freq=2, feature_fraction=0.8),
    "goss": dict(boosting="goss", tpu_wave_size=4, learning_rate=0.5,
                 top_rate=0.2, other_rate=0.1),
    "dart_uniform": dict(boosting="dart", tpu_wave_size=4, drop_rate=0.5,
                         drop_seed=9, uniform_drop=True),
    "dart_xgboost": dict(boosting="dart", tpu_wave_size=4, drop_rate=0.5,
                         drop_seed=9, xgboost_dart_mode=True, max_drop=3),
    "multiclass": dict(objective="multiclass", num_class=3,
                       tpu_wave_size=4),
}


@pytest.mark.parametrize("name", sorted(QUANTIZED))
def test_chunked_quantized_matches_reference_and_incore(name):
    extra = QUANTIZED[name]
    task = {"regression": "regression", "multiclass": "mc"}.get(name,
                                                                "binary")
    X, y = _data(4096 if name == "goss" else 3001, task=task)
    p = dict(_PIN, objective="binary", use_quantized_grad=True)
    p.update(extra)
    rounds = 8 if name.startswith("dart") else 6
    got = _port(p, X, y, rounds)
    incore = _incore(p, X, y, rounds)
    text = got.model_to_string()
    assert text == _ref(p, X, y, rounds).model_to_string(), name
    assert text == incore.model_to_string(), name
    assert np.array_equal(got.predict(X[:64]), incore.predict(X[:64]))


@pytest.mark.parametrize("n", [2048, 2049])
def test_chunked_boundary_shapes(n):
    X, y = _data(n, 5, seed=11)
    p = dict(_PIN, objective="binary", use_quantized_grad=True,
             tpu_wave_size=4)
    text = _port(p, X, y, 4).model_to_string()
    assert text == _ref(p, X, y, 4).model_to_string()
    assert text == _incore(p, X, y, 4).model_to_string()


def test_chunked_matches_reference_incore_pallas_interpret():
    """The reference through its Pallas kernels in interpret mode (the
    fused row update and the q8 leaf-channel kernel), in-core and over
    two 4096-row chunks, against the port's chunk path."""
    X, y = _data(8192, 4, seed=5)
    p = dict(_PIN, objective="binary", use_quantized_grad=True,
             num_leaves=7, max_bin=15, tpu_wave_size=2,
             tpu_hist_pack4=False)
    text = _port(p, X, y, 2, chunk_rows=4096).model_to_string()
    assert text == lgb.train(p, lgb.Dataset(X.copy(), label=y.copy()),
                             2).model_to_string()
    assert text == _ref(p, X, y, 2, chunk_rows=4096).model_to_string()


# ---------------------------------------------------------------------------
# exact: byte-identical to the port's in-core text; the reference's
# structure, predictions within rtol 1e-5
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    dict(tpu_wave_size=4),
    dict(objective="multiclass", num_class=3, tpu_wave_size=4),
], ids=["binary", "multiclass"])
def test_chunked_exact(extra):
    task = "mc" if extra.get("objective") == "multiclass" else "binary"
    X, y = _data(task=task)
    p = dict(_PIN, objective="binary")
    p.update(extra)
    got = _port(p, X, y, 6)
    text = got.model_to_string()
    assert text == _incore(p, X, y, 6).model_to_string()
    ref = _ref(p, X, y, 6)
    assert _tree_fields(text) == _tree_fields(ref.model_to_string())
    np.testing.assert_allclose(got.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# engine.train routing + envelope errors
# ---------------------------------------------------------------------------

def test_engine_routes_chunked_mode(monkeypatch):
    from lightgbm_tpu_torch.ingest import train as itrain
    X, y = _data(2048, 5, seed=2)
    p = dict(_PIN, objective="binary", use_quantized_grad=True,
             tpu_wave_size=4)
    calls = []
    real = itrain.train_streamed
    monkeypatch.setattr(itrain, "train_streamed",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    pc = dict(p, tpu_ingest_mode="chunked")
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=pc)
    bst = lt.train(pc, sd, num_boost_round=3, device="cpu")
    assert calls == [1]
    # tpu_ingest_mode is not in the params dump: the streamed route's
    # text is its in-core twin's
    assert bst.model_to_string() == _incore(p, X, y, 3).model_to_string()
    # the hbm route (the default) trains in-core from the binned cache
    sd2 = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=p)
    assert lt.train(p, sd2, 3, device="cpu").model_to_string() == \
        bst.model_to_string()
    assert calls == [1]


@pytest.mark.parametrize("kw", ["callbacks", "fobj", "feval",
                                "init_model"])
def test_engine_chunked_rejects(kw):
    X, y = _data(2048, 5, seed=2)
    p = dict(_PIN, objective="binary", tpu_ingest_mode="chunked")
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=p)
    val = {"callbacks": [lambda env: None],
           "fobj": lambda s, d: (s, s),
           "feval": lambda s, d: ("x", 0.0, False),
           "init_model": "model.txt"}[kw]
    with pytest.raises(ValueError, match=kw):
        lt.train(p, sd, num_boost_round=2, device="cpu", **{kw: val})


def test_envelope_errors():
    X, y = _data(2048, 5, seed=2)
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512),
                         params={"verbosity": -1})
    cases = [
        (dict(_PIN, objective="poisson"), "objective"),
        (dict(_PIN, objective="binary",
              monotone_constraints=[1, 0, 0, 0, 0]), "monotone"),
        ({"objective": "lambdarank", "verbosity": -1}, "objective"),
        ({"objective": "multiclassova", "num_class": 3, "verbosity": -1},
         "objective"),
        (dict(_PIN, objective="binary", boosting="dart", snapshot_freq=1),
         "checkpoint"),
        (dict(_PIN, objective="binary", boosting="rf",
              bagging_fraction=0.5, bagging_freq=1), "boosting"),
        (dict(_PIN, objective="binary", extra_trees=True), "extra_trees"),
        (dict(_PIN, objective="binary", path_smooth=1.0), "path_smooth"),
    ]
    for params, match in cases:
        with pytest.raises(StreamedEnvelopeError, match=match):
            train_streamed(params, sd, 2, device="cpu")
    # and the reference raises the same typed errors
    rsd = RefStreamedDataset(RefArraySource(X, y, chunk_rows=512),
                             params={"verbosity": -1})
    from lightgbm_tpu.ingest import StreamedEnvelopeError as RefEnvelope
    for params, match in cases[:2]:
        with pytest.raises(RefEnvelope, match=match):
            ref_train_streamed(params, rsd, 2)


def test_max_bin_past_255_refused():
    X, y = _data(2048, 3, seed=4)
    X[:, 0] = np.arange(2048) / 7.0
    p = dict(_PIN, objective="binary", max_bin=1023)
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=p)
    with pytest.raises(StreamedEnvelopeError, match="max_bin"):
        train_streamed(p, sd, 2, device="cpu")
    rsd = RefStreamedDataset(RefArraySource(X, y, chunk_rows=512), params=p)
    from lightgbm_tpu.ingest import StreamedEnvelopeError as RefEnvelope
    with pytest.raises(RefEnvelope, match="max_bin"):
        ref_train_streamed(p, rsd, 2)


def test_flight_dir_raises(tmp_path):
    """``flight_dir`` acts on the chunked path now (the reference's
    ingest/train.py:445-463): the tape lands there; ``publish_dir`` still
    raises, as the reference's chunked path has no publish lane."""
    X, y = _data(2048, 3, seed=4)
    p = dict(_PIN, objective="binary", flight_dir=str(tmp_path / "fl"))
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=p)
    train_streamed(p, sd, 2, device="cpu")
    assert os.listdir(tmp_path / "fl") == ["flight.jsonl"]
    q = dict(_PIN, objective="binary", publish_dir=str(tmp_path / "pub"))
    with pytest.raises(NotImplementedError, match="publish_dir"):
        train_streamed(q, sd, 2, device="cpu")
    assert not os.path.exists(tmp_path / "pub")


# ---------------------------------------------------------------------------
# streamed validation + early stopping
# ---------------------------------------------------------------------------

def test_chunked_valid_sets_metric_history():
    """A streamed and an in-core valid set: the scores the chunked walk
    records give the in-core run's metric values and stop round."""
    X, y = _data(4096, 6)
    Xtr, ytr, Xv, yv = X[:3000], y[:3000], X[3000:], y[3000:]
    p = dict(_PIN, objective="binary", use_quantized_grad=True,
             tpu_wave_size=4, early_stopping_round=2, learning_rate=0.9,
             num_leaves=31, min_data_in_leaf=2)
    ds = lt.Dataset(Xtr.copy(), label=ytr.copy())
    dv = lt.Dataset(Xv.copy(), label=yv.copy(), reference=ds)
    b1 = lt.train(p, ds, 40, valid_sets=[dv], valid_names=["va"],
                  device="cpu")
    pc = dict(p, tpu_ingest_mode="chunked")
    sd = StreamedDataset(ArraySource(Xtr, ytr, chunk_rows=512), params=pc)
    sv = StreamedDataset(ArraySource(Xv, yv, chunk_rows=512), params=pc)
    b2 = lt.train(pc, sd, 40, valid_sets=[sv], valid_names=["va"],
                  device="cpu")
    assert b1.best_iteration == b2.best_iteration
    assert b1.best_score == b2.best_score
    assert b1.model_to_string() == b2.model_to_string()
    # an in-core valid set of a chunked run bins against its mappers
    sd3 = StreamedDataset(ArraySource(Xtr, ytr, chunk_rows=512), params=pc)
    b3 = lt.train(pc, sd3, 40, valid_sets=[lt.Dataset(Xv.copy(),
                                                      label=yv.copy())],
                  device="cpu")
    assert b3.best_iteration == b1.best_iteration
    assert b3.best_score["valid_0"] == b1.best_score["va"]


@pytest.mark.slow
def test_chunked_dart_early_stop_same_round():
    X, y = _data(4096, 6)
    Xtr, ytr, Xv, yv = X[:3000], y[:3000], X[3000:], y[3000:]
    p = dict(_PIN, objective="binary", boosting="dart", drop_rate=0.5,
             drop_seed=9, use_quantized_grad=True, tpu_wave_size=4,
             early_stopping_round=4)
    ds = lt.Dataset(Xtr.copy(), label=ytr.copy())
    dv = lt.Dataset(Xv.copy(), label=yv.copy(), reference=ds)
    b1 = lt.train(p, ds, 25, valid_sets=[dv], device="cpu")
    pc = dict(p, tpu_ingest_mode="chunked")
    sd = StreamedDataset(ArraySource(Xtr, ytr, chunk_rows=512), params=pc)
    sv = StreamedDataset(ArraySource(Xv, yv, chunk_rows=512), params=pc)
    b2 = lt.train(pc, sd, 25, valid_sets=[sv], device="cpu")
    assert b1.best_iteration == b2.best_iteration
    assert b1.model_to_string() == b2.model_to_string()


@pytest.mark.slow
def test_chunked_multiclass_bagging_feature_fraction_identity():
    X, y = _data(task="mc")
    p = dict(_PIN, objective="multiclass", num_class=3,
             use_quantized_grad=True, tpu_wave_size=4,
             bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.8)
    text = _port(p, X, y, 6).model_to_string()
    assert text == _ref(p, X, y, 6).model_to_string()
    assert text == _incore(p, X, y, 6).model_to_string()


# ---------------------------------------------------------------------------
# resume mid-stream through resilience/checkpoint.py
# ---------------------------------------------------------------------------

def test_resume_mid_stream_bit_identical(tmp_path):
    X, y = _data()
    # checkpoint cadence params stay the same between the uninterrupted
    # and the resumed run (only resume / checkpoint_dir are excluded from
    # the model-text params dump)
    p = dict(_PIN, objective="binary", use_quantized_grad=True,
             tpu_wave_size=4, snapshot_freq=2,
             checkpoint_dir=str(tmp_path / "ck_full"))
    full = _port(p, X, y, 8).model_to_string()
    ck = dict(p, checkpoint_dir=str(tmp_path / "ck"))
    sd1 = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=ck)
    train_streamed(ck, sd1, 4, device="cpu")
    sd2 = StreamedDataset(ArraySource(X, y, chunk_rows=512),
                          params=dict(ck, resume="latest"))
    resumed = train_streamed(dict(ck, resume="latest"), sd2, 8,
                             device="cpu")
    assert resumed.model_to_string() == full
    assert sd1.fingerprint() == sd2.fingerprint()
    # the in-core run's fingerprint is the streamed one
    ds = lt.Dataset(X.copy(), label=y.copy(), params=p).construct()
    assert ds.fingerprint() == sd1.fingerprint()


def test_resume_rejects_fingerprint_mismatch(tmp_path):
    from lightgbm_tpu_torch.resilience.checkpoint import CheckpointError
    X, y = _data(2048, 5, seed=2)
    p = dict(_PIN, objective="binary", use_quantized_grad=True,
             checkpoint_dir=str(tmp_path / "ck"), snapshot_freq=1)
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=p)
    train_streamed(p, sd, 2, device="cpu")
    X2 = X.copy()
    X2[0, 0] += 1.0  # different data -> different streamed crc
    sd2 = StreamedDataset(ArraySource(X2, y, chunk_rows=512),
                          params=dict(p, resume="latest"))
    with pytest.raises(CheckpointError, match="fingerprint|match"):
        train_streamed(dict(p, resume="latest"), sd2, 4, device="cpu")
