"""SHAP values (``pred_contrib``) of the port held against the JAX package.

One model text (trained by the port on the CPU) loads into both
packages.

* The port's copy of the f64 host TreeSHAP walk (``models/shap.py``)
  equals the reference's ``predict_contrib`` to rtol 1e-12.
* The port's dense TreeSHAP program (``explain/dense_shap.py``) is within
  rtol 1e-4 of the host walk, the reference's own parity for its dense
  program, and ``Booster.predict(pred_contrib=True)`` within rtol 1e-4
  of ``lightgbm_tpu``'s, for binary, 3-class and categorical models.
* The additivity check and its counted fallback, the forced walk and the
  depth and table budgets each give the reference's reason.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.explain import compiler as jexp
from lightgbm_tpu.models import shap as jshap
from lightgbm_tpu_torch.explain import compiler as texp
from lightgbm_tpu_torch.explain import dense_shap as tds
from lightgbm_tpu_torch.models import shap as tshap
from lightgbm_tpu_torch.telemetry.metrics import default_registry

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

N, F = 900, 6
MODELS = ["binary", "multiclass", "categorical"]


def _rows(seed, n, cat=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    if cat:
        X[:, 3] = rng.randint(0, 40, n)
        X[rng.rand(n) < 0.03, 3] = np.nan
    return X


def _train(name):
    X = _rows(0, N, cat=name == "categorical")
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    p = dict(objective="binary", num_leaves=15, verbosity=-1,
             use_quantized_grad=True, min_data_in_leaf=5)
    y = (x0 + x1 ** 2 > 0.8).astype(float)
    kw = {}
    if name == "multiclass":
        p.update(objective="multiclass", num_class=3)
        y = np.digitize(x0, [-0.4, 0.4]).astype(float)
    elif name == "categorical":
        y = ((X[:, 3] % 3 == 0) + 0.3 * x0 > 0.8).astype(float)
        kw["categorical_feature"] = [3]
    return lt.train(p, lt.Dataset(X, y, **kw), 5,
                    device="cpu").model_to_string()


@pytest.fixture(scope="module")
def texts():
    return {name: _train(name) for name in MODELS}


def _queries(name, n=60):
    return _rows(3, n, cat=name == "categorical").astype(np.float32)


@pytest.mark.parametrize("name", MODELS)
def test_host_walk_copy_matches_reference(texts, name):
    X = _queries(name)
    got = tshap.predict_contrib(
        lt.Booster(model_str=texts[name], device="cpu")._gbdt, X)
    want = jshap.predict_contrib(lgb.Booster(model_str=texts[name])._gbdt,
                                 X)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", MODELS)
def test_dense_shap_matches_host_walk_and_reference(texts, name):
    X = _queries(name)
    pb = lt.Booster(model_str=texts[name], device="cpu")
    walk = tshap.predict_contrib(pb._gbdt, X)
    g = pb._gbdt
    k = g.num_tree_per_iteration
    exe, reason = texp.compile_explain(g.models, k, g.num_features,
                                       mode="dense")
    assert reason is None
    dense = exe.explain(X)
    scale = np.abs(walk).max()
    np.testing.assert_allclose(dense, walk, rtol=1e-4, atol=1e-4 * scale)
    got = pb.predict(X, pred_contrib=True)
    want = lgb.Booster(model_str=texts[name]).predict(X, pred_contrib=True)
    assert got.shape == want.shape == (X.shape[0], (F + 1) * k)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)
    # the rows' contributions sum to the raw score
    raw = pb.predict(X, raw_score=True).reshape(X.shape[0], k)
    np.testing.assert_allclose(got.reshape(X.shape[0], k, F + 1).sum(2),
                               raw, rtol=1e-4, atol=1e-4)


def test_dense_shap_chunks_and_window(texts):
    """Row chunks change nothing, and the iteration window is the host
    walk's."""
    X = _queries("binary", n=50)
    pb = lt.Booster(model_str=texts["binary"], device="cpu")
    g = pb._gbdt
    exe, _ = texp.compile_explain(g.models, 1, g.num_features)
    np.testing.assert_array_equal(exe.explain(X, max_rows=8),
                                  exe.explain(X))
    got = pb.predict(X, pred_contrib=True, start_iteration=1,
                     num_iteration=2)
    want = tshap.predict_contrib(g, X, 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _fb_batches(reason):
    return default_registry().counter(
        texp.EXPLAIN_FALLBACK_BATCHES,
        labels=("reason", "model")).value(reason=reason, model="-")


def test_additivity_failure_falls_back_counted(texts, monkeypatch):
    """A dense result whose rows do not sum to the raw score raises
    ExplainAdditivityError; ``pred_contrib`` then serves the host walk
    and counts reason ``additivity``, as the reference does."""
    X = _queries("binary")
    pb = lt.Booster(model_str=texts["binary"], device="cpu")
    walk = tshap.predict_contrib(pb._gbdt, X)
    real = tds._unwound_contribs
    monkeypatch.setattr(tds, "_unwound_contribs",
                        lambda *a: 2.0 * real(*a))
    g = pb._gbdt
    exe, _ = texp.compile_explain(g.models, 1, g.num_features)
    with pytest.raises(texp.ExplainAdditivityError):
        exe.explain(X)
    before = _fb_batches("additivity")
    got = pb.predict(X, pred_contrib=True)
    np.testing.assert_array_equal(got, walk)
    assert _fb_batches("additivity") == before + 1
    with pytest.raises(jexp.ExplainAdditivityError):
        jexp.check_additivity(2.0 * walk, walk.sum(1, keepdims=True), F + 1)
    with pytest.raises(texp.ExplainAdditivityError):
        texp.check_additivity(2.0 * walk, walk.sum(1, keepdims=True), F + 1)


@pytest.mark.parametrize("case", ["walk", "depth", "table", "empty"])
def test_explain_reasons_match_reference(texts, case):
    """Forced walk, the depth and table budgets and an empty ensemble:
    the reference's reasons, counted in ``serve_explain_fallback``."""
    pb = lt.Booster(model_str=texts["binary"], device="cpu")
    rb = lgb.Booster(model_str=texts["binary"])
    kw = {"walk": dict(mode="walk"), "depth": dict(depth_budget=1),
          "table": dict(table_budget=1), "empty": {}}[case]
    tm = [] if case == "empty" else pb._gbdt.models
    jm = [] if case == "empty" else rb._gbdt.models
    bt, bj = texp.explain_fallback_counts(), jexp.explain_fallback_counts()
    t_exe, t_reason = texp.compile_explain(tm, 1, F, **kw)
    j_exe, j_reason = jexp.compile_explain(jm, 1, F, **kw)
    assert t_exe is None and j_exe is None
    assert t_reason == j_reason == {"walk": "forced_walk",
                                    "depth": "explain_depth_budget",
                                    "table": "explain_table_budget",
                                    "empty": "no_trees"}[case]
    assert texp.explain_fallback_counts()[t_reason] == bt.get(t_reason,
                                                              0) + 1
    assert jexp.explain_fallback_counts()[j_reason] == bj.get(j_reason,
                                                              0) + 1
    if case == "depth":
        with pytest.raises(tds.DenseLoweringError):
            texp.compile_explain(tm, 1, F, mode="dense", **kw)


def test_forced_walk_param_and_predictor_lane(texts):
    """``tpu_explain_compiler=walk`` serves the host walk through
    ``Booster.predict``; the predictor's explain lane serves the dense
    program and reports it."""
    X = _queries("multiclass")
    text = texts["multiclass"]
    walk_b = lt.Booster(model_str=text,
                        params={"tpu_explain_compiler": "walk"},
                        device="cpu")
    np.testing.assert_array_equal(
        walk_b.predict(X, pred_contrib=True),
        tshap.predict_contrib(walk_b._gbdt, X))
    pred = lt.Booster(model_str=text, device="cpu").to_predictor()
    got = pred.explain(X)
    assert pred.info()["explain_compiler"] == "dense"
    np.testing.assert_allclose(
        got, walk_b.predict(X, pred_contrib=True), rtol=1e-4,
        atol=1e-4 * np.abs(got).max())
