"""The port's sklearn estimators (``lightgbm_tpu_torch/sklearn.py``) and
``GridSearchCVMany`` (``multitrain/sweep.py``), held against the
reference's estimators and against the port's own ``train()``.

Quantized training on the wave grower (``device="cpu"``: the plain
versions of the kernels) writes byte-identical text in both packages, so
each estimator's model text must equal the reference estimator's, and
``predict`` / ``predict_proba`` must agree exactly.  ``GridSearchCVMany``
trains every (combo, fold) model in one ``train_many`` batch; its
``cv_results_`` must equal the per-fold loop of the port's own estimator
(the reference's ``GridSearchCVMany`` fails under the installed sklearn,
ROADMAP "Reference baseline", so it is no oracle).
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu.sklearn as rs
import lightgbm_tpu_torch as lt

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

KW = dict(n_estimators=5, num_leaves=7, tpu_histogram_impl="pallas",
          tree_grow_mode="wave", use_quantized_grad=True,
          stochastic_rounding=False)


def _data(n=1500, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5)
    return X, rng


@pytest.mark.parametrize("kind", ["binary", "multiclass", "regression"])
def test_estimator_text_matches_reference(kind):
    X, rng = _data()
    if kind == "regression":
        y = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(len(X))
        ref, port = rs.LGBMRegressor(**KW), lt.LGBMRegressor(device="cpu",
                                                             **KW)
    else:
        y = (X[:, 0] + X[:, 1] ** 2 > 0.8).astype(int) if kind == "binary" \
            else np.digitize(X[:, 0], [-0.5, 0.5])
        y = np.array(["a", "b", "c"])[y]       # labels that need encoding
        ref, port = rs.LGBMClassifier(**KW), lt.LGBMClassifier(device="cpu",
                                                               **KW)
    ref.fit(X, y)
    port.fit(X, y)
    assert port.booster_.model_to_string() == \
        ref.booster_.model_to_string()
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    if kind != "regression":
        np.testing.assert_array_equal(port.predict_proba(X),
                                      ref.predict_proba(X))
        np.testing.assert_array_equal(port.classes_, ref.classes_)
    np.testing.assert_array_equal(port.feature_importances_,
                                  ref.feature_importances_)


def test_estimator_text_equals_train_with_the_same_params():
    X, rng = _data()
    y = (X[:, 0] > 0).astype(int)
    est = lt.LGBMClassifier(device="cpu", reg_lambda=2.0,
                            min_child_samples=10, **KW).fit(X, y)
    params = dict(objective="binary", num_leaves=7, lambda_l2=2.0,
                  min_data_in_leaf=10, verbosity=-1,
                  **{k: v for k, v in KW.items()
                     if k not in ("n_estimators", "num_leaves")})
    bst = lt.train(params, lt.Dataset(X, y.astype(float)), 5, device="cpu")
    assert est.booster_.model_to_string() == bst.model_to_string()


def test_ranker_matches_reference():
    X, rng = _data(n=1200)
    y = rng.randint(0, 4, len(X))
    group = np.full(40, 30)
    kw = dict(KW, use_quantized_grad=False, tree_grow_mode="partition")
    ref = rs.LGBMRanker(**kw).fit(X, y, group=group)
    port = lt.LGBMRanker(device="cpu", **kw).fit(X, y, group=group)
    # lambdarank's gradients are within 6e-7, not bitwise (ROADMAP queue 3
    # watch list): predictions within rtol 1e-5 of their scale
    want = ref.predict(X)
    np.testing.assert_allclose(port.predict(X), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="group"):
        lt.LGBMRanker(device="cpu").fit(X, y)


def test_eval_set_early_stopping_and_sklearn_protocol():
    sklearn = pytest.importorskip("sklearn")
    from sklearn.base import clone
    X, rng = _data(n=2000)
    y = (X[:, 0] + 0.3 * rng.randn(len(X)) > 0).astype(int)
    est = lt.LGBMClassifier(device="cpu", n_estimators=40, num_leaves=7,
                            learning_rate=0.3)
    est.fit(X[:1500], y[:1500], eval_set=[(X[1500:], y[1500:])],
            early_stopping_rounds=3)
    hist = est.evals_result_["valid_0"]["binary_logloss"]
    assert 1 <= est.best_iteration_ < 40 and len(hist) > est.best_iteration_
    twin = clone(est)
    assert twin.get_params() == est.get_params()
    assert twin.get_params()["device"] == "cpu"
    assert sklearn.base.is_classifier(est)
    assert sklearn.base.is_regressor(lt.LGBMRegressor())
    twin.set_params(num_leaves=5, max_bin=63)
    assert twin.get_params()["max_bin"] == 63


@pytest.mark.parametrize("kind", ["regressor", "classifier"])
def test_grid_search_cv_many_equals_the_per_fold_loop(kind):
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    from sklearn.metrics import check_scoring
    from sklearn.model_selection import KFold
    from lightgbm_tpu_torch.multitrain import GridSearchCVMany
    X, rng = _data(n=900, seed=2)
    if kind == "regressor":
        y = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.1 * rng.randn(len(X))
        est = lt.LGBMRegressor(device="cpu", n_estimators=6, num_leaves=7,
                               min_child_samples=5)
        scoring = "r2"
    else:
        y = (X[:, 0] + X[:, 1] > 0).astype(int)
        est = lt.LGBMClassifier(device="cpu", n_estimators=6, num_leaves=7,
                                min_child_samples=5)
        scoring = "accuracy"
    grid = {"reg_lambda": [0.0, 3.0], "learning_rate": [0.1, 0.3]}
    gs = GridSearchCVMany(est, grid, cv=KFold(3), refit=True)
    gs.fit(X, y)
    assert len(gs.cv_results_["params"]) == 4
    # the per-fold loop: each (combo, fold) model trained alone with
    # train() on the fold's rows of the sweep's one binned dataset (its
    # folds are sample masks over those bins), then scored as sklearn
    # scores the estimator
    scorer = check_scoring(est, scoring=scoring)
    tmpl = clone(est)
    y_fit, extra = tmpl._process_label(y, tmpl._make_params())
    ds = lt.Dataset(X, y_fit, params=dict(tmpl._make_params(), **extra))
    ds.construct()
    for ci, combo in enumerate(gs.cv_results_["params"]):
        for k, (tr, te) in enumerate(KFold(3).split(X, y)):
            one = clone(est).set_params(**combo)
            params = dict(one._make_params(), **extra)
            one._Booster = lt.train(params, ds.subset(tr), 6, device="cpu")
            one._classes = tmpl._classes
            assert gs.cv_results_[f"split{k}_test_score"][ci] == \
                scorer(one, X[te], y[te]), (combo, k)
    best = int(np.argmax(gs.cv_results_["mean_test_score"]))
    assert gs.best_params_ == gs.cv_results_["params"][best]
    assert gs.cv_results_["rank_test_score"][best] == 1
    assert gs.predict(X[:8]).shape == (8,)


def test_grid_search_cv_many_batches_u16_bins(monkeypatch):
    """At max_bin=511 (uint16 bins) the sweep trains as one batch, with no
    sequential fallback, and each split's score is the per-fold model's."""
    pytest.importorskip("sklearn")
    from sklearn.base import clone
    from sklearn.metrics import check_scoring
    from sklearn.model_selection import KFold
    from lightgbm_tpu_torch.multitrain import GridSearchCVMany
    from lightgbm_tpu_torch.multitrain import sweep

    def refuse(msg):
        raise AssertionError(f"fell back: {msg}")
    monkeypatch.setattr(sweep, "log_warning", refuse)
    X, rng = _data(n=900, seed=3)
    y = X[:, 0] + 0.1 * rng.randn(len(X))
    est = lt.LGBMRegressor(device="cpu", n_estimators=3, num_leaves=7,
                           min_child_samples=5, max_bin=511)
    gs = GridSearchCVMany(est, {"reg_lambda": [0.0, 3.0]}, cv=KFold(2))
    gs.fit(X, y)
    scorer = check_scoring(est, scoring="r2")
    ds = lt.Dataset(X, y, params=clone(est)._make_params())
    ds.construct()
    assert ds.X_binned.dtype == np.uint16
    for ci, combo in enumerate(gs.cv_results_["params"]):
        for k, (tr, te) in enumerate(KFold(2).split(X, y)):
            one = clone(est).set_params(**combo)
            one._Booster = lt.train(one._make_params(), ds.subset(tr), 3,
                                    device="cpu")
            assert gs.cv_results_[f"split{k}_test_score"][ci] == \
                scorer(one, X[te], y[te]), (combo, k)
