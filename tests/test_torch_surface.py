"""The Booster's training surface of the port held against the JAX
package: custom objectives and metrics, rollback, refit, resetting the
data and the parameters, leaf indices, the prediction early exit.

A Python ``fobj`` hands both packages the same numpy gradients, so
quantized wave text with the same ``fobj`` is byte-identical, and so is
the ``feval`` history; for K classes the flat gradients are class-major
(the reference's ``_coerce``).  Rolled-back-then-continued training
rebuilds the scores tree by tree in f32, as the reference does, and
writes its text byte for byte.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

N, F = 3000, 6


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F)
    X[rng.rand(N, F) < 0.03] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = (x0 + x1 ** 2 + 0.3 * rng.randn(N) > 0.8).astype(float)
    ymc = np.digitize(x0 + 0.3 * rng.randn(N), [-0.5, 0.5]).astype(float)
    return X, y, ymc


def _params(**kw):
    p = dict(objective="binary", num_leaves=7, max_bin=63, verbosity=-1,
             tpu_histogram_impl="pallas", tree_grow_mode="wave",
             use_quantized_grad=True, stochastic_rounding=False)
    p.update(kw)
    return p


def logloss_fobj(preds, dataset):
    """Binary logloss in numpy over the raw scores."""
    label = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-preds.astype(np.float64)))
    return p - label, p * (1.0 - p)


def softmax_fobj(preds, dataset):
    """3-class softmax in numpy, flat and class-major."""
    label = dataset.get_label().astype(int)
    z = preds - preds.max(axis=1, keepdims=True)
    p = np.exp(z) / np.exp(z).sum(axis=1, keepdims=True)
    onehot = np.eye(3)[label]
    grad = p - onehot
    hess = 2.0 * p * (1.0 - p)
    return grad.T.ravel(), hess.T.ravel()


def error_feval(preds, dataset):
    label = dataset.get_label()
    return "my_error", float(np.mean((preds > 0) != (label > 0))), False


def _both(params, rounds, fobj=None, feval=None, multiclass=False):
    X, y, ymc = _data()
    if multiclass:
        y = ymc
    hist = []
    for pkg in (lgb, lt):
        h = {}
        d = pkg.Dataset(X, y)
        v = pkg.Dataset(X[:500], y[:500], reference=d)
        kw = {} if pkg is lgb else {"device": "cpu"}
        bst = pkg.train(params, d, rounds, valid_sets=[v], fobj=fobj,
                        feval=feval,
                        callbacks=[pkg.record_evaluation(h)], **kw)
        hist.append((bst, h))
    (ref, h_ref), (port, h_port) = hist
    return X, ref, port, h_ref, h_port


def test_train_fobj_feval_matches_reference():
    X, ref, port, h_ref, h_port = _both(_params(), 5, logloss_fobj,
                                        error_feval)
    assert port.model_to_string() == ref.model_to_string()
    assert h_port == h_ref
    assert "my_error" in h_port["valid_0"]
    assert port._gbdt.objective is None
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))


def test_multiclass_fobj_class_major_matches_reference():
    X, ref, port, h_ref, h_port = _both(
        _params(objective="multiclass", num_class=3), 3, softmax_fobj,
        multiclass=True)
    assert port.model_to_string() == ref.model_to_string()
    assert port._gbdt.num_tree_per_iteration == 3
    # the (K, N) and (N, K) layouts are the flat class-major one
    gb = port._gbdt
    flat = np.arange(3 * N, dtype=np.float32)
    want = flat.reshape(3, N).T
    for a in (flat, flat.reshape(3, N), want):
        np.testing.assert_array_equal(gb._coerce_gradients(a).numpy(), want)


def test_booster_update_fobj_matches_reference():
    X, y, _ = _data()
    out = []
    for pkg in (lgb, lt):
        kw = {} if pkg is lgb else {"device": "cpu"}
        bst = pkg.Booster(params=_params(objective="none"),
                          train_set=pkg.Dataset(X, y), **kw)
        for _ in range(4):
            bst.update(fobj=logloss_fobj)
        out.append(bst.model_to_string())
    assert out[1] == out[0]


def test_cv_fobj_feval_matches_reference():
    X, y, _ = _data()
    kw = dict(num_boost_round=3, nfold=3, seed=7, fobj=logloss_fobj,
              feval=error_feval)
    ref = lgb.cv(_params(), lgb.Dataset(X, y), **kw)
    got = lt.cv(_params(), lt.Dataset(X, y), device="cpu", **kw)
    assert sorted(got) == sorted(ref)
    assert "valid my_error-mean" in got
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("boosting", ["gbdt", "goss"])
def test_rollback_then_continue_matches_reference(boosting):
    X, y, _ = _data()
    params = _params(boosting=boosting, learning_rate=0.5,
                     bagging_fraction=0.7 if boosting == "gbdt" else 1.0,
                     bagging_freq=1 if boosting == "gbdt" else 0)
    out = []
    for pkg in (lgb, lt):
        kw = {} if pkg is lgb else {"device": "cpu"}
        bst = pkg.Booster(params=params, train_set=pkg.Dataset(X, y), **kw)
        for _ in range(4):
            bst.update()
        bst.rollback_one_iter()
        bst.rollback_one_iter()
        assert bst.current_iteration == 2
        for _ in range(3):
            bst.update()
        out.append((bst.model_to_string(), bst))
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1]._gbdt.score.numpy(),
                                  np.asarray(out[0][1]._gbdt.score))


@pytest.mark.parametrize("decay", [0.9, 1.0])
def test_refit_matches_reference(decay):
    X, y, _ = _data()
    params = _params(use_quantized_grad=False)
    ref = lgb.train(params, lgb.Dataset(X, y), 4)
    port = lt.train(params, lt.Dataset(X, y), 4, device="cpu")
    rng = np.random.RandomState(3)
    X2 = X + 0.1 * rng.randn(*X.shape)
    y2 = (rng.rand(N) < 0.5).astype(float)
    # refit the REFERENCE's trees in both packages: the leaf values must
    # then be equal
    same = lt.Booster(params=params, model_str=ref.model_to_string(),
                      device="cpu")
    r2 = ref.refit(X2, y2, decay_rate=decay)
    p2 = same.refit(X2, y2, decay_rate=decay)
    for a, b in zip(r2._gbdt.models, p2._gbdt.models):
        np.testing.assert_array_equal(b.leaf_value, a.leaf_value)
        np.testing.assert_array_equal(b.leaf_count, a.leaf_count)
    if decay == 1.0:
        for a, b in zip(p2._gbdt.models, same._gbdt.models):
            np.testing.assert_array_equal(a.leaf_value, b.leaf_value)
    np.testing.assert_array_equal(p2.predict(X2), r2.predict(X2))
    # the port's own model refits to values within exact training's
    # tolerance of the reference's
    p3 = port.refit(X2, y2, decay_rate=decay)
    np.testing.assert_allclose(p3.predict(X2), r2.predict(X2), rtol=1e-5,
                               atol=1e-6)


def test_reset_train_data_and_parameter_match_reference():
    X, y, _ = _data()
    rng = np.random.RandomState(9)
    X2 = X + 0.05 * rng.randn(*X.shape)
    out = []
    for pkg in (lgb, lt):
        kw = {} if pkg is lgb else {"device": "cpu"}
        d = pkg.Dataset(X, y)
        bst = pkg.train(_params(), d, 3,
                        callbacks=[pkg.callback.reset_parameter(
                            learning_rate=lambda it: 0.3 * 0.8 ** it)],
                        **kw)
        assert bst._gbdt.config.learning_rate == pytest.approx(0.3 * 0.64)
        bst.reset_train_data(pkg.Dataset(X2, y, reference=d))
        bst.reset_parameter({"learning_rate": 0.05})
        for _ in range(2):
            bst.update()
        out.append(bst.model_to_string())
    assert out[1] == out[0]


def test_pred_leaf_matches_reference():
    X, ref, port, _, _ = _both(_params(), 4)
    lp_ref = ref.predict(X, pred_leaf=True)
    lp = port.predict(X, pred_leaf=True)
    assert lp.dtype == np.int32 and lp.shape == (N, 4)
    np.testing.assert_array_equal(lp, lp_ref)
    vals = np.stack([t.leaf_value[lp[:, i]]
                     for i, t in enumerate(port._gbdt.models)], axis=1)
    np.testing.assert_allclose(vals.sum(axis=1),
                               port.predict(X, raw_score=True), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(
        port.predict(X, pred_leaf=True, start_iteration=1,
                     num_iteration=2), lp[:, 1:3])


@pytest.mark.parametrize("multiclass", [False, True])
def test_pred_early_stop_matches_reference(multiclass):
    extra = dict(objective="multiclass", num_class=3) if multiclass else {}
    X, ref, port, _, _ = _both(_params(**extra), 8, multiclass=multiclass)
    kw = dict(pred_early_stop=True, pred_early_stop_freq=2,
              pred_early_stop_margin=0.5 if multiclass else 1.5)
    got = port.predict(X, raw_score=True, **kw)
    want = ref.predict(X, raw_score=True, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    full = port.predict(X, raw_score=True)
    assert not np.allclose(got, full)   # some rows stopped early
    np.testing.assert_allclose(port.predict(X, **kw), ref.predict(X, **kw),
                               rtol=1e-6, atol=1e-7)


def test_pred_contrib_names_roadmap_item():
    X, y, _ = _data()
    port = lt.train(_params(), lt.Dataset(X, y), 1, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 7"):
        port.predict(X, pred_contrib=True)


def test_surface_accessors():
    X, y, _ = _data()
    cols = [f"c{i}" for i in range(F)]
    port = lt.train(_params(objective="multiclass", num_class=3),
                    lt.Dataset(X, _data()[2], feature_name=cols), 2,
                    device="cpu")
    assert port.num_model_per_iteration() == 3
    assert port.feature_name() == cols
