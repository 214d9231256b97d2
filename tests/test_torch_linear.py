"""Linear trees (``linear_tree=true``) of the port held against the JAX
package.

Linear trees are not bitwise: the reference sums the per-leaf normal
equations in f32 (XLA:CPU's order, ``Precision.HIGHEST``), the port in
f64 (learner/linear.py), so coefficients differ in the last bits and the
later trees' gradients drift.  The tests hold the first tree's structure
equal and the raw predictions within 1e-5 of the prediction scale (max
|raw|).  Measured on this data: at most 2.1e-6 of the scale over seeds 0-2,
binary and L2, exact and quantized, 6 rounds of 7 leaves.

Also: the NaN fallback of a linear leaf, model text and ``convert.py``
carrying the linear fields, a linear model's refit, a valid set with
early stopping, the refusal of sparse input, and ``boosting=goss`` with
``linear_tree`` (a warning, then plain trees).
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import trees_from_reference
from lightgbm_tpu_torch.learner.linear import branch_features
from lightgbm_tpu_torch.models.tree import TreeBatch, predict_raw

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

N, F, ROUNDS = 3000, 6, 6
TOL = 1e-5   # of the prediction scale
STRUCTURE = ("num_leaves", "split_feature", "threshold", "decision_type",
             "left_child", "right_child", "leaf_count", "internal_count")


def _data(objective="regression", seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F)
    X[rng.rand(N, F) < 0.03] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    if objective == "binary":
        y = (x0 + x1 ** 2 + 0.3 * rng.randn(N) > 0.8).astype(float)
    else:
        y = 2 * x0 + np.abs(x1) * x1 + 0.1 * rng.randn(N)
    return X, y


def _params(objective="regression", quantized=False, **kw):
    p = dict(objective=objective, num_leaves=7, max_bin=63, verbosity=-1,
             tpu_histogram_impl="pallas", tree_grow_mode="wave",
             use_quantized_grad=quantized, stochastic_rounding=False,
             linear_tree=True, linear_lambda=0.1)
    p.update(kw)
    return p


def _trees(text):
    out = []
    for block in text.split("Tree=")[1:]:
        body = block.split("\n\n")[0]
        out.append(dict(ln.split("=", 1) for ln in body.split("\n")[1:]
                        if "=" in ln))
    return out


def _assert_close(port_raw, ref_raw):
    scale = np.abs(ref_raw).max()
    np.testing.assert_allclose(port_raw, ref_raw, rtol=0, atol=TOL * scale)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["exact", "quantized"])
@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_linear_trees_match_reference(objective, quantized):
    X, y = _data(objective)
    params = _params(objective, quantized)
    ref = lgb.train(params, lgb.Dataset(X, y), ROUNDS)
    port = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu")
    t_ref = _trees(ref.model_to_string())
    t_port = _trees(port.model_to_string())
    assert len(t_ref) == len(t_port) == ROUNDS
    for k in STRUCTURE + ("is_linear", "num_features"):
        assert t_ref[0].get(k) == t_port[0].get(k), k
    assert t_port[0]["is_linear"] == "1"
    gbdt = port._gbdt
    assert all(t.is_linear for t in gbdt.models)
    assert sum(len(c) for c in gbdt.models[0].leaf_coeff) > 0
    _assert_close(port.predict(X, raw_score=True),
                  ref.predict(X, raw_score=True))
    # the training scores are the prediction's (const + Σ coef·x per row)
    np.testing.assert_allclose(gbdt.score.numpy(),
                               port.predict(X, raw_score=True),
                               rtol=1e-5, atol=1e-5)


def test_linear_leaf_falls_back_on_nan():
    """A row with NaN in one of its leaf's features predicts the plain
    leaf value (tree.cpp PredictionFunLinear), in the tensor walk as in the
    host reference walk ``Tree.predict``."""
    X, y = _data()
    port = lt.train(_params(), lt.Dataset(X, y), 1, device="cpu")
    tree = port._gbdt.models[0]
    lp = port.predict(X, pred_leaf=True)[:, 0]
    # a NaN routes by its node's default direction: take a leaf and one of
    # its features whose NaN keeps some of the leaf's rows there
    found = None
    for leaf, feats in enumerate(tree.leaf_features_inner):
        rows = np.nonzero(lp == leaf)[0][:40]
        for f in feats:
            Xn = X[rows].copy()
            Xn[:, f] = np.nan
            still = port.predict(Xn, pred_leaf=True)[:, 0] == leaf
            if still.any():
                found = leaf, Xn, still
                break
        if found:
            break
    assert found is not None
    leaf, Xn, still = found
    got = port.predict(Xn, raw_score=True)
    np.testing.assert_allclose(got[still], tree.leaf_value[leaf], rtol=1e-6)
    np.testing.assert_allclose(got, tree.predict(Xn), rtol=1e-5, atol=1e-6)
    batch = TreeBatch([tree])
    np.testing.assert_allclose(
        predict_raw(batch, torch.as_tensor(X, dtype=torch.float32)).numpy(),
        tree.predict(X), rtol=1e-5, atol=1e-6)


def test_linear_text_and_convert_carry_linear_fields(tmp_path):
    X, y = _data()
    params = _params()
    ref = lgb.train(params, lgb.Dataset(X, y), 3)
    port = lt.train(params, lt.Dataset(X, y), 3, device="cpu")
    # the port's text round-trips; the reference's text loads in the port
    text = port.model_to_string()
    again = lt.Booster(model_str=text, device="cpu")
    assert again.model_to_string().split("\nparameters:\n")[0] == \
        text.split("\nparameters:\n")[0]
    np.testing.assert_array_equal(again.predict(X), port.predict(X))
    path = tmp_path / "linear.txt"
    ref.save_model(str(path))
    loaded = lt.Booster(model_file=str(path), device="cpu")
    ref_raw = ref.predict(X, raw_score=True)
    np.testing.assert_allclose(loaded.predict(X, raw_score=True), ref_raw,
                               rtol=1e-6, atol=1e-6)
    # convert.py: the reference's trees, arrays in hand
    trees = trees_from_reference(
        [dataclasses.asdict(t) for t in ref._gbdt.models])
    assert all(t.is_linear for t in trees)
    for a, b in zip(trees, ref._gbdt.models):
        assert a.leaf_coeff == b.leaf_coeff
        assert a.leaf_features == b.leaf_features
        np.testing.assert_array_equal(a.leaf_const, b.leaf_const)
    used = ref._gbdt.train_set.used_feature_map
    Xi = torch.as_tensor(X[:, used], dtype=torch.float32)
    np.testing.assert_allclose(predict_raw(TreeBatch(trees), Xi).numpy(),
                               ref_raw, rtol=1e-6, atol=1e-6)


def test_branch_features_match_reference():
    from lightgbm_tpu.learner.linear import branch_features as ref_bf
    X, y = _data()
    port = lt.train(_params(num_leaves=15), lt.Dataset(X, y), 1,
                    device="cpu")
    t = port._gbdt.models[0]
    is_cat = np.array([False, True] + [False] * (F - 2))
    args = (t.split_feature, t.left_child, t.right_child, t.num_leaves,
            is_cat)
    assert branch_features(*args) == ref_bf(*args)


@pytest.mark.parametrize("decay", [0.9, 1.0])
def test_linear_refit_matches_reference(decay):
    X, y = _data()
    params = _params()
    ref = lgb.train(params, lgb.Dataset(X, y), 3)
    port = lt.train(params, lt.Dataset(X, y), 3, device="cpu")
    rng = np.random.RandomState(5)
    X2 = X + 0.05 * rng.randn(*X.shape)
    y2 = y + 0.2
    r2 = ref.refit(X2, y2, decay_rate=decay)
    p2 = port.refit(X2, y2, decay_rate=decay)
    assert p2.device == port.device
    for a, b, old in zip(r2._gbdt.models, p2._gbdt.models,
                         port._gbdt.models):
        assert a.num_leaves == b.num_leaves
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-4,
                                   atol=1e-6)
        if decay == 1.0:
            np.testing.assert_array_equal(b.leaf_value, old.leaf_value)
            np.testing.assert_array_equal(b.leaf_const, old.leaf_const)
    _assert_close(p2.predict(X2, raw_score=True),
                  r2.predict(X2, raw_score=True))


def test_linear_valid_set_early_stopping():
    X, y = _data()
    Xv, yv = X[:600], y[:600] + 3.0 * np.sin(X[:600, 2].clip(-2, 2))
    params = _params(early_stopping_round=2, learning_rate=0.5, metric="l2")
    kw = dict(num_boost_round=30)
    rd = lgb.Dataset(X, y)
    ref = lgb.train(params, rd, valid_sets=[lgb.Dataset(Xv, yv,
                                                        reference=rd)], **kw)
    pd_ = lt.Dataset(X, y)
    port = lt.train(params, pd_, valid_sets=[lt.Dataset(Xv, yv,
                                                        reference=pd_)],
                    device="cpu", **kw)
    assert 0 < port.best_iteration < 30
    assert port.best_iteration == ref.best_iteration
    np.testing.assert_allclose(port.best_score["valid_0"]["l2"],
                               ref.best_score["valid_0"]["l2"], rtol=1e-5)
    # the valid scores are the linear prediction's
    raw = port.predict(Xv, raw_score=True,
                       num_iteration=port.current_iteration)
    np.testing.assert_allclose(port._gbdt.valid_scores[0].numpy(), raw,
                               rtol=1e-5, atol=1e-5)


def test_sparse_input_refused_as_reference():
    X, y = _data()
    X = np.nan_to_num(X)
    with pytest.raises(ValueError) as ref_err:
        lgb.train(_params(), lgb.Dataset(sp.csr_matrix(X), y), 1)
    with pytest.raises(ValueError) as port_err:
        lt.train(_params(), lt.Dataset(sp.csr_matrix(X), y), 1,
                 device="cpu")
    assert str(port_err.value) == str(ref_err.value)


def test_goss_with_linear_tree_trains_plain_trees(capsys):
    X, y = _data()
    params = _params(boosting="goss", learning_rate=0.5, verbosity=0,
                     use_quantized_grad=True)
    ref = lgb.train(params, lgb.Dataset(X, y), 4)
    capsys.readouterr()
    port = lt.train(params, lt.Dataset(X, y), 4, device="cpu")
    assert "linear_tree is not supported with boosting=goss" in \
        capsys.readouterr().out
    assert not any(t.is_linear for t in port._gbdt.models)
    assert port.model_to_string() == ref.model_to_string()
