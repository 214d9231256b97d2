"""The boosting variants (GOSS, DART, RF) of the port held against the JAX
package.

The same seeded data and params go through ``lightgbm_tpu.train`` (the
wave grower with the Pallas kernels in interpret mode, or its
partitioned grower) and through ``lightgbm_tpu_torch.train`` on the CPU
(the kernels' plain versions).

* Quantized wave training writes byte-identical model text: GOSS with
  round-half-up and with stochastic rounding; DART with uniform and
  weighted drops and in ``xgboost_dart_mode``, with a valid set whose
  scores the drops rescale; RF with bagging and ``feature_fraction``;
  3-class GOSS and DART.  The valid set's metric history is the
  reference's too.
* Exact training (wave and partitioned grower): the same structure and
  predictions within rtol 1e-5 (the rule of ``tests/test_torch_slice.py``).
* Model text: an RF model saved by the reference loads in the port and
  predicts what the reference predicts; the port's RF text round-trips.
* RF without bagging raises the reference's error.

GOSS samples only after ``int(1 / learning_rate)`` warm-up iterations, so
its cases run at learning_rate 0.5: iterations 2-5 of 6 sample.
"""

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.models.boosting import DART, GOSS, RF
from lightgbm_tpu_torch.models.gbdt import goss_sample_np

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

N, F, ROUNDS, LEAVES = 3000, 6, 6, 7
STRUCTURE = ("num_leaves", "split_feature", "threshold", "decision_type",
             "left_child", "right_child", "leaf_count", "internal_count")

GOSS_P = dict(boosting="goss", learning_rate=0.5, top_rate=0.3,
              other_rate=0.2)
DART_P = dict(boosting="dart", drop_rate=0.5, skip_drop=0.0)
RF_P = dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1,
            feature_fraction=0.8)

QUANTIZED = {
    "goss": dict(GOSS_P),
    "goss_stochastic": dict(GOSS_P, stochastic_rounding=True),
    "dart_weighted": dict(DART_P),
    "dart_uniform": dict(DART_P, uniform_drop=True),
    "dart_xgboost": dict(DART_P, xgboost_dart_mode=True),
    "dart_max_drop": dict(DART_P, max_drop=1),
    "rf": dict(RF_P),
    "multiclass_goss": dict(GOSS_P, objective="multiclass", num_class=3),
    "multiclass_dart": dict(DART_P, objective="multiclass", num_class=3),
}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F)
    X[rng.rand(N, F) < 0.03] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = (x0 + x1 ** 2 + 0.5 * np.nan_to_num(X[:, 3]) + 0.3 * rng.randn(N)
         > 0.8).astype(float)
    ymc = np.digitize(x0 + 0.3 * rng.randn(N), [-0.5, 0.5]).astype(float)
    return X, y, ymc


def _params(quantized=True, **kw):
    p = dict(objective="binary", num_leaves=LEAVES, max_bin=63,
             verbosity=-1, tpu_histogram_impl="pallas",
             tree_grow_mode="wave", use_quantized_grad=quantized,
             stochastic_rounding=False)
    p.update(kw)
    return p


def _train_both(params, with_valid=True):
    X, y, ymc = _data()
    if params.get("objective") == "multiclass":
        y = ymc
    hist_ref, hist_port = {}, {}
    rd = lgb.Dataset(X, y)
    ref = lgb.train(params, rd, ROUNDS,
                    valid_sets=[lgb.Dataset(X[:500], y[:500], reference=rd)]
                    if with_valid else None,
                    callbacks=[lgb.record_evaluation(hist_ref)])
    pd_ = lt.Dataset(X, y)
    port = lt.train(params, pd_, ROUNDS,
                    valid_sets=[lt.Dataset(X[:500], y[:500], reference=pd_)]
                    if with_valid else None,
                    callbacks=[lt.record_evaluation(hist_port)],
                    device="cpu")
    return X, ref, port, hist_ref, hist_port


def _trees(text):
    out = []
    for block in text.split("Tree=")[1:]:
        body = block.split("\n\n")[0]
        out.append(dict(ln.split("=", 1) for ln in body.split("\n")[1:]
                        if "=" in ln))
    return out


@pytest.mark.parametrize("case", list(QUANTIZED))
def test_quantized_text_matches_reference(case):
    X, ref, port, hist_ref, hist_port = _train_both(
        _params(**QUANTIZED[case]))
    assert port.model_to_string() == ref.model_to_string()
    assert hist_port == hist_ref
    np.testing.assert_array_equal(port.predict(X), ref.predict(X))
    gbdt = port._gbdt
    kind = QUANTIZED[case]["boosting"]
    assert type(gbdt) is {"goss": GOSS, "dart": DART, "rf": RF}[kind]
    k = gbdt.num_tree_per_iteration
    assert len(gbdt.models) == ROUNDS * k
    assert all(t.num_leaves > 2 for t in gbdt.models)
    if kind == "dart":
        # every iteration after the first dropped at least once here
        # (skip_drop=0) and the drops rescaled earlier trees
        assert len(gbdt._weights) == ROUNDS
        assert min(gbdt._weights[:-1]) < max(gbdt._weights)
    if kind == "rf":
        assert "average_output" in port.model_to_string()


def test_goss_samples_after_warmup():
    """The GOSS cases sample in iterations 2-5 (learning_rate 0.5): about
    top_rate + other_rate of the rows survive, the others' gradients are
    amplified by (1 - a) / b."""
    X, y, _ = _data()
    params = _params(**GOSS_P)
    bst = lt.Booster(params=params, train_set=lt.Dataset(X, y),
                     device="cpu")
    cfg = bst._gbdt.config
    g = np.linspace(-1, 1, N).astype(np.float32)
    h = np.ones(N, np.float32)
    assert goss_sample_np(cfg, g, h, 1) is None
    sampled = 0
    for it in range(ROUNDS):
        bst.update()
        mask = bst._gbdt._last_sample_mask.numpy()
        if it >= 2:
            sampled += 1
            share = mask.mean()
            assert 0.4 < share < 0.6, share
        else:
            assert mask.min() == 1.0
    assert sampled == ROUNDS - 2
    mask, mult = goss_sample_np(cfg, g, h, 2)
    amp = (1 - cfg.top_rate) / cfg.other_rate
    assert set(np.unique(mult)) == {np.float32(1.0), np.float32(amp)}
    assert np.all(mask[mult != 1.0] == 1.0)


@pytest.mark.parametrize("mode", ["wave", "partition"])
@pytest.mark.parametrize("kind", ["goss", "dart", "rf"])
def test_exact_training_matches_reference(kind, mode):
    extra = {"goss": GOSS_P, "dart": DART_P, "rf": RF_P}[kind]
    X, ref, port, _, _ = _train_both(
        _params(quantized=False, tree_grow_mode=mode, **extra),
        with_valid=False)
    t_ref = _trees(ref.model_to_string())
    t_port = _trees(port.model_to_string())
    assert len(t_ref) == len(t_port) == ROUNDS
    for i, (a, b) in enumerate(zip(t_ref, t_port)):
        for k in STRUCTURE:
            assert a.get(k) == b.get(k), f"tree {i} field {k}"
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_reference_rf_text_loads_in_port(tmp_path):
    X, ref, port, _, _ = _train_both(_params(**RF_P), with_valid=False)
    path = tmp_path / "rf.txt"
    ref.save_model(str(path))
    loaded = lt.Booster(model_file=str(path), device="cpu")
    assert isinstance(loaded._gbdt, RF)
    np.testing.assert_array_equal(loaded.predict(X), ref.predict(X))
    np.testing.assert_array_equal(loaded.predict(X, raw_score=True),
                                  ref.predict(X, raw_score=True))
    # the port's own RF text round-trips: the trees' text (a loaded model
    # writes no training parameters) and the predictions
    again = lt.Booster(model_str=port.model_to_string(), device="cpu")
    trees = port.model_to_string().split("\nparameters:\n")[0]
    assert again.model_to_string().split("\nparameters:\n")[0] == trees
    np.testing.assert_array_equal(again.predict(X), port.predict(X))


def test_rf_without_bagging_refused_as_reference():
    X, y, _ = _data()
    params = _params(boosting="rf")
    with pytest.raises(ValueError) as ref_err:
        lgb.train(params, lgb.Dataset(X, y), 1)
    with pytest.raises(ValueError) as port_err:
        lt.train(params, lt.Dataset(X, y), 1, device="cpu")
    assert str(port_err.value) == str(ref_err.value)


def test_goss_with_bagging_warns_and_ignores_it(capsys):
    X, y, _ = _data()
    params = _params(**GOSS_P, bagging_fraction=0.5, bagging_freq=1,
                     verbosity=0)
    ref = lgb.train(params, lgb.Dataset(X, y), 4)
    capsys.readouterr()
    port = lt.train(params, lt.Dataset(X, y), 4, device="cpu")
    assert "cannot use bagging in GOSS" in capsys.readouterr().out
    assert port.model_to_string() == ref.model_to_string()
