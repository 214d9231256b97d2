"""The PyTorch port's training slice held against the JAX package.

``lightgbm_tpu_torch.train`` (device="cpu": the plain PyTorch versions of
the kernels) and ``lightgbm_tpu.train`` with the Pallas kernels in
interpret mode and the wave grower get the same seeded data and params;
their models are compared field by field.

* Quantized training (stochastic_rounding=false) must give the same tree
  structure, leaf values within rtol=1e-6 and, for L2 regression,
  byte-identical model text.  Binary gradients go through ``exp``, which
  PyTorch and XLA round differently in the last ulp now and then, so a
  leaf value may move by an ulp (ROADMAP queue 3).
* Exact training must give the same tree structure with predictions
  within rtol=1e-5 (the reference's f32 histograms carry bf16 hi+lo
  weights, the port's are fixed point).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.convert import trees_from_reference

N, F, ROUNDS = 6000, 6, 5
STRUCTURE = ("num_leaves", "split_feature", "threshold", "decision_type",
             "left_child", "right_child", "leaf_count", "internal_count")
VALUES = ("leaf_value", "leaf_weight", "internal_value", "internal_weight",
          "split_gain")


def _data(objective, seed=0, n=N):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    if objective == "binary":
        y = (x0 + x1 ** 2 + 0.3 * rng.randn(n) > 0.8).astype(float)
    else:
        y = 2 * x0 + np.sin(3 * x1) + 0.1 * rng.randn(n)
    return X, y


def _params(objective, quantized, **kw):
    return dict(objective=objective, num_leaves=15, verbosity=-1,
                tpu_histogram_impl="pallas", tree_grow_mode="wave",
                use_quantized_grad=quantized, stochastic_rounding=False,
                **kw)


def _trees(text):
    """Per-tree {field: value string} blocks of a model text."""
    out = []
    for block in text.split("Tree=")[1:]:
        body = block.split("\n\n")[0]
        out.append(dict(ln.split("=", 1) for ln in body.split("\n")[1:]
                        if "=" in ln))
    return out


def _train_both(objective, quantized, **kw):
    X, y = _data(objective)
    params = _params(objective, quantized, **kw)
    ref = lgb.train(params, lgb.Dataset(X, y), ROUNDS)
    port = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu")
    return X, ref, port


def _assert_same_structure(t_ref, t_port, value_rtol):
    assert len(t_ref) == len(t_port)
    for i, (a, b) in enumerate(zip(t_ref, t_port)):
        for k in STRUCTURE:
            assert a.get(k) == b.get(k), f"tree {i} field {k}"
        for k in VALUES:
            if k in a:
                np.testing.assert_allclose(
                    np.array(b[k].split(), float), np.array(a[k].split(), float),
                    rtol=value_rtol, atol=value_rtol * 1e-3,
                    err_msg=f"tree {i} field {k}")


@pytest.mark.parametrize("objective", ["regression", "binary"])
@pytest.mark.parametrize("wave_size", [0, 4])
def test_quantized_training_matches_reference(objective, wave_size):
    X, ref, port = _train_both(objective, True, tpu_wave_size=wave_size)
    s_ref, s_port = ref.model_to_string(), port.model_to_string()
    _assert_same_structure(_trees(s_ref), _trees(s_port), 1e-6)
    if objective == "regression":
        assert s_port == s_ref
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-6,
                               atol=1e-7)


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_exact_training_matches_reference(objective):
    X, ref, port = _train_both(objective, False)
    _assert_same_structure(_trees(ref.model_to_string()),
                           _trees(port.model_to_string()), 1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)


def test_bagging_and_feature_fraction_match_reference():
    """The host samplers are copies, so bagged trees match too."""
    X, ref, port = _train_both("regression", True, bagging_fraction=0.7,
                               bagging_freq=1, feature_fraction=0.8)
    assert port.model_to_string() == ref.model_to_string()


def test_save_load_round_trip(tmp_path):
    X, y = _data("binary", seed=1)
    bst = lt.train(_params("binary", True), lt.Dataset(X, y), 3,
                   device="cpu")
    path = tmp_path / "model.txt"
    bst.save_model(str(path))
    again = lt.Booster(model_file=str(path), device="cpu")
    assert again.model_to_string().split("feature_importances:")[0] == \
        bst.model_to_string().split("feature_importances:")[0]
    np.testing.assert_array_equal(again.predict(X), bst.predict(X))


def test_reference_model_predicts_the_same_in_the_port():
    """A model the JAX package trained, carried into the port both through
    model text and through ``convert.trees_from_reference``."""
    import dataclasses
    X, y = _data("binary", seed=2)
    ref = lgb.train(_params("binary", False), lgb.Dataset(X, y), ROUNDS)
    expect = ref.predict(X)
    via_text = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    np.testing.assert_allclose(via_text.predict(X), expect, rtol=1e-6,
                               atol=1e-7)
    via_arrays = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    via_arrays._gbdt.models = trees_from_reference(
        [dataclasses.asdict(t) for t in ref._gbdt.models])
    np.testing.assert_allclose(via_arrays.predict(X), expect, rtol=1e-6,
                               atol=1e-7)


def test_valid_set_metric_tracks_training():
    X, y = _data("binary", seed=3)
    train = lt.Dataset(X[:4000], y[:4000])
    valid = train.create_valid(X[4000:], y[4000:])
    evals = {}
    from lightgbm_tpu_torch.callback import record_evaluation
    bst = lt.train(dict(_params("binary", True), metric="auc"), train, 4,
                   valid_sets=[valid], callbacks=[record_evaluation(evals)],
                   device="cpu")
    auc = evals["valid_0"]["auc"]
    assert len(auc) == 4 and auc[-1] > 0.8
    np.testing.assert_allclose(
        bst.predict(X[4000:], raw_score=True),
        bst._gbdt.valid_scores[0].numpy(), rtol=1e-6, atol=1e-6)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _data("regression")
    with pytest.raises(lt.DeviceUnavailableError, match="device='cpu'"):
        lt.train(_params("regression", True), lt.Dataset(X, y), 1)
    with pytest.raises(lt.DeviceUnavailableError):
        lt.Booster(model_str="tree\n")


@pytest.mark.parametrize("extra", [
    dict(stochastic_rounding=True, use_quantized_grad=True),
    dict(boosting="goss"),
    dict(objective="multiclass", num_class=3),
    dict(monotone_constraints=[1, 0, 0, 0, 0, 0]),
    dict(tree_grow_mode="partition"),
])
def test_unported_options_raise(extra):
    X, y = _data("regression")
    params = dict(_params("regression", False), **extra)
    with pytest.raises(NotImplementedError):
        lt.train(params, lt.Dataset(X, y), 1, device="cpu")


def test_port_imports_without_jax_or_the_reference():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['lightgbm_tpu'] = None\n"
            "import lightgbm_tpu_torch\n"
            "import lightgbm_tpu_torch.convert\n"
            "import lightgbm_tpu_torch.ops.cuda_lib\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
