"""The PyTorch port's training slice held against the JAX package.

``lightgbm_tpu_torch.train`` (device="cpu": the plain PyTorch versions of
the kernels) and ``lightgbm_tpu.train`` with the Pallas kernels in
interpret mode and the wave grower get the same seeded data and params;
their models are compared field by field.

* Quantized training (stochastic_rounding=false) must write byte-identical
  model text, binary and L2 regression.  Binary gradients are bitwise the
  reference's (the port's sigmoid runs XLA:CPU's f32 ``exp`` op for op,
  ops/fmath.py), and the root's right-child sums are rounded once, as the
  reference's jitted grower rounds them in a fused multiply-add
  (ops/split.py ``parent_exact``; ROADMAP queue 3).
* Exact training must give the same tree structure with predictions
  within rtol=1e-5 (the reference's f32 histograms carry bf16 hi+lo
  weights, the port's are fixed point).  That holds for the partitioned
  grower (``tree_grow_mode=partition``) too.
* Quantized leaf renewal (``quant_train_renew_leaf``) renews leaf values
  from exact sums, which again differ by the histogram weights' precision:
  same structure, leaf values within rtol=1e-4, predictions within
  rtol=1e-5.
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

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

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
    params = dict(_params(objective, quantized), **kw)
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
    assert s_port == s_ref
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-6,
                               atol=1e-7)


def test_quantized_binary_tree_matches_unjitted_reference():
    """The first quantized binary tree of the case above, grown by the
    port's wave grower and by the reference's wave grower, jitted (as
    ``lightgbm_tpu.train`` runs it) and UNJITTED, on the same inputs.

    The jitted grower fuses the root's dequantize multiply (int sum x
    scale) into the subtraction that yields the root split's right sums,
    and XLA:CPU contracts the pair into one fused multiply-add; the
    unjitted grower rounds the product first.  The port rounds that
    subtraction once too (ops/split.py ``parent_exact``), so it equals the
    jitted tree in every leaf and node field; the unjitted tree has the
    same structure and one leaf sum an ulp away (ROADMAP queue 3)."""
    import jax.numpy as jnp
    from lightgbm_tpu.learner.wave import make_wave_grow_fn as jax_grow_fn
    from lightgbm_tpu.ops import split as js
    from lightgbm_tpu_torch.binning import MissingType
    from lightgbm_tpu_torch.dataset import pad_rows
    from lightgbm_tpu_torch.learner.wave import make_wave_grow_fn
    from lightgbm_tpu_torch.ops import split as ts

    X, y = _data("binary")
    params = {"objective": "binary", "verbosity": -1}
    ds = lt.Dataset(X, y, params=params)
    ds.construct()
    mappers = [ds.bin_mappers[j] for j in ds.used_feature_map]
    nb = np.array([m.num_bin for m in mappers], np.int32)
    hn = np.array([m.missing_type == MissingType.NAN for m in mappers])
    f, n = len(nb), len(y)
    npad = pad_rows(n)
    xt = np.zeros((f, npad), np.uint8)
    xt[:, :n] = ds.X_binned.T
    # the first tree's gradients: every score at the boost-from-average
    # constant, through the port's objective (bitwise the reference's)
    gb = lt.Booster(params=params, train_set=ds, device="cpu")._gbdt
    grad, hess = gb.objective.get_gradients(gb.score)
    g, h, m = (np.pad(v.numpy(), (0, npad - n))
               for v in (grad, hess, torch.ones(n)))
    sp = js.SplitParams(any_cat=False)
    kw = dict(num_leaves=15, num_features=f, max_bins=255, max_depth=-1,
              wave_size=0, quantized=True, gq_max=2, hq_max=4,
              spec_ramp=True, exact_endgame=True)
    args = (jnp.asarray(xt), jnp.asarray(g), jnp.asarray(h), jnp.asarray(m),
            jnp.asarray(nb), jnp.zeros((f,), bool), jnp.asarray(hn),
            jnp.zeros((f,), jnp.int32), jnp.zeros((f,), jnp.float32), (),
            jnp.ones((f,), bool))
    jitted, unjitted = (
        jax_grow_fn(jit=jit, split_params=sp, hist_impl="pallas",
                    any_cat=False, interpret=True, stochastic=False,
                    **kw)(*args) for jit in (True, False))
    got = make_wave_grow_fn(split_params=ts.SplitParams(**sp._asdict()),
                            **kw)(
        torch.from_numpy(xt), torch.from_numpy(g), torch.from_numpy(h),
        torch.from_numpy(m), torch.from_numpy(nb), torch.from_numpy(hn),
        torch.ones(f, dtype=torch.bool))
    assert got.num_leaves == int(jitted.num_leaves) == 15
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "leaf_count", "leaf_weight", "leaf_value",
                 "internal_weight", "internal_value", "split_gain"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jitted, name)),
                                      err_msg=name)
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "leaf_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(unjitted, name)),
                                      err_msg=name)
    assert not np.array_equal(got.leaf_weight.numpy(),
                              np.asarray(unjitted.leaf_weight))


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_exact_training_matches_reference(objective):
    X, ref, port = _train_both(objective, False)
    _assert_same_structure(_trees(ref.model_to_string()),
                           _trees(port.model_to_string()), 1e-4)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)


def _assert_close_predictions(X, ref, port):
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_partition_training_matches_reference(objective):
    X, ref, port = _train_both(objective, False,
                               tree_grow_mode="partition")
    assert port._gbdt.learner.grow_mode == "partition"
    assert port._gbdt.last_hist_passes == 0
    _assert_same_structure(_trees(ref.model_to_string()),
                           _trees(port.model_to_string()), 1e-4)
    _assert_close_predictions(X, ref, port)


def _warnings_of(fn):
    from lightgbm_tpu_torch.utils.log import register_log_callback
    lines = []
    register_log_callback(lines.append)
    try:
        out = fn()
    finally:
        register_log_callback(None)
    return out, "".join(lines)


def test_two_leaves_fall_back_to_partition():
    """tree_grow_mode=wave with num_leaves=2 warns and grows with the
    partitioned grower, as the reference does."""
    X, y = _data("regression")
    params = dict(_params("regression", False), num_leaves=2, verbosity=0)
    port, said = _warnings_of(lambda: lt.train(params, lt.Dataset(X, y),
                                               ROUNDS, device="cpu"))
    assert "falling back to the partitioned grower" in said
    assert port._gbdt.learner.grow_mode == "partition"
    ref = lgb.train(params, lgb.Dataset(X, y), ROUNDS)
    _assert_same_structure(_trees(ref.model_to_string()),
                           _trees(port.model_to_string()), 1e-4)
    _assert_close_predictions(X, ref, port)


def test_quantized_under_partition_trains_exact():
    """use_quantized_grad under the partitioned grower warns and trains
    exact gradients, like the reference."""
    X, y = _data("binary")
    params = dict(_params("binary", True), tree_grow_mode="partition",
                  verbosity=0)
    port, said = _warnings_of(lambda: lt.train(params, lt.Dataset(X, y),
                                               ROUNDS, device="cpu"))
    assert "training with exact gradients" in said
    assert not port._gbdt.learner.quantized
    exact = lt.train(dict(params, use_quantized_grad=False),
                     lt.Dataset(X, y), ROUNDS, device="cpu")
    np.testing.assert_array_equal(port.predict(X), exact.predict(X))
    ref = lgb.train(params, lgb.Dataset(X, y), ROUNDS)
    _assert_same_structure(_trees(ref.model_to_string()),
                           _trees(port.model_to_string()), 1e-4)
    _assert_close_predictions(X, ref, port)


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_quant_train_renew_leaf_matches_reference(objective):
    X, ref, port = _train_both(objective, True, quant_train_renew_leaf=True)
    assert port._gbdt.learner.quantized
    _assert_same_structure(_trees(ref.model_to_string()),
                           _trees(port.model_to_string()), 1e-4)
    _assert_close_predictions(X, ref, port)
    # renewal moved the leaves off their quantized values
    _, y = _data(objective)
    plain = lt.train(_params(objective, True), lt.Dataset(X, y), ROUNDS,
                     device="cpu")
    assert not np.array_equal(plain.predict(X), port.predict(X))


def test_bagging_and_feature_fraction_match_reference():
    """The host samplers are copies, so bagged trees match too."""
    X, ref, port = _train_both("regression", True, bagging_fraction=0.7,
                               bagging_freq=1, feature_fraction=0.8)
    assert port.model_to_string() == ref.model_to_string()


def test_binned_matrix_matches_reference():
    """The port bins as the reference does, its columns spread over a
    thread pool: more columns than cores, NaNs, two bin budgets."""
    rng = np.random.RandomState(6)
    X = rng.randn(3000, 64) * rng.rand(64) * 10
    X[rng.rand(*X.shape) < 0.03] = np.nan
    for max_bin in (15, 255):
        params = {"max_bin": max_bin, "verbosity": -1}
        ref = lgb.Dataset(X, rng.rand(3000), params=params)
        ref.construct(None)
        port = lt.Dataset(X, rng.rand(3000), params=params)
        port.construct()
        np.testing.assert_array_equal(port.X_binned, ref.X_binned)


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


def test_reference_partitioned_model_predicts_the_same_in_the_port():
    """A model the reference's partitioned grower trained, carried into
    the port through ``convert.trees_from_reference``."""
    import dataclasses
    X, y = _data("regression", seed=4)
    ref = lgb.train(dict(_params("regression", False),
                         tree_grow_mode="partition"), lgb.Dataset(X, y),
                    ROUNDS)
    via_arrays = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    via_arrays._gbdt.models = trees_from_reference(
        [dataclasses.asdict(t) for t in ref._gbdt.models])
    np.testing.assert_allclose(via_arrays.predict(X), ref.predict(X),
                               rtol=1e-6, atol=1e-7)


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
    dict(tree_learner="data"),
    dict(tree_learner="voting"),
    dict(tree_learner="feature"),
    dict(tree_learner="data", max_bin=511),
])
def test_unported_options_raise(extra):
    """The parallel learners in a world of one process (no
    ``distributed.init``): the serial learner grows the trees, as the
    reference's does on a one-device mesh (lightgbm_tpu/parallel/
    __init__.py:33-46), so the model is ``tree_learner=serial``'s; at
    ``max_bin=511`` too, where both serial learners take uint16 bins."""
    from lightgbm_tpu_torch.learner.serial import SerialTreeLearner
    X, y = _data("regression")
    params = dict(_params("regression", False), **extra)
    bst = lt.train(params, lt.Dataset(X, y), 2, device="cpu")
    assert type(bst._gbdt.learner) is SerialTreeLearner
    serial = lt.train(dict(params, tree_learner="serial"), lt.Dataset(X, y),
                      2, device="cpu")
    assert _trees(bst.model_to_string()) == _trees(serial.model_to_string())
    assert len(_trees(bst.model_to_string())) == 2


def test_port_imports_without_jax_or_the_reference():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['lightgbm_tpu'] = None\n"
            "import lightgbm_tpu_torch\n"
            "import lightgbm_tpu_torch.convert\n"
            "import lightgbm_tpu_torch.distributed\n"
            "import lightgbm_tpu_torch.parallel.mesh\n"
            "import lightgbm_tpu_torch.parallel.data_parallel\n"
            "import lightgbm_tpu_torch.parallel.voting_parallel\n"
            "import lightgbm_tpu_torch.parallel.feature_parallel\n"
            "import lightgbm_tpu_torch.learner.partitioned\n"
            "import lightgbm_tpu_torch.ops.fmath\n"
            "import lightgbm_tpu_torch.ops.cuda_lib\n"
            "import lightgbm_tpu_torch.sklearn\n"
            "import lightgbm_tpu_torch.cli\n"
            "import lightgbm_tpu_torch.__main__\n"
            "import lightgbm_tpu_torch.multitrain.sweep\n"
            "from lightgbm_tpu_torch.multitrain import GridSearchCVMany\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
