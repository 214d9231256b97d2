"""The port's remaining objectives, multiclass, by-node sampling,
extra-trees and stochastic rounding held against the JAX package.

``lightgbm_tpu_torch.train`` (device="cpu", the plain versions of the
kernels) and ``lightgbm_tpu.train`` (Pallas kernels in interpret mode)
get the same seeded data and params.  The bars:

* Gradients: bitwise for every objective whose reference runs its ops
  eagerly with ``exp`` (the port's ``ops/fmath.exp_f32`` is XLA:CPU's):
  the regression zoo, binary, both cross entropies unweighted, softmax
  and one-vs-all.  Weighted ``cross_entropy_lambda`` also takes
  ``log1p``, which the port runs as ``torch.log1p``, not XLA:CPU's; the
  ranking objectives are jitted in the reference, where XLA fuses and
  reorders their f32 sums.  Those three agree within f32 rounding (rtol
  1e-5, atol 1e-6 x the largest gradient).
* Quantized training (``use_quantized_grad=true`` with stochastic
  rounding at its default) writes byte-identical model text wherever the
  gradients are bitwise: the threefry stream is jax's bit for bit
  (tests/test_torch_rng.py), so every row rounds the same way.
* Exact training grows the same trees with predictions within rtol 1e-5
  (the port's histograms sum fixed point, the reference's bf16 hi+lo
  pairs; ROADMAP queue 3 item 3).
* L1, quantile and MAPE renew their leaves to residual percentiles.
"""

import copy

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lgb
import lightgbm_tpu.objective as jobj
import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.objective as tobj
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.dataset import Metadata as JMetadata
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.dataset import Metadata as TMetadata
from lightgbm_tpu_torch.objective.base import weighted_percentile
from lightgbm_tpu_torch.ops.split import node_feature_mask, node_rand_bins
from lightgbm_tpu_torch.utils.random import prng_key

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

N, F, ROUNDS = 2000, 5, 3
STRUCTURE = ("num_leaves", "split_feature", "threshold", "decision_type",
             "left_child", "right_child", "leaf_count", "internal_count")
VALUES = ("leaf_value", "leaf_weight", "internal_value", "internal_weight",
          "split_gain")
REGRESSION_ZOO = ("regression", "regression_l1", "huber", "fair", "poisson",
                  "quantile", "mape", "gamma", "tweedie", "cross_entropy",
                  "cross_entropy_lambda")
ALL = REGRESSION_ZOO + ("binary", "multiclass", "multiclassova",
                        "lambdarank", "rank_xendcg")
BITWISE_GRAD_OFF = {("cross_entropy_lambda", True), ("lambdarank", False),
                    ("lambdarank", True), ("rank_xendcg", False),
                    ("rank_xendcg", True)}


def _features(n=N, f=F, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    X[rng.rand(n, f) < 0.05] = np.nan
    return X, rng


def _label(objective, X, rng, num_class=3):
    """A label of the kind ``objective`` takes, from the features."""
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    z = 2 * x0 + np.sin(3 * x1) + 0.1 * rng.randn(len(X))
    if objective == "binary":
        return (x0 + x1 ** 2 + 0.3 * rng.randn(len(X)) > 0.8).astype(float)
    if objective in ("multiclass", "multiclassova"):
        cuts = np.quantile(z, np.linspace(0, 1, num_class + 1)[1:-1])
        return np.digitize(z, cuts).astype(float)
    if objective in ("poisson", "tweedie"):
        return rng.poisson(np.exp(0.3 * z)).astype(float)
    if objective == "gamma":
        return rng.gamma(2.0, np.exp(0.2 * z) / 2.0)
    if objective in ("cross_entropy", "cross_entropy_lambda"):
        return 1.0 / (1.0 + np.exp(-z))
    if objective in ("lambdarank", "rank_xendcg"):
        return np.clip(np.round(z / 2 + 2), 0, 4)
    if objective == "mape":
        return z + 3.0 * np.sign(z)
    return z


def _groups(n, seed=0):
    rng = np.random.RandomState(seed + 1)
    g = rng.randint(2, 40, n)
    g = g[np.cumsum(g) <= n]
    return np.append(g, n - g.sum()) if g.sum() < n else g


def _params(objective, **kw):
    p = dict(objective=objective, num_leaves=15, verbosity=-1,
             tpu_histogram_impl="pallas", tree_grow_mode="wave")
    if objective in ("multiclass", "multiclassova"):
        p["num_class"] = 3
    p.update(kw)
    return p


def _datasets(objective, n=N, f=F, weight=None, seed=0, **label_kw):
    X, rng = _features(n, f, seed)
    y = _label(objective, X, rng, **label_kw)
    group = _groups(n, seed) if objective in ("lambdarank",
                                               "rank_xendcg") else None
    ref = lgb.Dataset(X, y, weight=weight, group=group)
    port = lt.Dataset(X, y, weight=weight, group=group)
    return X, y, ref, port


def _train_both(objective, rounds=ROUNDS, n=N, f=F, weight=None,
                label_kw=None, **kw):
    X, y, dref, dport = _datasets(objective, n, f, weight,
                                  **(label_kw or {}))
    params = _params(objective, **kw)
    ref = lgb.train(params, dref, rounds)
    port = lt.train(params, dport, rounds, device="cpu")
    return X, y, ref, port


def _trees(text):
    """Per-tree {field: value string} blocks of a model text."""
    out = []
    for block in text.split("Tree=")[1:]:
        body = block.split("\n\n")[0]
        out.append(dict(ln.split("=", 1) for ln in body.split("\n")[1:]
                        if "=" in ln))
    return out


def _leaf_of(tree, X):
    """The leaf every row of ``X`` reaches in a host tree."""
    probe = copy.copy(tree)
    probe.leaf_value = np.arange(tree.num_leaves, dtype=np.float64)
    return probe.predict(np.asarray(X, np.float32)).astype(int)


def _routed_apart(ref, port, X):
    """(N,) bool: the rows that reach another leaf of some tree in the two
    models (the reference's trees read back through the port's loader)."""
    again = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    apart = np.zeros(len(X), bool)
    for t_ref, t_port in zip(again._gbdt.models, port._gbdt.models):
        apart |= _leaf_of(t_ref, X) != _leaf_of(t_port, X)
    return apart


def _assert_same_structure(ref, port, value_rtol=1e-4, ties=False):
    """Every structural field equal; every value field within
    ``value_rtol`` of the reference, relative to the value or to the
    field's largest magnitude in the tree (a node value is a difference of
    sums, and the fixed-point and bf16 sums differ relative to the sums,
    not to their difference).

    ``ties`` (exact training): a node may take another threshold or send
    NaN the other way when both splits are a tie, the same features, child
    counts and gains (within ``value_rtol``).  The reference's bf16 sums
    and f32 histogram subtraction leave rounding residues (empty bins read
    +-1e-9) that break such ties at random; the port's fixed-point sums
    are exact and its scan takes the first tied bin.
    :func:`_assert_predictions` then leaves out the few rows the two
    choices route apart."""
    t_ref, t_port = _trees(ref.model_to_string()), \
        _trees(port.model_to_string())
    assert len(t_ref) == len(t_port)
    for i, (a, b) in enumerate(zip(t_ref, t_port)):
        for k in STRUCTURE:
            if not (ties and k in ("threshold", "decision_type")):
                assert a.get(k) == b.get(k), f"tree {i} field {k}"
        for k in VALUES:
            if k in a:
                want = np.array(a[k].split(), float)
                np.testing.assert_allclose(
                    np.array(b[k].split(), float), want, rtol=value_rtol,
                    atol=value_rtol * np.abs(want).max(),
                    err_msg=f"tree {i} field {k}")


def _assert_text_equal(ref, port):
    s_ref, s_port = ref.model_to_string(), port.model_to_string()
    if s_ref != s_port:
        _assert_same_structure(ref, port, 0.0)
    assert s_port == s_ref


def _assert_predictions(X, ref, port, rtol=1e-5, ties=False):
    """Raw scores and transformed predictions within ``rtol``, relative to
    each value or to the largest magnitude of its kind (the exact
    deviation is one of the sums, so a score near 0 or a probability near
    0 carries the deviation of its larger neighbours).  ``ties``: rows a
    tied split routes apart (:func:`_assert_same_structure`) are left
    out; at most 1% of the rows may be."""
    keep = slice(None)
    if ties:
        apart = _routed_apart(ref, port, X)
        assert apart.mean() <= 0.01, f"{apart.sum()} rows routed apart"
        keep = ~apart
    for raw in (True, False):
        want = ref.predict(X, raw_score=raw)[keep]
        got = port.predict(X, raw_score=raw)[keep]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(want).max()))


# -- gradients ----------------------------------------------------------------

def _objective_pair(objective, weighted, n=3000, seed=0):
    X, rng = _features(n, F, seed)
    y = _label(objective, X, rng)
    params = {"objective": objective}
    if objective in ("multiclass", "multiclassova"):
        params["num_class"] = 3
    pair = []
    for md_cls, cfg_cls, mod in ((JMetadata, JConfig, jobj),
                                 (TMetadata, TConfig, tobj)):
        md = md_cls()
        md.set_label(y)
        if weighted:
            md.set_weight(np.random.RandomState(seed + 2).rand(n) + 0.5)
        if objective in ("lambdarank", "rank_xendcg"):
            md.set_group(_groups(n, seed))
        obj = mod.create_objective(objective, cfg_cls(params))
        obj.init(md, n)
        pair.append(obj)
    return pair, rng


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("objective", ALL)
def test_gradients_match_reference(objective, weighted):
    """Same scores into both objectives, twice (``rank_xendcg`` draws new
    gammas each call): bitwise, or within f32 rounding for the ops the
    module docstring names."""
    (ref, port), rng = _objective_pair(objective, weighted)
    k = port.num_model_per_iteration
    assert k == ref.num_model_per_iteration
    for _ in range(2):
        shape = (3000,) if k == 1 else (3000, k)
        score = (rng.randn(*shape) * 1.5).astype(np.float32)
        g_ref, h_ref = (np.asarray(a) for a in
                        ref.get_gradients(jnp.asarray(score)))
        g, h = (a.numpy() for a in port.get_gradients(torch.as_tensor(score)))
        assert g.shape == g_ref.shape and h.shape == h_ref.shape
        assert g.dtype == np.float32 and h.dtype == np.float32
        if (objective, weighted) in BITWISE_GRAD_OFF:
            for got, want in ((g, g_ref), (h, h_ref)):
                np.testing.assert_allclose(
                    got, want, rtol=1e-5,
                    atol=1e-6 * max(1.0, float(np.abs(want).max())))
        else:
            np.testing.assert_array_equal(g, g_ref)
            np.testing.assert_array_equal(h, h_ref)
    for cid in range(k):
        assert port.boost_from_score(cid) == ref.boost_from_score(cid)


@pytest.mark.parametrize("objective", ALL)
def test_convert_output_matches_reference(objective):
    (ref, port), rng = _objective_pair(objective, False, n=500)
    k = port.num_model_per_iteration
    score = (rng.randn(500, k) if k > 1 else rng.randn(500)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        port.convert_output(torch.as_tensor(score)).numpy(),
        np.asarray(ref.convert_output(jnp.asarray(score))), rtol=1e-6,
        atol=1e-7)


def test_weighted_percentile_is_the_reference_function():
    from lightgbm_tpu.objective.base import weighted_percentile as ref_wp
    rng = np.random.RandomState(3)
    for n in (1, 2, 7, 100):
        v = rng.randn(n).astype(np.float32)
        w = rng.rand(n).astype(np.float32)
        for alpha in (0.1, 0.5, 0.9):
            assert weighted_percentile(v, None, alpha) == \
                ref_wp(v, None, alpha)
            assert weighted_percentile(v, w, alpha) == ref_wp(v, w, alpha)


# -- stochastic rounding ------------------------------------------------------

@pytest.mark.parametrize("bagging", [False, True])
@pytest.mark.parametrize("levels", [4, 16, 254])
@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_stochastic_quantized_text_matches_reference(objective, levels,
                                                     bagging):
    """The default quantized configuration (stochastic rounding on),
    uint8 bins."""
    extra = dict(bagging_fraction=0.7, bagging_freq=1) if bagging else {}
    X, _, ref, port = _train_both(objective, use_quantized_grad=True,
                                  num_grad_quant_bins=levels, **extra)
    assert port._gbdt.learner.quantized and \
        port._gbdt.config.stochastic_rounding
    _assert_text_equal(ref, port)


@pytest.mark.parametrize("bagging", [False, True])
@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_stochastic_quantized_packed_text_matches_reference(objective,
                                                            bagging):
    """max_bin=15: nibble-packed bins, stochastic rounding."""
    extra = dict(bagging_fraction=0.7, bagging_freq=1) if bagging else {}
    X, _, ref, port = _train_both(objective, use_quantized_grad=True,
                                  num_grad_quant_bins=16, max_bin=15,
                                  **extra)
    assert port._gbdt.learner.pack4
    _assert_text_equal(ref, port)


def test_stochastic_rounding_moves_the_trees():
    """The stream is really drawn: the same run with round-half-up grows
    other trees."""
    X, y, _, dport = _datasets("regression")
    p = _params("regression", use_quantized_grad=True)
    a = lt.train(p, dport, ROUNDS, device="cpu").model_to_string()
    b = lt.train(dict(p, stochastic_rounding=False), dport, ROUNDS,
                 device="cpu").model_to_string()
    assert a != b


def test_partitioned_grower_trains_exact_under_quantized_grad():
    """use_quantized_grad on the partitioned grower trains exact, as in
    the reference: same structure, predictions within 1e-5."""
    X, _, ref, port = _train_both("binary", use_quantized_grad=True,
                                  tree_grow_mode="partition")
    assert not port._gbdt.learner.quantized
    _assert_same_structure(ref, port, ties=True)
    _assert_predictions(X, ref, port, ties=True)


# -- by-node sampling and extra-trees -----------------------------------------

# Exact comparisons keep splits out of the reference's noise band: its
# bf16 hi+lo histogram sums sit up to 4e-5 (relative) off the float64 sums
# on these shapes, the port's fixed-point sums 1.5e-6 (measured on a
# 95-row leaf's hessian sum), so a split whose gain is f32 noise or a leaf
# of a few rows can be ordered either way (ROADMAP queue 3 item 3).
EXACT_MARGIN = dict(min_gain_to_split=1e-3, min_data_in_leaf=40)

NODE_OPTIONS = {"bynode": dict(feature_fraction_bynode=0.5),
                "extra_trees": dict(extra_trees=True),
                "both": dict(feature_fraction_bynode=0.5, extra_trees=True)}


@pytest.mark.parametrize("option", list(NODE_OPTIONS))
def test_node_sampling_quantized_text_matches_reference(option):
    X, _, ref, port = _train_both("binary", use_quantized_grad=True,
                                  **NODE_OPTIONS[option])
    _assert_text_equal(ref, port)


@pytest.mark.parametrize("grow_mode", ["wave", "partition"])
@pytest.mark.parametrize("option", list(NODE_OPTIONS))
def test_node_sampling_exact_matches_reference(option, grow_mode):
    """Exact training with per-node draws.  A node whose sampled features
    or random thresholds leave it no real split has candidates with gains
    of f32 rounding noise (1e-5 against a root gain of ~500), which the
    fixed-point and bf16 histograms order differently; ``EXACT_MARGIN``
    keeps such splits out of both packages' trees."""
    X, _, ref, port = _train_both("binary", tree_grow_mode=grow_mode,
                                  **EXACT_MARGIN, **NODE_OPTIONS[option])
    _assert_same_structure(ref, port, ties=True)
    _assert_predictions(X, ref, port, ties=True)


def test_node_draws_match_reference_streams():
    """The growers' per-node draws against the reference's formulas, node
    by node (reference wave.py:838-856)."""
    import jax
    ids = torch.tensor([30, 0, 1, 4, 5, 12, 13])
    nb = torch.tensor([256, 17, 2, 1, 64], dtype=torch.int32)
    key = prng_key(7)
    mask = node_feature_mask(key, ids, 5, 0.5)
    rb = node_rand_bins(key, ids, nb)
    jk = jax.random.PRNGKey(7)
    hi = np.maximum(nb.numpy() - 2, 0)
    for i, node in enumerate(ids.tolist()):
        r = jax.random.uniform(jax.random.fold_in(jk, node), (5,))
        kth = jax.lax.top_k(r, 3)[0][-1]
        np.testing.assert_array_equal(mask[i].numpy(), np.asarray(r >= kth))
        want = jnp.minimum((r * jnp.asarray(hi + 1, jnp.float32))
                           .astype(jnp.int32), jnp.asarray(hi))
        np.testing.assert_array_equal(rb[i].numpy(), np.asarray(want))
    assert int(mask.sum()) == 3 * len(ids)


# -- the objectives in training -----------------------------------------------

@pytest.mark.parametrize("objective", REGRESSION_ZOO)
def test_quantized_objective_text_matches_reference(objective):
    """Bitwise gradients, stochastic rounding: byte-identical text (the
    percentile objectives renew their leaves in both packages)."""
    X, _, ref, port = _train_both(objective, use_quantized_grad=True)
    _assert_text_equal(ref, port)
    _assert_predictions(X, ref, port, rtol=1e-6)


def test_weighted_cross_entropy_lambda_matches_reference():
    """Weighted ``cross_entropy_lambda``: its ``log1p`` is torch's, not
    XLA:CPU's (gradients within f32 rounding), so exact training is held
    to the same structure and predictions within rtol 1e-5."""
    w = np.random.RandomState(5).rand(N) + 0.5
    X, _, ref, port = _train_both("cross_entropy_lambda", weight=w)
    _assert_same_structure(ref, port, ties=True)
    _assert_predictions(X, ref, port, ties=True)


@pytest.mark.parametrize("objective", ["regression_l1", "quantile", "mape"])
def test_percentile_objectives_renew_leaves(objective):
    """Each leaf of the second tree is the alpha-percentile of its rows'
    residuals after the first tree (times the learning rate), computed
    here from the model alone."""
    X, y, _, dport = _datasets(objective)
    params = _params(objective, alpha=0.3, learning_rate=0.5)
    bst = lt.train(params, dport, 2, device="cpu")
    obj = bst._gbdt.objective
    assert obj.is_renew_tree_output
    score = bst.predict(X, raw_score=True, num_iteration=1)
    resid = y.astype(np.float32) - score
    tree = bst._gbdt.models[1]
    leaf_of = _leaf_of(tree, X)
    w = obj.label_weight.numpy() if objective == "mape" else None
    alpha = obj.renew_alpha
    for leaf in range(tree.num_leaves):
        sel = leaf_of == leaf
        want = weighted_percentile(resid[sel], None if w is None else w[sel],
                                   alpha) * 0.5
        np.testing.assert_allclose(tree.leaf_value[leaf], want, rtol=1e-5,
                                   atol=1e-6)


# -- multiclass ---------------------------------------------------------------

@pytest.mark.parametrize("num_class", [3, 5])
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_quantized_multiclass_text_matches_reference(objective, num_class):
    X, _, ref, port = _train_both(objective, use_quantized_grad=True,
                                  num_class=num_class,
                                  label_kw=dict(num_class=num_class))
    assert port.predict(X).shape == (N, num_class)
    _assert_text_equal(ref, port)


@pytest.mark.parametrize("grow_mode", ["wave", "partition"])
@pytest.mark.parametrize("num_class", [3, 5])
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_exact_multiclass_matches_reference(objective, num_class, grow_mode):
    """Exact K-class training, (N, K) predictions.  The rows carry random
    weights: unweighted, the first iteration's gradients take two values
    per class, so many splits tie exactly (swap rows of one class for as
    many of the same class) and the reference's rounding residues pick
    among them (:func:`_assert_same_structure`), after which the models
    differ on those rows by design."""
    w = np.random.RandomState(9).rand(N) + 0.5
    X, _, ref, port = _train_both(objective, num_class=num_class,
                                  tree_grow_mode=grow_mode, weight=w,
                                  label_kw=dict(num_class=num_class))
    assert port.num_trees() == ROUNDS * num_class
    assert port.predict(X, raw_score=True).shape == (N, num_class)
    _assert_same_structure(ref, port, ties=True)
    _assert_predictions(X, ref, port, ties=True)


def test_multiclass_model_reloads_and_evaluates():
    """Save / reload predicts the same (N, K); the valid set's running
    scores and multi_logloss follow the trees."""
    X, y, _, dport = _datasets("multiclass")
    valid = lt.Dataset(X[:500], y[:500], reference=dport)
    bst = lt.train(_params("multiclass", metric="multi_logloss"), dport,
                   ROUNDS, valid_sets=[valid], device="cpu")
    again = lt.Booster(model_str=bst.model_to_string(), device="cpu")
    np.testing.assert_array_equal(again.predict(X), bst.predict(X))
    np.testing.assert_allclose(bst._gbdt.valid_scores[0].numpy(),
                               bst.predict(X[:500], raw_score=True),
                               rtol=1e-6, atol=1e-6)
    (_, name, val, _), = bst.eval_valid()
    assert name == "multi_logloss" and 0 < val < np.log(3)


# -- ranking ------------------------------------------------------------------

@pytest.mark.parametrize("objective", ["lambdarank", "rank_xendcg"])
def test_ranking_matches_reference(objective):
    """Same structure; leaf values within f32 tolerance (the reference's
    ranking gradients are jitted, module docstring)."""
    X, _, ref, port = _train_both(objective, min_data_in_leaf=5)
    _assert_same_structure(ref, port, ties=True)
    _assert_predictions(X, ref, port, ties=True)


# -- the slice as a whole -----------------------------------------------------

def test_headline_config_matches_reference():
    """bench.py's headline configuration (254 levels, stochastic rounding,
    quantized leaf renewal; binary, max_bin 255, lr 0.1) at 8,000 rows x
    28 features, 63 leaves, 3 rounds: the same trees, leaf values within
    the renewal tolerance (renewal sums exact histograms, which the port
    keeps in fixed point; ROADMAP queue 3 item 3)."""
    rng = np.random.RandomState(4)
    X = rng.randn(8000, 28).astype(np.float32)
    X[:, :6] = np.exp(0.5 * X[:, :6])
    logit = X[:, 0] * X[:, 3] - 0.6 * X[:, 21] + np.sin(2 * X[:, 7]) - 1.0
    y = (rng.rand(8000) < 1 / (1 + np.exp(-logit))).astype(float)
    params = dict(objective="binary", num_leaves=63, max_bin=255,
                  learning_rate=0.1, min_data_in_leaf=20, verbosity=-1,
                  use_quantized_grad=True, num_grad_quant_bins=254,
                  quant_train_renew_leaf=True, tpu_histogram_impl="pallas")
    ref = lgb.train(params, lgb.Dataset(X, y), 3)
    port = lt.train(params, lt.Dataset(X, y), 3, device="cpu")
    assert port._gbdt.learner.quantized
    assert port._gbdt.config.stochastic_rounding
    _assert_same_structure(ref, port, 1e-4)
    _assert_predictions(X, ref, port)
