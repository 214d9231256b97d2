"""The port's serving compiler held against the JAX package.

One model text (trained by the port on the CPU) loads into both
packages; the same rows go through ``lightgbm_tpu``'s dense program in
its CPU form (``mxu=False``) and through the port's
(``models/dense_predict.py``, ``serve/compiler.py``).  Covered: numeric
splits with NaN (missing type nan) and with missing-zero, a categorical
model whose bitsets span two words, linear leaves, 3-class softmax, and
the leaf tables quantized to 8 and 16 bits.

* ``lower_ensemble``'s tables equal the reference's;
* raw scores are within rtol 1e-6 / atol 1e-6 of the reference's dense
  program and of the port's walk; ``pred_leaf`` is identical;
* quantized tables stay within each tree's scale / 2;
* ``compile_ensemble`` gives the reference's route and reason and bumps
  the same counters; ``DenseExecutable.extended``, row blocking, the
  shape-bucket ladder and ``CompiledPredictor`` (against
  ``Booster.predict``, with its bucket histogram) are checked too.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.models import dense_predict as jdp
from lightgbm_tpu.models import tree as jtree
from lightgbm_tpu.serve import compiler as jcomp
from lightgbm_tpu_torch.models import dense_predict as tdp
from lightgbm_tpu_torch.models import tree as ttree
from lightgbm_tpu_torch.serve import compiler as tcomp

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

N, F = 900, 6
BASE = dict(num_leaves=15, verbosity=-1, use_quantized_grad=True,
            min_data_in_leaf=5)
MODELS = ["nan", "zero", "categorical", "linear", "multiclass"]


def _rows(seed, n, cat=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    if cat:
        X[:, 3] = rng.randint(0, 50, n)
        X[rng.rand(n) < 0.03, 3] = np.nan
    return X


def _train(name):
    X = _rows(0, N, cat=name == "categorical")
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = (x0 + x1 ** 2 > 0.8).astype(float)
    p = dict(BASE, objective="binary")
    kw = {}
    if name == "zero":
        X = np.where(np.isnan(X), 0.0, X)
        X[np.random.RandomState(1).rand(N, F) < 0.2] = 0.0
        p["zero_as_missing"] = True
    elif name == "categorical":
        y = ((X[:, 3] % 3 == 0) + 0.3 * x0 > 0.8).astype(float)
        kw["categorical_feature"] = [3]
    elif name == "linear":
        p = dict(BASE, objective="regression", linear_tree=True)
        p.pop("use_quantized_grad")
        y = 2.0 * x0 + x1 + 0.1 * np.random.RandomState(2).randn(N)
    elif name == "multiclass":
        p = dict(BASE, objective="multiclass", num_class=3)
        y = np.digitize(x0, [-0.4, 0.4]).astype(float)
    bst = lt.train(p, lt.Dataset(X, y, **kw), 4, device="cpu")
    return bst.model_to_string()


@pytest.fixture(scope="module")
def texts():
    return {name: _train(name) for name in MODELS}


def _queries(name, n=77):
    X = _rows(5, n, cat=name == "categorical")
    if name == "categorical" and n >= 2:
        X[0, 3] = 3.5       # non-integer category: not a member
        X[1, 3] = 60.0      # unseen category
    if name == "zero":
        X[:, :] = np.where(np.random.RandomState(6).rand(n, F) < 0.2, 0.0,
                           np.nan_to_num(X))
    return X


def _both(text, params=None):
    p = params or {}
    return (lt.Booster(model_str=text, params=p, device="cpu"),
            lgb.Booster(model_str=text, params=p))


def _lower_both(text, leaf_bits=0):
    pb, rb = _both(text)
    g, rg = pb._gbdt, rb._gbdt
    k = g.num_tree_per_iteration
    ta, tm = tdp.lower_ensemble(g.models, k, g.num_features,
                                leaf_bits=leaf_bits)
    ja, jm = jdp.lower_ensemble(rg.models, k, rg.num_features,
                                leaf_bits=leaf_bits, mxu=False)
    return (ta, tm), (ja, jm), pb, rb


@pytest.mark.parametrize("name", MODELS)
def test_lowered_tables_match_reference(texts, name):
    (ta, tm), (ja, jm), _, _ = _lower_both(texts[name])
    assert (tm.num_class, tm.num_trees, tm.has_cat, tm.has_linear,
            tm.leaf_bits) == (jm.num_class, jm.num_trees, jm.has_cat,
                              jm.has_linear, jm.leaf_bits)
    assert tm.has_cat == (name == "categorical")
    assert tm.has_linear == (name == "linear")
    for field in tdp.DenseArrays._fields:
        a, b = getattr(ta, field), getattr(ja, field)
        assert (a is None) == (b is None), field
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=field)


@pytest.mark.parametrize("name", MODELS)
def test_dense_raw_and_leaf_match_reference_and_walk(texts, name):
    (ta, tm), (ja, jm), pb, rb = _lower_both(texts[name])
    X = _queries(name).astype(np.float32)
    got = tdp.dense_predict_raw(torch.as_tensor(X), ta, tm).numpy()
    want = np.asarray(jdp.dense_predict_raw(jnp.asarray(X), ja, jm))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    walk = lt.Booster(model_str=texts[name],
                      params={"tpu_predict_compiler": "walk"},
                      device="cpu").predict(X, raw_score=True)
    np.testing.assert_allclose(got if tm.num_class > 1 else got[:, 0], walk,
                               rtol=1e-6, atol=1e-6)
    leaf = tdp.dense_predict_leaf(torch.as_tensor(X), ta, tm).numpy()
    np.testing.assert_array_equal(
        leaf, np.asarray(jdp.dense_predict_leaf(jnp.asarray(X), ja, jm)))
    np.testing.assert_array_equal(
        leaf, rb.predict(X, pred_leaf=True))


@pytest.mark.parametrize("bits", [8, 16])
@pytest.mark.parametrize("name", ["nan", "multiclass"])
def test_quantized_leaf_tables(texts, name, bits):
    """int8 / int16 leaf codes: the reference's codes and scales, raw
    scores within rtol 1e-6 of its program and within the sum of each
    tree's scale / 2 of the exact tables."""
    (ta, tm), (ja, jm), _, _ = _lower_both(texts[name], leaf_bits=bits)
    np.testing.assert_array_equal(ta.leaf_codes.numpy(),
                                  np.asarray(ja.leaf_codes))
    np.testing.assert_array_equal(ta.leaf_scale.numpy(),
                                  np.asarray(ja.leaf_scale))
    X = torch.as_tensor(_queries(name).astype(np.float32))
    got = tdp.dense_predict_raw(X, ta, tm).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jdp.dense_predict_raw(jnp.asarray(X.numpy()), ja,
                                              jm)), rtol=1e-6, atol=1e-6)
    (ea, em), _, _, _ = _lower_both(texts[name])
    exact = tdp.dense_predict_raw(X, ea, em).numpy()
    bound = (ta.leaf_scale[:, 0, None] / 2 * ta.class_onehot).sum(0).numpy()
    assert np.all(np.abs(got - exact) <= bound[None, :] * (1 + 1e-5) + 1e-6)


@pytest.mark.parametrize("mode", ["auto", "dense", "walk"])
@pytest.mark.parametrize("name", MODELS)
def test_compile_route_and_counters_match_reference(texts, name, mode):
    pb, rb = _both(texts[name])
    g, rg = pb._gbdt, rb._gbdt
    k = g.num_tree_per_iteration
    before_t, before_j = tcomp.fallback_counts(), jcomp.fallback_counts()
    t_exe, t_reason = tcomp.compile_ensemble(g.models, k, g.num_features,
                                             mode=mode)
    j_exe, j_reason = jcomp.compile_ensemble(rg.models, k, rg.num_features,
                                             mode=mode)
    assert (t_exe is None, t_reason) == (j_exe is None, j_reason)

    def delta(after, before):
        return {r: n - before.get(r, 0) for r, n in after.items()
                if n != before.get(r, 0)}
    assert delta(tcomp.fallback_counts(), before_t) == \
        delta(jcomp.fallback_counts(), before_j)


def test_lowering_budgets_and_empty_ensembles(texts):
    """The budget reasons are the reference's, and an empty ensemble
    falls back (auto) or raises (dense) as there."""
    for name, kw, reason in (("categorical", {"cat_budget": 1},
                              "cat_table_budget"),
                             ("linear", {"linear_budget": 1},
                              "linear_table_budget")):
        pb, rb = _both(texts[name])
        for mod, trees in ((tdp, pb._gbdt.models), (jdp, rb._gbdt.models)):
            with pytest.raises(mod.DenseLoweringError) as e:
                mod.lower_ensemble(trees, 1, F, **kw)
            assert e.value.reason == reason
    assert tcomp.compile_ensemble([], 1, F) == (None, "no_trees")
    assert jcomp.compile_ensemble([], 1, F) == (None, "no_trees")
    with pytest.raises(tdp.DenseLoweringError):
        tcomp.compile_ensemble([], 1, F, mode="dense")
    with pytest.raises(ValueError, match="auto|dense|walk"):
        tcomp.compile_ensemble([], 1, F, mode="fast")


def test_predict_shard_raises_above_one(texts):
    """``tpu_predict_shard=W`` > 1 no longer raises: it pads the tree axis
    to a multiple of W with inert trees and runs on the one device, as
    the reference's does when it sees one device.  Predictions equal the
    reference's at every W, the padded capacity is the reference's, and
    the padding takes appended trees in place (splitting the tree axis
    over several cards stays ROADMAP queue 1 item 10)."""
    X = _queries("nan")
    want = lgb.Booster(model_str=texts["nan"]).predict(X, raw_score=True)
    for shard in (0, 1, 2, 3):
        got = lt.Booster(model_str=texts["nan"],
                         params={"tpu_predict_shard": shard,
                                 "tpu_predict_compiler": "dense"},
                         device="cpu").predict(X, raw_score=True)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    pb, rb = _both(texts["nan"])
    g, rg = pb._gbdt, rb._gbdt
    exe, _ = tcomp.compile_ensemble(g.models[:2], 1, F, mode="dense",
                                    shard=3)
    jexe, _ = jcomp.compile_ensemble(rg.models[:2], 1, F, mode="dense",
                                     shard=3)
    assert exe.capacity == jexe.capacity == 3
    assert exe.info()["num_trees"] == 2 and exe.shard == 0
    ex = exe.extended(g.models[2:3], F)
    assert ex is not None and ex.signature == exe.signature
    assert exe.extended(g.models[2:4], F) is None
    full, _ = tcomp.compile_ensemble(g.models[:3], 1, F, mode="dense")
    Xt = torch.as_tensor(X.astype(np.float32))
    np.testing.assert_allclose(ex.predict_raw(Xt).numpy(),
                               full.predict_raw(Xt).numpy(),
                               rtol=1e-6, atol=1e-6)


def test_row_blocks_equal_one_block(texts):
    """A workset budget that forces many row blocks changes nothing."""
    pb, _ = _both(texts["categorical"])
    g = pb._gbdt
    exe, _ = tcomp.compile_ensemble(g.models, 1, g.num_features,
                                    mode="dense")
    small = tcomp.DenseExecutable(exe.arrays, exe.meta,
                                  workset_budget=7 * tdp.dense_row_bytes(
                                      exe.arrays, exe.meta))
    assert small.max_rows == 7
    X = torch.as_tensor(_queries("categorical", n=100).astype(np.float32))
    np.testing.assert_array_equal(small.predict_raw(X).numpy(),
                                  exe.predict_raw(X).numpy())
    np.testing.assert_array_equal(small.predict_leaf(X).numpy(),
                                  exe.predict_leaf(X).numpy())


def test_extended(texts):
    """``extended``: no new trees gives the same executable; unsharded
    tables have no spare tree rows, so appended trees ask for a rebuild
    (``None``), as the reference's unsharded executable does; a
    text-loaded predictor then rebuilds and serves the longer model."""
    pb, rb = _both(texts["nan"])
    g, rg = pb._gbdt, rb._gbdt
    exe, _ = tcomp.compile_ensemble(g.models[:2], 1, F, mode="dense")
    jexe, _ = jcomp.compile_ensemble(rg.models[:2], 1, F, mode="dense")
    assert exe.extended([], F) is exe
    assert exe.capacity == jexe.capacity == 2
    assert exe.extended(g.models[2:], F) is None
    assert jexe.extended(rg.models[2:], F) is None
    short = lt.Booster(model_str=texts["nan"], device="cpu").to_predictor(
        num_iteration=2, compiler="dense")
    longer, how = short.extended(g.models[2:])
    assert how == "rebuild" and longer.num_trees == len(g.models)
    X = _queries("nan")
    np.testing.assert_allclose(longer.predict(X, raw_score=True),
                               pb.predict(X, raw_score=True),
                               rtol=1e-6, atol=1e-6)


def test_stacked_executable_lanes_equal_solo(texts):
    """Two same-signature executables on a model axis: each lane's raw
    scores are its solo program's; a spliced lane takes the new tables."""
    pb, _ = _both(texts["nan"])
    g = pb._gbdt
    a, _ = tcomp.compile_ensemble(g.models[:2], 1, F, mode="dense")
    b, _ = tcomp.compile_ensemble(g.models[2:4], 1, F, mode="dense")
    stack = tcomp.StackedExecutable(["a", "b"], [a, b])
    X = torch.as_tensor(_queries("nan").astype(np.float32))
    out = stack.predict_raw(torch.stack([X, X]))
    np.testing.assert_array_equal(out[0].numpy(), a.predict_raw(X).numpy())
    np.testing.assert_array_equal(out[1].numpy(), b.predict_raw(X).numpy())
    swapped = stack.splice("b", a).predict_raw(torch.stack([X, X]))
    np.testing.assert_array_equal(swapped[1].numpy(), out[0].numpy())
    c, _ = tcomp.compile_ensemble(g.models[:3], 1, F, mode="dense")
    with pytest.raises(ValueError, match="signature"):
        tcomp.StackedExecutable(["a", "c"], [a, c])


def test_shape_buckets_match_reference():
    assert ttree.SHAPE_BUCKETS == jtree.SHAPE_BUCKETS
    for n in (0, 1, 2, 8, 9, 64, 65, 511, 512, 513, 4096, 4097, 9000):
        assert ttree.bucket_rows(n) == jtree.bucket_rows(n)
        X = np.arange(max(n, 1) * 3, dtype=np.float32).reshape(-1, 3)[:n]
        np.testing.assert_array_equal(ttree.pad_rows(X), jtree.pad_rows(X))


@pytest.mark.parametrize("name", ["categorical", "multiclass"])
def test_compiled_predictor_matches_booster(texts, name):
    """``CompiledPredictor.predict`` equals ``Booster.predict`` through
    the dense program, and its bucket histogram counts one batch per
    request at the request's bucket."""
    pb = lt.Booster(model_str=texts[name],
                    params={"tpu_predict_compiler": "dense"}, device="cpu")
    from lightgbm_tpu_torch.serve import predictor as tpred
    pred = pb.to_predictor()
    assert pred.info()["compiler"] == "dense"
    keys = tpred.compile_key_count()
    for n in (1, 5, 64, 100):
        X = _queries(name, n=n)
        np.testing.assert_array_equal(pred.predict(X), pb.predict(X))
    snap = pred.stats.snapshot()
    assert snap["bucket_histogram"] == {"1": 1, "8": 1, "64": 1, "512": 1}
    assert snap["batches"] == 4 and snap["rows"] == 170
    # one new (signature, bucket) pair a bucket, once per process
    assert tpred.compile_key_count() - keys == snap["recompiles"] <= 4
    pred.predict(_queries(name, n=3))
    assert pred.stats.snapshot()["recompiles"] == snap["recompiles"]
    walk = pb.to_predictor(compiler="walk")
    assert walk.info()["fallback_reason"] == "forced_walk"
    X = _queries(name)
    np.testing.assert_allclose(walk.predict(X), pred.predict(X),
                               rtol=1e-6, atol=1e-6)
    assert walk.warmup() >= 0
