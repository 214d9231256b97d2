"""Categorical features in the port, held against the JAX package.

Both packages get the same seeded data with categorical columns: a
3-category column (the one-vs-rest branch, ``num_bins <=
max_cat_to_onehot``), a Zipf-skewed 40-category column with NaNs and a
12-category column (the sorted-subset branch).  The bars:

* the categorical bin mapper and the split scan equal the reference's bit
  for bit (the subset search's sort is stable, its ratio a true f32
  division, its group spacing a multiply by the f32 reciprocal of
  ``min_data_per_group``, as XLA rewrites the division);
* quantized training writes byte-identical model text (stochastic
  rounding off and on, alone and with EFB bundles);
* exact training grows the same structure on both growers, predictions
  within rtol 1e-5 of their scale;
* the row update's categorical / EFB form equals the reference's XLA
  fallback on a small (W, N) case.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu import efb as jefb
from lightgbm_tpu.binning import find_bin as jfind_bin
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.binning import find_bin as tfind_bin
from lightgbm_tpu_torch.convert import trees_from_reference
from lightgbm_tpu_torch.models.tree import TreeBatch, predict_raw
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import split as ts

from test_torch_objectives import _leaf_of, _trees

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

CATS = [2, 3, 4]


def _cat_data(n=6000, seed=1, bundle=False):
    """Two numeric columns, categorical columns 2-4 (3, 40 with NaNs and a
    Zipf skew, 12 categories) and, with ``bundle``, 8 exclusive
    indicator columns that EFB bundles."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 13 if bundle else 5))
    X[:, :2] = rng.randn(n, 2)
    X[:, 2] = rng.randint(0, 3, n)
    X[:, 3] = np.minimum(rng.zipf(1.3, n) - 1, 39)
    X[:, 4] = rng.randint(0, 12, n)
    X[rng.rand(n) < 0.03, 3] = np.nan
    eff = rng.randn(40)
    z = (X[:, 0] + 0.8 * (X[:, 2] == 1) +
         eff[np.nan_to_num(X[:, 3]).astype(int)] +
         0.4 * np.isin(X[:, 4], [1, 5, 7]) + 0.3 * rng.randn(n))
    if bundle:
        pick = rng.randint(0, 9, n)
        for j in range(8):
            m = pick == j + 1
            X[m, 5 + j] = rng.choice((1, 2), m.sum())
        z = z + 0.6 * (X[:, 6] > 0)
    return X, (z > 0.3).astype(float)


def _params(**kw):
    p = dict(objective="binary", num_leaves=15, verbosity=-1,
             tpu_histogram_impl="pallas", tree_grow_mode="wave",
             min_data_per_group=20, cat_smooth=5.0)
    p.update(kw)
    return p


def _train_both(X, y, params, rounds=5):
    ref = lgb.train(params, lgb.Dataset(X, y, categorical_feature=CATS),
                    rounds)
    port = lt.train(params, lt.Dataset(X, y, categorical_feature=CATS),
                    rounds, device="cpu")
    return ref, port


def _num_cat(booster):
    return sum(int(ln.split("=")[1]) for ln in
               booster.model_to_string().splitlines()
               if ln.startswith("num_cat="))


def _assert_same_partitions(ref, port, X, rtol=1e-4):
    """Exact training's bar for categorical trees: every tree splits the
    rows into the same leaves (up to the leaves' numbering), on the same
    features with gains within 1e-4 (of the tree's largest gain, as
tests/test_torch_objectives.py holds values), and predictions agree
within rtol.

    A sorted-subset split and its complement with the children swapped
    are one partition with one gain (the gain is symmetric in the two
    children): the reference's bf16 sums break that tie by rounding
    residue, the port's exact sums take the forward scan, so the node
    numbering may differ where the rows do not.  As for numeric ties
    (tests/test_torch_objectives.py), at most 1% of the rows may reach
    another leaf; they are left out of the prediction check.

    Predictions are held to rtol 1e-4, not 1e-5: the backward subset scan
    takes a small left child's sums as ``total_used - prefix`` in f32
    (reference split.py:417-425), a cancellation that moves the two
    packages' different exact sums (bf16 hi+lo pairs, 64-bit fixed point)
    further apart in a small leaf's weight and in the raw scores than
    rtol 1e-5 allows on this data."""
    again = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    t_ref, t_port = _trees(ref.model_to_string()), \
        _trees(port.model_to_string())
    assert len(t_ref) == len(t_port) == len(port._gbdt.models)
    apart = np.zeros(len(X), bool)
    for i, (a, b) in enumerate(zip(t_ref, t_port)):
        assert a["num_leaves"] == b["num_leaves"], f"tree {i}"
        assert sorted(a["split_feature"].split()) == \
            sorted(b["split_feature"].split()), f"tree {i}"
        want = np.sort(np.array(a["split_gain"].split(), float))
        np.testing.assert_allclose(
            np.sort(np.array(b["split_gain"].split(), float)), want,
            rtol=1e-4, atol=1e-4 * np.abs(want).max(), err_msg=f"tree {i}")
        la = _leaf_of(again._gbdt.models[i], X)
        lb = _leaf_of(port._gbdt.models[i], X)
        # each reference leaf's rows go to one port leaf (the majority)
        pair = la * 1000 + lb
        vals, counts = np.unique(pair, return_counts=True)
        best = {}
        for v, c in zip(vals, counts):
            if c > best.get(v // 1000, (0, -1))[0]:
                best[v // 1000] = (c, v % 1000)
        mapped = np.array([best[x][1] for x in la])
        apart |= mapped != lb
    assert apart.mean() <= 0.01, f"{apart.sum()} rows reach other leaves"
    for raw in (True, False):
        want = ref.predict(X, raw_score=raw)[~apart]
        got = port.predict(X, raw_score=raw)[~apart]
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("params", [
    {},
    dict(max_cat_to_onehot=8, max_cat_threshold=16, cat_l2=1.5,
         cat_smooth=2.0, min_data_per_group=50, is_enable_bundle=False),
    dict(bundle="false", max_conflict_rate=0.5),
])
def test_categorical_and_bundle_params_resolve_as_reference(params):
    """The categorical and EFB parameters (and their aliases) resolve as
    the reference's ``Config`` resolves them; ``max_conflict_rate`` is no
    parameter of either (both bundle at ``efb.CONFLICT_RATE``)."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu_torch.config import Config as TConfig
    ref, port = JConfig(params), TConfig(params)
    for name in ("max_cat_to_onehot", "max_cat_threshold", "cat_l2",
                 "cat_smooth", "min_data_per_group", "enable_bundle"):
        assert getattr(port, name) == getattr(ref, name), name
    assert not hasattr(port, "max_conflict_rate")
    assert not hasattr(ref, "max_conflict_rate")


def test_categorical_bin_mapper_matches_reference():
    """1,000 Zipf-skewed categories: the same mapper as the reference's,
    categories by descending frequency, cut at 99% coverage and at the
    bin cap."""
    rng = np.random.RandomState(5)
    col = np.minimum(rng.zipf(1.2, 50000), 1000).astype(np.float64) - 1
    col[rng.rand(len(col)) < 0.01] = np.nan
    kw = dict(max_bin=255, min_data_in_bin=3, total_cnt=len(col),
              is_categorical=True, use_missing=True, zero_as_missing=False,
              forced_bounds=None, pre_filter_cnt=0)
    ref, port = jfind_bin(col, **kw), tfind_bin(col, **kw)
    assert port.num_bin == ref.num_bin <= 255
    assert list(port.bin_to_cat) == list(ref.bin_to_cat)
    assert port.cat_to_bin == ref.cat_to_bin
    assert port.missing_type.name == ref.missing_type.name
    counts = {c: int(np.sum(col == c)) for c in port.bin_to_cat}
    freq = [counts[c] for c in port.bin_to_cat]
    assert freq == sorted(freq, reverse=True)
    assert sum(freq) >= 0.99 * np.sum(~np.isnan(col)) or \
        port.num_bin >= 254
    np.testing.assert_array_equal(port.value_to_bin(col),
                                  ref.value_to_bin(col))


@pytest.mark.parametrize("mode", ["onehot", "subset", "subset_extra"])
def test_categorical_scan_matches_reference(mode):
    """The scan on the same f32 histograms (dequantized integer sums):
    gains, thresholds, LEFT memberships and child sums bit for bit, for
    one-vs-rest, the sorted subsets and extra-trees' random draws."""
    rng = np.random.RandomState({"onehot": 1, "subset": 2,
                                 "subset_extra": 3}[mode])
    f, b = 6, 48
    counts = rng.poisson(30, (f, b)).astype(np.int32)
    counts[:, ::7] = rng.randint(0, 4, counts[:, ::7].shape)
    gq = rng.randint(-400, 400, (f, b)).astype(np.int32)
    hq = (counts * rng.randint(1, 5, (f, b))).astype(np.int32)
    scale = np.array([0.0123, 0.0071, 1.0], np.float32)
    hist = np.stack([gq, hq, counts], -1).astype(np.float32) * scale
    num_bins = np.array([b, 3, 40, 4, b, 17], np.int32)
    for j in range(f):
        hist[j, num_bins[j]:] = 0
    is_cat = np.array([False, True, True, True, False, True])
    has_nan = np.array([True, False, True, False, False, False])
    parent = hist[0].sum(axis=0)
    extra = mode == "subset_extra"
    sp_ref = js.SplitParams(
        min_data_in_leaf=10, cat_smooth=5.0, min_data_per_group=40,
        max_cat_threshold=8, extra_trees=extra,
        use_cat_subset=mode != "onehot",
        cat_idx=(1, 2, 3, 5) if mode == "subset" else ())
    if mode == "onehot":
        sp_ref = sp_ref._replace(max_cat_to_onehot=64)
    sp = ts.SplitParams(**sp_ref._asdict())
    rb = rng.randint(0, 40, f).astype(np.int32) if extra else None
    ref = js.best_split_per_feature(
        jnp.asarray(hist), jnp.asarray(parent), jnp.asarray(num_bins),
        jnp.asarray(is_cat), jnp.asarray(has_nan), sp_ref,
        rand_bins=None if rb is None else jnp.asarray(rb))
    t = lambda a: torch.from_numpy(np.asarray(a))
    got = ts.best_split_per_feature(
        t(hist).unsqueeze(0), t(parent).unsqueeze(0), t(num_bins),
        t(has_nan), sp, rand_bins=None if rb is None else t(rb)[None],
        is_cat=t(is_cat))
    assert np.any(np.asarray(ref.gain)[is_cat] > 0)
    for name in ("gain", "threshold_bin", "default_left", "left_sum",
                 "right_sum", "cat_member"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("stochastic,bundle", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_categorical_quantized_text_matches_reference(stochastic, bundle):
    """Quantized wave training on both categorical branches, alone and
    with EFB bundles: the reference's model text byte for byte."""
    X, y = _cat_data(bundle=bundle)
    ref, port = _train_both(X, y, _params(use_quantized_grad=True,
                                          stochastic_rounding=stochastic))
    assert _num_cat(ref) > 0
    assert (port._gbdt.train_set.efb is not None) == bundle
    assert port.model_to_string() == ref.model_to_string()


@pytest.mark.parametrize("grow,bundle", [("wave", False), ("partition", False),
                                         ("partition", True)])
def test_categorical_exact_same_structure(grow, bundle):
    """Exact training: the same trees on both growers (with EFB on the
    partitioned one), predictions within rtol 1e-5."""
    X, y = _cat_data(bundle=bundle)
    ref, port = _train_both(X, y, _params(tree_grow_mode=grow))
    assert _num_cat(ref) > 0
    _assert_same_partitions(ref, port, X)


def test_categorical_model_text_round_trip(tmp_path):
    """Saved categorical text loads back (``cat_boundaries`` /
    ``cat_threshold`` bitsets over raw values) and writes itself again;
    the loaded model predicts as the trained one, and so does the
    reference's model read by the port."""
    X, y = _cat_data(n=3000)
    X[::50, 4] = 37          # a category the training set never saw
    ref, port = _train_both(X, y, _params(use_quantized_grad=True))
    path = tmp_path / "model.txt"
    port.save_model(str(path))
    again = lt.Booster(model_file=str(path),
                       params=_params(use_quantized_grad=True), device="cpu")
    assert again.model_to_string() == port.model_to_string()
    probe = X.copy()
    probe[::7, 3] = -1.0     # negative categories go right
    probe[::11, 4] = 2.5     # fractional ones too
    np.testing.assert_array_equal(again.predict(probe), port.predict(probe))
    from_ref = lt.Booster(model_str=ref.model_to_string(), device="cpu")
    np.testing.assert_array_equal(from_ref.predict(probe),
                                  ref.predict(probe))


def test_convert_categorical_trees():
    """A categorical reference model's trees carried into the port: the
    host walk predicts the reference's leaf values bit for bit, the
    device walk within 1e-6."""
    X, y = _cat_data(n=3000)
    ref = lgb.train(_params(use_quantized_grad=True),
                    lgb.Dataset(X, y, categorical_feature=CATS), 4)
    trees = ref._gbdt.models
    port_trees = trees_from_reference(
        [dataclasses.asdict(t) for t in trees])
    assert any(t.cat_boundaries is not None for t in port_trees)
    for t_ref, t_port in zip(trees, port_trees):
        np.testing.assert_array_equal(t_port.predict(X), t_ref.predict(X))
    raw = predict_raw(TreeBatch(port_trees),
                      torch.as_tensor(X, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(raw, ref.predict(X, raw_score=True),
                               rtol=0, atol=1e-6)


def test_row_update_decode_matches_reference_fallback():
    """The row update's categorical / EFB form (plain version) against the
    reference grower's XLA fallback (learner/wave.py:1371-1409) on a small
    (W, N) case: bundled numeric splits, categorical splits by membership,
    numeric splits with a NaN bin, inactive splits.  Under categorical
    features or EFB the endgame is off and no split of a wave takes a
    leaf another split of the wave creates, so the kernel's in-order walk
    equals the fallback's argmax over the match matrix."""
    X, y = _cat_data(n=4096, bundle=True)
    ds = lt.Dataset(X, y, categorical_feature=CATS).construct()
    info = ds.efb
    F, W, n, B = len(info.f_bundle), 7, ds.num_data(), 64
    rng = np.random.RandomState(4)
    feats = np.array([0, 2, 3, 5, 7, 4, 1], np.int32)
    sel = np.array([3, 0, 5, 9, 1, 11, 2], np.int32)
    rl = rng.choice(sel, n).astype(np.int32)
    rl[::9] = 13                                        # in no split leaf
    act = np.array([1, 1, 1, 1, 1, 1, 0], np.int32)
    thr = rng.randint(0, 3, W).astype(np.int32)
    nan_bin = np.where(feats == 1, 7, -1).astype(np.int32)
    mappers = [ds.bin_mappers[j] for j in ds.used_feature_map]
    is_cat = np.array([m.is_categorical for m in mappers])[feats]
    member = np.zeros((W, B), bool)
    for j in np.nonzero(is_cat)[0]:
        member[j, rng.randint(0, mappers[feats[j]].num_bin, 4)] = True
    tab = np.stack([thr, nan_bin, rng.randint(0, 2, W), rng.randint(0, 2, W),
                    sel, 20 + np.arange(W), act, np.zeros(W)]).astype(
                        np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    dec = hc.split_decode(t(is_cat), t(member), t(info.f_offset[feats]),
                          t(info.f_nbins[feats]), t(info.f_default[feats]),
                          t(info.f_single[feats]))
    bins_t = t(ds.X_binned.T)
    rl_p, ch_p = hc.wave_row_update(bins_t, t(rl), t(tab),
                                    feats=t(info.f_bundle[feats]),
                                    decode=dec)
    # the reference's fallback, as written in its wave grower
    arrays = (jnp.asarray(info.exp_map), jnp.asarray(info.f_bundle),
              jnp.asarray(info.f_offset), jnp.asarray(info.f_default),
              jnp.asarray(info.f_nbins), jnp.asarray(info.f_single))
    decode = jefb.make_bundle_decode(arrays)
    Xb = jnp.asarray(ds.X_binned.T)
    cols_w = jnp.stack([decode(Xb[info.f_bundle[f]].astype(jnp.int32), f)
                        for f in feats])
    num_go = jnp.where(cols_w == nan_bin[:, None], tab[2][:, None] > 0,
                       cols_w <= thr[:, None])
    go_w = jnp.where(jnp.asarray(is_cat)[:, None],
                     jnp.take_along_axis(jnp.asarray(member), cols_w, axis=1),
                     num_go)
    rlj = jnp.asarray(rl)
    match = (act[:, None] > 0) & (rlj[None, :] == sel[:, None])
    has = jnp.any(match, axis=0)
    jhit = jnp.argmax(match, axis=0)
    go = jnp.take_along_axis(go_w, jhit[None, :], axis=0)[0]
    ch_ref = jnp.where(has & (go == (tab[3][jhit] > 0)),
                       jhit.astype(jnp.int8), jnp.int8(-1))
    rl_ref = jnp.where(has & jnp.logical_not(go), (20 + jhit), rlj)
    np.testing.assert_array_equal(rl_p.numpy(), np.asarray(rl_ref))
    np.testing.assert_array_equal(ch_p.numpy(), np.asarray(ch_ref))
    assert (ch_p >= 0).any() and (rl_p != t(rl)).any()
