"""uint16 bin codes (``max_bin`` > 255) in the port, held against the JAX
package.

* The plain uint16 histograms (single leaf, the exact and quantized leaf
  channels) against the reference's XLA histograms
  (``lightgbm_tpu/ops/histogram.py``), which serve uint16 bins there, on
  integer-valued weights: equal bit for bit.  The row update against the
  reference's row-update semantics (``wave_row_update_pallas`` in
  interpret mode on the gathered uint16 columns).
* Training at ``max_bin`` 511 and 4095: the port picks the reference's
  grower and mode (``auto`` partitions, quantized gradients train exact
  there; an explicit wave grower keeps its kernels, exact or quantized).
  Quantized wave text is byte-identical.  Exact training grows the
  reference's trees, predictions within rtol 1e-5.  The reference's
  partitioned grower casts its row copy to uint8
  (``lightgbm_tpu/learner/partitioned.py:201``), which wraps codes past
  255 (ROADMAP queue 3): the port's partitioned and masked growers are
  both held against the reference's masked grower, which reads uint16.
* The launch geometry of the uint16 kernels: every B up to 65,536 fits a
  block's shared memory through the bin-tile axis, and the blocks cover
  every (channel, feature, bin, row) cell once.  The leaf histograms' row
  list: the plain channel partition's layout, its chunk slots, and a
  plain walk of the blocks over it equal to the plain histograms.

The CUDA kernels themselves run on the card only
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase 15).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import histogram as rh
from lightgbm_tpu.ops import histogram_pallas as hp
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

N, F, ROUNDS = 6000, 6, 5
STRUCTURE = ("num_leaves", "split_feature", "threshold", "decision_type",
             "left_child", "right_child", "leaf_count", "internal_count")
VALUES = ("leaf_value", "leaf_weight", "internal_value", "internal_weight",
          "split_gain")


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


# -- plain uint16 kernels against the reference ------------------------------

@pytest.mark.parametrize("num_bins", [257, 1023, 4096, 65_536])
def test_plain_single_histogram_u16_matches_reference(num_bins):
    rng = np.random.RandomState(num_bins % 97)
    n, f = 3000, 5
    bins = rng.randint(0, num_bins, (n, f)).astype(np.uint16)
    bins[:40, 0] = num_bins - 1                     # the top code
    g = rng.randint(-50, 50, n).astype(np.float32)
    h = rng.randint(1, 20, n).astype(np.float32)
    m = (rng.rand(n) < 0.7).astype(np.float32)
    ref = np.asarray(rh.build_histogram(jnp.asarray(bins), jnp.asarray(g),
                                        jnp.asarray(h), jnp.asarray(m),
                                        num_bins=num_bins, impl="segment"))
    bt = _t(bins.T)
    assert bt.dtype == torch.uint16
    port = hc.build_histogram(bt, _t(g), _t(h), _t(m), num_bins=num_bins)
    np.testing.assert_array_equal(port.numpy(), ref)
    # the row-major view the partitioned grower passes
    w = th.pack_weights(_t(g), _t(h), _t(m))
    rows = hc.hist_single(_t(bins).t(), w, num_bins=num_bins)
    np.testing.assert_array_equal(th.fx_to_f32(rows, w.inv_scale).numpy(),
                                  ref)


@pytest.mark.parametrize("num_bins", [300, 4095])
def test_plain_leaf_histograms_u16_match_reference(num_bins):
    rng = np.random.RandomState(num_bins)
    n, f = 4096, 4
    bins = rng.randint(0, num_bins, (n, f)).astype(np.uint16)
    ch = rng.randint(-1, hc.Q_LEAF_CHANNELS, n).astype(np.int8)
    gq = rng.randint(-127, 128, n).astype(np.int8)
    hq = rng.randint(0, 128, n).astype(np.int8)
    cnt = (ch >= 0).astype(np.int8)
    wch = np.zeros((8, n), np.int8)
    wch[0], wch[1], wch[2] = gq, hq, cnt
    ref = np.asarray(rh.build_histogram_leaves(
        jnp.asarray(bins), jnp.asarray(gq, jnp.float32),
        jnp.asarray(hq, jnp.float32), jnp.asarray(cnt, jnp.float32),
        jnp.asarray(ch), num_channels=hc.Q_LEAF_CHANNELS,
        num_bins=num_bins, impl="segment"))
    q8 = hc.build_histogram_leaves_q8(_t(bins.T), _t(wch), _t(ch),
                                      num_bins=num_bins)
    assert q8.dtype == torch.int32
    np.testing.assert_array_equal(q8.numpy(), np.round(ref).astype(np.int32))
    # exact channels: integer-valued f32 weights sum exactly in both
    che = np.where(ch < hc.LEAF_CHANNELS, ch, -1).astype(np.int8)
    g, hh = gq.astype(np.float32), hq.astype(np.float32)
    mk = (che >= 0).astype(np.float32)
    ref = np.asarray(rh.build_histogram_leaves(
        jnp.asarray(bins), jnp.asarray(g), jnp.asarray(hh), jnp.asarray(mk),
        jnp.asarray(che), num_channels=hc.LEAF_CHANNELS, num_bins=num_bins,
        impl="segment"))
    w = th.pack_weights(_t(g), _t(hh), _t(mk))
    fx = hc.build_histogram_leaves(_t(bins.T), w, _t(che), num_bins=num_bins)
    np.testing.assert_array_equal(fx.numpy(), ref)


@pytest.mark.parametrize("w", [1, 6, 42])
def test_plain_row_update_u16_matches_reference(w):
    rng = np.random.RandomState(w)
    f, n, leaves, num_bins = 7, 8192, 50, 2000
    bins = rng.randint(0, num_bins, (f, n)).astype(np.uint16)
    feats = rng.randint(0, f, w).astype(np.int32)
    rl = rng.randint(0, leaves, n).astype(np.int32)
    tab = np.stack([
        rng.randint(200, num_bins, w), np.where(rng.rand(w) < 0.5,
                                                num_bins - 1, -1),
        rng.randint(0, 2, w), rng.randint(0, 2, w),
        rng.choice(leaves, w, replace=False), leaves + np.arange(w),
        np.ones(w, int), np.zeros(w, int)]).astype(np.int32)
    if w > 1:
        tab[4, 1] = tab[5, 0]     # a chained split
    rl_r, ch_r = hp.wave_row_update_pallas(
        jnp.asarray(bins[feats]), jnp.asarray(rl), jnp.asarray(tab),
        interpret=True)
    rl_t, ch_t = hc.wave_row_update(_t(bins), _t(rl), _t(tab),
                                    feats=_t(feats))
    np.testing.assert_array_equal(rl_t.numpy(), np.asarray(rl_r))
    np.testing.assert_array_equal(ch_t.numpy(), np.asarray(ch_r))
    trial = hc.wave_trial_channels(
        _t(bins), _t(rl), *(_t(tab[i]) for i in (4, 0, 1, 2, 3, 6)),
        feats=_t(feats))
    tab_t = tab.copy()
    tab_t[5] = tab_t[4]
    _, ch_tr = hp.wave_row_update_pallas(
        jnp.asarray(bins[feats]), jnp.asarray(rl), jnp.asarray(tab_t),
        interpret=True)
    np.testing.assert_array_equal(trial.numpy(), np.asarray(ch_tr))


def test_u16_wrappers_refuse_what_the_kernels_do_not_take():
    bins = torch.zeros((3, 4096), dtype=torch.uint16)
    w = th.pack_weights(torch.ones(4096), torch.ones(4096), torch.ones(4096))
    with pytest.raises(ValueError, match="65536"):
        hc.hist_single(bins, w, num_bins=70_000)
    with pytest.raises(ValueError, match="256"):
        hc.hist_single(bins.to(torch.uint8), w, num_bins=300)
    with pytest.raises(TypeError, match="uint8"):
        hc.hist_single(bins, w, num_bins=16, bins_packed=True)
    # the model-axis forms take uint16 bins within the same limits, all
    # lanes of one dtype
    with pytest.raises(ValueError, match="65536"):
        hc.hist_single_lanes([bins], [w], num_bins=70_000)
    with pytest.raises(ValueError, match="dtype"):
        hc.hist_single_lanes([bins, bins.to(torch.uint8)], [w, w],
                             num_bins=16)
    assert hc.hist_single_lanes([bins], [w], num_bins=300).shape == \
        (1, 3, 300, 3)


# -- training against the reference ------------------------------------------

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


def _trees(text):
    out = []
    for block in text.split("Tree=")[1:]:
        body = block.split("\n\n")[0]
        out.append(dict(ln.split("=", 1) for ln in body.split("\n")[1:]
                        if "=" in ln))
    return out


def _tie_at(a, b):
    """True when trees ``a`` and ``b`` first part at a split of the same
    feature whose gains agree within rtol 1e-5: an exact near-tie between
    two bins, which the reference's f32 sums and the port's fixed point
    break apart (ROADMAP queue 3 item 3, "Exact ties")."""
    fa, fb = a["split_feature"].split(), b["split_feature"].split()
    ta, tb = a["threshold"].split(), b["threshold"].split()
    ga = np.array(a["split_gain"].split(), float)
    gb = np.array(b["split_gain"].split(), float)
    for j in range(min(len(fa), len(fb))):
        if (fa[j], ta[j]) != (fb[j], tb[j]):
            return fa[j] == fb[j] and abs(ga[j] - gb[j]) <= 1e-5 * abs(ga[j])
    return False


def _assert_same_trees(X, ref, port):
    """The same structure; values within rtol 1e-4 of each field's scale
    (exact training: fixed-point against f32 sums, ROADMAP queue 3 item
    3); predictions within rtol 1e-5.  A tree that parts from the
    reference's at an exact near-tie (:func:`_tie_at`) ends the
    comparison there; at least three trees must match first."""
    t_ref, t_port = _trees(ref.model_to_string()), \
        _trees(port.model_to_string())
    assert len(t_ref) == len(t_port)
    same = len(t_ref)
    for i, (a, b) in enumerate(zip(t_ref, t_port)):
        if i >= 3 and a["threshold"] != b["threshold"] and _tie_at(a, b):
            same = i
            break
        for k in STRUCTURE:
            assert a.get(k) == b.get(k), f"tree {i} field {k}"
        for k in VALUES:
            if k in a:
                va = np.array(a[k].split(), float)
                np.testing.assert_allclose(
                    np.array(b[k].split(), float), va, rtol=1e-4,
                    atol=1e-4 * np.abs(va).max(), err_msg=f"tree {i} {k}")
    np.testing.assert_allclose(port.predict(X, num_iteration=same),
                               ref.predict(X, num_iteration=same),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("objective,max_bin", [("binary", 511),
                                               ("regression", 4095)])
def test_quantized_wave_text_matches_reference(objective, max_bin):
    X, y = _data(objective)
    params = dict(objective=objective, num_leaves=15, verbosity=-1,
                  max_bin=max_bin, tpu_histogram_impl="pallas",
                  tree_grow_mode="wave", use_quantized_grad=True,
                  stochastic_rounding=False)
    ref = lgb.train(params, lgb.Dataset(X, y), ROUNDS)
    port = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu")
    assert port._gbdt.train_set.X_binned.dtype == np.uint16
    assert port._gbdt.learner.grow_mode == "wave"
    assert port._gbdt.learner.quantized
    assert port.model_to_string() == ref.model_to_string()


def test_exact_wave_matches_reference():
    X, y = _data("binary")
    params = dict(objective="binary", num_leaves=15, verbosity=-1,
                  max_bin=511, tpu_histogram_impl="pallas",
                  tree_grow_mode="wave")
    ref = lgb.train(params, lgb.Dataset(X, y), ROUNDS)
    port = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu")
    assert port._gbdt.learner.grow_mode == "wave"
    _assert_same_trees(X, ref, port)


@pytest.mark.parametrize("objective,max_bin", [
    ("binary", 511), ("binary", 4095), ("regression", 511),
    ("regression", 4095)])
def test_partitioned_and_masked_match_reference(objective, max_bin):
    X, y = _data(objective)
    base = dict(objective=objective, num_leaves=15, verbosity=-1,
                max_bin=max_bin)
    pool = dict(histogram_pool_size=0.001)     # below one leaf's pool
    ref = lgb.train(dict(base, **pool), lgb.Dataset(X, y), ROUNDS)
    part = lt.train(base, lt.Dataset(X, y), ROUNDS, device="cpu")
    masked = lt.train(dict(base, **pool), lt.Dataset(X, y), ROUNDS,
                      device="cpu")
    assert part._gbdt.learner.grow_mode == "partition"
    assert masked._gbdt.learner.grow_mode == "masked"
    _assert_same_trees(X, ref, part)
    _assert_same_trees(X, ref, masked)


def test_auto_partitions_and_trains_exact_as_the_reference(recwarn):
    """Under ``auto`` the reference's uint16 histograms are XLA's, so it
    partitions, and quantized gradients then train exact with a warning
    (reference serial.py:759, :772-776)."""
    X, y = _data("binary", n=2000)
    params = dict(objective="binary", num_leaves=7, verbosity=-1,
                  max_bin=511, use_quantized_grad=True)
    q = lt.train(params, lt.Dataset(X, y), 2, device="cpu")
    e = lt.train(dict(params, use_quantized_grad=False), lt.Dataset(X, y), 2,
                 device="cpu")
    assert q._gbdt.learner.grow_mode == "partition"
    assert not q._gbdt.learner.quantized
    assert q.model_to_string().split("parameters:")[0] == \
        e.model_to_string().split("parameters:")[0]
    ref = lgb.Dataset(X, y, params={"max_bin": 511}).construct()
    port = q._gbdt.train_set
    np.testing.assert_array_equal(port.X_binned, np.asarray(ref.X_binned))


def test_train_many_refuses_u16_bins():
    """Since the model-axis kernels' uint16 forms, ``train_many`` and
    ``cv`` at max_bin=511 train on the CPU through the batch (each model's
    text its standalone ``train()``'s); the batch refuses only the
    pool-less (masked) grower, as the reference's does, with
    ``MultiTrainError``: ``train_many`` then trains its models one by one
    (or raises with ``allow_fallback=False``) and ``cv`` runs its per-fold
    loop, whose metrics it returns."""
    from lightgbm_tpu_torch.multitrain import MultiTrainError
    X, y = _data("regression", n=2000)
    params = {"objective": "regression", "num_leaves": 7, "verbosity": -1,
              "max_bin": 511}
    variants = [{"lambda_l2": 0.0}, {"lambda_l2": 1.0}]
    mb = lt.train_many(params, lt.Dataset(X, y), 2, variants=variants,
                       device="cpu")
    assert mb.batched_indices == [0, 1] and mb.fallback_indices == []
    for m, v in enumerate(variants):
        ref = lt.train({**params, **v}, lt.Dataset(X, y), 2, device="cpu")
        assert ref._gbdt.learner.grow_mode == "partition"
        assert mb[m].model_to_string() == ref.model_to_string()
    kw = dict(num_boost_round=2, nfold=3, seed=7, device="cpu")
    fast = lt.cv(params, lt.Dataset(X, y), **kw)
    assert fast == lt.cv({**params, "tpu_cv_many": False},
                         lt.Dataset(X, y), **kw)
    masked = {**params, "histogram_pool_size": 0.001}
    with pytest.raises(MultiTrainError, match="masked"):
        lt.train_many(masked, lt.Dataset(X, y), 2, variants=variants,
                      allow_fallback=False, device="cpu")
    mb = lt.train_many(masked, lt.Dataset(X, y), 2, variants=variants,
                       device="cpu")
    assert mb.fallback_indices == [0, 1]
    loop = lt.cv(masked, lt.Dataset(X, y), **kw)
    assert loop == lt.cv({**masked, "tpu_cv_many": False}, lt.Dataset(X, y),
                         **kw)
    assert len(loop["valid l2-mean"]) == 2


def test_wave_refuses_a_categorical_feature_past_256_bins():
    rng = np.random.RandomState(3)
    X = np.c_[rng.randn(3000, 2), rng.randint(0, 400, 3000)]
    y = (X[:, 0] > 0).astype(float)
    params = dict(objective="binary", num_leaves=7, verbosity=-1,
                  max_bin=511, tree_grow_mode="wave", min_data_per_group=1,
                  cat_smooth=1.0)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lt.train(params, lt.Dataset(X, y, categorical_feature=[2]), 1,
                 device="cpu")


# -- launch geometry of the uint16 kernels -------------------------------------

SMS = 132
SM_SMEM = 233_472
BIG_BINS = [257, 1024, 4096, 10_598, 10_599, 11_621, 11_622, 17_664,
            17_665, 32_768, 65_535, 65_536]


MAIN_ROWS = 10_502_144


def _mix_counts(mix, n, k, seed=0):
    """Rows per channel of a mix over ``n`` rows and ``k`` channels:
    chip_smoke.py phase 15a's (half the rows kept, spread evenly over 42
    channels, the exact form's first 25 of them), one channel holding 90%
    of the kept rows with several empty, or no kept row at all."""
    if mix == "none":
        return torch.zeros(k, dtype=torch.int64)
    if mix == "phase15a":
        c = torch.full((k,), n // 2 // hc.Q_LEAF_CHANNELS, dtype=torch.int64)
        c[:n // 2 % hc.Q_LEAF_CHANNELS] += 1 if k == hc.Q_LEAF_CHANNELS else 0
        return c
    rng = np.random.RandomState(seed)
    kept = n // 2
    c = np.zeros(k, np.int64)
    c[3] = kept * 9 // 10
    rest = rng.choice([i for i in range(k) if i % 4 != 1 and i != 3],
                      kept - c[3])
    np.add.at(c, rest, 1)
    return torch.from_numpy(c)


def _pieces(offsets, slots, table):
    """(channel, first, end) of every slot's listed rows, by rank."""
    out = []
    for e in table.tolist():
        if e < 0:
            continue
        c, j = e & 255, e >> 8
        o, m, s = int(offsets[c]), int(offsets[c + 1] - offsets[c]), \
            int(slots[c])
        out.append((c, o + m * j // s, o + m * (j + 1) // s))
    return out


@pytest.mark.parametrize("num_bins", BIG_BINS)
@pytest.mark.parametrize("q8", [True, False])
def test_leaf_geometry_fits_every_bin_count(num_bins, q8):
    """The uint16 leaf histograms' geometry (``list_geometry``): a block's
    histogram fits ``BLOCK_SMEM``, the tiles cover B, a slot's block
    columns cover every (feature, bin) once, its slots split each
    channel's listed rows once, every q8 block takes at most 2^24 rows,
    and phase 15a's mix fills at least 132 blocks at B=1024."""
    k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
    for n in (4096, MAIN_ROWS):
        geo = hc.list_geometry(SMS, 28, n, num_bins, k, q8)
        assert geo.smem <= hc.BLOCK_SMEM
        assert geo.smem == geo.fg * geo.bt * (12 if q8 else 20)
        assert geo.bt * geo.tiles >= num_bins > geo.bt * (geo.tiles - 1)
        assert geo.tiles <= 8          # a tile cluster's portable size
        columns = geo.f_groups * geo.tiles
        assert geo.blocks == columns * (geo.slots + k)
        cover = np.zeros((28, num_bins), np.int64)
        for col in range(columns):
            b0 = (col % geo.tiles) * geo.bt
            f0 = (col // geo.tiles) * geo.fg
            assert b0 < num_bins and f0 < 28
            cover[f0:f0 + geo.fg, b0:b0 + geo.bt] += 1
        assert (cover == 1).all()
        for mix in ("phase15a", "skewed", "none"):
            counts = _mix_counts(mix, n, k)
            offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                                 torch.cumsum(counts, 0)])
            slots, table = hc.list_slots(counts, geo.slots)
            assert table.numel() == geo.slots + k
            pieces = _pieces(offsets, slots, table)
            rows = np.zeros(int(offsets[-1]), np.int64)
            for c, a, b in pieces:
                assert offsets[c] <= a <= b <= offsets[c + 1]
                rows[a:b] += 1
                if q8:
                    assert b - a <= hc.Q8_MAX_BLOCK_ROWS
            assert (rows == 1).all()
            if mix == "phase15a" and num_bins == 1024 and n == MAIN_ROWS:
                assert columns * len(pieces) >= SMS


@pytest.mark.parametrize("mix", ["phase15a", "skewed", "none"])
def test_list_slots_rank_by_share_start(mix):
    """Each channel with rows takes max(1, round(n_c S / total)) slots, S
    + K at most; the table ranks them by (j / s_c, c), -1 after; no slot
    holds more than ceil(2 total / S) rows, so S >= 2N / 2^24 keeps q8
    blocks under 2^24 rows even at 2^28 rows."""
    for n, k, num_slots in ((MAIN_ROWS, 42, 126), (MAIN_ROWS, 25, 125),
                            (1 << 28, 42, hc.list_slots_least(1 << 28, True)),
                            (4096, 25, 250)):
        counts = _mix_counts(mix, n, k)
        total = int(counts.sum())
        slots, table = hc.list_slots(counts, num_slots)
        s = slots.long()
        assert ((s == 0) == (counts == 0)).all()
        assert int(s.sum()) <= num_slots + k
        used = int(s.sum())
        assert (table[used:] == -1).all()
        keys = [((e >> 8) / int(s[e & 255]), e & 255)
                for e in table[:used].tolist()]
        assert keys == sorted(keys) and len(set(keys)) == used
        if total:
            most = max(-(-int(counts[c]) // int(s[c])) for c in range(k)
                       if s[c] > 0)
            assert most <= -(-2 * total // num_slots)
            if n == 1 << 28:
                assert most <= hc.Q8_MAX_BLOCK_ROWS


def _channels(mix, n, k, rng):
    """(N,) int8 channels of a mix, rows outside [0, K) unlisted."""
    if mix == "none":
        return torch.full((n,), -1, dtype=torch.int8)
    if mix == "uniform":
        return torch.from_numpy(rng.randint(-1, k + 3, n).astype(np.int8))
    ch = np.full(n, -1, np.int8)
    kept = rng.rand(n) < 0.6
    heavy = rng.rand(n) < 0.9
    ch[kept & heavy] = 3
    light = kept & ~heavy
    ch[light] = rng.choice([c for c in range(k) if c % 4 != 1 and c != 3],
                           int(light.sum()))
    return torch.from_numpy(ch)


@pytest.mark.parametrize("mix", ["uniform", "skewed", "none"])
@pytest.mark.parametrize("q8", [True, False])
def test_plain_partition_lists_each_channel_in_row_order(mix, q8):
    """The plain channel partition: the offsets are the cumulative
    ``bincount`` of the listed channels, ids ascend within a channel,
    rows outside [0, K) are absent, and every record carries its row's
    three weights."""
    rng = np.random.RandomState(5)
    n = 6000
    k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
    ch = _channels(mix, n, k, rng)
    if q8:
        w = torch.from_numpy(rng.randint(-128, 128, (8, n)).astype(np.int8))
    else:
        w = th.pack_weights(torch.randn(n), torch.rand(n),
                            (torch.rand(n) < 0.8).float()).w
    rl = hc.leaf_partition(ch, w, num_channels=k, slots=3 * k)
    kept = (ch >= 0) & (ch < k)
    counts = torch.bincount(ch[kept].long(), minlength=k)
    np.testing.assert_array_equal(
        rl.offsets.numpy(), np.concatenate([[0], np.cumsum(counts.numpy())]))
    ids = rl.ids()
    assert ids.numel() == int(kept.sum())
    assert set(ids.tolist()) == set(torch.nonzero(kept).squeeze(1).tolist())
    for c in range(k):
        run = ids[rl.offsets[c]:rl.offsets[c + 1]]
        assert (ch[run] == c).all()
        assert (run[1:] > run[:-1]).all()
    np.testing.assert_array_equal(rl.weights().numpy(),
                                  w[:3, ids].long().numpy())


def _wrap32(x):
    """int64 ``x`` mod 2^32 as signed 32-bit values (two's complement)."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _walk(bins, w3, ch, k, num_bins, geo):
    """The list histograms' decomposition in plain PyTorch: block b of
    ``geo`` (tile t of its column's cluster) adds 1/tiles of its slot's
    listed rows for its features, each bin into the tile that holds it;
    after the cluster's barrier each tile's sums add into the (K, F, B,
    3) result.  q8 (int8 ``w3``) sums in 32-bit words as the kernel does:
    a tile's words wrap mod 2^32 and add into the int32 result mod 2^32
    (its ``red.global.add.u32``); past one tile its g and h share one
    (g << 32) + h word, which decodes exactly while a cluster's sum h
    fits 32 bits (the slot cap), asserted here.  fx sums int64."""
    q8 = w3.dtype == torch.int8
    f = bins.shape[0]
    rl = hc.leaf_partition(ch, w3, num_channels=k, slots=geo.slots)
    ids, wts = rl.ids(), rl.weights()
    pieces = _pieces(rl.offsets, rl.slots, rl.table)
    out = torch.zeros((geo.tiles, k, f, geo.bt, 3), dtype=torch.int64)
    wide = bins.to(torch.int64)
    for u in range(geo.blocks // geo.tiles):   # cluster u: (slot, group)
        if u // geo.f_groups >= len(pieces):
            continue
        c, s0, s1 = pieces[u // geo.f_groups]
        f0 = (u % geo.f_groups) * geo.fg
        nf = min(geo.fg, f - f0)
        acc = torch.zeros((geo.tiles, nf, geo.bt, 3), dtype=torch.int64)
        for t in range(geo.tiles):
            p0 = s0 + (s1 - s0) * t // geo.tiles
            p1 = s0 + (s1 - s0) * (t + 1) // geo.tiles
            rows, w = ids[p0:p1], wts[:, p0:p1]
            for x in range(f0, f0 + nf):
                bb = wide[x, rows]
                keep = bb < num_bins
                bb, wk = bb[keep], w[:, keep]
                for owner in range(geo.tiles):
                    mine = bb // geo.bt == owner
                    acc[owner, x - f0].index_add_(
                        0, bb[mine] - owner * geo.bt, wk[:, mine].T)
        if q8:
            if geo.tiles > 1:
                assert ((acc[..., 1] >= -(1 << 31)) &
                        (acc[..., 1] < 1 << 31)).all()
            out[:, c, f0:f0 + nf] = _wrap32(out[:, c, f0:f0 + nf] +
                                            _wrap32(acc))
        else:
            out[:, c, f0:f0 + nf] += acc
    out = torch.cat(list(out), dim=2)[:, :, :num_bins]
    return out.to(torch.int32) if q8 else out


def _int32(u):
    """uint32 ``u`` as a signed 32-bit value."""
    return u - (1 << 32) if u >= 1 << 31 else u


def _merged_q8(g, h):
    """csrc/hist_leaves_u16.cu ``add_codes``' merged q8 weights: the lanes'
    g + 65536 h summed in one 32-bit word (``__reduce_add_sync``), g the
    word's low 16 bits sign-extended and h the rest."""
    s = _int32(sum((a + 65536 * b) & 0xFFFFFFFF for a, b in zip(g, h))
               & 0xFFFFFFFF)
    gs = _int32((s << 16) & 0xFFFFFFFF) >> 16
    return gs, (s - gs) >> 16


def _merged64(v):
    """``warp_sum64``: the lanes' 64-bit values summed mod 2^64 from their
    low and middle 16 bits and high 32 bits, each part a 32-bit sum."""
    u = [x & 0xFFFFFFFFFFFFFFFF for x in v]
    lo = sum(x & 0xFFFF for x in u) & 0xFFFFFFFF
    mid = sum((x >> 16) & 0xFFFF for x in u) & 0xFFFFFFFF
    hi = sum(x >> 32 for x in u) & 0xFFFFFFFF
    t = ((hi << 32) + (mid << 16) + lo) & 0xFFFFFFFFFFFFFFFF
    return t - (1 << 64) if t >= 1 << 63 else t


@pytest.mark.parametrize("case", ["low", "high", "mixed", "one lane"])
def test_warp_merged_sums_are_exact(case):
    """A warp's merged adds (every lane of 32, or one, on one entry) carry
    the exact sums: q8's g and h packed in one 32-bit word at the int8
    extremes, fx's 64-bit weights over their whole range mod 2^64."""
    rng = np.random.RandomState(len(case))
    lanes = 1 if case == "one lane" else 32
    g = {"low": [-128] * lanes, "high": [127] * lanes}.get(
        case, rng.randint(-128, 128, lanes).tolist())
    h = {"low": [-128] * lanes, "high": [127] * lanes}.get(
        case, rng.randint(-128, 128, lanes).tolist())
    assert _merged_q8(g, h) == (sum(g), sum(h))
    big = {"low": [-(1 << 63)] * lanes, "high": [(1 << 63) - 1] * lanes}
    v = big.get(case, [int(x) for x in rng.randint(
        -(1 << 63), (1 << 63) - 1, lanes, dtype=np.int64)])
    want = sum(v) & 0xFFFFFFFFFFFFFFFF
    assert _merged64(v) == (want - (1 << 64) if want >= 1 << 63 else want)


def _plan_model(counts, num_slots):
    """The plan's slots and table as the scatter's block 0 computes them
    (csrc/hist_leaves_u16.cu ``write_plan``): a slot's channel is the
    count of channels whose slots end at or before it; its rank j + the
    slots of every other channel starting before j / s_c (and those
    starting with it, of a lower channel), in 32-bit unsigned arithmetic."""
    k = counts.numel()
    total = int(counts.sum())
    s = [max(1, (2 * int(nc) * num_slots + total) // (2 * total))
         if nc > 0 else 0 for nc in counts.tolist()]
    pre = np.concatenate([[0], np.cumsum(s)]).astype(np.int64)
    table = [-1] * (num_slots + k)
    m32 = 0xFFFFFFFF
    for u in range(int(pre[k])):
        c = int((pre[1:] <= u).sum())
        j, sc = u - int(pre[c]), s[c]
        part = 0
        for d in range(k):
            if d == c or s[d] == 0:
                continue
            q = (j * s[d]) & m32
            part += ((q + sc - 1) & m32) // sc + (d < c and q % sc == 0)
        table[(j + part) & m32] = (j << 8) | c
    return (torch.tensor(s, dtype=torch.int32),
            torch.tensor(table, dtype=torch.int32))


def _partition_model(ch, w, k, num_slots, part_blocks, q8):
    """The channel partition's placement in plain PyTorch
    (csrc/hist_leaves_u16.cu ``part_count``, ``part_scatter``): P blocks
    of ``part_block_rows`` rows count their rows per channel; each block
    starts in channel c at its offset plus the earlier blocks' rows of c
    and walks its rows in tiles of ``part_tile_rows``; warp v of the
    block owns the tile's rows [v x 32 R, (v + 1) x 32 R) and ranks each
    row within its channel among the warp's rows; the tile's stage place
    is the channel's start in the tile + the earlier warps' rows of it +
    that rank; the list place the block's running place in the channel +
    the same; and the block's place advances by the tile's rows of each
    channel.  Returns the RowList the kernels write, asserting that each
    tile's stage places and the list places are each taken once."""
    n = ch.shape[0]
    tile = hc.part_tile_rows(q8)
    warps = hc.PART_THREADS // 32
    br = hc.part_block_rows(n, part_blocks)
    assert br % hc.PART_ROW_STEP == 0 and br * part_blocks >= n
    key = torch.where((ch >= 0) & (ch < k), ch.long(), -1)
    counts = torch.zeros((k, part_blocks), dtype=torch.int64)
    for b in range(part_blocks):
        kb = key[b * br:(b + 1) * br]
        counts[:, b] = torch.bincount(kb[kb >= 0], minlength=k)
    tot = counts.sum(1)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(tot, 0)])
    every = hc._records(torch.arange(n), w)
    records = torch.zeros_like(every)
    taken = torch.zeros(n, dtype=torch.int64)
    for b in range(part_blocks):
        place = offsets[:-1] + counts[:, :b].sum(1)
        r0, r1 = b * br, min(n, (b + 1) * br)
        for t0 in range(r0, r1, tile):
            kt = torch.full((tile,), -1, dtype=torch.int64)
            kt[:min(tile, r1 - t0)] = key[t0:min(t0 + tile, r1)]
            kw = kt.view(warps, -1)
            hot = kw[..., None] == torch.arange(k)
            local = torch.cumsum(hot.long(), 1) - hot.long()
            wcnt = hot.sum(1)
            wpre = torch.cumsum(wcnt, 0) - wcnt
            ttot = wcnt.sum(0)
            tstart = torch.cumsum(ttot, 0) - ttot
            kept = kw >= 0
            c = kw.clamp(min=0)
            rank = local.gather(2, c[..., None]).squeeze(2)
            pos = (tstart[c] + wpre.gather(1, c) + rank)[kept]
            rows = (t0 + torch.arange(tile)).view(warps, -1)[kept]
            stage_c = c[kept]
            assert sorted(pos.tolist()) == list(range(int(ttot.sum())))
            dst = pos + (place - tstart)[stage_c]
            records[dst] = every[rows]
            taken[dst] += 1
            place += ttot
    m = int(offsets[-1])
    assert (taken[:m] == 1).all() and not taken[m:].any()
    slots, table = _plan_model(tot, num_slots)
    return hc.RowList(records, offsets.to(torch.int32), slots, table)


def _part_weights(n, q8, rng):
    if q8:
        return torch.from_numpy(rng.randint(-128, 128, (8, n)).astype(
            np.int8))
    return th.pack_weights(torch.randn(n), torch.rand(n),
                           (torch.rand(n) < 0.8).float()).w


def _same_list(got, want):
    m = int(want.offsets[-1])
    assert int(got.offsets[-1]) == m
    assert torch.equal(got.records[:m], want.records[:m])
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a, b)


# (rows, row blocks) in tiles T of the scatter: below one tile, a tile's
# multiple and one off either side of it over 2 blocks (channels spanning
# tiles and blocks), one block of 5 tiles and a bit
PART_SIZES = {"small": lambda t: (1000, 1),
              "tile-1": lambda t: (t - 1, 1),
              "3 tiles-1": lambda t: (3 * t - 1, 2),
              "3 tiles": lambda t: (3 * t, 2),
              "3 tiles+1": lambda t: (3 * t + 1, 2),
              "one block": lambda t: (5 * t + 7, 1)}


@pytest.mark.parametrize("k", [1, None, 64])
@pytest.mark.parametrize("size", list(PART_SIZES))
@pytest.mark.parametrize("mix", ["uniform", "skewed", "none"])
@pytest.mark.parametrize("q8", [True, False])
def test_partition_model_matches_plain(q8, mix, size, k):
    """The partition kernels' index arithmetic (:func:`_partition_model`:
    blocks, tiles, per-warp and per-tile channel prefixes, run writes
    from the block's running place; the plan's warp-parallel slot table)
    lists every kept row once, record for record and plan for plan
    ``leaf_partition_plain``'s, at every edge size and K = 1, the form's K
    and 64."""
    rng = np.random.RandomState(11)
    k = k or (hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS)
    n, blocks = PART_SIZES[size](hc.part_tile_rows(q8))
    ch = _channels(mix, n, k, rng)
    w = _part_weights(n, q8, rng)
    num_slots = 3 * k
    want = hc.leaf_partition_plain(ch, w, num_channels=k, slots=num_slots)
    _same_list(_partition_model(ch, w, k, num_slots, blocks, q8), want)


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("q8", [True, False])
def test_partition_model_in_the_lanes_share(q8, lanes):
    """Each lane of ``leaf_partition_lanes`` walks its rows in the lanes'
    share of row blocks (``_part_blocks(sms, n, lanes)``), over lanes of
    different mixes: the model's list is that lane's plain list."""
    rng = np.random.RandomState(lanes)
    k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
    n = 3 * hc.LIST_PART_MIN_ROWS + 5
    blocks = hc._part_blocks(132, n, lanes)
    assert blocks == 4
    chs = [_channels(("uniform", "skewed", "none")[i % 3], n, k, rng)
           for i in range(lanes)]
    ws = [_part_weights(n, q8, rng) for _ in range(lanes)]
    wants = hc.leaf_partition_lanes_plain(chs, ws, num_channels=k,
                                          slots=4 * k)
    for c, w, want in zip(chs, ws, wants):
        _same_list(_partition_model(c, w, k, 4 * k, blocks, q8), want)


@pytest.mark.parametrize("q8,mix,num_bins", [
    (q8, mix, nb) for q8 in (True, False) for mix in ("uniform", "skewed")
    for nb in (257, 1024, 65_535)] + [(True, "extreme", 257),
                                      (True, "extreme", 19_371)])
def test_list_walk_matches_plain_histograms(num_bins, mix, q8):
    """Walking ``list_geometry``'s blocks over the plain row list (per
    slot, feature group and tile of a cluster, then summed) gives
    ``build_histogram_leaves{,_q8}_plain`` bit for bit: the decomposition
    drops and doubles no row, and q8's 32-bit words give the plain int32
    sums.  ``extreme``: q8 at the slot cap, ``Q8_MAX_BLOCK_ROWS`` rows of
    one channel in one slot and one bin, every g -128 and every h 127 at
    one tile (the cluster's words reach -2^31 and 2^31 - 2^24), -128 at
    two (sum h -2^31 in the low word of (g << 32) + h)."""
    rng = np.random.RandomState(num_bins % 89)
    n, f = 4096, 5
    k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
    if mix == "extreme":
        n, f = hc.Q8_MAX_BLOCK_ROWS, 1
        bins = torch.full((f, n), num_bins - 1, dtype=torch.uint16)
        ch = torch.zeros(n, dtype=torch.int8)
        wch = torch.ones((8, n), dtype=torch.int8)
        h = 127 if num_bins == 257 else -128
        wch[0], wch[1] = -128, h
        geo = hc.list_geometry(SMS, f, n, num_bins, k, q8)
        geo = geo._replace(slots=1, blocks=(1 + k) * geo.tiles)
        want = hc.build_histogram_leaves_q8_plain(bins, wch, ch,
                                                  num_bins=num_bins)
        assert want[0, 0, -1].tolist() == [-(1 << 31), h * n, n]
        got = _walk(bins, wch, ch, k, num_bins, geo)
        assert torch.equal(got, want)
        return
    bins = torch.from_numpy(rng.randint(0, num_bins, (f, n)).astype(
        np.uint16))
    ch = _channels(mix, n, k, rng)
    geo = hc.list_geometry(SMS, f, n, num_bins, k, q8)
    if q8:
        wch = torch.from_numpy(rng.randint(-128, 128, (8, n)).astype(np.int8))
        want = hc.build_histogram_leaves_q8_plain(bins, wch, ch,
                                                  num_bins=num_bins)
        got = _walk(bins, wch, ch, k, num_bins, geo)
        assert got.dtype == want.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    else:
        w = th.pack_weights(torch.randn(n), torch.rand(n),
                            (torch.rand(n) < 0.8).float())
        want = hc.build_histogram_leaves_plain(bins, w, ch, num_bins=num_bins,
                                               raw=True)
        got = _walk(bins, w.w, ch, k, num_bins, geo)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("num_bins", BIG_BINS)
def test_list_geometry_owner_mode_past_one_tile(num_bins):
    """The exact form's f32 values past one bin tile take owner mode (no
    slot shares a channel, so each (channel, feature group) has one
    cluster: ``slots`` 0, ``k`` ranks); at one tile, its raw sums and the
    q8 form keep slot mode, their geometry unchanged by ``f32_out``."""
    kx, kq = hc.LEAF_CHANNELS, hc.Q_LEAF_CHANNELS
    slot = hc.list_geometry(SMS, 28, MAIN_ROWS, num_bins, kx, False)
    geo = hc.list_geometry(SMS, 28, MAIN_ROWS, num_bins, kx, False,
                           f32_out=True)
    assert geo.owner == (geo.tiles > 1) == hc.list_owner(num_bins, False,
                                                         True)
    assert not slot.owner and slot.slots >= kx
    assert geo._replace(slots=slot.slots, blocks=slot.blocks) == slot
    if geo.owner:
        assert geo.blocks == geo.f_groups * geo.tiles * kx
    else:
        assert geo == slot
    q8 = hc.list_geometry(SMS, 28, MAIN_ROWS, num_bins, kq, True)
    assert hc.list_geometry(SMS, 28, MAIN_ROWS, num_bins, kq, True,
                            f32_out=True) == q8 and not q8.owner
    if num_bins == 65_535:
        assert (geo.tiles, geo.fg, geo.f_groups) == (6, 1, 28)
    if num_bins == 1024:
        assert not geo.owner


@pytest.mark.parametrize("mix", ["phase15a", "skewed", "none"])
def test_owner_plan_gives_each_channel_one_slot(mix):
    """At S = 0 slots, ``list_slots`` and the scatter's plan arithmetic
    (:func:`_plan_model`) give every channel with rows exactly one slot,
    however many rows it holds (the skewed mix's channel 3 holds 90%),
    ranked by channel, and the plain partition's plan says the same."""
    k = hc.LEAF_CHANNELS
    counts = _mix_counts(mix, MAIN_ROWS, k)
    slots, table = hc.list_slots(counts, 0)
    assert torch.equal(slots.long(), (counts > 0).long())
    used = [c for c in range(k) if counts[c] > 0]
    assert table.tolist() == used + [-1] * (k - len(used))
    mslots, mtable = _plan_model(counts, 0)
    assert torch.equal(mslots, slots) and torch.equal(mtable, table)
    rng = np.random.RandomState(8)
    ch = _channels("uniform" if mix == "phase15a" else mix, 6000, k, rng)
    w = _part_weights(6000, False, rng)
    rl = hc.leaf_partition(ch, w, num_channels=k, slots=0)
    kept = torch.bincount(ch[(ch >= 0) & (ch < k)].long(), minlength=k)
    assert torch.equal(rl.slots.long(), (kept > 0).long())
    assert rl.table.numel() == k


def _owner_walk(bins, w, ch, k, num_bins, geo):
    """The owner mode's decomposition in plain PyTorch: cluster (channel
    c, feature group g) walks all of c's listed rows, tile t of it
    1/tiles of them, each bin added into the tile that holds it; after the
    cluster's barrier each block writes its tile of the (K, F, B, 3)
    output once as (float)((double)sum x scale), an empty channel's zeros
    too.  Returns the output and each entry's write count."""
    f = bins.shape[0]
    rl = hc.leaf_partition(ch, w.w, num_channels=k, slots=geo.slots)
    ids, wts = rl.ids(), rl.weights()
    wide = bins.to(torch.int64)
    out = torch.full((k, f, num_bins, 3), float("nan"))
    writes = torch.zeros((k, f, num_bins), dtype=torch.int64)
    for c in range(k):
        s0, s1 = int(rl.offsets[c]), int(rl.offsets[c + 1])
        for g in range(geo.f_groups):
            f0 = g * geo.fg
            tiles = torch.zeros((geo.tiles, geo.fg, geo.bt, 3),
                                dtype=torch.int64)
            for t in range(geo.tiles):
                p0 = s0 + (s1 - s0) * t // geo.tiles
                p1 = s0 + (s1 - s0) * (t + 1) // geo.tiles
                rows, wk = ids[p0:p1], wts[:, p0:p1]
                for x in range(f0, min(f0 + geo.fg, f)):
                    bb = wide[x, rows]
                    keep = bb < num_bins
                    for owner in range(geo.tiles):
                        mine = keep & (bb // geo.bt == owner)
                        tiles[owner, x - f0].index_add_(
                            0, bb[mine] - owner * geo.bt, wk[:, mine].T)
            for t in range(geo.tiles):
                b0 = t * geo.bt
                nb = min(geo.bt, num_bins - b0)
                nf = min(geo.fg, f - f0)
                vals = tiles[t, :nf, :nb].double() * w.inv_scale
                out[c, f0:f0 + nf, b0:b0 + nb] = vals.float()
                writes[c, f0:f0 + nf, b0:b0 + nb] += 1
    return out, writes


@pytest.mark.parametrize("num_bins", [11_623, 65_535])
@pytest.mark.parametrize("mix", ["uniform", "skewed", "none"])
def test_owner_walk_matches_plain_f32(num_bins, mix):
    """Walking the owner mode's clusters over the plain row list writes
    every (channel, feature, bin) once and gives
    ``build_histogram_leaves_plain`` (f32, raw=False) bit for bit: the
    clusters' final sums scaled once are ``fx_to_f32`` of the int64
    sums."""
    rng = np.random.RandomState(num_bins % 97)
    n, f, k = 4096, 3, hc.LEAF_CHANNELS
    bins = torch.from_numpy(rng.randint(0, num_bins, (f, n)).astype(
        np.uint16))
    bins[:, :50] = num_bins - 1
    ch = _channels(mix, n, k, rng)
    geo = hc.list_geometry(SMS, f, n, num_bins, k, False, f32_out=True)
    assert geo.owner
    w = th.pack_weights(torch.randn(n), torch.rand(n),
                        (torch.rand(n) < 0.8).float())
    got, writes = _owner_walk(bins, w, ch, k, num_bins, geo)
    assert (writes == 1).all()
    want = hc.build_histogram_leaves_plain(bins, w, ch, num_bins=num_bins)
    assert want.dtype == torch.float32
    assert torch.equal(got, want)


def _cluster_of(b, tiles, f_groups, ranks, lanes, feature_major):
    """csrc/hist_leaves_u16.cu ``cluster_of``: block b's (lane, rank,
    group, tile)."""
    u, tile = divmod(b, tiles)
    if feature_major:
        u, rank = divmod(u, ranks)
        g, lane = divmod(u, lanes)
    else:
        u, g = divmod(u, f_groups)
        lane, rank = divmod(u, ranks)
    return lane, rank, g, tile


# (lanes, ranks, feature groups, tiles): the exact form's owner mode,
# small shapes, and the q8 form's slot mode at L=4 and 10.5M rows at
# B=1024 (one tile) and 65,535 (4 tiles), its ranks the slots + K
Q8_LANE_SHAPES = [
    (4, g.slots + hc.Q_LEAF_CHANNELS, g.f_groups, g.tiles)
    for g in (hc.list_geometry(132, 28, 10_502_144, nb, hc.Q_LEAF_CHANNELS,
                               True) for nb in (1024, 65_535))]


@pytest.mark.parametrize("shape", [(1, 25, 28, 6), (4, 25, 28, 6),
                                   (3, 50, 4, 1), (4, 42, 28, 4)] +
                         Q8_LANE_SHAPES)
@pytest.mark.parametrize("feature_major", [False, True])
def test_lane_cluster_orders_cover_each_cluster_once(shape, feature_major):
    """One launch of L lanes' clusters, lane-major or feature-major: its
    blocks cover every (lane, rank, feature group, tile) once, a
    cluster's tiles in consecutive blocks (tile fastest, the cluster's
    rank); lane-major runs one rank's feature groups together,
    feature-major one feature group's lanes and ranks together."""
    lanes, ranks, f_groups, tiles = shape
    blocks = lanes * ranks * f_groups * tiles
    seen = [_cluster_of(b, tiles, f_groups, ranks, lanes, feature_major)
            for b in range(blocks)]
    assert len(set(seen)) == blocks
    assert all(0 <= la < lanes and 0 <= r < ranks and 0 <= g < f_groups
               for la, r, g, _ in seen)
    for b0 in range(0, blocks, tiles):
        cl = seen[b0:b0 + tiles]
        assert [t for *_, t in cl] == list(range(tiles))
        assert len({x[:3] for x in cl}) == 1
    step = tiles * (ranks * lanes if feature_major else f_groups)
    for b0 in range(0, blocks, step):
        run = seen[b0:b0 + step]
        key = {x[2] for x in run} if feature_major else \
            {x[:2] for x in run}
        assert len(key) == 1


@pytest.mark.parametrize("num_bins", BIG_BINS)
@pytest.mark.parametrize("layout", ["rows", "features"])
def test_single_geometry_fits_every_bin_count(num_bins, layout):
    for f, n in ((28, 10_502_144), (28, 34_330), (1, 10_502_144)):
        geo = hc.single_geometry(SMS, f, n, num_bins, layout)
        assert geo.smem == geo.fg * (geo.bt | 1) * hc.SINGLE_BIN_BYTES
        assert geo.smem <= hc.BLOCK_SMEM
        per_sm = hc.LEAF_THREADS // geo.threads
        assert per_sm * (geo.smem + 1024) <= SM_SMEM
        assert geo.bt * geo.tiles >= num_bins > geo.bt * (geo.tiles - 1)
        assert geo.f_groups <= 65_535                      # grid rows
        # one cluster of each feature group: its blocks keep every
        # (feature, bin) of the group once, block rank r the bins
        # r % tiles, + tiles, + 2 tiles, ... (at most bt of them)
        fgc = geo.cluster // geo.tiles * geo.fg
        cover = np.zeros((f, num_bins), np.int64)
        for y in range(geo.f_groups):
            for rank in range(geo.cluster):
                f0 = y * fgc + rank // geo.tiles * geo.fg
                t = rank % geo.tiles
                assert len(range(t, num_bins, geo.tiles)) <= geo.bt
                cover[f0:f0 + geo.fg, t::geo.tiles] += 1
        assert (cover == 1).all()
        assert geo.chunks * geo.chunk_rows >= n


def test_bin_tiles_start_where_one_feature_overflows():
    assert hc.single_bin_tile(11_621) == (11_621, 1)
    assert hc.single_bin_tile(11_622)[1] == 2
    assert hc.leaf_bin_tile(11_622, False) == (11_622, 1)
    assert hc.leaf_bin_tile(11_623, False)[1] == 2
    assert hc.leaf_bin_tile(19_370, True) == (19_370, 1)
    assert hc.leaf_bin_tile(19_371, True)[1] == 2
    assert hc.leaf_bin_tile(65_536, True)[1] == 4
    # uint8 bins never tile
    for b in (1, 16, 255, 256):
        assert hc.single_bin_tile(b) == (b, 1)
        assert hc.leaf_bin_tile(b, True) == (b, 1)
