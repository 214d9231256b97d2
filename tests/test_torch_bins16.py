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
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        hc.hist_single_lanes([bins], [w], num_bins=300)


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
    X, y = _data("regression", n=2000)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        lt.train_many({"objective": "regression", "num_leaves": 7,
                       "verbosity": -1, "max_bin": 511},
                      lt.Dataset(X, y), 2,
                      variants=[{"lambda_l2": 0.0}, {"lambda_l2": 1.0}],
                      device="cpu")


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


def _walk(bins, w3, ch, k, num_bins, geo):
    """The list histograms' decomposition in plain PyTorch: block b of
    ``geo`` (tile t of its column's cluster) adds 1/tiles of its slot's
    listed rows for its features, each bin into the tile that holds it,
    and the tiles' histograms add into the (K, F, B, 3) int64 sums."""
    f = bins.shape[0]
    rl = hc.leaf_partition(ch, w3, num_channels=k, slots=geo.slots)
    ids, wts = rl.ids(), rl.weights()
    pieces = _pieces(rl.offsets, rl.slots, rl.table)
    tiles = torch.zeros((geo.tiles, k, f, geo.bt, 3), dtype=torch.int64)
    wide = bins.to(torch.int64)
    columns = geo.f_groups * geo.tiles
    for b in range(geo.blocks):
        if b // columns >= len(pieces):
            continue
        c, s0, s1 = pieces[b // columns]
        col = b % columns
        t = col % geo.tiles
        f0 = (col // geo.tiles) * geo.fg
        p0 = s0 + (s1 - s0) * t // geo.tiles
        p1 = s0 + (s1 - s0) * (t + 1) // geo.tiles
        rows, w = ids[p0:p1], wts[:, p0:p1]
        for x in range(f0, min(f0 + geo.fg, f)):
            bb = wide[x, rows]
            keep = bb < num_bins
            bb, wk = bb[keep], w[:, keep]
            for owner in range(geo.tiles):
                mine = bb // geo.bt == owner
                tiles[owner, c, x].index_add_(
                    0, bb[mine] - owner * geo.bt, wk[:, mine].T)
    return torch.cat(list(tiles), dim=2)[:, :, :num_bins]


@pytest.mark.parametrize("num_bins", [257, 1024, 65_535])
@pytest.mark.parametrize("mix", ["uniform", "skewed"])
@pytest.mark.parametrize("q8", [True, False])
def test_list_walk_matches_plain_histograms(num_bins, mix, q8):
    """Walking ``list_geometry``'s blocks over the plain row list (per
    slot, feature group and tile of a cluster, then summed) gives
    ``build_histogram_leaves{,_q8}_plain`` bit for bit: the decomposition
    drops and doubles no row."""
    rng = np.random.RandomState(num_bins % 89)
    n, f = 4096, 5
    k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
    bins = torch.from_numpy(rng.randint(0, num_bins, (f, n)).astype(
        np.uint16))
    ch = _channels(mix, n, k, rng)
    geo = hc.list_geometry(SMS, f, n, num_bins, k, q8)
    if q8:
        wch = torch.from_numpy(rng.randint(-128, 128, (8, n)).astype(np.int8))
        want = hc.build_histogram_leaves_q8_plain(bins, wch, ch,
                                                  num_bins=num_bins)
        got = _walk(bins, wch, ch, k, num_bins, geo)
        np.testing.assert_array_equal(got.numpy(), want.long().numpy())
    else:
        w = th.pack_weights(torch.randn(n), torch.rand(n),
                            (torch.rand(n) < 0.8).float())
        want = hc.build_histogram_leaves_plain(bins, w, ch, num_bins=num_bins,
                                               raw=True)
        got = _walk(bins, w.w, ch, k, num_bins, geo)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


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
        assert geo.f_groups * geo.tiles <= 65_535          # grid rows
        cover = np.zeros((f, num_bins), np.int64)
        for y in range(geo.f_groups * geo.tiles):
            f0 = (y // geo.tiles) * geo.fg
            b0 = (y % geo.tiles) * geo.bt
            cover[f0:f0 + geo.fg, b0:b0 + geo.bt] += 1
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
