"""The model-axis (lane) forms of the port's kernels, held on the CPU.

Each ``*_lanes`` wrapper of ``lightgbm_tpu_torch.ops.histogram_cuda``
takes L lanes' inputs over one shared bin matrix; its plain version (what
the CUDA kernel is held to on the card) must be bitwise equal to L calls
of the single form and to the reference's ``jax.vmap`` of the Pallas entry
point in interpret mode (the batch axis of pallas_call's batching rule),
at a small shape.  All sums here are exact: quantized int8 weights sum to
int32, and the exact forms get weights that bf16 hi+lo pairs and f32 sums
carry without rounding (multiples of 1/16 and 1/32), so the reference's
f32 sums and the port's fixed-point ones are the same numbers.  The lane
counts are 1 and 3 (not a power of two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram_pallas as hp
from lightgbm_tpu_torch.learner import lanes as kc
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

F = 4
N = 4096
B = 16


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _weights(rng, lanes):
    """Per-lane (g, h, mask), exactly representable in bf16 and summed
    exactly in f32."""
    g = (rng.randint(-64, 65, (lanes, N)) / 16.0).astype(np.float32)
    h = (rng.randint(1, 33, (lanes, N)) / 32.0).astype(np.float32)
    m = (rng.rand(lanes, N) < 0.8).astype(np.float32)
    return g, h, m


def _wch(rng, lanes):
    w = np.zeros((lanes, 8, N), np.int8)
    w[:, 0] = rng.randint(-127, 128, (lanes, N))
    w[:, 1] = rng.randint(0, 128, (lanes, N))
    w[:, 2] = rng.rand(lanes, N) < 0.8
    return w


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("packed", [False, True])
def test_hist_leaves_q8_lanes_bitwise(lanes, packed):
    rng = np.random.RandomState(lanes)
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    wch = _wch(rng, lanes)
    ch = rng.randint(-1, hc.Q_LEAF_CHANNELS, (lanes, N)).astype(np.int8)
    b = th.pack_bins4(_t(bins)) if packed else _t(bins)
    got = hc.build_histogram_leaves_q8_lanes(b, _t(wch), _t(ch), num_bins=B,
                                             bins_packed=packed)
    assert got.shape == (lanes, hc.Q_LEAF_CHANNELS, F, B, 3)
    for lane in range(lanes):
        one = hc.build_histogram_leaves_q8(b, _t(wch[lane]), _t(ch[lane]),
                                           num_bins=B, bins_packed=packed)
        assert torch.equal(got[lane], one)
    ref = jax.vmap(lambda w, c: hp.build_histogram_pallas_leaves_q8(
        jnp.asarray(bins), w, c, num_bins=B, interpret=True))(
            jnp.asarray(wch), jnp.asarray(ch))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lanes", [1, 3])
def test_hist_leaves_fx_lanes_bitwise(lanes):
    """Each lane keeps its own tree's fixed-point scale."""
    rng = np.random.RandomState(10 + lanes)
    bins = rng.randint(0, B, (F, N)).astype(np.uint8)
    g, h, m = _weights(rng, lanes)
    g[-1] *= 8.0       # another scale in the last lane
    ch = rng.randint(-1, hc.LEAF_CHANNELS, (lanes, N)).astype(np.int8)
    ws = [th.pack_weights(_t(g[i]), _t(h[i]), _t(m[i]))
          for i in range(lanes)]
    got = hc.build_histogram_leaves_lanes(_t(bins), ws, _t(ch), num_bins=B)
    assert got.dtype == torch.float32
    for lane in range(lanes):
        one = hc.build_histogram_leaves(_t(bins), ws[lane], _t(ch[lane]),
                                        num_bins=B)
        assert torch.equal(got[lane], one)
    ref = jax.vmap(lambda gg, hh, mm, c: hp.build_histogram_pallas_leaves(
        jnp.asarray(bins), hp.pack_weights8(gg, hh, mm), c, num_bins=B,
        interpret=True))(*map(jnp.asarray, (g, h, m, ch)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lanes", [1, 3])
def test_hist_single_lanes_bitwise(lanes):
    """Per-lane segments of per-lane row-major copies (the partitioned
    grower's leaves: other starts, other lengths, the same strides)."""
    rng = np.random.RandomState(20 + lanes)
    P = [_t(rng.randint(0, B, (N, F + 3)).astype(np.uint8))
         for _ in range(lanes)]
    g, h, m = _weights(rng, lanes)
    starts = [0, 512, 1000][:lanes]
    ends = [N, 3000, 1000 + 2048][:lanes]
    bins, ws, ref_bins, ref_w = [], [], [], []
    for i, (s, e) in enumerate(zip(starts, ends)):
        w = th.pack_weights(_t(g[i]), _t(h[i]), _t(m[i]))
        bins.append(P[i][s:e, :F].t())
        ws.append(th.FxWeights(w.w[:, s:e], w.inv_scale))
        pad = N - (e - s)
        ref_bins.append(np.pad(P[i][s:e, :F].numpy().T, ((0, 0), (0, pad))))
        ref_w.append([np.pad(v[i, s:e], (0, pad)) for v in (g, h, m)])
    got = hc.hist_single_lanes(bins, ws, num_bins=B)
    assert got.shape == (lanes, F, B, 3) and got.dtype == torch.int64
    for lane in range(lanes):
        assert torch.equal(got[lane],
                           hc.hist_single(bins[lane], ws[lane], num_bins=B))
    f32 = th.fx_to_f32(got, torch.stack([w.inv_scale for w in ws]))
    rw = np.asarray(ref_w, np.float32)                      # (L, 3, N)
    ref = jax.vmap(lambda bb, gg, hh, mm: hp.build_histogram_pallas(
        bb, gg, hh, mm, num_bins=B, interpret=True))(
            jnp.asarray(np.stack(ref_bins)), *map(jnp.asarray, rw.swapaxes(
                0, 1)))
    np.testing.assert_array_equal(f32.numpy(), np.asarray(ref))


@pytest.mark.parametrize("lanes", [1, 3])
def test_hist_single_lanes_packed_bitwise(lanes):
    """The packed form: each lane's feature-major (F, N/2) nibble-packed
    bytes (the autotune probe's layout) against L packed single launches
    and the reference's ``jax.vmap`` of ``build_histogram_pallas(...,
    bins_packed=True)`` in interpret mode."""
    rng = np.random.RandomState(40 + lanes)
    codes = rng.randint(0, B, (lanes, F, N)).astype(np.uint8)
    packed = [th.pack_bins4(_t(c)) for c in codes]
    g, h, m = _weights(rng, lanes)
    ws = [th.pack_weights(_t(g[i]), _t(h[i]), _t(m[i]))
          for i in range(lanes)]
    got = hc.hist_single_lanes(packed, ws, num_bins=B, bins_packed=True)
    assert got.shape == (lanes, F, B, 3) and got.dtype == torch.int64
    for lane in range(lanes):
        assert torch.equal(got[lane], hc.hist_single(
            packed[lane], ws[lane], num_bins=B, bins_packed=True))
    assert torch.equal(got, hc.hist_single_lanes(
        [_t(c) for c in codes], ws, num_bins=B))
    f32 = th.fx_to_f32(got, torch.stack([w.inv_scale for w in ws]))
    ref = jax.vmap(lambda bb, gg, hh, mm: hp.build_histogram_pallas(
        bb, gg, hh, mm, num_bins=B, interpret=True, bins_packed=True))(
            jnp.asarray(np.stack([p.numpy() for p in packed])),
            jnp.asarray(g), jnp.asarray(h), jnp.asarray(m))
    np.testing.assert_array_equal(f32.numpy(), np.asarray(ref))


def _row_case(rng, lanes, w, num_leaves=40):
    bins = rng.randint(0, 64, (F + 2, N)).astype(np.uint8)
    rl = rng.randint(0, num_leaves, (lanes, N)).astype(np.int32)
    feats = rng.randint(0, F + 2, (lanes, w)).astype(np.int32)
    tabs = []
    for lane in range(lanes):
        leaves = rng.choice(num_leaves, w, replace=False).astype(np.int32)
        tab = np.stack([
            rng.randint(0, 64, w), np.where(rng.rand(w) < 0.5, 63, -1),
            rng.randint(0, 2, w), rng.randint(0, 2, w), leaves,
            num_leaves + np.arange(w), (rng.rand(w) < 0.8).astype(int),
            np.zeros(w, int)]).astype(np.int32)
        if w > 1:   # a later split catches rows an earlier one moved
            tab[4, 1] = tab[5, 0]
        tabs.append(tab)
    return bins, rl, feats, np.stack(tabs)


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("packed", [False, True])
def test_wave_row_update_lanes_bitwise(lanes, packed):
    rng = np.random.RandomState(30 + lanes)
    bins, rl, feats, tab = _row_case(rng, lanes, 6)
    if packed:
        bins = bins & 15
        tab[:, 0] &= 15
        tab[:, 1] = np.where(tab[:, 1] >= 0, 15, -1)
    b = th.pack_bins4(_t(bins)) if packed else _t(bins)
    rl_g, ch_g = hc.wave_row_update_lanes(b, _t(rl), _t(tab), feats=_t(feats),
                                          bins_packed=packed)
    assert rl_g.shape == ch_g.shape == (lanes, N)
    for lane in range(lanes):
        rl1, ch1 = hc.wave_row_update(b, _t(rl[lane]), _t(tab[lane]),
                                      feats=_t(feats[lane]),
                                      bins_packed=packed)
        assert torch.equal(rl_g[lane], rl1) and torch.equal(ch_g[lane], ch1)
    cols = np.stack([bins[feats[i]] for i in range(lanes)])
    rl_r, ch_r = jax.vmap(lambda c, r, t: hp.wave_row_update_pallas(
        c, r, t, interpret=True))(*map(jnp.asarray, (cols, rl, tab)))
    np.testing.assert_array_equal(rl_g.numpy(), np.asarray(rl_r))
    np.testing.assert_array_equal(ch_g.numpy(), np.asarray(ch_r))


def test_wave_row_update_ext_lanes_bitwise():
    """The categorical / EFB form: per-lane decode tables and membership."""
    rng = np.random.RandomState(41)
    lanes, w = 3, 5
    bins, rl, feats, tab = _row_case(rng, lanes, w)
    decs = []
    for _ in range(lanes):
        member = torch.from_numpy(rng.rand(w, 64) < 0.4)
        decs.append(hc.split_decode(
            torch.from_numpy(rng.rand(w) < 0.5), member,
            torch.zeros(w, dtype=torch.int32),
            torch.full((w,), 64, dtype=torch.int32),
            torch.zeros(w, dtype=torch.int32),
            torch.ones(w, dtype=torch.int32)))
    rl_g, ch_g = hc.wave_row_update_lanes(_t(bins), _t(rl), _t(tab),
                                          feats=_t(feats), decode=decs)
    for lane in range(lanes):
        rl1, ch1 = hc.wave_row_update(_t(bins), _t(rl[lane]), _t(tab[lane]),
                                      feats=_t(feats[lane]),
                                      decode=decs[lane])
        assert torch.equal(rl_g[lane], rl1) and torch.equal(ch_g[lane], ch1)


def test_wave_trial_channels_lanes_bitwise():
    rng = np.random.RandomState(50)
    lanes = 3
    bins, rl, feats, tab = _row_case(rng, lanes, 6)
    args = [(t[4], t[0], t[1], t[2].astype(bool), t[3].astype(bool),
             t[6].astype(bool)) for t in tab]
    tabs = [hc.trial_tab(*map(_t, a)) for a in args]
    got = hc.wave_trial_channels_lanes(_t(bins), _t(rl), tabs,
                                       feats=_t(feats))
    for lane in range(lanes):
        one = hc.wave_trial_channels(_t(bins), _t(rl[lane]),
                                     *map(_t, args[lane]),
                                     feats=_t(feats[lane]))
        assert torch.equal(got[lane], one)
    cols = np.stack([bins[feats[i]] for i in range(lanes)])
    ref = jax.vmap(lambda c, r, *a: hp.wave_trial_channels_pallas(
        c, r, *a, interpret=True))(
            jnp.asarray(cols), jnp.asarray(rl),
            *[jnp.asarray(np.stack([a[k] for a in args])) for k in range(6)])
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_lane_wrappers_check_arguments():
    """Lane counts must agree, every lane's row update needs the same W,
    and a tensor on a device that is neither the CPU nor the current card
    is refused: no plain version runs off the CPU."""
    bins = torch.zeros((F, N), dtype=torch.uint8)
    ch = torch.zeros((2, N), dtype=torch.int8)
    with pytest.raises(ValueError, match="one entry per lane"):
        hc.build_histogram_leaves_q8_lanes(
            bins, torch.zeros((3, 8, N), dtype=torch.int8), ch, num_bins=B)
    rl = torch.zeros((2, N), dtype=torch.int32)
    tabs = [torch.zeros((8, 2), dtype=torch.int32),
            torch.zeros((8, 3), dtype=torch.int32)]
    feats = [torch.zeros(2, dtype=torch.int32),
             torch.zeros(3, dtype=torch.int32)]
    with pytest.raises(ValueError, match="same W"):
        hc.wave_row_update_lanes(bins, rl, tabs, feats=feats)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="current CUDA device"):
        hc.hist_single_lanes([torch.zeros((F, 8), dtype=torch.uint8, **meta)],
                             [torch.zeros((3, 8), dtype=torch.int64, **meta)],
                             num_bins=B)
    with pytest.raises(ValueError, match="current CUDA device"):
        hc.wave_row_update_lanes(
            torch.zeros((F, N), dtype=torch.uint8, **meta),
            torch.zeros((1, N), dtype=torch.int32, **meta),
            torch.zeros((1, 8, 2), dtype=torch.int32, **meta),
            feats=torch.zeros((1, 2), dtype=torch.int32, **meta))


def test_run_lanes_groups_requests_by_key():
    """The lockstep driver serves each round's requests with one launch
    per key, and each lane gets its own slice back."""
    rng = np.random.RandomState(60)
    bins = _t(rng.randint(0, B, (F, N)).astype(np.uint8))
    wch = _t(_wch(rng, 3))
    chs = _t(rng.randint(-1, 5, (3, N)).astype(np.int8))
    groups = []
    real = kc._run_group

    def spy(calls):
        groups.append(len(calls))
        return real(calls)

    def lane(i, rounds):
        out = []
        for _ in range(rounds):
            out.append((yield kc.leaves_q8(bins, wch[i], chs[i], num_bins=B,
                                           bins_packed=False)))
        return out

    kc._run_group = spy
    try:
        res = kc.run_lanes([lane(0, 2), lane(1, 2), lane(2, 1)])
    finally:
        kc._run_group = real
    assert groups == [3, 2]
    for i, r in enumerate(res):
        one = hc.build_histogram_leaves_q8(bins, wch[i], chs[i], num_bins=B)
        assert all(torch.equal(x, one) for x in r)
    assert kc.run_single(lane(1, 2))[1].equal(res[1][1])


@pytest.mark.parametrize("lanes", [1, 3, 4, 7])
def test_lane_geometry_covers_rows_within_caps(lanes):
    """The model-axis geometries: every lane's rows in some chunk, the
    leaf kernels' per-block row caps kept, and ``hist_single_lanes``'
    real blocks within one resident round of an H100's 132 SMs."""
    n = 10_502_144
    for q8, k in ((True, hc.Q_LEAF_CHANNELS), (False, hc.LEAF_CHANNELS)):
        for nb, packed in ((256, False), (16, True)):
            g = hc.lane_leaf_geometry(132, 28, n, nb, k, q8, packed, lanes)
            assert g.chunks * g.chunk_rows >= n
            assert g.chunk_rows <= (hc.Q8_MAX_BLOCK_ROWS if q8
                                    else hc.LEAF_MAX_BLOCK_ROWS)
            one = hc.leaf_geometry(132, 28, n, nb, k, q8, packed)
            assert (g.cg, g.fg) == (one.cg, one.fg)
    for rows in ([n, n // 2, 50_003, n // 5][:lanes] + [7] * (lanes - 4),
                 [10_000] * lanes, [1] * lanes):
        for f, layout in ((28, "rows"), (1, "features")):
            g = hc.lane_single_geometry(132, f, rows, 256, layout)
            assert g.chunks * g.chunk_rows >= max(rows)
            blocks = sum(-(-r // g.chunk_rows) for r in rows) * g.f_groups
            assert blocks <= 132 * (hc.LEAF_THREADS // g.threads) or \
                g.chunk_rows == hc.SINGLE_MIN_ROWS
