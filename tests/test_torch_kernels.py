"""The PyTorch port's kernel modules held against the JAX package.

Each module of ``lightgbm_tpu_torch`` that holds a kernel (or feeds one)
gets the same seeded numpy inputs as its ``lightgbm_tpu`` counterpart; the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do.  On the CPU the port's wrappers take their plain PyTorch
versions, which are what the CUDA kernels are held against on the card
(tests/test_torch_gpu.py and ``chip_smoke.py``).

Tolerances: quantized histograms, quantization, the row update, trial
channels, the split scan and the f32 ``exp`` are integer or same-order
f32 arithmetic and must match bit for bit.  The exact (f32) histograms
differ by design: the reference carries g*mask as bf16 hi+lo pairs (good
to about 2^-16 relative per weight), the port as 64-bit fixed point, so
the leaf-channel form is held to rtol=1e-4 with an absolute floor of 1e-5
of the largest sum, as is the single-leaf form; counts are exact.  The
single-leaf form is also held to a float64 sum of the same rows within
rtol=1e-6 (its fixed point keeps ~2^-37 of the largest weight).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.learner.wave import make_wave_grow_fn as jax_grow_fn
from lightgbm_tpu.ops import histogram_pallas as hp
from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.learner.wave import make_wave_grow_fn
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops.fmath import exp_f32, sigmoid_f32
from lightgbm_tpu_torch.ops import split as ts

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

F = 6
N = 8192


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _bins(rng, b):
    return rng.randint(0, b, (F, N)).astype(np.uint8)


def _grad_hess_mask(rng):
    grad = (rng.randn(N) * 0.5).astype(np.float32)
    hess = (rng.rand(N) * 0.25 + 0.01).astype(np.float32)
    mask = (rng.rand(N) < 0.8).astype(np.float32)
    return grad, hess, mask


def _scales(grad, hess, mask, gq=127, hq=127):
    gm = np.abs(grad * mask).max()
    hm = (hess * mask).max()
    return (np.float32(max(gm, np.float32(1e-30)) / np.float32(gq)),
            np.float32(max(hm, np.float32(1e-30)) / np.float32(hq)))


@pytest.mark.parametrize("levels", [4, 254])
def test_quantize_wch_bitwise(levels):
    rng = np.random.RandomState(1)
    grad, hess, mask = _grad_hess_mask(rng)
    gq, hq = jq.quant_levels(levels)
    assert tq.quant_levels(levels) == (gq, hq)
    gs, hs = _scales(grad, hess, mask, gq, hq)
    ref = jq.quantize_wch(jnp.asarray(grad), jnp.asarray(hess),
                          jnp.asarray(mask), jnp.float32(gs), jnp.float32(hs),
                          None, gq_max=gq, hq_max=hq, stochastic=False)
    got = tq.quantize_wch(_t(grad), _t(hess), _t(mask), torch.tensor(gs),
                          torch.tensor(hs), gq_max=gq, hq_max=hq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_quantize_stochastic_raises():
    """Stochastic rounding is ported (tests/test_torch_objectives.py);
    without the tree's threefry key it refuses instead of rounding."""
    z = torch.zeros(8)
    with pytest.raises(ValueError, match="threefry"):
        tq.quantize_wch(z, z, z, torch.tensor(1.0), torch.tensor(1.0),
                        gq_max=1, hq_max=1, stochastic=True)


@pytest.mark.parametrize("num_bins,bin_hi", [(17, 17), (64, 64), (256, 256),
                                              (17, 24)])
def test_hist_leaves_q8_bitwise(num_bins, bin_hi):
    """bin_hi > num_bins: bin codes past the histogram are ignored, as
    the reference's one-hot ignores them."""
    rng = np.random.RandomState(2)
    bins = _bins(rng, bin_hi)
    grad, hess, mask = _grad_hess_mask(rng)
    gs, hs = _scales(grad, hess, mask)
    wch = np.asarray(jq.quantize_wch(
        jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(mask),
        jnp.float32(gs), jnp.float32(hs), None, gq_max=127, hq_max=127,
        stochastic=False))
    ch = rng.randint(-1, hc.Q_LEAF_CHANNELS, N).astype(np.int8)
    ref = hp.build_histogram_pallas_leaves_q8(
        jnp.asarray(bins), jnp.asarray(wch), jnp.asarray(ch),
        num_bins=num_bins, interpret=True)
    got = hc.build_histogram_leaves_q8(_t(bins), _t(wch), _t(ch),
                                       num_bins=num_bins)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("num_bins", [17, 64])
def test_hist_leaves_f32_within_tolerance(num_bins):
    rng = np.random.RandomState(3)
    bins = _bins(rng, num_bins)
    grad, hess, mask = _grad_hess_mask(rng)
    ch = rng.randint(-1, hc.LEAF_CHANNELS, N).astype(np.int8)
    ref = np.asarray(hp.build_histogram_pallas_leaves(
        jnp.asarray(bins), hp.pack_weights8(jnp.asarray(grad),
                                            jnp.asarray(hess),
                                            jnp.asarray(mask)),
        jnp.asarray(ch), num_bins=num_bins, interpret=True))
    w = th.pack_weights(_t(grad), _t(hess), _t(mask))
    got = hc.build_histogram_leaves(_t(bins), w, _t(ch),
                                    num_bins=num_bins).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    for c in (0, 1):
        np.testing.assert_allclose(
            got[..., c], ref[..., c], rtol=1e-4,
            atol=1e-5 * np.abs(ref[..., c]).max())


def test_hist_leaves_f32_is_order_free():
    """Fixed-point sums do not depend on the order rows are added in:
    permuting the rows gives the same bits (the property that makes the
    CUDA kernel deterministic from run to run)."""
    rng = np.random.RandomState(4)
    bins = _bins(rng, 64)
    grad, hess, mask = _grad_hess_mask(rng)
    ch = rng.randint(-1, hc.LEAF_CHANNELS, N).astype(np.int8)
    perm = rng.permutation(N)
    a = hc.build_histogram_leaves(_t(bins), th.pack_weights(
        _t(grad), _t(hess), _t(mask)), _t(ch), num_bins=64)
    b = hc.build_histogram_leaves(
        _t(bins[:, perm]), th.pack_weights(_t(grad[perm]), _t(hess[perm]),
                                           _t(mask[perm])),
        _t(ch[perm]), num_bins=64)
    assert torch.equal(a, b)


@pytest.mark.parametrize("layout,num_bins,n_real", [
    ("feature_major", 256, N),
    ("row_major_segment", 64, N // 2),   # P[s:e, :F].T, two strides
    ("ragged", 17, N - 301),             # B=17, rows not a 4096 multiple
])
def test_build_histogram_matches_pallas(layout, num_bins, n_real):
    """The plain single-leaf histogram (what the CUDA kernel is held to on
    the card) against ``build_histogram_pallas`` in interpret mode.  The
    reference needs N padded to its row block; the extra rows carry mask
    0, and the port gets the real rows only."""
    rng = np.random.RandomState(20)
    grad, hess, mask = _grad_hess_mask(rng)
    if layout == "row_major_segment":
        P = rng.randint(0, num_bins, (2 * N, F + 7)).astype(np.uint8)
        s0 = 1000
        seg = _t(P)[s0:s0 + n_real, :F].t()           # strided view
        assert seg.stride() == (1, F + 7)
        bins_ref = np.ascontiguousarray(P[s0:s0 + n_real, :F].T)
        bins_ref = np.pad(bins_ref, ((0, 0), (0, N - n_real)))
        args = (seg,)
    else:
        bins_ref = _bins(rng, num_bins)
        args = (_t(bins_ref[:, :n_real]),)
    mask[n_real:] = 0.0
    ref = np.asarray(hp.build_histogram_pallas(
        jnp.asarray(bins_ref), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(mask), num_bins=num_bins, interpret=True))
    w = [_t(v[:n_real]) for v in (grad, hess, mask)]
    got = th.build_histogram(*args, *w, num_bins=num_bins).numpy()
    assert got.shape == ref.shape == (F, num_bins, 3)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    for c in (0, 1):
        np.testing.assert_allclose(
            got[..., c], ref[..., c], rtol=1e-5,
            atol=1e-5 * np.abs(ref[..., c]).max())
    exact = np.zeros((F, num_bins, 3))
    b64 = bins_ref[:, :n_real].astype(np.int64)
    w64 = np.stack([grad * mask, hess * mask, mask], -1)[:n_real]
    for j in range(F):
        np.add.at(exact[j], b64[j], w64.astype(np.float64))
    np.testing.assert_allclose(got, exact, rtol=1e-6, atol=1e-6)
    # the wrapper takes the same plain path for CPU tensors
    assert np.array_equal(
        hc.build_histogram(*args, *w, num_bins=num_bins).numpy(), got)


def test_hist_single_is_order_free_and_subtracts_exactly():
    """Fixed-point sums: permuting rows gives the same bits, and a parent
    minus one child's histogram is the other child's, bit for bit (the
    partitioned grower's subtraction trick)."""
    rng = np.random.RandomState(21)
    bins = _bins(rng, 64)
    grad, hess, mask = _grad_hess_mask(rng)
    w = th.pack_weights(_t(grad), _t(hess), _t(mask))
    perm = torch.from_numpy(rng.permutation(N))
    full = hc.hist_single(_t(bins), w, num_bins=64)
    shuf = hc.hist_single(_t(bins)[:, perm],
                          th.FxWeights(w.w[:, perm], w.inv_scale),
                          num_bins=64)
    assert full.dtype == torch.int64 and torch.equal(full, shuf)
    k = 3000
    left = hc.hist_single(_t(bins)[:, :k],
                          th.FxWeights(w.w[:, :k], w.inv_scale), num_bins=64)
    right = hc.hist_single(_t(bins)[:, k:],
                           th.FxWeights(w.w[:, k:], w.inv_scale),
                           num_bins=64)
    assert torch.equal(full - left, right)


def test_exp_matches_xla_bitwise():
    """The port's f32 exp against ``jax.jit(jnp.exp)`` on every 251st f32
    bit pattern of [-90, 90] (both signs), plus the special values."""
    top = int(np.array([90.0], np.float32).view(np.int32)[0])
    pats = np.arange(0, top, 251, dtype=np.int64)
    bits = np.concatenate([pats, pats | (1 << 31)]).astype(np.uint32)
    x = np.concatenate([bits.view(np.float32),
                        np.array([np.inf, -np.inf, 0.0, -0.0, 88.8, -87.4,
                                  -103.0], np.float32)])
    ref = np.asarray(jax.jit(jnp.exp)(jnp.asarray(x)))
    np.testing.assert_array_equal(exp_f32(_t(x)).numpy(), ref)
    np.testing.assert_array_equal(
        sigmoid_f32(_t(x[:4096])).numpy(),
        np.asarray(1.0 / (1.0 + jnp.exp(-jnp.asarray(x[:4096])))))


def _row_update_case(rng, w, num_leaves=60):
    cols = rng.randint(0, 64, (w, N)).astype(np.uint8)
    rl = rng.randint(0, num_leaves, N).astype(np.int32)
    leaves = rng.choice(num_leaves, w, replace=False).astype(np.int32)
    tab = np.stack([
        rng.randint(0, 64, w), np.where(rng.rand(w) < 0.5, 63, -1),
        rng.randint(0, 2, w), rng.randint(0, 2, w), leaves,
        num_leaves + np.arange(w), (rng.rand(w) < 0.8).astype(int),
        np.zeros(w, int)]).astype(np.int32)
    return cols, rl, tab


@pytest.mark.parametrize("w", [1, 25, 42])
def test_wave_row_update_bitwise(w):
    rng = np.random.RandomState(5 + w)
    cols, rl, tab = _row_update_case(rng, w)
    # a later split catches rows an earlier one moved (parents precede
    # children in the endgame's pending flush)
    if w > 1:
        tab[4, 1] = tab[5, 0]
    rl_r, ch_r = hp.wave_row_update_pallas(jnp.asarray(cols), jnp.asarray(rl),
                                           jnp.asarray(tab), interpret=True)
    rl_t, ch_t = hc.wave_row_update(_t(cols), _t(rl), _t(tab))
    np.testing.assert_array_equal(rl_t.numpy(), np.asarray(rl_r))
    np.testing.assert_array_equal(ch_t.numpy(), np.asarray(ch_r))


def test_wave_trial_channels_bitwise():
    rng = np.random.RandomState(9)
    cols, rl, tab = _row_update_case(rng, 25)
    args = (tab[4], tab[0], tab[1], tab[2].astype(bool),
            tab[3].astype(bool), tab[6].astype(bool))
    ref = hp.wave_trial_channels_pallas(
        jnp.asarray(cols), jnp.asarray(rl), *map(jnp.asarray, args),
        interpret=True)
    got = hc.wave_trial_channels(_t(cols), _t(rl), *map(_t, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_wrappers_check_arguments():
    bins = torch.zeros((F, N), dtype=torch.uint8)
    ch = torch.zeros(N, dtype=torch.int8)
    with pytest.raises(TypeError):
        hc.build_histogram_leaves_q8(bins, torch.zeros((8, N)), ch,
                                     num_bins=16)
    with pytest.raises(ValueError):
        hc.build_histogram_leaves_q8(bins, torch.zeros((8, N - 1),
                                                       dtype=torch.int8),
                                     ch, num_bins=16)
    with pytest.raises(ValueError):
        hc.wave_row_update(torch.zeros((2, N), dtype=torch.uint8)[:, ::2],
                           torch.zeros(N // 2, dtype=torch.int32),
                           torch.zeros((8, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="current CUDA device"):
        hc.wave_row_update(torch.zeros((2, N), dtype=torch.uint8,
                                       device="meta"),
                           torch.zeros(N, dtype=torch.int32, device="meta"),
                           torch.zeros((8, 2), dtype=torch.int32,
                                       device="meta"))


@pytest.mark.parametrize("num_bins", [5, 17, 64, 255])
def test_cumsum_bins_matches_xla_order(num_bins):
    rng = np.random.RandomState(10)
    x = (rng.randn(3, F, num_bins) * rng.rand(3, F, num_bins) * 1e3
         ).astype(np.float32)
    ref = np.asarray(jnp.cumsum(jnp.asarray(x), axis=-1))
    np.testing.assert_array_equal(ts.cumsum_bins(_t(x)).numpy(), ref)


@pytest.mark.parametrize("l1,l2,mds", [(0.0, 0.0, 0.0), (0.5, 2.0, 0.7)])
def test_split_scan_bitwise(l1, l2, mds):
    """Same f32 histograms -> same gains, thresholds, directions and child
    sums as the reference scan (dequantized integer sums, as the quantized
    grower feeds it)."""
    rng = np.random.RandomState(11)
    b = 32
    counts = rng.poisson(20, (F, b)).astype(np.int32)
    gq = rng.randint(-300, 300, (F, b)).astype(np.int32)
    hq = (counts * rng.randint(1, 5, (F, b))).astype(np.int32)
    scale = np.array([0.0123, 0.0071, 1.0], np.float32)
    hist = np.stack([gq, hq, counts], -1).astype(np.float32) * scale
    has_nan = np.array([True, False, True, False, False, True])
    num_bins = np.array([b, b, 20, 9, b, 2], np.int32)
    # every feature's real bins sum to the leaf total
    parent = hist[0].sum(axis=0)
    sp_ref = js.SplitParams(lambda_l1=l1, lambda_l2=l2, max_delta_step=mds,
                            min_data_in_leaf=10, any_cat=False)
    sp = ts.SplitParams(**sp_ref._asdict())
    ref = js.best_split_per_feature(
        jnp.asarray(hist), jnp.asarray(parent), jnp.asarray(num_bins),
        jnp.zeros(F, bool), jnp.asarray(has_nan), sp_ref)
    got = ts.best_split_per_feature(_t(hist), _t(parent), _t(num_bins),
                                    _t(has_nan), sp)
    for name in ("gain", "threshold_bin", "default_left", "left_sum",
                 "right_sum"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(
        ts.leaf_output(_t(parent[:1]), _t(parent[1:2]), sp).numpy(),
        np.asarray(js.leaf_output(jnp.asarray(parent[:1]),
                                  jnp.asarray(parent[1:2]), sp_ref)))


def test_split_scan_runs_every_lifted_option():
    """The scan carries every split option the reference's scan does (the
    refusals are gone): a constraint against the split drops it, the
    bounds clamp the outputs, smoothing and CEGB move the gains, and
    ``feature_contri`` scales them (bitwise the reference's in
    tests/test_torch_options.py)."""
    rng = np.random.RandomState(3)
    counts = rng.poisson(30, (F, 16)).astype(np.float32)
    g = np.cumsum(np.ones((F, 16)), axis=1) - 8.0      # rises with the bin
    hist = _t(np.stack([g, counts, counts], -1).astype(np.float32))
    parent = hist[0].sum(dim=0)
    nb = _t(np.full(F, 16, np.int32))
    hn = _t(np.zeros(F, bool))
    base = ts.SplitParams(min_data_in_leaf=5, any_cat=False)
    plain = ts.best_split_per_feature(hist, parent, nb, hn, base)
    assert bool((plain.gain > 0).all())
    wide = _t(np.array([-1e30, 1e30], np.float32))
    # g rises with the bin: the left output exceeds the right, so an
    # increasing constraint drops every split and a decreasing one keeps
    # them, with the same gains inside unbounded limits
    for sign, kept in ((1, False), (-1, True)):
        mc = ts.best_split_per_feature(
            hist, parent, nb, hn, base._replace(use_monotone=True),
            monotone=_t(np.full(F, sign, np.int32)), bound=wide,
            depth=_t(np.int32(0)))
        assert bool((mc.gain > 0).all()) == kept
    narrow = ts.best_split_per_feature(
        hist, parent, nb, hn, base._replace(use_monotone=True),
        monotone=_t(np.zeros(F, np.int32)),
        bound=_t(np.array([-0.01, 0.01], np.float32)),
        depth=_t(np.int32(0)))
    assert bool((narrow.gain < plain.gain).all())
    smooth = ts.best_split_per_feature(
        hist, parent, nb, hn, base._replace(path_smooth=50.0),
        parent_out=_t(np.float32(0.0)))
    assert bool((smooth.gain < plain.gain).all())
    pen = _t(np.arange(F, dtype=np.float32))
    cegb = ts.best_split_per_feature(
        hist, parent, nb, hn,
        base._replace(use_cegb=True, cegb_penalty_split=0.01),
        cegb_penalty=pen)
    torch.testing.assert_close(cegb.gain,
                               plain.gain - parent[2] * 0.01 - pen)
    scale = _t(np.linspace(0.5, 1.0, F).astype(np.float32))
    contri = ts.best_split_per_feature(hist, parent, nb, hn, base,
                                       gain_scale=scale)
    torch.testing.assert_close(contri.gain, plain.gain * scale)


def _grow_inputs(seed=12, nb=64):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, nb - 1, (F, N)).astype(np.uint8)
    logit = (bins[0].astype(np.float32) / nb - 0.5) * 3 + \
        ((bins[1] > 40).astype(np.float32) - 0.5) * 2 + \
        (bins[2].astype(np.float32) / nb) * (bins[3] > 20)
    y = (logit + rng.randn(N) * 0.7 > 0).astype(np.float32)
    grad = (0.5 - y).astype(np.float32)
    hess = np.full(N, 0.25, np.float32)
    mask = np.ones(N, np.float32)
    mask[6000:] = 0.0
    return bins, grad, hess, mask


@pytest.mark.parametrize("quantized,wave,leaves", [
    (True, 0, 15),       # whole tree in the exact endgame
    (True, 4, 15),       # speculative ramp + waves + endgame
    (False, 4, 15),
    (True, 2, 9),        # plain waves before the endgame
])
def test_wave_tree_matches_jax_grower(quantized, wave, leaves):
    bins, grad, hess, mask = _grow_inputs()
    nb = 64
    sp_ref = js.SplitParams(min_data_in_leaf=5, min_sum_hessian_in_leaf=0.0,
                            any_cat=False)
    ref_grow = jax_grow_fn(
        num_leaves=leaves, num_features=F, max_bins=nb, max_depth=0,
        split_params=sp_ref, hist_impl="pallas", any_cat=False,
        interpret=True, jit=False, wave_size=wave, quantized=quantized,
        stochastic=False, spec_ramp=True, exact_endgame=True)
    ref = ref_grow(jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess),
                   jnp.asarray(mask), jnp.full((F,), nb, jnp.int32),
                   jnp.zeros((F,), bool), jnp.zeros((F,), bool),
                   jnp.zeros((F,), jnp.int32), jnp.zeros((F,), jnp.float32),
                   (), jnp.ones((F,), bool))
    grow = make_wave_grow_fn(
        num_leaves=leaves, num_features=F, max_bins=nb, max_depth=0,
        split_params=ts.SplitParams(**sp_ref._asdict()), wave_size=wave,
        quantized=quantized, spec_ramp=True, exact_endgame=True)
    got = grow(_t(bins), _t(grad), _t(hess), _t(mask),
               torch.full((F,), nb, dtype=torch.int32),
               torch.zeros(F, dtype=torch.bool),
               torch.ones(F, dtype=torch.bool))
    assert got.num_leaves == int(ref.num_leaves)
    assert got.hist_passes == int(ref.hist_passes)
    for name in ("split_feature", "threshold_bin", "nan_bin",
                 "decision_type", "left_child", "right_child", "row_leaf",
                 "leaf_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    tol = 0 if quantized else 1e-5
    for name in ("leaf_value", "leaf_weight", "internal_value",
                 "split_gain"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=tol, atol=tol, err_msg=name)
