"""The PyTorch port's kernel modules held against the JAX package.

Each module of ``lightgbm_tpu_torch`` that holds a kernel (or feeds one)
gets the same seeded numpy inputs as its ``lightgbm_tpu`` counterpart; the
JAX side runs its Pallas kernels in interpret mode, as the JAX package's
own tests do.  On the CPU the port's wrappers take their plain PyTorch
versions, which are what the CUDA kernels are held against on the card
(tests/test_torch_gpu.py and ``chip_smoke.py``).

Tolerances: quantized histograms, quantization, the row update, trial
channels and the split scan are integer or same-order f32 arithmetic and
must match bit for bit.  The exact (f32) histogram differs by design: the
reference carries g*mask as bf16 hi+lo pairs (good to about 2^-16
relative per weight), the port as 64-bit fixed point, so it is held to
rtol=1e-4 with an absolute floor of 1e-5 of the largest sum; counts are
exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.learner.wave import make_wave_grow_fn as jax_grow_fn
from lightgbm_tpu.ops import histogram_pallas as hp
from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.learner.wave import make_wave_grow_fn
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import quantize as tq
from lightgbm_tpu_torch.ops import split as ts

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
    z = torch.zeros(8)
    with pytest.raises(NotImplementedError, match="threefry"):
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
    w = hc.pack_weights(_t(grad), _t(hess), _t(mask))
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
    a = hc.build_histogram_leaves(_t(bins), hc.pack_weights(
        _t(grad), _t(hess), _t(mask)), _t(ch), num_bins=64)
    b = hc.build_histogram_leaves(
        _t(bins[:, perm]), hc.pack_weights(_t(grad[perm]), _t(hess[perm]),
                                           _t(mask[perm])),
        _t(ch[perm]), num_bins=64)
    assert torch.equal(a, b)


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


def test_split_unported_options_raise():
    with pytest.raises(NotImplementedError, match="monotone"):
        ts.check_supported(ts.SplitParams(any_cat=False, use_monotone=True))
    with pytest.raises(NotImplementedError, match="categorical"):
        ts.check_supported(ts.SplitParams())


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
