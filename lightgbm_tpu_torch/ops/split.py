"""Vectorized split finding over histogram bins, numeric features.

Port of ``lightgbm_tpu/ops/split.py`` (reference:
src/treelearner/feature_histogram.hpp ``FindBestThresholdSequentially``):
the per-bin threshold loop becomes a cumulative sum over the bin axis,
all features (and all candidate leaves of a wave) at once; the
missing-direction double scan becomes two masked gain tensors.

Covered: l1/l2, min_data_in_leaf / min_sum_hessian_in_leaf,
min_gain_to_split, max_delta_step, NaN bins with default_left, and the
lowest-feature (then lowest-bin) tie-break of the reference's argmax.
Categorical splits, monotone constraints, path smoothing, CEGB,
extra-trees and feature_contri raise ``NotImplementedError``.

Bitwise parity.  Every gain is computed with the reference's f32
operations in the reference's order, and the bin-axis cumulative sum
reproduces XLA:CPU's summation order (:func:`cumsum_bins`), so on the
same f32 histograms the port picks the same splits and the same sums as
the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["SplitParams", "FeatureSplits", "best_split_per_feature",
           "leaf_output", "leaf_gain", "cumsum_bins", "BIG", "NEG_INF",
           "local_best_candidates", "check_supported"]

NEG_INF = -1e30
BIG = 1e30  # "unbounded" leaf-output constraint sentinel


class SplitParams(NamedTuple):
    """Static split-finding hyperparameters (field-for-field the
    reference's ``SplitParams``, so configurations carry over)."""
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    max_delta_step: float = 0.0
    cat_l2: float = 10.0
    cat_smooth: float = 10.0
    path_smooth: float = 0.0
    use_monotone: bool = False
    monotone_penalty: float = 0.0
    max_cat_to_onehot: int = 4
    max_cat_threshold: int = 32
    min_data_per_group: int = 100
    use_cat_subset: bool = False
    cat_idx: tuple = ()
    use_cegb: bool = False
    cegb_tradeoff: float = 1.0
    cegb_penalty_split: float = 0.0
    feature_fraction_bynode: float = 1.0
    extra_trees: bool = False
    any_cat: bool = True


def check_supported(params: SplitParams) -> None:
    """Raise for split features this slice of the port does not carry."""
    unported = [
        ("categorical features", params.any_cat),
        ("monotone_constraints", params.use_monotone),
        ("path_smooth", params.path_smooth > 0.0),
        ("cost-effective gradient boosting (cegb_*)", params.use_cegb),
        ("extra_trees", params.extra_trees),
        ("feature_fraction_bynode", params.feature_fraction_bynode < 1.0),
    ]
    for what, on in unported:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to lightgbm_tpu_torch yet "
                "(ROADMAP queue 1, items 4-5 and 7)")


class FeatureSplits(NamedTuple):
    """Per-feature best split (the vectorized SplitInfo); every field has
    the leading batch shape of the histograms it came from."""
    gain: torch.Tensor           # (..., F) NEG_INF when invalid
    threshold_bin: torch.Tensor  # (..., F) int32
    default_left: torch.Tensor   # (..., F) bool
    left_sum: torch.Tensor       # (..., F, 3)
    right_sum: torch.Tensor      # (..., F, 3)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _threshold_l1(g: torch.Tensor, l1: float) -> torch.Tensor:
    return torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)


def leaf_gain(g: torch.Tensor, h: torch.Tensor, l1: float,
              l2: float) -> torch.Tensor:
    """ThresholdL1(G)^2 / (H + l2), 0 where H + l2 <= 0."""
    t = _threshold_l1(g, l1)
    d = h + l2
    return torch.where(d > 0, t * t / d, _f32(0.0, g))


def leaf_output(g: torch.Tensor, h: torch.Tensor,
                params: SplitParams) -> torch.Tensor:
    """Closed-form leaf value (feature_histogram.hpp
    ``CalculateSplittedLeafOutput``)."""
    t = _threshold_l1(g, params.lambda_l1)
    d = h + params.lambda_l2
    out = torch.where(d > 0, -t / d, _f32(0.0, g))
    if params.max_delta_step > 0.0:
        out = torch.clamp(out, -params.max_delta_step, params.max_delta_step)
    return out


_XLA_SCAN_BLOCK = 16


def cumsum_bins(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumulative sum over the last axis, in XLA:CPU's order.

    ``jnp.cumsum`` lowers to a reduce-window that XLA rewrites into blocks
    of 16: a sequential sum inside each block, plus the sequential
    exclusive sum of the block totals.  Summing in exactly that order makes
    the port's prefix sums, and so its gains and child sums, equal the
    reference's bit for bit (``torch.cumsum`` accumulates in another order,
    and on the CPU in float64)."""
    *lead, b = x.shape
    nb = -(-b // _XLA_SCAN_BLOCK)
    pad = nb * _XLA_SCAN_BLOCK - b
    if pad:
        x = torch.cat([x, x.new_zeros((*lead, pad))], dim=-1)
    xb = x.reshape(*lead, nb, _XLA_SCAN_BLOCK)
    inner = torch.empty_like(xb)
    acc = xb[..., 0]
    inner[..., 0] = acc
    for i in range(1, _XLA_SCAN_BLOCK):
        acc = acc + xb[..., i]
        inner[..., i] = acc
    carry = torch.empty_like(inner[..., -1])
    run = torch.zeros_like(carry[..., 0])
    for i in range(nb):
        carry[..., i] = run
        run = run + inner[..., i, -1]
    out = (inner + carry.unsqueeze(-1)).reshape(*lead, nb * _XLA_SCAN_BLOCK)
    return out[..., :b]


def _at_bin(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., F) gather of one bin per feature from an (..., F, B) plane."""
    return torch.gather(a, -1, idx.unsqueeze(-1)).squeeze(-1)


def best_split_per_feature(hist: torch.Tensor, parent_sum: torch.Tensor,
                           num_bins: torch.Tensor, has_nan: torch.Tensor,
                           params: SplitParams) -> FeatureSplits:
    """Best numeric split per feature for a batch of leaves.

    Args:
      hist: (..., F, B, 3) float32 (grad, hess, count) histograms.
      parent_sum: (..., 3) leaf totals.
      num_bins: (F,) int32 bins per feature, including the trailing NaN
        bin when has_nan.
      has_nan: (F,) bool.
    """
    b = hist.shape[-2]
    dev = hist.device
    l1, l2 = params.lambda_l1, params.lambda_l2
    min_h = params.min_sum_hessian_in_leaf
    min_cnt = float(params.min_data_in_leaf)
    neg_inf = _f32(NEG_INF, hist)
    zero = _f32(0.0, hist)

    ps = parent_sum.unsqueeze(-2)                                # (..., 1, 3)
    parent_gain = leaf_gain(ps[..., 0], ps[..., 1], l1, l2)      # (..., 1)
    min_gain_shift = parent_gain + params.min_gain_to_split

    bins_r = torch.arange(b, dtype=torch.int32, device=dev).unsqueeze(0)
    nan_bin = (num_bins - 1).to(torch.int32).unsqueeze(1)        # (F, 1)
    hn_f = has_nan.unsqueeze(1)                                  # (F, 1)
    real_bin = torch.where(hn_f, bins_r < nan_bin,
                           bins_r < num_bins.unsqueeze(1))
    thr_valid = torch.where(hn_f, bins_r < nan_bin,
                            bins_r < num_bins.unsqueeze(1) - 1)

    hg, hh, hc = hist[..., 0], hist[..., 1], hist[..., 2]       # (..., F, B)
    hg_m = torch.where(real_bin, hg, zero)
    hh_m = torch.where(real_bin, hh, zero)
    hc_m = torch.where(real_bin, hc, zero)

    nan_idx = nan_bin.long().clamp(min=0).expand(hg.shape[:-1] + (1,))
    nan_g = torch.where(hn_f, torch.gather(hg, -1, nan_idx), zero)
    nan_h = torch.where(hn_f, torch.gather(hh, -1, nan_idx), zero)
    nan_c = torch.where(hn_f, torch.gather(hc, -1, nan_idx), zero)

    cum_g = cumsum_bins(hg_m)
    cum_h = cumsum_bins(hh_m)
    cum_c = cumsum_bins(hc_m)
    tot_g, tot_h, tot_c = ps[..., 0:1], ps[..., 1:2], ps[..., 2:3]

    def dir_gain(lg, lh, lc):
        rg, rh, rc = tot_g - lg, tot_h - lh, tot_c - lc
        ok = ((lc >= min_cnt) & (rc >= min_cnt) &
              (lh >= min_h) & (rh >= min_h) & thr_valid)
        gl = leaf_gain(lg, lh, l1, l2)
        gr = leaf_gain(rg, rh, l1, l2)
        g = gl + gr - min_gain_shift.unsqueeze(-1)
        return torch.where(ok & (g > 0), g, neg_inf)

    # numerical, missing->right (left = cum of real bins up to b)
    gain_r = dir_gain(cum_g, cum_h, cum_c)
    # numerical, missing->left (NaN bin joins the left side)
    gain_l = dir_gain(cum_g + nan_g, cum_h + nan_h, cum_c + nan_c)
    gain_l = torch.where(hn_f, gain_l, neg_inf)

    # argmax returns the first maximal index, as jnp.argmax does
    best_r_bin = torch.argmax(gain_r, dim=-1)
    best_r_gain = _at_bin(gain_r, best_r_bin)
    best_l_bin = torch.argmax(gain_l, dim=-1)
    best_l_gain = _at_bin(gain_l, best_l_bin)

    use_left = best_l_gain > best_r_gain
    gain = torch.where(use_left, best_l_gain, best_r_gain)
    pick = torch.where(use_left, best_l_bin, best_r_bin)
    left = torch.stack([_at_bin(cum_g, pick), _at_bin(cum_h, pick),
                        _at_bin(cum_c, pick)], dim=-1)
    nan3 = torch.cat([nan_g, nan_h, nan_c], dim=-1)              # (..., F, 3)
    left = left + torch.where(use_left.unsqueeze(-1), nan3, zero)
    right = parent_sum.unsqueeze(-2) - left
    return FeatureSplits(gain=gain, threshold_bin=pick.to(torch.int32),
                         default_left=use_left & has_nan,
                         left_sum=left, right_sum=right)


def local_best_candidates(hist: torch.Tensor, leaf_sum: torch.Tensor,
                          num_bins: torch.Tensor, has_nan: torch.Tensor,
                          feature_mask: torch.Tensor, params: SplitParams):
    """Best split over features for a batch of leaves (the reference's
    ``local_best_candidate`` vmapped): (gain, feat, bin, default_left,
    left_sum, right_sum), each with the batch shape of ``leaf_sum[..., 0]``.
    The lowest feature wins ties."""
    fs = best_split_per_feature(hist, leaf_sum, num_bins, has_nan, params)
    gain = torch.where(feature_mask, fs.gain, _f32(NEG_INF, hist))
    f = torch.argmax(gain, dim=-1)
    fi = f.unsqueeze(-1)
    fi3 = fi.unsqueeze(-1).expand(*f.shape, 1, 3)
    return (torch.gather(gain, -1, fi).squeeze(-1), f.to(torch.int32),
            torch.gather(fs.threshold_bin, -1, fi).squeeze(-1),
            torch.gather(fs.default_left, -1, fi).squeeze(-1),
            torch.gather(fs.left_sum, -2, fi3).squeeze(-2),
            torch.gather(fs.right_sum, -2, fi3).squeeze(-2))
