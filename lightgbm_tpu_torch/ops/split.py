"""Vectorized split finding over histogram bins.

Port of ``lightgbm_tpu/ops/split.py`` (reference:
src/treelearner/feature_histogram.hpp ``FindBestThresholdSequentially``):
the per-bin threshold loop becomes a cumulative sum over the bin axis,
all features (and all candidate leaves of a wave) at once; the
missing-direction double scan becomes two masked gain tensors.

Covered: l1/l2, min_data_in_leaf / min_sum_hessian_in_leaf,
min_gain_to_split, max_delta_step, NaN bins with default_left, the
lowest-feature (then lowest-bin) tie-break of the reference's argmax, and
the two per-node random draws (reference split.py:73-74, :258-262, and
the growers' ``node_mask`` / ``node_rand``): by-node feature sampling
(:func:`node_feature_mask`) and the extra-trees threshold, one random
bin per feature per node (:func:`node_rand_bins`), and the categorical
search (reference split.py:331-470, feature_histogram.hpp
``FindBestThresholdCategoricalInner``): one-vs-rest for features of at
most ``max_cat_to_onehot`` bins, the sorted-subset search above it, with
each feature's LEFT-side bins returned as ``cat_member``; and the
split options (reference split.py:126-163, :233-330, :503-515): path
smoothing (:func:`leaf_output_smoothed`), monotone constraints (outputs
clamped to the leaf's bounds, splits against the constraint dropped,
``monotone_penalty`` by depth), the CEGB split and per-feature penalties
and ``feature_contri``'s gain scale.

Bitwise parity.  Every gain is computed with the reference's f32
operations in the reference's order, and the bin-axis cumulative sum
reproduces XLA:CPU's summation order (:func:`cumsum_bins`), so on the
same f32 histograms the port picks the same splits and the same sums as
the JAX package.  Where the reference's scan multiplies and adds in one
fused loop, XLA:CPU contracts the pair into one fused multiply-add (the
smoothing blend, the gain of a given output); the port rounds those
pairs once too (ops/fmath.py ``_fma``).  Which product of a sum of two
is fused follows the operand order LLVM gives each fused loop: the port
takes the choice of the reference's root, wave and endgame scans; under
smoothing with forced splits or monotone bounds some of the reference's
loops take the other one (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import NamedTuple

import math

import torch

from ..utils.random import fold_in, uniform
from .fmath import _fma, exp_f32

__all__ = ["SplitParams", "FeatureSplits", "best_split_per_feature",
           "leaf_output", "leaf_output_smoothed", "leaf_gain",
           "monotone_penalty_factor", "cumsum_bins", "BIG", "NEG_INF",
           "local_best_candidates", "node_feature_mask", "node_rand_bins",
           "node_draws"]

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


def node_feature_mask(key: torch.Tensor, ids: torch.Tensor,
                      num_features: int, fraction: float) -> torch.Tensor:
    """(k, F) by-node feature samples of the nodes ``ids`` (ColSampler
    bynode, reference col_sampler.hpp): each node keeps its
    ceil(F * fraction) features of highest ``uniform(fold_in(key, id),
    (F,))``, ``key`` the by-node stream's key (utils/random.py).  All
    nodes in one draw."""
    kcnt = max(1, int(math.ceil(num_features * fraction)))
    r = uniform(fold_in(key, ids), (num_features,))
    kth = torch.topk(r, kcnt, dim=-1).values[..., -1:]
    return r >= kth


def node_rand_bins(key: torch.Tensor, ids: torch.Tensor,
                   num_bins: torch.Tensor) -> torch.Tensor:
    """(k, F) int32 extra-trees thresholds of the nodes ``ids`` (ExtraTrees,
    feature_histogram.hpp USE_RAND): ``min(int(u * (hi + 1)), hi)`` with
    ``hi = max(num_bins - 2, 0)`` (numeric features) and u from
    ``uniform(fold_in(key, id), (F,))``, ``key`` the extra-trees stream's
    key.  The float-to-int conversion truncates, as jax's does."""
    hi = torch.clamp(num_bins.to(torch.int32) - 2, min=0)
    u = uniform(fold_in(key, ids), (num_bins.shape[0],))
    return torch.minimum((u * (hi + 1).float()).to(torch.int32), hi)


def node_draws(node_key, ids: torch.Tensor, feature_mask: torch.Tensor,
               num_bins: torch.Tensor, params: SplitParams):
    """The split scan's per-node inputs of the nodes ``ids``: (k, F)
    feature masks (``feature_mask`` and, under by-node sampling, the
    node's sample) and (k, F) extra-trees bins or None.  ``node_key``
    holds the by-node stream's key ([0]) and the extra-trees stream's
    ([1]), reference models/gbdt.py:866-881."""
    fms = feature_mask.expand(ids.shape[0], num_bins.shape[0])
    if params.feature_fraction_bynode < 1.0:
        fms = fms & node_feature_mask(node_key[0], ids, num_bins.shape[0],
                                      params.feature_fraction_bynode)
    rb = node_rand_bins(node_key[1], ids, num_bins) \
        if params.extra_trees else None
    return fms, rb


class FeatureSplits(NamedTuple):
    """Per-feature best split (the vectorized SplitInfo); every field has
    the leading batch shape of the histograms it came from."""
    gain: torch.Tensor           # (..., F) NEG_INF when invalid
    threshold_bin: torch.Tensor  # (..., F) int32
    default_left: torch.Tensor   # (..., F) bool
    left_sum: torch.Tensor       # (..., F, 3)
    right_sum: torch.Tensor      # (..., F, 3)
    cat_member: torch.Tensor     # (..., F, B) bool: categorical LEFT bins


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    # a fill on the device: ``torch.tensor`` would copy from the host and
    # wait for the device's queue to drain on every call
    return torch.full((), x, dtype=torch.float32, device=like.device)


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


def leaf_output_smoothed(g: torch.Tensor, h: torch.Tensor, cnt: torch.Tensor,
                         parent_out, params: SplitParams) -> torch.Tensor:
    """Leaf value with path smoothing (feature_histogram.hpp
    ``CalculateSplittedLeafOutput`` USE_SMOOTHING): the raw output,
    clipped to ``max_delta_step`` first, shrinks toward the parent's
    output by ``path_smooth / (cnt + path_smooth)``."""
    out = leaf_output(g, h, params)
    if params.path_smooth > 0.0:
        f = cnt / (cnt + params.path_smooth)
        # out * f + parent * (1 - f): in the reference's growers XLA:CPU
        # fuses the first product into the add
        out = _fma(out, f, parent_out * (1.0 - f))
    return out


def _gain_given_output(g, h, out, l1: float, l2: float,
                       fused: str = "linear") -> torch.Tensor:
    """Objective improvement of a leaf held at ``out`` (feature_histogram
    .hpp ``GetLeafGainGivenOutput``): -(2 t out + (h + l2) out^2).
    XLA:CPU fuses one product into the add: the linear term's in the
    scan's per-bin loop, the square's in the per-leaf (parent) gain."""
    t = _threshold_l1(g, l1)
    if fused == "linear":
        return -_fma(2.0 * t, out, (h + l2) * out * out)
    return -_fma(out, (h + l2) * out, 2.0 * t * out)


def monotone_penalty_factor(depth: torch.Tensor,
                            penalty: float) -> torch.Tensor:
    """Gain multiplier of splits on monotone features at ``depth``
    (monotone_constraints.hpp ``ComputeMonotoneSplitGainPenalty``).
    ``jnp.exp2`` lowers to e^(x ln 2) with XLA:CPU's exp, which
    :func:`exp_f32` reproduces."""
    eps = 1e-15
    d = depth.float()
    ln2 = torch.full((), 0.693147182, dtype=torch.float32, device=d.device)

    def exp2(x):
        return exp_f32(ln2 * x)
    lo = 1.0 - penalty / exp2(d) + eps
    hi = 1.0 - exp2(penalty - 1.0 - d) + eps
    return torch.where(penalty >= d + 1.0, _f32(eps, d),
                       lo if penalty <= 1.0 else hi)


_XLA_SCAN_BLOCK = 16


def cumsum_bins(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumulative sum over the last axis, in XLA:CPU's order.

    ``jnp.cumsum`` lowers to a reduce-window that XLA rewrites into blocks
    of 16: a sequential sum inside each block, plus the exclusive sum of
    the block totals, itself a cumsum rewritten the same way when there
    are more than 16 blocks (B > 256: uint16 bins).  Summing in exactly
    that order makes the port's prefix sums, and so its gains and child
    sums, equal the reference's bit for bit (``torch.cumsum`` accumulates
    in another order, and on the CPU in float64)."""
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
    totals = inner[..., -1]
    if nb > _XLA_SCAN_BLOCK:
        inc = cumsum_bins(totals)
        carry = torch.cat([torch.zeros_like(inc[..., :1]), inc[..., :-1]],
                          dim=-1)
    else:
        carry = torch.empty_like(totals)
        run = torch.zeros_like(carry[..., 0])
        for i in range(nb):
            carry[..., i] = run
            run = run + totals[..., i]
    out = (inner + carry.unsqueeze(-1)).reshape(*lead, nb * _XLA_SCAN_BLOCK)
    return out[..., :b]


def _at_bin(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(..., F) gather of one bin per feature from an (..., F, B) plane."""
    return torch.gather(a, -1, idx.unsqueeze(-1)).squeeze(-1)


def best_split_per_feature(hist: torch.Tensor, parent_sum: torch.Tensor,
                           num_bins: torch.Tensor, has_nan: torch.Tensor,
                           params: SplitParams,
                           parent_exact: torch.Tensor = None,
                           rand_bins: torch.Tensor = None,
                           is_cat: torch.Tensor = None,
                           monotone: torch.Tensor = None,
                           bound: torch.Tensor = None,
                           depth: torch.Tensor = None,
                           cegb_penalty: torch.Tensor = None,
                           gain_scale: torch.Tensor = None,
                           parent_out: torch.Tensor = None,
                           nan_left_refused: bool = False,
                           nan_left_square: bool = False
                           ) -> FeatureSplits:
    """Best split per feature for a batch of leaves.

    Args:
      hist: (..., F, B, 3) float32 (grad, hess, count) histograms.
      parent_sum: (..., 3) leaf totals.
      num_bins: (F,) int32 bins per feature, including the trailing NaN
        bin when has_nan.
      has_nan: (F,) bool.
      parent_exact: optional (..., 3) float64 leaf totals before their
        rounding to f32: the returned right sums are then ``parent -
        left`` rounded ONCE, as a fused multiply-subtract rounds them.
        The quantized root pass passes its dequantized totals (int sum x
        scale, exact in float64): the reference's jitted grower fuses
        that multiply into the subtraction that yields the chosen split's
        right sums, and XLA:CPU contracts the pair into one fused
        multiply-add.  Its gains keep the rounded totals (there XLA
        shares the product with the parent gain and does not contract).
      rand_bins: optional (..., F) int32 extra-trees thresholds: each
        feature is scanned at that one bin only (:func:`node_rand_bins`).
      is_cat: optional (F,) bool, the categorical features (read when
        ``params.any_cat``): one-vs-rest at ``num_bins <=
        max_cat_to_onehot``, else the sorted-subset search over the
        features ``params.cat_idx`` (all F when empty).
      monotone, bound, depth: read under ``params.use_monotone``: the
        (F,) constraint directions, the leaves' (..., 2) output bounds
        (min, max) and (...,) depths (``monotone_penalty``).
      cegb_penalty: optional (F,) or (..., F) per-feature CEGB penalty,
        added to the split penalty under ``params.use_cegb``.
      gain_scale: optional (F,) ``feature_contri`` gain multipliers.
      parent_out: (...,) the leaves' own outputs, the smoothing target
        under ``params.path_smooth``.
      nan_left_refused: under path smoothing, the NaN-left gain of each
        feature's chosen bin is computed again with the parent's gain
        fused the other way round (its linear term's product), as the
        reference's forced waves do at some wave widths
        (:data:`FORCED_NAN_LEFT_REFUSED`): XLA:CPU recomputes that gain in
        a loop of its own there, and LLVM contracts the other product.
      nan_left_square: under path smoothing with monotone bounds, the
        NaN-left direction's child gains fuse their square term's
        product (``_gain_given_output`` ``fused="square"``), as the
        reference's wave children scans do at some wave widths
        (:data:`MONOTONE_SMOOTH_NAN_LEFT_SQUARE`).
    """
    b = hist.shape[-2]
    dev = hist.device
    l1, l2 = params.lambda_l1, params.lambda_l2
    min_h = params.min_sum_hessian_in_leaf
    min_cnt = float(params.min_data_in_leaf)
    neg_inf = _f32(NEG_INF, hist)
    zero = _f32(0.0, hist)

    ps = parent_sum.unsqueeze(-2)                                # (..., 1, 3)
    use_mc = params.use_monotone
    use_sm = params.path_smooth > 0.0
    if use_sm:
        # the leaf's own (smoothed) output is its children's smoothing
        # target and sets the gain shift (GetLeafGain USE_SMOOTHING)
        po = parent_out.unsqueeze(-1)                            # (..., 1)
        parent_gain = _gain_given_output(ps[..., 0], ps[..., 1], po, l1, l2,
                                         fused="square")
        po = po.unsqueeze(-1)                                    # (..., 1, 1)
    else:
        po = None
        parent_gain = leaf_gain(ps[..., 0], ps[..., 1], l1, l2)  # (..., 1)
    min_gain_shift = parent_gain + params.min_gain_to_split
    if use_mc:
        mn = bound[..., 0].unsqueeze(-1).unsqueeze(-1)           # (..., 1, 1)
        mx = bound[..., 1].unsqueeze(-1).unsqueeze(-1)
        mono = monotone.to(torch.int32)
        if is_cat is not None:
            mono = torch.where(is_cat, 0, mono)
        mono = mono.unsqueeze(-1)                                # (F, 1)
        pen = (monotone_penalty_factor(depth, params.monotone_penalty)
               .unsqueeze(-1).unsqueeze(-1)
               if params.monotone_penalty > 0.0 else None)
    pair_gain = _pair_gain_fn(params, po, mn if use_mc else None,
                              mx if use_mc else None)

    bins_r = torch.arange(b, dtype=torch.int32, device=dev).unsqueeze(0)
    nan_bin = (num_bins - 1).to(torch.int32).unsqueeze(1)        # (F, 1)
    hn_f = has_nan.unsqueeze(1)                                  # (F, 1)
    real_bin = torch.where(hn_f, bins_r < nan_bin,
                           bins_r < num_bins.unsqueeze(1))
    thr_valid = torch.where(hn_f, bins_r < nan_bin,
                            bins_r < num_bins.unsqueeze(1) - 1)
    if params.extra_trees and rand_bins is not None:
        thr_valid = thr_valid & (bins_r == rand_bins.unsqueeze(-1))

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

    def dir_gain(lg, lh, lc, blend_fused="parent", shift=None,
                 gain_fused="linear"):
        shift = min_gain_shift if shift is None else shift
        rg, rh, rc = tot_g - lg, tot_h - lh, tot_c - lc
        ok = ((lc >= min_cnt) & (rc >= min_cnt) &
              (lh >= min_h) & (rh >= min_h) & thr_valid)
        gl, gr, out_l, out_r = pair_gain(lg, lh, lc, rg, rh, rc, l2,
                                         blend_fused, gain_fused)
        if use_mc:
            # splits against the constraint are dropped (GetSplitGains
            # USE_MC)
            viol = (((mono > 0) & (out_l > out_r)) |
                    ((mono < 0) & (out_l < out_r)))
            ok = ok & ~viol
        g = gl + gr - shift.unsqueeze(-1)
        if use_mc and pen is not None:
            g = torch.where(mono != 0, g * pen, g)
        return torch.where(ok & (g > 0), g, neg_inf)

    # numerical, missing->right (left = cum of real bins up to b)
    gain_r = dir_gain(cum_g, cum_h, cum_c)
    # numerical, missing->left (NaN bin joins the left side)
    # XLA:CPU fuses this direction's smoothing blend the other way round
    left_fused = "square" if nan_left_square and use_sm and use_mc \
        else "linear"
    gain_l = dir_gain(cum_g + nan_g, cum_h + nan_h, cum_c + nan_c, "own",
                      gain_fused=left_fused)
    gain_l = torch.where(hn_f, gain_l, neg_inf)

    # argmax returns the first maximal index, as jnp.argmax does
    best_r_bin = torch.argmax(gain_r, dim=-1)
    best_r_gain = _at_bin(gain_r, best_r_bin)
    best_l_bin = torch.argmax(gain_l, dim=-1)
    if nan_left_refused and use_sm:
        shift = _gain_given_output(ps[..., 0], ps[..., 1], po.squeeze(-1),
                                   l1, l2, fused="linear") + \
            params.min_gain_to_split
        gain_l = torch.where(hn_f, dir_gain(cum_g + nan_g, cum_h + nan_h,
                                            cum_c + nan_c, "own", shift,
                                            left_fused),
                             neg_inf)
    best_l_gain = _at_bin(gain_l, best_l_bin)

    use_left = best_l_gain > best_r_gain
    gain = torch.where(use_left, best_l_gain, best_r_gain)
    pick = torch.where(use_left, best_l_bin, best_r_bin)
    thr = pick.to(torch.int32)
    left = torch.stack([_at_bin(cum_g, pick), _at_bin(cum_h, pick),
                        _at_bin(cum_c, pick)], dim=-1)
    nan3 = torch.cat([nan_g, nan_h, nan_c], dim=-1)              # (..., F, 3)
    left = left + torch.where(use_left.unsqueeze(-1), nan3, zero)
    default_left = use_left & has_nan
    if params.any_cat and is_cat is not None:
        cat_gain, cat_member, cat_left = _categorical(
            hg_m, hh_m, hc_m, real_bin, tot_g, tot_h, tot_c,
            min_gain_shift.unsqueeze(-1), num_bins, is_cat, params,
            rand_bins, bins_r, pair_gain)
        gain = torch.where(is_cat, cat_gain, gain)
        cat_member = cat_member & is_cat.unsqueeze(-1) & \
            (gain > NEG_INF / 2).unsqueeze(-1)
        # the first member bin stands as the threshold (display only: the
        # row decision reads the membership)
        cat_thr = torch.argmax(cat_member.to(torch.int8), dim=-1)
        thr = torch.where(is_cat, cat_thr.to(torch.int32), thr)
        left = torch.where(is_cat.unsqueeze(-1), cat_left, left)
        default_left = default_left & ~is_cat
    else:
        cat_member = torch.zeros(hg.shape, dtype=torch.bool, device=dev)
    gain = _penalize(gain, ps[..., 2], params, cegb_penalty, gain_scale)
    if parent_exact is None:
        right = parent_sum.unsqueeze(-2) - left
    else:
        right = (parent_exact.unsqueeze(-2) - left.double()).float()
    return FeatureSplits(gain=gain, threshold_bin=thr,
                         default_left=default_left, left_sum=left,
                         right_sum=right, cat_member=cat_member)


def _pair_gain_fn(params: SplitParams, po, mn, mx):
    """``pair_gain(lg, lh, lc, rg, rh, rc, l2, blend_fused, gain_fused)
    -> (gain_l, gain_r, out_l, out_r)`` of a split's two children
    (feature_histogram.hpp ``GetSplitGains``): the closed-form gains, or
    under path smoothing (target ``po``) or monotone bounds (``mn``,
    ``mx``) the gains of the outputs the children can take, clipped to
    ``max_delta_step`` before the blend and clamped to the bounds last
    (``out_*`` None without either option).  ``blend_fused`` names the
    product of the smoothing blend that XLA:CPU fuses into its add in
    that part of the reference's scan: the parent's ("parent") or the
    child's own ("own"); ``gain_fused`` the product of the children's
    gains (``_gain_given_output``'s ``fused``)."""
    l1 = params.lambda_l1
    use_sm = po is not None
    use_mc = mn is not None

    def child_out(sg, sh, sc, l2, blend_fused):
        t = _threshold_l1(sg, l1)
        d = sh + l2
        out = torch.where(d > 0, -t / d, _f32(0.0, sg))
        if params.max_delta_step > 0.0:
            out = torch.clamp(out, -params.max_delta_step,
                              params.max_delta_step)
        if use_sm:
            fac = sc / (sc + params.path_smooth)
            out = (_fma(po, 1.0 - fac, out * fac) if blend_fused == "parent"
                   else _fma(out, fac, po * (1.0 - fac)))
        return torch.minimum(torch.maximum(out, mn), mx) if use_mc else out

    def pair_gain(lg, lh, lc, rg, rh, rc, l2, blend_fused="parent",
                  gain_fused="linear"):
        if not (use_sm or use_mc):
            return leaf_gain(lg, lh, l1, l2), leaf_gain(rg, rh, l1, l2), \
                None, None
        out_l = child_out(lg, lh, lc, l2, blend_fused)
        out_r = child_out(rg, rh, rc, l2, blend_fused)
        return (_gain_given_output(lg, lh, out_l, l1, l2, gain_fused),
                _gain_given_output(rg, rh, out_r, l1, l2, gain_fused),
                out_l, out_r)
    return pair_gain


def _penalize(gain, cnt, params: SplitParams, cegb_penalty, gain_scale):
    """Each feature's best gain less the CEGB penalty, tradeoff x
    penalty_split x the leaf's count plus the feature's own, then scaled
    by ``feature_contri`` (reference split.py:503-515); invalid gains
    stay NEG_INF.  The count's product is per leaf, computed outside the
    per-feature loop, so XLA:CPU rounds it before the add."""
    valid = gain > NEG_INF / 2
    if params.use_cegb:
        delta = cnt * (params.cegb_tradeoff * params.cegb_penalty_split)
        if cegb_penalty is not None:
            delta = delta + cegb_penalty
        gain = torch.where(valid, gain - delta, gain)
    if gain_scale is not None:
        gain = torch.where(valid, gain * gain_scale, gain)
    return gain


def _categorical(hg_m, hh_m, hc_m, real_bin, tot_g, tot_h, tot_c,
                 min_gain_shift, num_bins, is_cat, params, rand_bins,
                 bins_r, pair_gain):
    """Per-feature best categorical split (reference split.py:331-470):
    (gain, (..., F, B) LEFT membership, (..., F, 3) left sums), in the
    reference's f32 operations and order."""
    *lead, f, b = hg_m.shape
    dev = hg_m.device
    l1 = params.lambda_l1
    min_h = params.min_sum_hessian_in_leaf
    min_cnt = float(params.min_data_in_leaf)
    cat_l2 = params.lambda_l2 + params.cat_l2
    neg_inf = _f32(NEG_INF, hg_m)
    zero = _f32(0.0, hg_m)
    use_et = params.extra_trees and rand_bins is not None

    # ---- one-vs-rest: category bin b goes left, the rest right
    crg, crh, crc = tot_g - hg_m, tot_h - hh_m, tot_c - hc_m
    cgl, cgr, _, _ = pair_gain(hg_m, hh_m, hc_m, crg, crh, crc, cat_l2)
    cat_ok = ((hc_m >= min_cnt) & (crc >= min_cnt) &
              (hh_m >= min_h) & (crh >= min_h) & real_bin)
    if use_et:  # one random category per node
        cat_ok = cat_ok & (bins_r == rand_bins.unsqueeze(-1))
    cat_gain = cgl + cgr - min_gain_shift
    cat_gain = torch.where(cat_ok & (cat_gain > 0), cat_gain, neg_inf)
    oh_bin = torch.argmax(cat_gain, dim=-1)
    oh_gain = _at_bin(cat_gain, oh_bin)
    oh_member = bins_r == oh_bin.unsqueeze(-1)
    oh_left = torch.stack([_at_bin(hg_m, oh_bin), _at_bin(hh_m, oh_bin),
                           _at_bin(hc_m, oh_bin)], dim=-1)
    if not params.use_cat_subset:
        return oh_gain, oh_member, oh_left

    # ---- sorted subsets: categories ordered by g / (h + cat_smooth),
    # prefixes scanned from both ends up to max_cat_threshold; the LEFT
    # child takes the subset.  Only the categorical columns are sorted.
    ci = (torch.as_tensor(params.cat_idx, dtype=torch.long, device=dev)
          if params.cat_idx else torch.arange(f, device=dev))
    nc = ci.shape[0]
    hgc, hhc, hcc = (a.index_select(-2, ci) for a in (hg_m, hh_m, hc_m))
    real_bin_c = real_bin.index_select(0, ci)
    mdpg = float(params.min_data_per_group)
    # candidate categories: count >= cat_smooth (the reference reuses
    # cat_smooth as the per-category minimum count)
    cat_valid = real_bin_c & (hcc >= params.cat_smooth)
    # a true f32 division, as the reference's (the divisor is no constant)
    ratio = torch.where(cat_valid, hgc / (hhc + params.cat_smooth),
                        _f32(BIG, hg_m))
    order = torch.sort(ratio, dim=-1, stable=True).indices       # (..., nc, B)
    pos = torch.arange(b, dtype=torch.int32, device=dev)
    rank = torch.empty_like(order).scatter_(
        -1, order, pos.to(order.dtype).expand(order.shape).contiguous())
    used = cat_valid.sum(dim=-1, dtype=torch.int32).unsqueeze(-1)  # (.., nc, 1)
    pos_used = pos < used

    def fwd_bwd(plane):
        sh = torch.where(pos_used, torch.gather(plane, -1, order), zero)
        cumf = cumsum_bins(sh)
        total_used = cumf[..., -1:]
        # prefix of the (i+1) LARGEST ratios = total_used - cumf[used-2-i]
        bidx = used - 2 - pos
        tb = torch.gather(cumf, -1, bidx.clamp(0, b - 1).long())
        return cumf, total_used - torch.where(bidx >= 0, tb, zero)

    cumf_g, cumb_g = fwd_bwd(hgc)
    cumf_h, cumb_h = fwd_bwd(hhc)
    cumf_c, cumb_c = fwd_bwd(hcc)
    max_pos = torch.minimum(
        torch.clamp((used + 1) // 2, max=params.max_cat_threshold), used)
    pos_ok = pos < max_pos
    if use_et:  # one random subset size per node
        rb_c = rand_bins.index_select(-1, ci).unsqueeze(-1)
        pos_ok = pos_ok & (pos == rb_c % torch.clamp(max_pos, min=1))
    # XLA rewrites the division by the constant min_data_per_group into a
    # multiply by its f32 reciprocal; the port multiplies the same way
    inv_mdpg = _f32(1.0 / mdpg, hg_m)
    min_rc = max(min_cnt, mdpg)

    def subset_gain(lg, lh, lc):
        rg, rh, rc = tot_g - lg, tot_h - lh, tot_c - lc
        # group spacing: a position counts once min_data_per_group rows
        # accumulated past the last counted multiple (the reference's
        # approximation of its per-group spacing)
        gcross = torch.floor(lc * inv_mdpg)
        gprev = torch.cat([torch.full_like(gcross[..., :1], -1.0),
                           gcross[..., :-1]], dim=-1)
        ok = (pos_ok & (lc >= min_cnt) & (lh >= min_h) &
              (rc >= min_rc) & (rh >= min_h) & (gcross > gprev))
        gl_, gr_, _, _ = pair_gain(lg, lh, lc, rg, rh, rc, cat_l2)
        g = gl_ + gr_ - min_gain_shift
        return torch.where(ok & (g > 0), g, neg_inf)

    gain_f = subset_gain(cumf_g, cumf_h, cumf_c)
    gain_bk = subset_gain(cumb_g, cumb_h, cumb_c)
    f_pos = torch.argmax(gain_f, dim=-1)
    f_best = _at_bin(gain_f, f_pos)
    b_pos = torch.argmax(gain_bk, dim=-1)
    b_best = _at_bin(gain_bk, b_pos)
    use_bk = b_best > f_best
    sub_gain = torch.where(use_bk, b_best, f_best)
    sub_pos = torch.where(use_bk, b_pos, f_pos).unsqueeze(-1)
    sub_left = torch.where(
        use_bk.unsqueeze(-1),
        torch.stack([_at_bin(cumb_g, b_pos), _at_bin(cumb_h, b_pos),
                     _at_bin(cumb_c, b_pos)], dim=-1),
        torch.stack([_at_bin(cumf_g, f_pos), _at_bin(cumf_h, f_pos),
                     _at_bin(cumf_c, f_pos)], dim=-1))
    # forward: ranks [0, pos]; backward: the top (pos+1) ranks of the used
    # range
    sub_member = torch.where(use_bk.unsqueeze(-1),
                             (rank >= used - 1 - sub_pos) & (rank < used),
                             rank <= sub_pos)
    # scatter the categorical columns back into feature space
    cat_gain = torch.full(tuple(lead) + (f,), NEG_INF, dtype=hg_m.dtype,
                          device=dev).index_copy(-1, ci, sub_gain)
    cat_left = torch.zeros(tuple(lead) + (f, 3), dtype=hg_m.dtype,
                           device=dev).index_copy(-2, ci, sub_left)
    cat_mem = torch.zeros(tuple(lead) + (f, b), dtype=torch.bool,
                          device=dev).index_copy(-2, ci, sub_member)
    use_subset = is_cat & (num_bins > params.max_cat_to_onehot)
    return (torch.where(use_subset, cat_gain, oh_gain),
            torch.where(use_subset.unsqueeze(-1), cat_mem, oh_member),
            torch.where(use_subset.unsqueeze(-1), cat_left, oh_left))


# The wave widths at which the reference's forced waves recompute the
# chosen bin's NaN-left gain with the parent gain's other product fused (read in its dumped LLVM IR at W = 4, 6, 14 and 42; W = 4 keeps the
# scan's own fusion, and other widths are not known)
FORCED_NAN_LEFT_REFUSED = frozenset({6, 14, 42})
# The wave widths at which, under path smoothing with monotone bounds, the
# reference's children scans fuse the square term's product into the
# NaN-left direction's child gains: W = 4.  There XLA:CPU computes those
# gains inside the bins' argmax fusion and the chosen bin's gather
# fusion, whose machine code adds ((h + l2) out) * out in one fused
# multiply-add, while the NaN-right gains' own fusion fuses (2 t) * out
# (read in the dumped object code; the same choice found by trying every
# combination of the scan's fused products against the reference's
# quantized text, basic and intermediate bounds).  W = 3, 6, 8, 14 and 42
# keep the scan's own fusion; W = 2 differs elsewhere, not found.
MONOTONE_SMOOTH_NAN_LEFT_SQUARE = frozenset({4})


def local_best_candidates(hist: torch.Tensor, leaf_sum: torch.Tensor,
                          num_bins: torch.Tensor, has_nan: torch.Tensor,
                          feature_mask: torch.Tensor, params: SplitParams,
                          parent_exact: torch.Tensor = None,
                          rand_bins: torch.Tensor = None,
                          is_cat: torch.Tensor = None, **options):
    """Best split over features for a batch of leaves (the reference's
    ``local_best_candidate`` vmapped): (gain, feat, bin, default_left,
    left_sum, right_sum, cat_member), each with the batch shape of
    ``leaf_sum[..., 0]`` (``cat_member`` (..., B)).  The lowest feature
    wins ties.  ``parent_exact``, ``rand_bins``, ``is_cat`` and the split
    options (``monotone``, ``bound``, ``depth``, ``cegb_penalty``,
    ``gain_scale``, ``parent_out``): as in :func:`best_split_per_feature`."""
    fs = best_split_per_feature(hist, leaf_sum, num_bins, has_nan, params,
                                parent_exact, rand_bins, is_cat, **options)
    gain = torch.where(feature_mask, fs.gain, _f32(NEG_INF, hist))
    f = torch.argmax(gain, dim=-1)
    fi = f.unsqueeze(-1)
    fi3 = fi.unsqueeze(-1).expand(*f.shape, 1, 3)
    fib = fi.unsqueeze(-1).expand(*f.shape, 1, fs.cat_member.shape[-1])
    return (torch.gather(gain, -1, fi).squeeze(-1), f.to(torch.int32),
            torch.gather(fs.threshold_bin, -1, fi).squeeze(-1),
            torch.gather(fs.default_left, -1, fi).squeeze(-1),
            torch.gather(fs.left_sum, -2, fi3).squeeze(-2),
            torch.gather(fs.right_sum, -2, fi3).squeeze(-2),
            torch.gather(fs.cat_member, -2, fib).squeeze(-2))
