"""Wave grower — leaf-wise growth with no physical row movement.

Port of ``lightgbm_tpu/learner/wave.py`` ``make_wave_grow_fn`` for the
serial learner.  Growth proceeds in *waves*: each
wave splits the top-``wave_size`` leaves by candidate gain, applies the W
splits to the per-row ``row_leaf`` vector in one kernel pass
(ops/histogram_cuda.py ``wave_row_update``), and builds the wave's SMALLER
children's histograms in one leaf-batched kernel pass; the larger siblings
come from the subtraction trick (serial_tree_learner.cpp:311-320).

Carried over from the reference, with the same semantics:

* waves with the endgame taper (:func:`wave_taper_k`);
* the root pass through the leaves kernel with an all-zero channel;
* the speculative ramp (reference wave.py:861-1136): a provisional
  subtree grown on a strided row subsample, verified by ONE full-data
  pass, committing every provisional split within ``spec_tol`` of its
  node's exact best;
* the exact endgame (reference wave.py:1710-1933): once the remaining
  budget drops below 2W, one batched trial-channel pass precomputes the
  frontier candidates' smaller children, and splits commit in the true
  sequential best-first order;
* exact (f32) and quantized (int8 -> int32) histograms, with stochastic
  rounding drawn from the port's threefry stream (utils/random.py) under
  the tree's ``quant_key``, or round-half-up;
* by-node feature sampling and extra-trees thresholds (reference
  wave.py:834-856): one batched draw per wave over the children's node
  ids (2t, 2t+1 for node t; 2L for the root) from the ``node_key`` rows,
  the streams the partitioned grower draws one node at a time;
* quantized leaf renewal (``quant_train_renew_leaf``, reference
  wave.py:1936-1972): one exact pass of the single-leaf histogram kernel
  over ``row_leaf`` as a one-feature bin column;
* nibble-packed 4-bit bins (``pack4``, reference wave.py:466-475,
  :644-679, :877-889, :918-928, :977-981): the leaf kernels read the
  ``(F, N/2)`` packed matrix in the waves and the ramp, the ramp's
  subsample strides over packed BYTES (adjacent row pairs), and the row
  update reads the winning columns' nibbles in place;
* categorical features and EFB bundles (reference wave.py:285-295,
  :545-549, :1313-1420): histograms are built and pooled in bundle space
  (G, Bb) and expanded to feature space (efb.py ``make_expand_hist``)
  before every scan; each split records its categorical LEFT bins
  (``cat_member``); the row update's categorical / EFB form decodes the
  bundle column and decides by membership on the device; the speculative
  ramp, the endgame and packed bins are off, as the reference gates them.

* the split options (reference wave.py:316-363, :446-453,
  :1163-1254, :1282-1330, :1444-1600): path smoothing, CEGB and
  ``feature_contri`` through the scan; forced splits as committed waves
  grouped ahead of time (a wave never splits a leaf created in the same
  wave); interaction constraints through each leaf's path of used
  features; basic monotone bounds, and intermediate ones: each leaf keeps
  its bin-space region box and the W splits of a wave tighten the bounds
  of every geometrically contiguous leaf one after another (a host loop
  over W on the small (L,) arrays); lazy CEGB, a (F, N/8) bitmap of the
  (feature, row) pairs already computed that lasts across trees, with
  per-(feature, child) unused row counts.  The speculative ramp is off
  under every option; the exact endgame only under monotone constraints,
  interaction constraints and lazy CEGB, as the reference gates them.

The reference runs the whole tree inside one jitted ``lax.while_loop``;
here PyTorch runs eagerly and the host drives the loops, reading the leaf
count once per wave and the best candidate once per endgame commit.

Not ported (ROADMAP queue 1): the voting and scatter merges of the
data-parallel strategies.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch

from ..dataset import pad_rows
from ..efb import make_expand_hist
from ..models.tree import CAT_MASK, DEFAULT_LEFT_MASK, MISSING_NAN
from ..ops.histogram import (PACK4_MAX_BINS, fx_to_f32, histogram_subtract,
                             pack_bins4, pack_weights)
from ..ops.histogram_cuda import LEAF_CHANNELS, Q_LEAF_CHANNELS, split_decode
from ..ops.quantize import dequant_scales, quant_scales, quantize_wch
from ..ops.fmath import _fma
from ..ops.split import (BIG, FORCED_NAN_LEFT_REFUSED,
                         MONOTONE_SMOOTH_NAN_LEFT_SQUARE, NEG_INF, SplitParams,
                         cumsum_bins, leaf_gain,
                         leaf_output, leaf_output_smoothed,
                         local_best_candidates, node_draws)
from . import lanes as kc
from .endgame import patch_child_pointers, write_split_records
from .serial import (GrownTree, basic_bounds, child_outputs,
                     interaction_allowed, interaction_groups_mask)

__all__ = ["make_wave_grow_fn", "WAVE_SIZE", "Q_WAVE_SIZE", "wave_taper_k",
           "forced_wave_groups", "lazy_bitmap_init", "LAZY_PACK"]

WAVE_SIZE = LEAF_CHANNELS        # 25 leaves per exact pass
CAND_NAMES = ("cand_gain", "cand_feat", "cand_bin", "cand_dleft",
              "cand_lsum", "cand_rsum", "cand_member")
Q_WAVE_SIZE = Q_LEAF_CHANNELS    # 42 leaves per quantized pass

_I32 = torch.int32
_F32 = torch.float32


def wave_taper_k(budget: int, W: int) -> int:
    """Endgame-taper wave width: commit min(W, budget) splits while the
    budget is ample, halve the wave once budget < 2W (with a W//4 floor
    capping the halving cascade)."""
    taper = max(budget // 2, min(W // 4, budget))
    return min(W, max(1, budget if budget >= 2 * W else taper))


def _topk(vals: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties broken toward the lower
    index."""
    v, i = torch.sort(vals, descending=True, stable=True)
    return v[:k], i[:k]


def forced_wave_groups(forced_splits: tuple, L: int, W: int) -> list:
    """BFS-ordered (leaf, feature, bin) forced splits grouped into waves
    ahead of time (reference wave.py:361-390): a wave takes at most W
    splits and never splits a leaf twice or a leaf created in the same
    wave, which keeps the sequential right-child numbering of the
    triples."""
    waves: list = []
    cur: list = []
    blocked: set = set()
    nl_sim = 1
    for (leaf, f, b) in forced_splits[:min(len(forced_splits), L - 1)]:
        if leaf in blocked or len(cur) == W:
            waves.append(cur)
            cur, blocked = [], set()
        cur.append((leaf, f, b))
        blocked.add(leaf)
        blocked.add(nl_sim)
        nl_sim += 1
    if cur:
        waves.append(cur)
    return waves


# lazy CEGB's bitmap: one bit per (feature, row), packed LSB first
LAZY_PACK = 8
_BIT_SHIFTS = torch.arange(LAZY_PACK, dtype=torch.uint8)


def lazy_bitmap_init(num_features: int, n: int, device) -> torch.Tensor:
    """A fresh (F, N/8) 'feature computed for row' bitmap (the
    reference's feature_used_in_data_, allocated once per training
    run)."""
    return torch.zeros((num_features, n // LAZY_PACK), dtype=torch.uint8,
                       device=device)


def _pack_bits(m: torch.Tensor) -> torch.Tensor:
    """(N,) bool -> (N/8,) uint8, LSB first."""
    b = m.reshape(-1, LAZY_PACK).to(torch.uint8)
    return (b << _BIT_SHIFTS.to(m.device)).sum(dim=1, dtype=torch.uint8)


def _unpack_bits(p: torch.Tensor) -> torch.Tensor:
    """(N/8,) uint8 -> (N,) bool, LSB first."""
    sh = _BIT_SHIFTS.to(p.device)
    return ((p.unsqueeze(-1) >> sh) & 1).reshape(-1).to(torch.bool)


def _set_drop(arr: torch.Tensor, idx: torch.Tensor, val,
              valid: torch.Tensor) -> None:
    """``arr.at[idx].set(val, mode="drop")`` for the lanes where ``valid``
    holds (the reference routes invalid lanes to an out-of-range index)."""
    if not isinstance(val, torch.Tensor):
        val = torch.as_tensor(val, device=arr.device)
    if val.dim() == 0:
        val = val.expand(idx.shape)
    arr[idx[valid]] = val[valid].to(arr.dtype)


def make_wave_grow_fn(*, num_leaves: int, num_features: int, max_bins: int,
                      max_depth: int, split_params: SplitParams,
                      wave_size: int = 0, quantized: bool = False,
                      gq_max: int = 127, hq_max: int = 127,
                      stochastic: bool = False, spec_ramp: bool = False,
                      spec_tol: float = 0.3, spec_subsample: int = 1 << 19,
                      exact_endgame: bool = True, renew_leaf: bool = False,
                      pack4: bool = False, efb=None, mc_inter: bool = False,
                      forced_splits: tuple = (),
                      interaction_groups: tuple = (),
                      feature_contri: tuple = (), cegb_lazy: tuple = (),
                      subsample_cache: Optional[dict] = None):
    """Build the wave single-tree grower.

    Returns ``grow(X_T, grad, hess, bag_mask, num_bins, has_nan,
    feature_mask, quant_key=None, node_key=None, is_cat=None,
    monotone=None, cegb_penalty=None, lazy_used=None) -> GrownTree`` with
    ``X_T`` the FEATURE-MAJOR (G, N) uint8 bin matrix (G = F, or the
    bundles of ``efb``, an ``efb.EfbArrays``), N a multiple of the
    4096-row block, ``is_cat`` the (F,) categorical flags (read when
    ``split_params.any_cat``), ``monotone`` the (F,) constraint
    directions, ``cegb_penalty`` the (F,) coupled CEGB penalties and
    every tensor on one device.  Under lazy CEGB (``cegb_lazy``, (F,)
    penalties pre-scaled by the tradeoff) ``lazy_used`` is the bitmap of
    :func:`lazy_bitmap_init` and ``grow`` returns (tree, updated bitmap).
    ``mc_inter`` selects intermediate monotone constraints;
    ``forced_splits`` are BFS (leaf, inner feature, bin) triples,
    ``interaction_groups`` tuples of inner features and
    ``feature_contri`` (F,) gain scales.
    ``quant_key`` keys the tree's stochastic rounding; ``node_key`` holds
    the keys of the by-node sampling stream ([0]) and the extra-trees
    stream ([1]) (host keys or (2,) tensors, utils/random.py).  Under ``pack4`` ``X_T`` is
    the nibble-packed (F, N/2) matrix (ops/histogram.py ``pack_bins4``).
    The reference's ``tpu_pallas_pipeline`` knob reaches the grower only
    through ``pack4`` (the learner turns packing off for ``blockspec``);
    the kernels have one form per bin layout.

    ``own_rows`` (a sorted (n,) int64 tensor, or None = every row) are
    the rows a masked lane of a batch trains on (multitrain/batched.py
    ``sample_masks``; every other row has zero weight): the draws over row
    positions (stochastic rounding and the speculative ramp's subsample)
    are then those of a run on the compacted ``n`` rows, so the lane grows
    the tree that run grows.

    ``grow.gen`` is the same grower as a generator of kernel requests
    (learner/lanes.py), which ``grow`` drives with single launches and
    the batch trainer drives in lockstep with other lanes.
    ``subsample_cache`` (a dict shared by the lanes' growers) keeps the
    speculative ramp's row subsample of the bin matrix, so the lanes'
    ramp passes read one matrix and share launches."""
    any_cat = bool(split_params.any_cat)
    use_efb = efb is not None
    if pack4 and (max_bins > PACK4_MAX_BINS or any_cat or use_efb):
        raise ValueError(f"pack4 bins require numeric non-EFB data with "
                         f"max_bin <= {PACK4_MAX_BINS}")
    if max_bins > 256:
        raise NotImplementedError("uint16 bin codes are not ported to "
                                  "lightgbm_tpu_torch yet (ROADMAP queue 1): "
                                  "the wave kernels take uint8 bins "
                                  "(max_bin <= 255)")
    L = num_leaves
    F = num_features
    G, Bb = (efb.n_bundles, efb.bundle_bins) if use_efb else (F, max_bins)
    sp = split_params
    expand = make_expand_hist(efb, F)
    # the row update's categorical / EFB form (the reference's XLA
    # fallback, wave.py:1341-1420)
    ext_rows = any_cat or use_efb
    ch_cap = Q_WAVE_SIZE if quantized else WAVE_SIZE
    W = max(1, min(int(wave_size) or ch_cap, ch_cap, L - 1))
    use_bynode = sp.feature_fraction_bynode < 1.0
    use_et = sp.extra_trees
    use_mc = sp.use_monotone
    use_sm = sp.path_smooth > 0.0
    use_ic = len(interaction_groups) > 0
    use_lazy = len(cegb_lazy) > 0
    # the reference gates its two fast paths apart (wave.py:339-363):
    # the exact endgame is off only under the per-wave state it cannot
    # carry (monotone bounds, interaction paths, the lazy bitmap, the
    # per-node streams) and the categorical / EFB shapes; the
    # speculative ramp also under smoothing, CEGB, feature_contri and
    # forced splits
    no_endgame = (use_bynode or use_et or any_cat or use_efb or
                  max_bins > 255 or use_mc or use_ic or use_lazy)
    use_spec = (spec_ramp and max_depth <= 0 and W >= 2 and L >= 3 * W and
                not (no_endgame or use_sm or sp.use_cegb or feature_contri
                     or forced_splits))
    use_endgame = exact_endgame and L > 2 and not no_endgame
    EG = 2 * W   # pending-commit capacity (budget < 2W at endgame entry)
    forced_waves = forced_wave_groups(forced_splits, L, W)
    mc_inter = mc_inter and use_mc

    def grow_gen(X_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                 bag_mask: torch.Tensor, num_bins: torch.Tensor,
                 has_nan: torch.Tensor, feature_mask: torch.Tensor,
                 quant_key=None, node_key=None, is_cat=None, monotone=None,
                 cegb_penalty=None, lazy_used=None, own_rows=None):
        dev = X_T.device
        n = X_T.shape[1] * 2 if pack4 else X_T.shape[1]
        # the padded row count of a run on the lane's own rows
        n_own = n if own_rows is None else pad_rows(own_rows.shape[0])
        nb_full = num_bins.to(_I32)
        hn_full = has_nan
        ic_full = (is_cat.to(torch.bool) if any_cat and is_cat is not None
                   else torch.zeros((F,), dtype=torch.bool, device=dev))
        zf = torch.zeros((), dtype=_F32, device=dev)
        neg_inf = torch.full((), NEG_INF, dtype=_F32, device=dev)
        mono = (monotone.to(_I32) if use_mc
                else torch.zeros((F,), dtype=_I32, device=dev))
        # the scans' per-feature penalties (reference wave.py:524-527)
        cegb_full = None
        if sp.use_cegb:
            cegb_full = (cegb_penalty.to(_F32) if cegb_penalty is not None
                         else torch.zeros((F,), dtype=_F32, device=dev))
        contri = (torch.tensor(feature_contri, dtype=_F32, device=dev)
                  if feature_contri else None)
        groups = (interaction_groups_mask(interaction_groups, F, dev)
                  if use_ic else None)
        lazy_pen = (torch.tensor(cegb_lazy, dtype=_F32, device=dev)
                    if use_lazy else None)

        def route(bins, rl, tab, feats, member=None):
            """The row update reading the split columns of ``bins`` in
            place (packed under ``pack4``); under categorical features or
            EFB its categorical / EFB form, which reads each feature's
            bundle column, decodes it and decides categorical splits by
            the (W, B) ``member`` table."""
            if not ext_rows:
                return (yield kc.row_update(
                    bins, rl, tab, feats=feats.to(_I32), bins_packed=pack4))
            fl = feats.long()
            if use_efb:
                col = efb.f_bundle[fl]
                dec = (efb.f_offset[fl], efb.f_nbins[fl],
                       efb.f_default[fl], efb.f_single[fl])
            else:
                col = feats
                dec = (torch.zeros_like(feats), nb_full[fl],
                       torch.zeros_like(feats), torch.ones_like(feats))
            return (yield kc.row_update(
                bins, rl, tab, feats=col.to(_I32),
                decode=split_decode(ic_full[fl], member, *dec)))

        gm = (grad * bag_mask).float()
        hm = (hess * bag_mask).float()
        if quantized:
            # per-tree linear quantization scales
            # (gradient_discretizer.cpp DiscretizeGradients)
            g_scale, h_scale = quant_scales(gm.abs().max(), hm.max(),
                                            gq_max, hq_max)
            qscales = dequant_scales(g_scale, h_scale)
            w_all = quantize_wch(grad, hess, bag_mask, g_scale, h_scale,
                                 quant_key, gq_max=gq_max, hq_max=hq_max,
                                 stochastic=stochastic,
                                 own=(None if own_rows is None
                                      else (own_rows, n_own)))
        else:
            w_all = pack_weights(grad, hess, bag_mask)

        def dq(h):
            """int32 channel sums -> f32 (sum_grad, sum_hess, count)."""
            return h.float() * qscales if quantized else h

        def hist_kernel(bins, w, ch):
            if quantized:
                return (yield kc.leaves_q8(bins, w, ch, num_bins=Bb,
                                           bins_packed=pack4))
            return (yield kc.leaves_fx(bins, w, ch, num_bins=Bb,
                                       bins_packed=pack4))

        def hist_waves(ch, k=W, with_totals=False):
            """(k, F, Bb, 3) histograms of the wave's leaf channels
            (quantized: exact int32 channel sums) and, optionally, the
            (k, 3) f32 channel totals from feature 0's bins."""
            hk = (yield from hist_kernel(X_T, w_all, ch))[:k]
            if not with_totals:
                return hk
            return hk, dq(hk[:, 0].sum(dim=1).to(hk.dtype))

        def many_candidates(hists, sums, fms, sums_exact=None,
                            rand_bins=None, bounds=None, depths=None,
                            pouts=None, cegb=None, nan_left_refused=False,
                            nan_left_square=False):
            """Best-split candidates for a batch of leaves: the scan on
            the dequantized histograms, expanded to feature space under
            EFB (the reference's ``_scan_hists``, wave.py:591-599), with
            the leaves' monotone ``bounds`` (k, 2), ``depths`` (k,), own
            outputs ``pouts`` (k,) and CEGB penalties ``cegb`` ((k, F),
            the lazy costs; else the coupled ones)."""
            return local_best_candidates(
                expand(dq(hists), sums), sums, nb_full, hn_full,
                fms, sp, sums_exact, rand_bins,
                ic_full if any_cat else None, monotone=mono, bound=bounds,
                depth=depths, cegb_penalty=cegb_full if cegb is None
                else cegb, gain_scale=contri, parent_out=pouts,
                nan_left_refused=nan_left_refused,
                nan_left_square=nan_left_square)

        fm_row = feature_mask.to(torch.bool)

        def node_inputs(ids):
            """The scan's feature masks and extra-trees bins of the nodes
            ``ids``: one batched draw for all of them."""
            return node_draws(node_key, ids, fm_row, nb_full, sp)
        hdtype = torch.int32 if quantized else _F32

        def empty_state() -> Dict[str, torch.Tensor]:
            def z(shape, dtype, fill=0):
                return torch.full(shape, fill, dtype=dtype, device=dev)
            return {
                "row_leaf": z((n,), _I32),
                "leaf_sum": z((L, 3), _F32),
                "leaf_depth": z((L,), _I32),
                "cand_gain": z((L,), _F32, NEG_INF),
                "cand_feat": z((L,), _I32),
                "cand_bin": z((L,), _I32),
                "cand_dleft": z((L,), torch.bool),
                "cand_lsum": z((L, 3), _F32),
                "cand_rsum": z((L, 3), _F32),
                "cand_member": z((L, max_bins), torch.bool),
                "hists": z((L, G, Bb, 3), hdtype),
                "split_feature": z((L - 1,), _I32, -1),
                "threshold_bin": z((L - 1,), _I32),
                "nan_bin": z((L - 1,), _I32, -1),
                "cat_member": z((L - 1, max_bins), torch.bool),
                "decision_type": z((L - 1,), _I32),
                "left_child": z((L - 1,), _I32),
                "right_child": z((L - 1,), _I32),
                "split_gain": z((L - 1,), _F32),
                "internal_value": z((L - 1,), _F32),
                "internal_weight": z((L - 1,), _F32),
                "internal_count": z((L - 1,), _F32),
                "leaf_value": z((L,), _F32),
                "leaf_weight": z((L,), _F32),
                "leaf_count": z((L,), _F32),
                # monotone bounds, the features on each leaf's path
                "leaf_mn": z((L,), _F32, -BIG),
                "leaf_mx": z((L,), _F32, BIG),
                "leaf_path": z((L, F), torch.bool),
            }

        def set_candidates(s, idx, cands, valid=None):
            valid = torch.ones_like(idx, dtype=torch.bool) \
                if valid is None else valid
            for name, val in zip(CAND_NAMES, cands):
                _set_drop(s[name], idx, val, valid)

        # ---- speculative ramp ------------------------------------------
        def spec_state():
            """Provisional subtree from a row subsample, verified and
            committed against one full-data W-channel pass (reference
            wave.py:861-1136).  Replaces the root pass and the first
            ~log2(W) ramp waves."""
            Kc, K1 = W, W - 1
            stride = max(1, n_own // max(int(spec_subsample), 4096))
            n_ss = max((n_own // stride) // 4096 * 4096, 4096)

            def subsample(a):
                """Every ``stride``-th row of ``a`` (..., n), the first
                n_ss.  Under pack4 every ``stride``-th packed BYTE: the
                subsample keeps adjacent row pairs so the packed kernels
                consume it directly, and the weights follow the same
                pairs (reference wave.py:878-889)."""
                if pack4:
                    a = a.reshape(a.shape[0], -1, 2)[:, ::stride]
                    return a[:, :n_ss // 2].reshape(a.shape[0], n_ss)
                return a[:, ::stride][:, :n_ss].contiguous()

            if own_rows is not None:
                # the subsample's positions among the lane's own rows
                # (positions past them are the compacted run's zero
                # padding), gathered from the shared matrix: per lane
                if pack4:
                    j = torch.arange(0, n_own // 2, stride,
                                     device=dev)[:n_ss // 2]
                    q = torch.stack([2 * j, 2 * j + 1], 1).reshape(-1)
                else:
                    q = torch.arange(0, n_own, stride, device=dev)[:n_ss]
                pad = q >= own_rows.shape[0]
                p = own_rows[q.clamp(max=own_rows.shape[0] - 1)]
                if pack4:
                    X_ss = (X_T[:, p // 2] >> (4 * (p % 2)).to(
                        torch.uint8)) & 15
                    X_ss = pack_bins4(X_ss.masked_fill(pad, 0))
                else:
                    X_ss = X_T[:, p].masked_fill(pad, 0)

                def subsample(a):
                    return a[:, p].masked_fill(pad, 0)
            else:
                src, X_ss = (subsample_cache or {}).get(
                    (stride, n_ss), (None, None))
                if src is not X_T:   # a strong ref: ids can be recycled
                    X_ss = (X_T[:, ::stride][:, :n_ss // 2].contiguous()
                            if pack4 else subsample(X_T))
                    if subsample_cache is not None:
                        subsample_cache.clear()
                        subsample_cache[(stride, n_ss)] = (X_T, X_ss)
            w_ss = (subsample(w_all) if quantized
                    else w_all._replace(w=subsample(w_all.w)))
            nan_of = torch.where(hn_full, nb_full - 1,
                                 torch.full_like(nb_full, -1))
            fm_k = fm_row.expand(Kc, F)
            jar = torch.arange(Kc, dtype=_I32, device=dev)

            rl_ss = torch.zeros((n_ss,), dtype=_I32, device=dev)
            nlp = 1
            pfeat = torch.zeros((K1,), dtype=_I32, device=dev)
            pthr = torch.zeros((K1,), dtype=_I32, device=dev)
            pnan = torch.full((K1,), -1, dtype=_I32, device=dev)
            pdl = torch.zeros((K1,), dtype=_I32, device=dev)
            pleaf = torch.zeros((K1,), dtype=_I32, device=dev)
            pact = torch.zeros((K1,), dtype=torch.bool, device=dev)
            ppar = torch.full((K1,), -1, dtype=_I32, device=dev)
            owner = torch.full((Kc,), -1, dtype=_I32, device=dev)
            Lm = torch.zeros((K1, Kc), dtype=torch.bool, device=dev)
            Rm = torch.zeros((K1, Kc), dtype=torch.bool, device=dev)
            tabs = []
            for _t in range(max(1, int(math.ceil(math.log2(Kc))))):
                h_ss = (yield from hist_kernel(X_ss, w_ss,
                                               rl_ss.to(torch.int8)))[:Kc]
                sums_pl = dq(h_ss[:, 0].sum(dim=1).to(h_ss.dtype))
                cnds = many_candidates(h_ss, sums_pl, fm_k)
                g = torch.where(jar < nlp, cnds[0], neg_inf)
                vals, sel_l = _topk(g, Kc)
                sel = (vals > 0) & (jar < Kc - nlp)
                prefix = torch.cumsum(sel.to(_I32), 0).to(_I32)
                newids = nlp + prefix - 1
                nodeids = (nlp - 1) + prefix - 1
                feat_s = cnds[1][sel_l]
                thr_s = cnds[2][sel_l]
                dl_s = cnds[3][sel_l].to(_I32)
                fnan_s = nan_of[feat_s.long()]
                for arr, val in ((pfeat, feat_s), (pthr, thr_s),
                                 (pnan, fnan_s), (pdl, dl_s),
                                 (pleaf, sel_l), (pact, sel),
                                 (ppar, owner[sel_l])):
                    _set_drop(arr, nodeids.long(), val, sel)
                # descendant propagation: nodes holding leaf r gain leaf s
                A = torch.zeros((Kc, Kc), dtype=_F32, device=dev)
                A[sel_l[sel], newids[sel].long()] = 1.0
                Lm = Lm | (Lm.float() @ A > 0)
                Rm = Rm | (Rm.float() @ A > 0)
                ni = nodeids[sel].long()
                Lm[ni] = torch.nn.functional.one_hot(
                    sel_l[sel], Kc).to(torch.bool)
                Rm[ni] = torch.nn.functional.one_hot(
                    newids[sel].long(), Kc).to(torch.bool)
                _set_drop(owner, sel_l, nodeids, sel)
                _set_drop(owner, newids.long(), nodeids, sel)
                feats_cl = torch.clamp(feat_s, 0, F - 1)
                tab = torch.stack([
                    thr_s, fnan_s, dl_s, torch.ones_like(thr_s),
                    sel_l.to(_I32), newids, sel.to(_I32),
                    torch.zeros_like(thr_s)]).contiguous()
                rl_ss, _ = yield from route(X_ss, rl_ss, tab, feats_cl)
                tabs.append((tab, feats_cl))
                nlp = nlp + int(prefix[-1])

            # route ALL rows through the provisional tree
            rl_full = torch.zeros((n,), dtype=_I32, device=dev)
            for tab, feats_cl in tabs:
                rl_full, _ = yield from route(X_T, rl_full, tab, feats_cl)

            # ONE full-data pass: exact per-prov-leaf channel sums
            h_ch, leaf_tot = yield from hist_waves(rl_full.to(torch.int8),
                                                   k=Kc, with_totals=True)
            hf_ch = dq(h_ch)

            # exact node aggregates: sums over descendant leaves in leaf
            # order (the reference's 0/1 dot products)
            Dn = Lm | Rm
            lt3 = torch.zeros((K1, 3), dtype=_F32, device=dev)
            rt3 = torch.zeros_like(lt3)
            H_node = torch.zeros((K1,) + hf_ch.shape[1:], dtype=_F32,
                                 device=dev)
            for l in range(Kc):
                lt3 = lt3 + torch.where(Lm[:, l:l + 1], leaf_tot[l], zf)
                rt3 = rt3 + torch.where(Rm[:, l:l + 1], leaf_tot[l], zf)
                H_node = H_node + torch.where(
                    Dn[:, l].view(K1, 1, 1, 1), hf_ch[l], zf)
            pt3 = lt3 + rt3
            bg = local_best_candidates(H_node, pt3, nb_full, hn_full,
                                       fm_row.expand(K1, F), sp)[0]

            def lg3(s3):
                return leaf_gain(s3[:, 0], s3[:, 1], sp.lambda_l1,
                                 sp.lambda_l2)

            pg = lg3(lt3) + lg3(rt3) - (lg3(pt3) + sp.min_gain_to_split)
            okc = ((lt3[:, 2] >= sp.min_data_in_leaf) &
                   (rt3[:, 2] >= sp.min_data_in_leaf) &
                   (lt3[:, 1] >= sp.min_sum_hessian_in_leaf) &
                   (rt3[:, 1] >= sp.min_sum_hessian_in_leaf))
            test = (pact & okc & (pg > 0) &
                    (pg >= (1.0 - spec_tol) * torch.clamp(bg, min=0.0)))
            iv_all = leaf_output(pt3[:, 0], pt3[:, 1], sp)

            # host replay of the commit decisions (parents precede children)
            test_h = test.cpu().numpy()
            ppar_h = ppar.cpu().numpy()
            pleaf_h = pleaf.cpu().numpy()
            pfeat_h, pthr_h = pfeat.cpu().numpy(), pthr.cpu().numpy()
            pnan_h, pdl_h = pnan.cpu().numpy(), pdl.cpu().numpy()
            Rm_h, Dn_h = Rm.cpu().numpy(), Dn.cpu().numpy()
            comm = np.zeros(K1, bool)
            for j in range(K1):
                pok = True if ppar_h[j] < 0 else comm[ppar_h[j]]
                comm[j] = pok and test_h[j]

            s = empty_state()
            s_map = np.zeros(Kc, np.int64)     # prov leaf -> state leaf
            depth_pl = np.zeros(Kc, np.int64)
            nl_run = 1
            lc_ = np.zeros(L - 1, np.int64)
            rc_ = np.zeros(L - 1, np.int64)
            nodes, srcs = [], []
            for j in range(K1):
                if not comm[j]:
                    continue
                sl = int(s_map[pleaf_h[j]])
                new_leaf, nid, enc = nl_run, nl_run - 1, -(sl + 1)
                lc_[lc_ == enc] = nid
                rc_[rc_ == enc] = nid
                lc_[nid] = enc
                rc_[nid] = -(new_leaf + 1)
                nodes.append(nid)
                srcs.append(j)
                s["split_feature"][nid] = int(pfeat_h[j])
                s["threshold_bin"][nid] = int(pthr_h[j])
                s["nan_bin"][nid] = int(pnan_h[j])
                s["decision_type"][nid] = (
                    (DEFAULT_LEFT_MASK if pdl_h[j] > 0 else 0) |
                    (MISSING_NAN if pnan_h[j] >= 0 else 0))
                s_map = np.where(Rm_h[j], new_leaf, s_map)
                depth_pl = np.where(Dn_h[j], depth_pl + 1, depth_pl)
                nl_run += 1
            if nodes:
                ni = torch.as_tensor(nodes, device=dev)
                sj = torch.as_tensor(srcs, device=dev)
                s["split_gain"][ni] = pg[sj]
                s["internal_value"][ni] = iv_all[sj]
                s["internal_weight"][ni] = pt3[sj, 1]
                s["internal_count"][ni] = pt3[sj, 2]
            s["left_child"].copy_(torch.as_tensor(lc_, dtype=_I32))
            s["right_child"].copy_(torch.as_tensor(rc_, dtype=_I32))

            # pools + frontier candidates: prov leaves folded into their
            # state leaves in prov-leaf order
            s_map_t = torch.as_tensor(s_map, device=dev)
            s["row_leaf"] = s_map_t.to(_I32)[rl_full.long()]
            for l in range(Kc):
                t = int(s_map[l])
                s["hists"][t] += h_ch[l]
                s["leaf_sum"][t] += leaf_tot[l]
            s["leaf_depth"][s_map_t] = torch.as_tensor(
                depth_pl, dtype=_I32, device=dev)
            live = torch.arange(L, device=dev) < nl_run
            lsum0 = s["leaf_sum"]
            s["leaf_value"] = torch.where(
                live, leaf_output(lsum0[:, 0], lsum0[:, 1], sp), zf)
            s["leaf_weight"] = torch.where(live, lsum0[:, 1], zf)
            s["leaf_count"] = torch.where(live, lsum0[:, 2], zf)
            cnds0 = many_candidates(s["hists"][:Kc], lsum0[:Kc], fm_k)
            cg0 = torch.where(jar < nl_run, cnds0[0], neg_inf)
            set_candidates(s, torch.arange(Kc, device=dev),
                           (cg0,) + tuple(cnds0[1:]))
            # one full-data histogram pass so far (the provisional passes
            # run at subsample scale and are not counted)
            return s, nl_run, 1

        # ---- root ----------------------------------------------------------
        def root_state():
            zch = torch.zeros((n,), dtype=torch.int8, device=dev)
            root_exact = None
            if quantized:
                rh, rtot = yield from hist_waves(zch, k=1, with_totals=True)
                root_hist, root_sum = rh[0], rtot[0]
                # the dequantized totals unrounded (f32(int) x f32 scale
                # is exact in float64): the reference's jitted root scan
                # fuses this multiply into its right-side subtractions
                root_exact = (root_hist[0].sum(dim=0).float().double() *
                              qscales.double())
            else:
                root_hist = (yield from hist_waves(zch, k=1))[0]
                # the fixed-point totals: order-free, so a tree does not
                # depend on the rows' order or on zero-weight rows (a
                # masked fold grows the tree of its row subset)
                root_sum = fx_to_f32(w_all.w.sum(dim=1), w_all.inv_scale)
            root_out = leaf_output_smoothed(root_sum[0], root_sum[1],
                                            root_sum[2], zf, sp)
            fm0, rb0 = node_inputs(torch.full((1,), 2 * L,
                                              dtype=torch.int64, device=dev))
            if use_ic:
                fm0 = fm0 & interaction_allowed(
                    groups, torch.zeros((F,), dtype=torch.bool, device=dev))
            cegb0 = None
            if use_lazy:
                # charge only the in-bag rows whose bit is still unset in
                # the bitmap that lasts across trees (reference
                # wave.py:1169-1187)
                in_bag = bag_mask > 0
                used_root = torch.stack([
                    (_unpack_bits(used[f]) & in_bag).sum()
                    for f in range(F)]).to(_F32)
                unused = torch.clamp(root_sum[2] - used_root, min=0.0)
                cegb0 = _fma(lazy_pen, unused,
                             cegb_full).unsqueeze(0)
            cand = many_candidates(
                root_hist.unsqueeze(0), root_sum.unsqueeze(0), fm0,
                None if root_exact is None else root_exact.unsqueeze(0),
                rb0, bounds=torch.tensor([[-BIG, BIG]], dtype=_F32,
                                         device=dev),
                depths=torch.zeros((1,), dtype=_I32, device=dev),
                pouts=root_out.view(1), cegb=cegb0)
            s = empty_state()
            s["leaf_sum"][0] = root_sum
            set_candidates(s, torch.zeros((1,), dtype=torch.long,
                                          device=dev), cand)
            s["hists"][0] = root_hist
            s["leaf_value"][0] = root_out
            s["leaf_weight"][0] = root_sum[1]
            s["leaf_count"][0] = root_sum[2]
            return s, 1, 1

        if use_lazy:
            used = (lazy_used if lazy_used is not None
                    else lazy_bitmap_init(F, n, dev))
        if use_spec:
            s, num_leaves_now, hist_passes = yield from spec_state()
        else:
            s, num_leaves_now, hist_passes = yield from root_state()
        if mc_inter:
            # each leaf's bin-space region box, on the host: the wave's
            # intermediate refinement runs there
            box_lo = torch.zeros((L, F), dtype=_I32)
            box_hi = (nb_full.cpu() - 1).expand(L, F).clone()
        if use_lazy:
            s["used"] = used

        jarange = torch.arange(W, dtype=_I32, device=dev)

        # ---- one wave ----------------------------------------------------
        def body(s, nl0, forced=None):
            if forced is None:
                budget = L - nl0
                k_eff = wave_taper_k(budget, W)
                vals, sel_leaves = _topk(s["cand_gain"], W)
                sel = (vals > 0) & (jarange < k_eff)
                sl = sel_leaves
                feat = s["cand_feat"][sl]
                thr = s["cand_bin"][sl]
                dleft = s["cand_dleft"][sl]
                lsum = s["cand_lsum"][sl]
                rsum = s["cand_rsum"][sl]
                member = s["cand_member"][sl]              # (W, B)
                psum_ = s["leaf_sum"][sl]
            else:
                # a forced wave (reference wave.py:1282-1330): fixed
                # (leaf, feature, bin) splits whatever their gain, default
                # right, child sums the cumulative bins of the leaf's
                # pooled histogram; an empty leaf is skipped
                k = len(forced)
                trip = torch.tensor(list(forced) + [(0, 0, 0)] * (W - k),
                                    dtype=_I32, device=dev)
                sl = trip[:, 0].long()
                feat, thr = trip[:, 1].contiguous(), trip[:, 2].contiguous()
                psum_ = s["leaf_sum"][sl]
                sel = (jarange < k) & (psum_[:, 2] > 0)
                dleft = torch.zeros((W,), dtype=torch.bool, device=dev)
                member = torch.zeros((W, max_bins), dtype=torch.bool,
                                     device=dev)
                exh = expand(dq(s["hists"][sl]), psum_)    # (W, F, B, 3)
                fh = exh[torch.arange(W, device=dev), feat.long()]
                csum = cumsum_bins(fh.transpose(1, 2))     # (W, 3, B)
                lsum = csum[torch.arange(W, device=dev), :,
                            torch.clamp(thr, 0, max_bins - 1).long()]
                rsum = psum_ - lsum

                def lg(v):
                    return leaf_gain(v[:, 0], v[:, 1], sp.lambda_l1,
                                     sp.lambda_l2)
                vals = lg(lsum) + lg(rsum) - lg(psum_) - sp.min_gain_to_split
            prefix = torch.cumsum(sel.to(_I32), 0).to(_I32)
            sel_h = sel.cpu()
            total_new = int(sel_h.sum())
            new_ids = nl0 + prefix - 1
            node_ids = (nl0 - 1) + prefix - 1
            left_smaller = lsum[:, 2] <= rsum[:, 2]
            fnan = hn_full[feat.long()]
            fcat = ic_full[feat.long()]
            f_nan_bin = torch.where(fnan, nb_full[feat.long()] - 1,
                                    torch.full_like(feat, -1))

            # ---- row_leaf + wave-channel update: one kernel pass ----
            rl_old = s["row_leaf"]
            tab = torch.stack([
                thr, f_nan_bin, dleft.to(_I32), left_smaller.to(_I32),
                sl.to(_I32), new_ids, sel.to(_I32),
                torch.zeros_like(thr)]).contiguous()
            s["row_leaf"], ch = yield from route(X_T, s["row_leaf"], tab, feat,
                                                 member)

            # ---- one kernel pass: all W smaller-child histograms ----
            hist_small = yield from hist_waves(ch)
            hist_big = histogram_subtract(s["hists"][sl], hist_small)
            ls4 = left_smaller.view(W, 1, 1, 1)
            hist_l = torch.where(ls4, hist_small, hist_big)
            hist_r = torch.where(ls4, hist_big, hist_small)

            # ---- children's outputs (smoothed toward the split leaf's
            # own value) and monotone bounds ----
            out_l, out_r = child_outputs(lsum, rsum, s["leaf_value"][sl], sp)
            bounds2 = None
            if mc_inter:
                out_l, out_r, bnd_l, bnd_r = intermediate_bounds(
                    s, sel_h, sl, feat, thr, fcat, new_ids, out_l, out_r)
                bounds2 = torch.cat([bnd_l, bnd_r])
            elif use_mc:
                m = torch.where(fcat, 0, mono[feat.long()])
                out_l, out_r, bl, br = basic_bounds(
                    out_l, out_r, s["leaf_mn"][sl], s["leaf_mx"][sl], m)
                bounds2 = torch.cat([torch.stack(bl, dim=1),
                                     torch.stack(br, dim=1)])

            # ---- children candidates: one batched scan over 2W ----
            child_depth = s["leaf_depth"][sl] + 1
            hists2 = torch.cat([hist_l, hist_r])
            sums2 = torch.cat([lsum, rsum])
            ids2 = torch.cat([2 * node_ids, 2 * node_ids + 1]).long()
            idx2 = torch.cat([sl, new_ids.long()])
            v2 = torch.cat([sel, sel])
            fm2, rb2 = node_inputs(ids2)
            if use_ic:
                path = s["leaf_path"][sl] | (
                    torch.arange(F, device=dev).unsqueeze(0) ==
                    feat.long().unsqueeze(1))
                path2 = torch.cat([path, path])
                fm2 = fm2 & interaction_allowed(groups, path2)
                _set_drop(s["leaf_path"], idx2, path2, v2)
            cegb2 = (lazy_costs(s, rl_old, sel_h, sl, feat, idx2, v2,
                                sums2) if use_lazy else None)
            # the reference's forced waves recheck the NaN-left gain with
            # the other fused product at some widths, and under monotone
            # bounds its children scans fuse the NaN-left gains' square
            # term at others (ops/split.py FORCED_NAN_LEFT_REFUSED,
            # MONOTONE_SMOOTH_NAN_LEFT_SQUARE)
            cands = many_candidates(
                hists2, sums2, fm2, rand_bins=rb2, bounds=bounds2,
                depths=torch.cat([child_depth, child_depth]),
                pouts=torch.cat([out_l, out_r]), cegb=cegb2,
                nan_left_refused=(forced is not None and
                                  W in FORCED_NAN_LEFT_REFUSED),
                nan_left_square=W in MONOTONE_SMOOTH_NAN_LEFT_SQUARE)
            depth_ok = (torch.ones_like(sel) if max_depth <= 0
                        else child_depth < max_depth)
            cg = torch.where(torch.cat([depth_ok, depth_ok]) &
                             torch.cat([sel, sel]), cands[0], neg_inf)

            # ---- state updates (invalid lanes dropped) ----
            _set_drop(s["hists"], sl, hist_l, sel)
            _set_drop(s["hists"], new_ids.long(), hist_r, sel)
            _set_drop(s["leaf_sum"], idx2, sums2, v2)
            _set_drop(s["leaf_depth"], idx2,
                      torch.cat([child_depth, child_depth]), v2)
            set_candidates(s, idx2, (cg,) + tuple(cands[1:]), v2)
            _set_drop(s["leaf_value"], idx2, torch.cat([out_l, out_r]), v2)
            _set_drop(s["leaf_weight"], idx2, sums2[:, 1], v2)
            _set_drop(s["leaf_count"], idx2, sums2[:, 2], v2)
            if use_mc and not mc_inter:
                _set_drop(s["leaf_mn"], idx2, bounds2[:, 0], v2)
                _set_drop(s["leaf_mx"], idx2, bounds2[:, 1], v2)

            # ---- tree node records ----
            nidx = node_ids.long()
            # a categorical node sends NaN (bin 0's side) as its member
            # bin 0 goes (reference wave.py:1652-1656)
            dleft_rec = torch.where(fcat, member[:, 0], dleft)
            dt_bits = (torch.where(fcat, CAT_MASK, 0) |
                       torch.where(dleft_rec, DEFAULT_LEFT_MASK, 0) |
                       torch.where(fnan & ~fcat, MISSING_NAN, 0)).to(_I32)
            for name, val in (("split_feature", feat),
                              ("threshold_bin", thr),
                              ("nan_bin", f_nan_bin),
                              ("cat_member", member),
                              ("decision_type", dt_bits),
                              ("split_gain", vals),
                              ("internal_value",
                               leaf_output(psum_[:, 0], psum_[:, 1], sp)),
                              ("internal_weight", psum_[:, 1]),
                              ("internal_count", psum_[:, 2])):
                _set_drop(s[name], nidx, val, sel)
            # patch parent slots pointing at the split leaves (encoded
            # -(leaf+1)), then write the new nodes' own slots
            enc = -(sl.to(_I32) + 1)
            for name, own in (("left_child", enc),
                              ("right_child", -(new_ids + 1))):
                arr = s[name]
                match = (arr.unsqueeze(1) == enc.unsqueeze(0)) & \
                    sel.unsqueeze(0)
                has = match.any(dim=1)
                pick = torch.argmax(match.to(torch.int8), dim=1)
                arr = torch.where(has, node_ids[pick], arr)
                _set_drop(arr, nidx, own, sel)
                s[name] = arr
            return total_new

        def intermediate_bounds(s, sel_h, sl, feat, thr, fcat, new_ids,
                                out_l, out_r):
            """Intermediate monotone constraints for a wave (reference
            wave.py:1444-1560, IntermediateLeafConstraints): each child
            is bounded by its SIBLING's output, and every new output caps
            the leaves whose region box touches the child's across one
            constrained feature.  The W splits are refined one after
            another on the host, so later slots see earlier slots'
            bounds.  Returns the children's outputs and (W, 2) bounds."""
            mn_all, mx_all = s["leaf_mn"].cpu(), s["leaf_mx"].cpu()
            ol_all, or_all = out_l.cpu(), out_r.cpu()
            sl_h, feat_h, thr_h = sl.cpu(), feat.cpu().long(), thr.cpu()
            fcat_h, new_h = fcat.cpu(), new_ids.cpu().long()
            mono_h = mono.cpu()
            inc, dec = (mono_h > 0).unsqueeze(0), (mono_h < 0).unsqueeze(0)
            bnd_l = torch.zeros((W, 2), dtype=_F32)
            bnd_r = torch.zeros((W, 2), dtype=_F32)
            for j in range(W):
                if not bool(sel_h[j]):
                    continue
                p, fj, r = int(sl_h[j]), int(feat_h[j]), int(new_h[j])
                mj = 0 if bool(fcat_h[j]) else int(mono_h[fj])
                pmn, pmx = mn_all[p].clone(), mx_all[p].clone()
                ol = torch.minimum(torch.maximum(ol_all[j], pmn), pmx)
                orr = torch.minimum(torch.maximum(or_all[j], pmn), pmx)
                # bounds tightened by earlier slots can cross a stale
                # candidate's outputs: collapse to the shared boundary
                if (mj > 0 and ol > orr) or (mj < 0 and ol < orr):
                    mid = torch.minimum(torch.maximum((ol + orr) / 2.0, pmn),
                                        pmx)
                    ol, orr = mid, mid
                mn_l = torch.maximum(pmn, orr) if mj < 0 else pmn
                mx_l = torch.minimum(pmx, orr) if mj > 0 else pmx
                mn_r = torch.maximum(pmn, ol) if mj > 0 else pmn
                mx_r = torch.minimum(pmx, ol) if mj < 0 else pmx
                lo_p, hi_p = box_lo[p].clone(), box_hi[p].clone()
                hi_l, lo_r = hi_p.clone(), lo_p.clone()
                if not bool(fcat_h[j]):
                    hi_l[fj] = thr_h[j]
                    lo_r[fj] = thr_h[j] + 1
                for c_lo, c_hi, c_out in ((lo_p, hi_l, ol), (lo_r, hi_p, orr)):
                    inter = (box_lo <= c_hi) & (box_hi >= c_lo)   # (L, F)
                    onlyf = ((~inter).sum(dim=1) == 1).unsqueeze(1) & ~inter
                    below = onlyf & (box_hi < c_lo)
                    above = onlyf & (box_lo > c_hi)
                    capmax = ((below & inc) | (above & dec)).any(dim=1)
                    capmin = ((above & inc) | (below & dec)).any(dim=1)
                    mx_all = torch.where(capmax, torch.minimum(mx_all, c_out),
                                         mx_all)
                    mn_all = torch.where(capmin, torch.maximum(mn_all, c_out),
                                         mn_all)
                mn_all[p], mn_all[r] = mn_l, mn_r
                mx_all[p], mx_all[r] = mx_l, mx_r
                box_hi[p], box_hi[r] = hi_l, hi_p
                box_lo[r] = lo_r
                ol_all[j], or_all[j] = ol, orr
                bnd_l[j, 0], bnd_l[j, 1] = mn_l, mx_l
                bnd_r[j, 0], bnd_r[j, 1] = mn_r, mx_r
            s["leaf_mn"] = mn_all.to(dev)
            s["leaf_mx"] = mx_all.to(dev)
            return (ol_all.to(dev), or_all.to(dev), bnd_l.to(dev),
                    bnd_r.to(dev))

        def lazy_costs(s, rl_old, sel_h, sl, feat, idx2, v2, sums2):
            """Lazy CEGB (reference wave.py:1574-1600): mark the wave's
            split features computed for every in-bag row of the split
            leaves, then charge each child the lazy penalty of every
            feature per in-bag row still unmarked.  Returns the (2W, F)
            per-child penalties (the coupled ones plus the lazy ones, one
            fused multiply-add as in the reference)."""
            used_b = s["used"]
            in_bag = bag_mask > 0
            leaf_feat = torch.full((L,), -1, dtype=torch.long, device=dev)
            _set_drop(leaf_feat, sl, feat.long(), sel_h.to(dev))
            row_feat = torch.where(in_bag, leaf_feat[rl_old.long()], -1)
            for f in sorted(set(feat.cpu()[sel_h].tolist())):
                used_b[f] |= _pack_bits(row_feat == f)
            rl = s["row_leaf"].long()
            cid = torch.where(v2, idx2, torch.full_like(idx2, L))
            used_cnt = torch.stack([
                torch.bincount(rl[_unpack_bits(used_b[f]) & in_bag],
                               minlength=L + 1)[cid]
                for f in range(F)]).to(_F32)                  # (F, 2W)
            unused = torch.clamp(sums2[:, 2].unsqueeze(0) - used_cnt,
                                 min=0.0)
            return _fma(lazy_pen.unsqueeze(1), unused,
                        cegb_full.unsqueeze(1)).t()

        def keep_waving(nl, done):
            go = (not done) and nl < L
            if use_endgame:
                # hand off to the endgame instead of tapering the wave
                go = go and nl + 2 * W <= L
            return go

        for fw in forced_waves:      # the ForceSplits prefix
            num_leaves_now += yield from body(s, num_leaves_now, forced=fw)
            hist_passes += 1
        done = False
        while keep_waving(num_leaves_now, done):
            total_new = yield from body(s, num_leaves_now)
            num_leaves_now += total_new
            done = total_new == 0
            hist_passes += 1

        if use_endgame:
            num_leaves_now, hist_passes = yield from _endgame(
                s, num_leaves_now, hist_passes, X_T, hist_waves,
                many_candidates, nb_full, hn_full, fm_row, neg_inf)

        if quantized and renew_leaf:
            # exact leaf-value renewal (reference wave.py:1936-1972): one
            # pass of the single-leaf kernel per 256 leaves, row_leaf % 256
            # as a one-feature bin column, replaces the quantized leaf sums
            # with exact sums for live, non-empty leaves
            rl = s["row_leaf"]
            bins1 = (rl % 256).to(torch.uint8).unsqueeze(0)
            parts = []
            for c in range((L + 255) // 256):
                m = bag_mask * (rl // 256 == c).to(bag_mask.dtype)
                wfx = pack_weights(grad, hess, m)
                h1 = yield kc.single(bins1, wfx, num_bins=256)
                parts.append(fx_to_f32(h1, wfx.inv_scale)[0])
            gh = torch.cat(parts)[:L, :2]
            # under smoothing the recorded (pre-renewal) value stands in
            # for the parent, as in the reference
            vals = leaf_output_smoothed(gh[:, 0], gh[:, 1], s["leaf_count"],
                                        s["leaf_value"], sp)
            if use_mc:
                vals = torch.minimum(torch.maximum(vals, s["leaf_mn"]),
                                     s["leaf_mx"])
            live = torch.arange(L, device=dev) < num_leaves_now
            ok = live & (s["leaf_count"] > 0)
            s["leaf_value"] = torch.where(ok, vals, s["leaf_value"])
            s["leaf_weight"] = torch.where(ok, gh[:, 1], s["leaf_weight"])

        tree = GrownTree(
            split_feature=s["split_feature"],
            threshold_bin=s["threshold_bin"], nan_bin=s["nan_bin"],
            decision_type=s["decision_type"],
            left_child=s["left_child"], right_child=s["right_child"],
            split_gain=s["split_gain"],
            internal_value=s["internal_value"],
            internal_weight=s["internal_weight"],
            internal_count=s["internal_count"],
            leaf_value=s["leaf_value"], leaf_weight=s["leaf_weight"],
            leaf_count=s["leaf_count"], num_leaves=int(num_leaves_now),
            row_leaf=s["row_leaf"], hist_passes=int(hist_passes),
            cat_member=s["cat_member"] if any_cat else None)
        return (tree, s["used"]) if use_lazy else tree

    # ---- exact endgame (reference wave.py:1710-1933) -----------------------
    def _endgame(s, num_leaves_now, hist_passes, X_T, hist_waves,
                 many_candidates, nb_full, hn_full, fm_row, neg_inf):
        dev = s["cand_gain"].device

        def pend0():
            z = torch.zeros((EG,), dtype=_I32, device=dev)
            return {"feat": z.clone(), "thr": z.clone(), "nan": z - 1,
                    "dleft": z.clone(), "leaf": z.clone(),
                    "newid": z.clone(), "act": z.clone()}

        def apply_pending(rl, pend, pcnt):
            """Flush committed endgame splits into row_leaf in commit order
            (a row rerouted by an earlier entry can be caught by a later
            one — parents precede children)."""
            if pcnt == 0:
                return rl
            for c in range(EG // W):
                sl_ = slice(c * W, (c + 1) * W)
                zero = torch.zeros((W,), dtype=_I32, device=dev)
                tab = torch.stack([pend["thr"][sl_], pend["nan"][sl_],
                                   pend["dleft"][sl_], zero,
                                   pend["leaf"][sl_], pend["newid"][sl_],
                                   pend["act"][sl_], zero]).contiguous()
                rl, _ = yield kc.row_update(
                    X_T, rl, tab, feats=pend["feat"][sl_],
                    bins_packed=pack4)
            return rl

        pend, pcnt = pend0(), 0
        while num_leaves_now < L and float(s["cand_gain"].max()) > 0:
            s["row_leaf"] = yield from apply_pending(s["row_leaf"], pend,
                                                     pcnt)
            pend, pcnt = pend0(), 0
            vals, sel_leaves = _topk(s["cand_gain"], W)
            sel = vals > 0
            feat = s["cand_feat"][sel_leaves]
            lsum = s["cand_lsum"][sel_leaves]
            rsum = s["cand_rsum"][sel_leaves]
            fnanb = torch.where(hn_full[feat.long()],
                                nb_full[feat.long()] - 1,
                                torch.full_like(feat, -1))
            small = lsum[:, 2] <= rsum[:, 2]
            ch = yield kc.trial(
                X_T, s["row_leaf"], sel_leaves,
                s["cand_bin"][sel_leaves], fnanb,
                s["cand_dleft"][sel_leaves], small, sel,
                feats=feat.to(_I32), bins_packed=pack4)
            bank = yield from hist_waves(ch)
            slot = torch.full((L,), -1, dtype=torch.long, device=dev)
            _set_drop(slot, sel_leaves,
                      torch.arange(W, device=dev), sel)
            slot_h = slot.cpu().numpy()
            while True:
                b = int(torch.argmax(s["cand_gain"]))
                if not (num_leaves_now < L and
                        float(s["cand_gain"][b]) > 0 and slot_h[b] >= 0):
                    break
                _commit(s, b, int(slot_h[b]), bank, num_leaves_now,
                        many_candidates, nb_full, hn_full, fm_row, neg_inf,
                        pend, pcnt)
                slot_h[b] = -1
                slot_h[num_leaves_now] = -1
                num_leaves_now += 1
                pcnt += 1
            hist_passes += 1
        s["row_leaf"] = yield from apply_pending(s["row_leaf"], pend, pcnt)
        return num_leaves_now, hist_passes

    def _commit(s, b, slot_b, bank, nl0, many_candidates, nb_full, hn_full,
                fm_row, neg_inf, pend, pcnt):
        """Commit the global best candidate ``b`` (reference wave.py
        ``_make_commit``)."""
        # copies: the rows are overwritten below
        gain, feat, thr, dleft, lsum, rsum, psum_ = (
            s[k][b].clone() for k in ("cand_gain", "cand_feat", "cand_bin",
                                      "cand_dleft", "cand_lsum",
                                      "cand_rsum", "leaf_sum"))
        new_id, node = nl0, nl0 - 1
        fnan = hn_full[feat.long()]
        f_nan_bin = torch.where(fnan, nb_full[feat.long()] - 1,
                                torch.full_like(feat, -1))
        left_smaller = lsum[2] <= rsum[2]
        hist_small = bank[slot_b]
        hist_big = histogram_subtract(s["hists"][b], hist_small)
        hist_l = torch.where(left_smaller, hist_small, hist_big)
        hist_r = torch.where(left_smaller, hist_big, hist_small)
        child_depth = s["leaf_depth"][b] + 1
        out_l, out_r = child_outputs(lsum, rsum, s["leaf_value"][b], sp)
        sums2 = torch.stack([lsum, rsum])
        cnds = many_candidates(torch.stack([hist_l, hist_r]), sums2,
                               fm_row.expand(2, fm_row.shape[0]),
                               depths=child_depth.expand(2),
                               pouts=torch.stack([out_l, out_r]))
        cg2 = cnds[0]
        if max_depth > 0:
            cg2 = torch.where(child_depth < max_depth, cg2, neg_inf)
        idx2 = torch.tensor([b, new_id], device=bank.device)
        s["hists"][b] = hist_l
        s["hists"][new_id] = hist_r
        s["leaf_sum"][idx2] = sums2
        s["leaf_depth"][idx2] = child_depth
        for name, val in zip(CAND_NAMES, (cg2,) + tuple(cnds[1:])):
            s[name][idx2] = val.to(s[name].dtype)
        s["leaf_value"][idx2] = torch.stack([out_l, out_r])
        s["leaf_weight"][idx2] = sums2[:, 1]
        s["leaf_count"][idx2] = sums2[:, 2]
        dt_bits = (torch.where(dleft, DEFAULT_LEFT_MASK, 0) |
                   torch.where(fnan, MISSING_NAN, 0)).to(_I32)
        lc, rc = patch_child_pointers(s["left_child"], s["right_child"], b,
                                      node)
        write_split_records(
            s, node=node, leaf=b, new_id=new_id, feat=feat, thr=thr,
            f_nan_bin=f_nan_bin, dt_bits=dt_bits, gain=gain,
            internal_value=leaf_output(psum_[0], psum_[1], sp),
            internal_weight=psum_[1], internal_count=psum_[2],
            left_child=lc, right_child=rc)
        for k_, v_ in (("feat", feat), ("thr", thr), ("nan", f_nan_bin),
                       ("dleft", dleft.to(_I32)), ("leaf", b),
                       ("newid", new_id), ("act", 1)):
            pend[k_][pcnt] = v_

    def grow(*args, **kwargs):
        return kc.run_single(grow_gen(*args, **kwargs))

    grow.gen = grow_gen
    return grow
