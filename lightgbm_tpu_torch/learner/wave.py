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

The reference runs the whole tree inside one jitted ``lax.while_loop``;
here PyTorch runs eagerly and the host drives the loops, reading the leaf
count once per wave and the best candidate once per endgame commit.

Not ported (ROADMAP queue 1; refused before the grower is built): voting
and scatter merges, lazy CEGB, forced splits, interaction constraints and
monotone constraints.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..efb import make_expand_hist
from ..models.tree import CAT_MASK, DEFAULT_LEFT_MASK, MISSING_NAN
from ..ops.histogram import (PACK4_MAX_BINS, histogram_subtract,
                             pack_weights)
from ..ops.histogram_cuda import (LEAF_CHANNELS, Q_LEAF_CHANNELS,
                                  build_histogram, build_histogram_leaves,
                                  build_histogram_leaves_q8, split_decode,
                                  wave_row_update, wave_trial_channels)
from ..ops.quantize import dequant_scales, quant_scales, quantize_wch
from ..ops.split import (NEG_INF, SplitParams, check_supported, leaf_gain,
                         leaf_output, local_best_candidates, node_draws)
from .endgame import patch_child_pointers, write_split_records
from .serial import GrownTree

__all__ = ["make_wave_grow_fn", "WAVE_SIZE", "Q_WAVE_SIZE", "wave_taper_k"]

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
                      pack4: bool = False, efb=None):
    """Build the wave single-tree grower.

    Returns ``grow(X_T, grad, hess, bag_mask, num_bins, has_nan,
    feature_mask, quant_key=None, node_key=None, is_cat=None) ->
    GrownTree`` with ``X_T`` the FEATURE-MAJOR (G, N) uint8 bin matrix (G
    = F, or the bundles of ``efb``, an ``efb.EfbArrays``), N a multiple of
    the 4096-row block, ``is_cat`` the (F,) categorical flags (read when
    ``split_params.any_cat``) and every tensor on one device.
    ``quant_key`` keys the tree's stochastic rounding; ``node_key`` holds
    the keys of the by-node sampling stream ([0]) and the extra-trees
    stream ([1]) (host keys or (2,) tensors, utils/random.py).  Under ``pack4`` ``X_T`` is
    the nibble-packed (F, N/2) matrix (ops/histogram.py ``pack_bins4``).
    The reference's ``tpu_pallas_pipeline`` knob reaches the grower only
    through ``pack4`` (the learner turns packing off for ``blockspec``);
    the kernels have one form per bin layout."""
    check_supported(split_params)
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
    # the per-node streams, categorical features and EFB keep the plain
    # ramp and the tapered waves, as the reference gates them
    # (wave.py:339-365)
    plain = use_bynode or use_et or any_cat or use_efb or max_bins > 255
    use_spec = (spec_ramp and max_depth <= 0 and W >= 2 and L >= 3 * W and
                not plain)
    use_endgame = exact_endgame and L > 2 and not plain
    EG = 2 * W   # pending-commit capacity (budget < 2W at endgame entry)

    def grow(X_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
             bag_mask: torch.Tensor, num_bins: torch.Tensor,
             has_nan: torch.Tensor, feature_mask: torch.Tensor,
             quant_key=None, node_key=None, is_cat=None) -> GrownTree:
        dev = X_T.device
        n = X_T.shape[1] * 2 if pack4 else X_T.shape[1]
        nb_full = num_bins.to(_I32)
        hn_full = has_nan
        ic_full = (is_cat.to(torch.bool) if any_cat and is_cat is not None
                   else torch.zeros((F,), dtype=torch.bool, device=dev))
        zf = torch.zeros((), dtype=_F32, device=dev)
        neg_inf = torch.full((), NEG_INF, dtype=_F32, device=dev)

        def route(bins, rl, tab, feats, member=None):
            """The row update reading the split columns of ``bins`` in
            place (packed under ``pack4``); under categorical features or
            EFB its categorical / EFB form, which reads each feature's
            bundle column, decodes it and decides categorical splits by
            the (W, B) ``member`` table."""
            if not ext_rows:
                return wave_row_update(bins, rl, tab, feats=feats.to(_I32),
                                       bins_packed=pack4)
            fl = feats.long()
            if use_efb:
                col = efb.f_bundle[fl]
                dec = (efb.f_offset[fl], efb.f_nbins[fl],
                       efb.f_default[fl], efb.f_single[fl])
            else:
                col = feats
                dec = (torch.zeros_like(feats), nb_full[fl],
                       torch.zeros_like(feats), torch.ones_like(feats))
            return wave_row_update(
                bins, rl, tab, feats=col.to(_I32),
                decode=split_decode(ic_full[fl], member, *dec))

        gm = (grad * bag_mask).float()
        hm = (hess * bag_mask).float()
        cnt_mask = (bag_mask > 0).float()
        if quantized:
            # per-tree linear quantization scales
            # (gradient_discretizer.cpp DiscretizeGradients)
            g_scale, h_scale = quant_scales(gm.abs().max(), hm.max(),
                                            gq_max, hq_max)
            qscales = dequant_scales(g_scale, h_scale)
            w_all = quantize_wch(grad, hess, bag_mask, g_scale, h_scale,
                                 quant_key, gq_max=gq_max, hq_max=hq_max,
                                 stochastic=stochastic)
        else:
            w_all = pack_weights(grad, hess, bag_mask)

        def dq(h):
            """int32 channel sums -> f32 (sum_grad, sum_hess, count)."""
            return h.float() * qscales if quantized else h

        def hist_kernel(bins, w, ch):
            if quantized:
                return build_histogram_leaves_q8(bins, w, ch, num_bins=Bb,
                                                 bins_packed=pack4)
            return build_histogram_leaves(bins, w, ch, num_bins=Bb,
                                          bins_packed=pack4)

        def hist_waves(ch, k=W, with_totals=False):
            """(k, F, Bb, 3) histograms of the wave's leaf channels
            (quantized: exact int32 channel sums) and, optionally, the
            (k, 3) f32 channel totals from feature 0's bins."""
            hk = hist_kernel(X_T, w_all, ch)[:k]
            if not with_totals:
                return hk
            return hk, dq(hk[:, 0].sum(dim=1).to(hk.dtype))

        def many_candidates(hists, sums, fms, sums_exact=None,
                            rand_bins=None):
            """Best-split candidates for a batch of leaves: the scan on
            the dequantized histograms, expanded to feature space under
            EFB (the reference's ``_scan_hists``, wave.py:591-599)."""
            return local_best_candidates(
                expand(dq(hists), sums), sums, nb_full, hn_full,
                fms, sp, sums_exact, rand_bins,
                ic_full if any_cat else None)

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
            stride = max(1, n // max(int(spec_subsample), 4096))
            n_ss = max((n // stride) // 4096 * 4096, 4096)

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

            X_ss = (X_T[:, ::stride][:, :n_ss // 2].contiguous() if pack4
                    else subsample(X_T))
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
                h_ss = hist_kernel(X_ss, w_ss, rl_ss.to(torch.int8))[:Kc]
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
                rl_ss, _ = route(X_ss, rl_ss, tab, feats_cl)
                tabs.append((tab, feats_cl))
                nlp = nlp + int(prefix[-1])

            # route ALL rows through the provisional tree
            rl_full = torch.zeros((n,), dtype=_I32, device=dev)
            for tab, feats_cl in tabs:
                rl_full, _ = route(X_T, rl_full, tab, feats_cl)

            # ONE full-data pass: exact per-prov-leaf channel sums
            h_ch, leaf_tot = hist_waves(rl_full.to(torch.int8), k=Kc,
                                        with_totals=True)
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
                rh, rtot = hist_waves(zch, k=1, with_totals=True)
                root_hist, root_sum = rh[0], rtot[0]
                # the dequantized totals unrounded (f32(int) x f32 scale
                # is exact in float64): the reference's jitted root scan
                # fuses this multiply into its right-side subtractions
                root_exact = (root_hist[0].sum(dim=0).float().double() *
                              qscales.double())
            else:
                root_hist = hist_waves(zch, k=1)[0]
                root_sum = torch.stack([gm.sum(), hm.sum(), cnt_mask.sum()])
            root_out = leaf_output(root_sum[0], root_sum[1], sp)
            fm0, rb0 = node_inputs(torch.full((1,), 2 * L,
                                              dtype=torch.int64, device=dev))
            cand = many_candidates(
                root_hist.unsqueeze(0), root_sum.unsqueeze(0), fm0,
                None if root_exact is None else root_exact.unsqueeze(0),
                rb0)
            s = empty_state()
            s["leaf_sum"][0] = root_sum
            set_candidates(s, torch.zeros((1,), dtype=torch.long,
                                          device=dev), cand)
            s["hists"][0] = root_hist
            s["leaf_value"][0] = root_out
            s["leaf_weight"][0] = root_sum[1]
            s["leaf_count"][0] = root_sum[2]
            return s, 1, 1

        if use_spec:
            s, num_leaves_now, hist_passes = spec_state()
        else:
            s, num_leaves_now, hist_passes = root_state()

        jarange = torch.arange(W, dtype=_I32, device=dev)

        # ---- one wave ----------------------------------------------------
        def body(s, nl0):
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
            member = s["cand_member"][sl]                  # (W, B)
            psum_ = s["leaf_sum"][sl]
            prefix = torch.cumsum(sel.to(_I32), 0).to(_I32)
            total_new = int(prefix[-1])
            new_ids = nl0 + prefix - 1
            node_ids = (nl0 - 1) + prefix - 1
            left_smaller = lsum[:, 2] <= rsum[:, 2]
            fnan = hn_full[feat.long()]
            fcat = ic_full[feat.long()]
            f_nan_bin = torch.where(fnan, nb_full[feat.long()] - 1,
                                    torch.full_like(feat, -1))

            # ---- row_leaf + wave-channel update: one kernel pass ----
            tab = torch.stack([
                thr, f_nan_bin, dleft.to(_I32), left_smaller.to(_I32),
                sl.to(_I32), new_ids, sel.to(_I32),
                torch.zeros_like(thr)]).contiguous()
            s["row_leaf"], ch = route(X_T, s["row_leaf"], tab, feat, member)

            # ---- one kernel pass: all W smaller-child histograms ----
            hist_small = hist_waves(ch)
            hist_big = histogram_subtract(s["hists"][sl], hist_small)
            ls4 = left_smaller.view(W, 1, 1, 1)
            hist_l = torch.where(ls4, hist_small, hist_big)
            hist_r = torch.where(ls4, hist_big, hist_small)

            out_l = leaf_output(lsum[:, 0], lsum[:, 1], sp)
            out_r = leaf_output(rsum[:, 0], rsum[:, 1], sp)

            # ---- children candidates: one batched scan over 2W ----
            child_depth = s["leaf_depth"][sl] + 1
            hists2 = torch.cat([hist_l, hist_r])
            sums2 = torch.cat([lsum, rsum])
            ids2 = torch.cat([2 * node_ids, 2 * node_ids + 1]).long()
            fm2, rb2 = node_inputs(ids2)
            cands = many_candidates(hists2, sums2, fm2, rand_bins=rb2)
            depth_ok = (torch.ones_like(sel) if max_depth <= 0
                        else child_depth < max_depth)
            cg = torch.where(torch.cat([depth_ok, depth_ok]) &
                             torch.cat([sel, sel]), cands[0], neg_inf)

            # ---- state updates (invalid lanes dropped) ----
            idx2 = torch.cat([sl, new_ids.long()])
            v2 = torch.cat([sel, sel])
            _set_drop(s["hists"], sl, hist_l, sel)
            _set_drop(s["hists"], new_ids.long(), hist_r, sel)
            _set_drop(s["leaf_sum"], idx2, sums2, v2)
            _set_drop(s["leaf_depth"], idx2,
                      torch.cat([child_depth, child_depth]), v2)
            set_candidates(s, idx2, (cg,) + tuple(cands[1:]), v2)
            _set_drop(s["leaf_value"], idx2, torch.cat([out_l, out_r]), v2)
            _set_drop(s["leaf_weight"], idx2, sums2[:, 1], v2)
            _set_drop(s["leaf_count"], idx2, sums2[:, 2], v2)

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

        def keep_waving(nl, done):
            go = (not done) and nl < L
            if use_endgame:
                # hand off to the endgame instead of tapering the wave
                go = go and nl + 2 * W <= L
            return go

        done = False
        while keep_waving(num_leaves_now, done):
            total_new = body(s, num_leaves_now)
            num_leaves_now += total_new
            done = total_new == 0
            hist_passes += 1

        if use_endgame:
            num_leaves_now, hist_passes = _endgame(
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
                parts.append(build_histogram(bins1, grad, hess, m,
                                             num_bins=256)[0])
            gh = torch.cat(parts)[:L, :2]
            vals = leaf_output(gh[:, 0], gh[:, 1], sp)
            live = torch.arange(L, device=dev) < num_leaves_now
            ok = live & (s["leaf_count"] > 0)
            s["leaf_value"] = torch.where(ok, vals, s["leaf_value"])
            s["leaf_weight"] = torch.where(ok, gh[:, 1], s["leaf_weight"])

        return GrownTree(
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
                rl, _ = wave_row_update(X_T, rl, tab, feats=pend["feat"][sl_],
                                        bins_packed=pack4)
            return rl

        pend, pcnt = pend0(), 0
        while num_leaves_now < L and float(s["cand_gain"].max()) > 0:
            s["row_leaf"] = apply_pending(s["row_leaf"], pend, pcnt)
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
            ch = wave_trial_channels(
                X_T, s["row_leaf"], sel_leaves,
                s["cand_bin"][sel_leaves], fnanb,
                s["cand_dleft"][sel_leaves], small, sel,
                feats=feat.to(_I32), bins_packed=pack4)
            bank = hist_waves(ch)
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
        s["row_leaf"] = apply_pending(s["row_leaf"], pend, pcnt)
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
        out_l = leaf_output(lsum[0], lsum[1], sp)
        out_r = leaf_output(rsum[0], rsum[1], sp)
        sums2 = torch.stack([lsum, rsum])
        cnds = many_candidates(torch.stack([hist_l, hist_r]), sums2,
                               fm_row.expand(2, fm_row.shape[0]))
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

    return grow
