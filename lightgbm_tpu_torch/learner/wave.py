"""Wave grower — leaf-wise growth with no physical row movement.

Port of ``lightgbm_tpu/learner/wave.py`` ``make_wave_grow_fn`` for the
serial, numeric, non-EFB configuration.  Growth proceeds in *waves*: each
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
* exact (f32) and quantized (int8 -> int32, deterministic rounding)
  histograms.

The reference runs the whole tree inside one jitted ``lax.while_loop``;
here PyTorch runs eagerly and the host drives the loops, reading the leaf
count once per wave and the best candidate once per endgame commit.

Raise ``NotImplementedError`` (ROADMAP queue 1, item 5): voting and
scatter merges, lazy CEGB, forced splits, interaction constraints,
by-node sampling and extra-trees (both draw from ``jax.random`` in the
reference), monotone constraints, categorical features, EFB, packed 4-bit
bins and quantized leaf renewal.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..models.tree import DEFAULT_LEFT_MASK, MISSING_NAN
from ..ops.histogram import histogram_subtract
from ..ops.histogram_cuda import (LEAF_CHANNELS, Q_LEAF_CHANNELS,
                                  build_histogram_leaves,
                                  build_histogram_leaves_q8, pack_weights,
                                  wave_row_update, wave_trial_channels)
from ..ops.quantize import dequant_scales, quantize_wch
from ..ops.split import (NEG_INF, SplitParams, check_supported, leaf_gain,
                         leaf_output, local_best_candidates)
from .endgame import patch_child_pointers, write_split_records
from .serial import GrownTree

__all__ = ["make_wave_grow_fn", "WAVE_SIZE", "Q_WAVE_SIZE", "wave_taper_k"]

WAVE_SIZE = LEAF_CHANNELS        # 25 leaves per exact pass
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
                      pack4: bool = False, interpret=None, pipeline=None):
    """Build the wave single-tree grower.

    Returns ``grow(X_T, grad, hess, bag_mask, num_bins, has_nan,
    feature_mask) -> GrownTree`` with ``X_T`` the FEATURE-MAJOR (F, N)
    uint8 bin matrix, N a multiple of the 4096-row block, and every tensor
    on one device.  ``interpret``/``pipeline`` are the reference's
    TPU-kernel knobs, accepted and ignored."""
    check_supported(split_params)
    if pack4:
        raise NotImplementedError(
            "packed 4-bit bins are not ported to lightgbm_tpu_torch yet "
            "(ROADMAP queue 2: packed bins)")
    if quantized and renew_leaf:
        raise NotImplementedError(
            "quant_train_renew_leaf needs the single-leaf histogram kernel "
            "(build_histogram_pallas), not ported yet (ROADMAP queue 2, "
            "kernel 5)")
    if quantized and stochastic:
        raise NotImplementedError(
            "stochastic_rounding=true needs the reference's jax.random "
            "threefry stream (ROADMAP queue 1, item 2); set "
            "stochastic_rounding=false")
    if max_bins > 256:
        raise NotImplementedError("the wave kernels take uint8 bins "
                                  "(max_bin <= 255)")
    L = num_leaves
    F = num_features
    Bb = max_bins
    sp = split_params
    ch_cap = Q_WAVE_SIZE if quantized else WAVE_SIZE
    W = max(1, min(int(wave_size) or ch_cap, ch_cap, L - 1))
    use_spec = (spec_ramp and max_depth <= 0 and W >= 2 and L >= 3 * W)
    use_endgame = exact_endgame and L > 2
    EG = 2 * W   # pending-commit capacity (budget < 2W at endgame entry)

    def grow(X_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
             bag_mask: torch.Tensor, num_bins: torch.Tensor,
             has_nan: torch.Tensor, feature_mask: torch.Tensor
             ) -> GrownTree:
        dev = X_T.device
        n = X_T.shape[1]
        nb_full = num_bins.to(_I32)
        hn_full = has_nan
        zf = torch.zeros((), dtype=_F32, device=dev)
        neg_inf = torch.full((), NEG_INF, dtype=_F32, device=dev)

        def take_cols(feats: torch.Tensor) -> torch.Tensor:
            return X_T.index_select(0, feats.long())

        gm = (grad * bag_mask).float()
        hm = (hess * bag_mask).float()
        cnt_mask = (bag_mask > 0).float()
        if quantized:
            # per-tree linear quantization scales
            # (gradient_discretizer.cpp DiscretizeGradients)
            g_scale = torch.clamp(gm.abs().max(), min=1e-30) / gq_max
            h_scale = torch.clamp(hm.max(), min=1e-30) / hq_max
            qscales = dequant_scales(g_scale, h_scale)
            w_all = quantize_wch(grad, hess, bag_mask, g_scale, h_scale,
                                 gq_max=gq_max, hq_max=hq_max,
                                 stochastic=False)
        else:
            w_all = pack_weights(grad, hess, bag_mask)

        def dq(h):
            """int32 channel sums -> f32 (sum_grad, sum_hess, count)."""
            return h.float() * qscales if quantized else h

        def hist_kernel(bins, w, ch):
            if quantized:
                return build_histogram_leaves_q8(bins, w, ch, num_bins=Bb)
            return build_histogram_leaves(bins, w, ch, num_bins=Bb)

        def hist_waves(ch, k=W, with_totals=False):
            """(k, F, Bb, 3) histograms of the wave's leaf channels
            (quantized: exact int32 channel sums) and, optionally, the
            (k, 3) f32 channel totals from feature 0's bins."""
            hk = hist_kernel(X_T, w_all, ch)[:k]
            if not with_totals:
                return hk
            return hk, dq(hk[:, 0].sum(dim=1).to(hk.dtype))

        def many_candidates(hists, sums, fms):
            """Best-split candidates for a batch of leaves (the f32 scan
            form of the histograms)."""
            return local_best_candidates(dq(hists), sums, nb_full, hn_full,
                                         fms, sp)

        fm_row = feature_mask.to(torch.bool)
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
                "hists": z((L, F, Bb, 3), hdtype),
                "split_feature": z((L - 1,), _I32, -1),
                "threshold_bin": z((L - 1,), _I32),
                "nan_bin": z((L - 1,), _I32, -1),
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
            for name, val in zip(("cand_gain", "cand_feat", "cand_bin",
                                  "cand_dleft", "cand_lsum", "cand_rsum"),
                                 cands):
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
            X_ss = X_T[:, ::stride][:, :n_ss].contiguous()
            if quantized:
                w_ss = w_all[:, ::stride][:, :n_ss].contiguous()
            else:
                w_ss = w_all._replace(
                    w=w_all.w[:, ::stride][:, :n_ss].contiguous())
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
                rl_ss, _ = wave_row_update(
                    X_ss.index_select(0, feats_cl.long()), rl_ss, tab)
                tabs.append((tab, feats_cl))
                nlp = nlp + int(prefix[-1])

            # route ALL rows through the provisional tree
            rl_full = torch.zeros((n,), dtype=_I32, device=dev)
            for tab, feats_cl in tabs:
                rl_full, _ = wave_row_update(take_cols(feats_cl), rl_full,
                                             tab)

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
            if quantized:
                rh, rtot = hist_waves(zch, k=1, with_totals=True)
                root_hist, root_sum = rh[0], rtot[0]
            else:
                root_hist = hist_waves(zch, k=1)[0]
                root_sum = torch.stack([gm.sum(), hm.sum(), cnt_mask.sum()])
            root_out = leaf_output(root_sum[0], root_sum[1], sp)
            cand = many_candidates(root_hist.unsqueeze(0),
                                   root_sum.unsqueeze(0),
                                   fm_row.unsqueeze(0))
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
            psum_ = s["leaf_sum"][sl]
            prefix = torch.cumsum(sel.to(_I32), 0).to(_I32)
            total_new = int(prefix[-1])
            new_ids = nl0 + prefix - 1
            node_ids = (nl0 - 1) + prefix - 1
            left_smaller = lsum[:, 2] <= rsum[:, 2]
            fnan = hn_full[feat.long()]
            f_nan_bin = torch.where(fnan, nb_full[feat.long()] - 1,
                                    torch.full_like(feat, -1))

            # ---- row_leaf + wave-channel update: one kernel pass ----
            tab = torch.stack([
                thr, f_nan_bin, dleft.to(_I32), left_smaller.to(_I32),
                sl.to(_I32), new_ids, sel.to(_I32),
                torch.zeros_like(thr)]).contiguous()
            s["row_leaf"], ch = wave_row_update(take_cols(feat),
                                                s["row_leaf"], tab)

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
            cands = many_candidates(hists2, sums2, fm_row.expand(2 * W, F))
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
            dt_bits = (torch.where(dleft, DEFAULT_LEFT_MASK, 0) |
                       torch.where(fnan, MISSING_NAN, 0)).to(_I32)
            for name, val in (("split_feature", feat),
                              ("threshold_bin", thr),
                              ("nan_bin", f_nan_bin),
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
                s, num_leaves_now, hist_passes, take_cols, hist_waves,
                many_candidates, nb_full, hn_full, fm_row, neg_inf)

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
            row_leaf=s["row_leaf"], hist_passes=int(hist_passes))

    # ---- exact endgame (reference wave.py:1710-1933) -----------------------
    def _endgame(s, num_leaves_now, hist_passes, take_cols, hist_waves,
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
                rl, _ = wave_row_update(take_cols(pend["feat"][sl_]), rl,
                                        tab)
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
                take_cols(feat), s["row_leaf"], sel_leaves,
                s["cand_bin"][sel_leaves], fnanb,
                s["cand_dleft"][sel_leaves], small, sel)
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
        for name, val in zip(("cand_gain", "cand_feat", "cand_bin",
                              "cand_dleft", "cand_lsum", "cand_rsum"),
                             (cg2,) + tuple(cnds[1:])):
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
