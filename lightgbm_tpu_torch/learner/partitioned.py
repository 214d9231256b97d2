"""Partition-ordered leaf-wise tree grower.

Port of ``lightgbm_tpu/learner/partitioned.py`` ``make_partitioned_grow_fn``
for the serial learner: the exact sequential leaf-wise path (best-first
by gain, one split at a time, the growth order of LightGBM's
serial_tree_learner.cpp:158-209).

As in the reference, the PACKED ROW DATA itself is kept leaf-contiguous
(the analog of LightGBM's DataPartition, data_partition.hpp:170): each
leaf owns one segment ``[start, start + cnt)`` of the row-major bin matrix
``P`` (N, F), of the tree's fixed-point weights (3, N) and of the original
row index.  A split stably partitions only its leaf's segment, lefts
first; the smaller child's histogram then reads its contiguous segment in
place, ``P[s:e].T`` with the kernel reading both strides (no gather, no
transpose copy), and the larger child comes from the subtraction trick
(serial_tree_learner.cpp:311-320).

Differences from the reference, none of which changes growth:

* The histograms are the single-leaf kernel's int64 fixed-point sums
  (ops/histogram_cuda.py ``hist_single``) with one scale per tree, kept in
  the pool as integers, so parent minus child is exact; they are scaled to
  f32 for the split scan.
* The partition of a segment is a cumulative-sum rank and one
  ``index_copy_`` per array, not the reference's chunked ``lax.sort`` and
  staged stores: PyTorch runs eagerly on the segment's real length, so the
  reference's static chunk shapes (``CHUNK_BULK``, ``CHUNK_TAIL``) have no
  counterpart and no segment spans several chunks.
* The host drives the loop and reads two things per split: the best leaf
  (with its gain and which child is smaller) and the left child's row
  count.  ``GrownTree.host_syncs`` counts those reads per tree.

By-node feature sampling and extra-trees thresholds draw one node at a
time from the ``node_key`` streams (ids 2L for the root, 2t and 2t+1 for
the children of split t; reference partitioned.py:174-195), the draws the
wave grower batches over a wave.

Categorical features and EFB bundles (reference partitioned.py:79-83,
:264-285, :396-403, :535): the rows hold one byte per bundle, the
single-leaf histograms are built in bundle space (G, Bb) and expanded to
feature space before each scan (efb.py ``make_expand_hist``; the
fixed-point sums make each default-bin fix exact), and a split decides
its rows on the feature's decoded bin, by membership for a categorical
split.

The split options (reference partitioned.py:101-155, :440-471,
:613-614): basic monotone bounds, path smoothing, interaction
constraints (each leaf's path of used features limits its children's
scan), CEGB and ``feature_contri`` through the scan, and forced splits
as the first ``n_forced`` steps of the loop: a fixed (leaf, feature, bin)
split whatever its gain, its child sums read from the leaf's pooled
histogram.
"""

from __future__ import annotations

import torch

from ..efb import make_bundle_decode, make_expand_hist
from ..models.tree import CAT_MASK, DEFAULT_LEFT_MASK, MISSING_NAN
from ..ops.histogram import (FxWeights, fx_to_f32, pack_weights, take_rows,
                             widen_bins)
from ..ops.split import (BIG, NEG_INF, SplitParams, cumsum_bins, leaf_gain,
                         leaf_output, leaf_output_smoothed, node_draws)
from . import lanes as kc
from .endgame import patch_child_pointers, write_split_records
from .serial import (CommStrategy, GrownTree, basic_bounds, child_outputs,
                     interaction_allowed, interaction_groups_mask)

__all__ = ["make_partitioned_grow_fn"]

_I32 = torch.int32
_F32 = torch.float32


def make_partitioned_grow_fn(*, num_leaves: int, num_features: int,
                             max_bins: int, max_depth: int,
                             split_params: SplitParams, efb=None,
                             forced_splits: tuple = (),
                             interaction_groups: tuple = (),
                             feature_contri: tuple = ()):
    """Build the partition-ordered single-tree grower.

    Returns ``grow(X, grad, hess, bag_mask, num_bins, has_nan,
    feature_mask, node_key=None, is_cat=None, monotone=None,
    cegb_penalty=None) -> GrownTree`` with ``X`` the ROW-MAJOR (N, G)
    uint8 or uint16 bin matrix (G = F, or the bundles of ``efb``, an
    ``efb.EfbArrays``; left untouched: the grower reorders a copy) and
    every tensor on one device; ``node_key`` holds the keys of the
    by-node and extra-trees streams, ``is_cat`` the (F,) categorical
    flags (read when ``split_params.any_cat``), ``monotone`` the (F,)
    constraint directions and ``cegb_penalty`` the (F,) coupled CEGB
    penalties.  ``forced_splits`` are BFS (leaf, inner feature, bin)
    triples, ``interaction_groups`` tuples of inner features and
    ``feature_contri`` (F,) gain scales.  The histogram wrapper runs the
    CUDA kernel on a card and its plain version on the CPU.  ``grow.gen``
    is the same grower as a generator of kernel requests
    (learner/lanes.py)."""
    L = num_leaves
    F = num_features
    Bb = efb.bundle_bins if efb is not None else max_bins
    sp = split_params
    any_cat = bool(sp.any_cat)
    expand = make_expand_hist(efb, F)
    decode = make_bundle_decode(efb)
    use_mc = sp.use_monotone
    use_ic = len(interaction_groups) > 0
    n_forced = min(len(forced_splits), L - 1)

    def grow_gen(X: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                 bag_mask: torch.Tensor, num_bins: torch.Tensor,
                 has_nan: torch.Tensor, feature_mask: torch.Tensor,
                 node_key=None, is_cat=None, monotone=None,
                 cegb_penalty=None):
        dev = X.device
        n = X.shape[0]
        G = X.shape[1]
        nb = num_bins.to(_I32)
        hn = has_nan.to(torch.bool)
        fm = feature_mask.to(torch.bool)
        ic = (is_cat.to(torch.bool) if any_cat and is_cat is not None
              else torch.zeros((F,), dtype=torch.bool, device=dev))
        mono = (monotone.to(_I32) if use_mc
                else torch.zeros((F,), dtype=_I32, device=dev))
        strat = CommStrategy(
            nb, hn, ic if any_cat else None,
            monotone=mono if use_mc else None,
            cegb=cegb_penalty if sp.use_cegb else None,
            contri=(torch.tensor(feature_contri, dtype=_F32, device=dev)
                    if feature_contri else None))
        groups = (interaction_groups_mask(interaction_groups, F, dev)
                  if use_ic else None)

        def node_inputs(first: int, k: int):
            """The scan's feature masks and extra-trees bins of the nodes
            ``first .. first + k - 1`` (ids made on the device: a host
            tensor would wait for the device's queue)."""
            ids = torch.arange(k, dtype=torch.int64, device=dev) + first
            return node_draws(node_key, ids, fm, nb, sp)

        # ---- pack rows: bins | fixed-point g*bag, h*bag, bag | orig idx ----
        P = X.clone()
        # the partition moves uint16 rows through an int16 view (the same
        # bits; PyTorch's index_copy_ does not take uint16)
        Pm = P.view(torch.int16) if P.dtype == torch.uint16 else P
        wfx = pack_weights(grad, hess, bag_mask)   # reads two maxima
        syncs = 2
        Wt, inv = wfx.w, wfx.inv_scale
        order = torch.arange(n, device=dev)

        def hist_of(start: int, cnt: int) -> torch.Tensor:
            """(G, Bb, 3) int64 histogram of one contiguous segment."""
            e = start + cnt
            return (yield kc.single(P[start:e].t(),
                                    FxWeights(Wt[:, start:e], inv),
                                    num_bins=Bb))

        def scan_form(h: torch.Tensor) -> torch.Tensor:
            """A leaf's (F, B, 3) f32 scan histogram: expanded to feature
            space in the fixed-point integers (any bundle's bins sum to the
            leaf's total), then scaled."""
            return fx_to_f32(expand(h, h[0].sum(dim=0)), inv)

        def z(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        s = {
            "leaf_sum": z((L, 3), _F32),
            "cand_gain": z((L,), _F32, NEG_INF),
            "cand_feat": z((L,), _I32),
            "cand_bin": z((L,), _I32),
            "cand_dleft": z((L,), torch.bool),
            "cand_lsum": z((L, 3), _F32),
            "cand_rsum": z((L, 3), _F32),
            "cand_member": z((L, max_bins), torch.bool),
            "hists": z((L, G, Bb, 3), torch.int64),
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
        cand_names = ("cand_gain", "cand_feat", "cand_bin", "cand_dleft",
                      "cand_lsum", "cand_rsum", "cand_member")
        leaf_start = [n] * L
        leaf_seg = [0] * L
        leaf_depth = [0] * L

        # ---- root ----------------------------------------------------------
        root_hist = yield from hist_of(0, n)
        root_sum = fx_to_f32(Wt.sum(dim=1), inv)
        zero = torch.zeros((), dtype=_F32, device=dev)
        root_out = leaf_output_smoothed(root_sum[0], root_sum[1],
                                        root_sum[2], zero, sp)
        fm0, rb0 = node_inputs(2 * L, 1)
        if use_ic:
            path0 = torch.zeros((F,), dtype=torch.bool, device=dev)
            fm0 = fm0 & interaction_allowed(groups, path0)
        cand = strat.leaf_candidates(
            scan_form(root_hist), root_sum, fm0[0], sp,
            None if rb0 is None else rb0[0],
            bound=torch.tensor([-BIG, BIG], dtype=_F32, device=dev),
            depth=torch.zeros((), dtype=_I32, device=dev),
            parent_out=root_out)
        for name, val in zip(cand_names, cand):
            s[name][0] = val
        s["hists"][0] = root_hist
        s["leaf_sum"][0] = root_sum
        s["leaf_value"][0] = root_out
        s["leaf_weight"][0] = root_sum[1]
        s["leaf_count"][0] = root_sum[2]
        leaf_start[0], leaf_seg[0] = 0, n
        num_leaves_now = 1
        leaf_mn = torch.full((L,), -BIG, dtype=_F32, device=dev)
        leaf_mx = torch.full((L,), BIG, dtype=_F32, device=dev)
        leaf_path = torch.zeros((L, F), dtype=torch.bool, device=dev)

        ar = torch.arange(n, device=dev)
        ids = torch.arange(L, device=dev)
        for t in range(L - 1):
            if t < n_forced:
                # ForceSplits (reference partitioned.py:440-471): a fixed
                # (leaf, feature, bin) split whatever its gain, default
                # right, its child sums the cumulative bins of the leaf's
                # pooled histogram; an empty leaf is skipped
                best, f_, b_ = (int(v) for v in forced_splits[t])
                if leaf_seg[best] == 0:
                    continue
                psum = s["leaf_sum"][best].clone()
                fh = scan_form(s["hists"][best])[f_]            # (B, 3)
                lsum = cumsum_bins(fh.t())[:, min(b_, max_bins - 1)]
                rsum = psum - lsum
                gain = (leaf_gain(lsum[0], lsum[1], sp.lambda_l1,
                                  sp.lambda_l2) +
                        leaf_gain(rsum[0], rsum[1], sp.lambda_l1,
                                  sp.lambda_l2) -
                        leaf_gain(psum[0], psum[1], sp.lambda_l1,
                                  sp.lambda_l2) - sp.min_gain_to_split)
                feat = torch.tensor(f_, dtype=_I32, device=dev)
                thr = torch.tensor(b_, dtype=_I32, device=dev)
                dleft = torch.zeros((), dtype=torch.bool, device=dev)
                member = torch.zeros((max_bins,), dtype=torch.bool,
                                     device=dev)
                left_smaller = bool(lsum[2] <= rsum[2])
                syncs += 1
            else:
                # ---- best leaf, its gain and its smaller side: one host
                # read (indexing with a 0-d device tensor would read it on
                # the host: every device-side index below is a 1-element
                # tensor)
                b1 = torch.argmax(s["cand_gain"]).view(1)
                info = torch.cat([
                    b1.double(), s["cand_gain"].index_select(0, b1).double(),
                    (s["cand_lsum"].index_select(0, b1)[:, 2] <=
                     s["cand_rsum"].index_select(0, b1)[:, 2]).double()
                ]).tolist()
                syncs += 1
                best, bgain, left_smaller = (int(info[0]), info[1],
                                             info[2] > 0)
                if not bgain > 0:
                    break
                gain, feat, thr, dleft, lsum, rsum, member = (
                    s[k][best].clone() for k in cand_names)
                psum = s["leaf_sum"][best].clone()
            new_id, node = t + 1, t
            f1 = feat.long().view(1)
            fnan = hn.index_select(0, f1)[0]
            fcat = ic.index_select(0, f1)[0]
            f_nan_bin = torch.where(fnan, nb.index_select(0, f1)[0] - 1,
                                    torch.full_like(feat, -1))

            # ---- stable partition of the leaf's segment, lefts first ----
            start, cnt = leaf_start[best], leaf_seg[best]
            e = start + cnt
            seg = Pm[start:e]
            g1 = f1 if efb is None else efb.f_bundle.index_select(
                0, f1).long()
            col = decode(widen_bins(take_rows(P[start:e], g1, 1).squeeze(1))
                         .to(_I32), f1)
            go_left = torch.where(col == f_nan_bin, dleft, col <= thr)
            if any_cat:
                go_left = torch.where(
                    fcat, member.index_select(0, col.long()), go_left)
            cl = torch.cumsum(go_left.to(torch.int64), 0)
            nl_dev = cl[-1]
            pos = torch.where(go_left, cl - 1, nl_dev + ar[:cnt] - cl)
            seg.index_copy_(0, pos, seg.clone())
            wseg = Wt[:, start:e]
            wseg.index_copy_(1, pos, wseg.clone())
            oseg = order[start:e]
            oseg.index_copy_(0, pos, oseg.clone())
            nl = int(nl_dev)
            syncs += 1
            nr = cnt - nl

            # ---- smaller child by kernel, larger by subtraction ----------
            small = yield from (hist_of(start, nl) if left_smaller else
                                hist_of(start + nl, nr))
            big = s["hists"][best] - small
            h_l, h_r = (small, big) if left_smaller else (big, small)

            # ---- children's outputs and monotone bounds -----------------
            out_l, out_r = child_outputs(lsum, rsum, s["leaf_value"][best],
                                         sp)
            bounds = None
            idx2 = torch.cat([ids[best:best + 1], ids[new_id:new_id + 1]])
            if use_mc:
                m = torch.where(fcat, 0, mono.index_select(0, f1)[0])
                out_l, out_r, bl, br = basic_bounds(
                    out_l, out_r, leaf_mn[best], leaf_mx[best], m)
                bounds = torch.stack([torch.stack(bl), torch.stack(br)])
                leaf_mn[idx2], leaf_mx[idx2] = bounds[:, 0], bounds[:, 1]

            # ---- both children's candidates: one batched scan ------------
            sums2 = torch.stack([lsum, rsum])
            fm2, rb2 = node_inputs(2 * t, 2)
            if use_ic:
                path = leaf_path[best] | (torch.arange(F, device=dev) ==
                                          feat.long())
                leaf_path[idx2] = path
                fm2 = fm2 & interaction_allowed(groups, path)
            child_depth = leaf_depth[best] + 1
            cl_, cr_ = strat.pair_candidates(
                scan_form(h_l), scan_form(h_r), lsum, rsum, fm2, sp, rb2,
                bounds=bounds,
                depth=torch.tensor(child_depth, dtype=_I32, device=dev),
                parent_outs=torch.stack([out_l, out_r]))
            cands = tuple(torch.stack([a, b]) for a, b in zip(cl_, cr_))
            cg = cands[0]
            if max_depth > 0 and child_depth >= max_depth:
                cg = torch.full_like(cg, NEG_INF)
            for name, val in zip(cand_names, (cg,) + tuple(cands[1:])):
                s[name][idx2] = val.to(s[name].dtype)
            s["hists"][best] = h_l
            s["hists"][new_id] = h_r
            s["leaf_sum"][idx2] = sums2
            s["leaf_value"][idx2] = torch.stack([out_l, out_r])
            s["leaf_weight"][idx2] = sums2[:, 1]
            s["leaf_count"][idx2] = sums2[:, 2]
            leaf_start[best], leaf_seg[best] = start, nl
            leaf_start[new_id], leaf_seg[new_id] = start + nl, nr
            leaf_depth[best] = leaf_depth[new_id] = child_depth

            # ---- node records (learner/endgame.py) ------------------------
            # a categorical node sends NaN as its member bin 0 goes
            dleft_rec = torch.where(fcat, member[0], dleft)
            dt_bits = (torch.where(fcat, CAT_MASK, 0) |
                       torch.where(dleft_rec, DEFAULT_LEFT_MASK, 0) |
                       torch.where(fnan & ~fcat, MISSING_NAN, 0)).to(_I32)
            s["cat_member"][node] = member
            lc, rc = patch_child_pointers(s["left_child"], s["right_child"],
                                          best, node)
            write_split_records(
                s, node=node, leaf=best, new_id=new_id, feat=feat, thr=thr,
                f_nan_bin=f_nan_bin, dt_bits=dt_bits, gain=gain,
                internal_value=leaf_output(psum[0], psum[1], sp),
                internal_weight=psum[1], internal_count=psum[2],
                left_child=lc, right_child=rc)
            num_leaves_now += 1

        # ---- row_leaf in ORIGINAL row order --------------------------------
        # the leaves' segments tile [0, n): one leaf id per position, then
        # one scatter through the original row index
        by_start = sorted(range(num_leaves_now), key=lambda j: leaf_start[j])
        leaf_of_pos = torch.repeat_interleave(
            torch.tensor(by_start, dtype=_I32, device=dev),
            torch.tensor([leaf_seg[j] for j in by_start], device=dev),
            output_size=n)
        row_leaf = torch.empty((n,), dtype=_I32, device=dev)
        row_leaf[order] = leaf_of_pos

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
            leaf_count=s["leaf_count"], num_leaves=num_leaves_now,
            row_leaf=row_leaf, hist_passes=0, host_syncs=syncs,
            cat_member=s["cat_member"] if any_cat else None)

    def grow(*args, **kwargs) -> GrownTree:
        return kc.run_single(grow_gen(*args, **kwargs))

    grow.gen = grow_gen
    return grow
