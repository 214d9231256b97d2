"""Serial (single-device) tree learner: the growers' host wrapper.

Port of ``lightgbm_tpu/learner/serial.py``: ``GrownTree``,
``CommStrategy`` (the serial strategy's ``leaf_candidates`` and
``pair_candidates``, reference serial.py:96-197), the pool-less masked
grower (``make_grow_fn``, :199-538), ``resolve_hist_impl``,
``split_params_from_config``, ``resolve_monotone_method`` (:623-643),
``hist_pool_fits`` (:645-652), the grower choice of
``SerialTreeLearner`` (:723-776), its 4-bit packing decision (:777-794),
its EFB descriptors (:688-703), the lazy-CEGB bitmap that lasts across
trees (:908, :950-960) and its wave, partition and masked branches
(:784-850, :901-967).  The parallel learners (``parallel/``) build on
this learner with their strategies; the histogram autotuner is
``learner/autotune.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..models.tree import CAT_MASK, DEFAULT_LEFT_MASK, MISSING_NAN
from ..ops.histogram import (PACK4_MAX_BINS, FxWeights, fx_exponents,
                             fx_to_f32, pack_weights, take_rows, widen_bins)
from ..ops.histogram_cuda import MEMBER_WORDS, hist_single
from ..ops.split import (BIG, NEG_INF, SplitParams, leaf_output,
                         leaf_output_smoothed, local_best_candidates)
from ..utils.log import log_info, log_warning
from ..utils.random import host_key
from .endgame import patch_child_pointers, write_split_records

__all__ = ["SerialTreeLearner", "GrownTree", "CommStrategy",
           "make_grow_fn", "resolve_hist_impl", "split_params_from_config",
           "resolve_monotone_method", "hist_pool_fits", "child_outputs",
           "basic_bounds", "interaction_allowed"]


class GrownTree(NamedTuple):
    """Result of growing one tree (tensors on the training device)."""
    split_feature: torch.Tensor     # (L-1,) int32 (inner feature indices)
    threshold_bin: torch.Tensor     # (L-1,) int32
    nan_bin: torch.Tensor           # (L-1,) int32
    decision_type: torch.Tensor     # (L-1,) int32
    left_child: torch.Tensor        # (L-1,) int32
    right_child: torch.Tensor       # (L-1,) int32
    split_gain: torch.Tensor        # (L-1,) float32
    internal_value: torch.Tensor    # (L-1,) float32
    internal_weight: torch.Tensor   # (L-1,) float32
    internal_count: torch.Tensor    # (L-1,) float32
    leaf_value: torch.Tensor        # (L,) float32
    leaf_weight: torch.Tensor       # (L,) float32
    leaf_count: torch.Tensor        # (L,) float32
    num_leaves: int                 # leaves actually grown
    row_leaf: torch.Tensor          # (N,) int32 final leaf of every row
    hist_passes: int                # full-data histogram passes (wave
    #                                 grower; 0 = untracked: the
    #                                 partitioned grower's builds scale
    #                                 with the split leaf, not with N)
    host_syncs: int = -1            # device-to-host reads of the grower
    #                                 (partitioned grower; -1 = not counted)
    cat_member: Optional[torch.Tensor] = None   # (L-1, B) bool LEFT bins
    #                                 of categorical nodes (None: no
    #                                 categorical feature)


class CommStrategy:
    """The serial (no-communication) strategy of the reference's growers:
    split candidates of one leaf, or of a split's two children in one
    batched scan (the reference's vmap).  ``monotone``, ``cegb`` and
    ``contri`` are the (F,) constraint directions, CEGB penalties and
    ``feature_contri`` gain scales the scans read (None: off).

    The parallel strategies (``parallel/``) override the hooks where the
    reference's insert collectives (reference serial.py:96-200):

    * ``reduce_sum(v)`` / ``reduce_max(v)``: per-rank sums and maxima
      over row shards (leaf totals; quantization scales and fixed-point
      exponents);
    * ``shard_key(key)``: the rank's stochastic-rounding stream;
    * ``reduce_hist(h)``: a freshly built histogram batch merged across
      row shards;
    * ``local_meta(fm)``: the per-feature descriptors of this rank's
      histogram width;
    * ``get_column(X_T, feat)``: the winning feature's bin column for the
      partition update (feature-parallel: its owner's broadcast);
    * ``fx_rows(n)``: the row count the fixed-point exponents are taken
      for (the global one under row shards, so every rank packs its
      weights on the same scale and the integer sums add).

    ``scan_merges`` marks a strategy whose ``leaf_candidates`` take the
    masked grower's RAW int64 shard-local histograms and merge them in
    the scan (data- and voting-parallel)."""

    rows_sharded = False
    scan_merges = False
    nshards = 1
    hist_scatter = False
    hist_voting = False
    spec_ok = True

    def __init__(self, num_bins: torch.Tensor, has_nan: torch.Tensor,
                 is_cat: Optional[torch.Tensor] = None, monotone=None,
                 cegb=None, contri=None):
        self.num_bins_full = num_bins
        self.has_nan_full = has_nan
        self.is_cat_full = is_cat
        self.monotone_full = monotone
        self.cegb_full = cegb
        self.contri_full = contri

    def bind(self, num_bins, has_nan, is_cat=None, monotone=None,
             cegb=None, contri=None) -> "CommStrategy":
        """A per-tree copy carrying this tree's descriptors (the
        reference's shallow per-trace copy, wave.py:476-484)."""
        import copy
        s = copy.copy(self)
        CommStrategy.__init__(s, num_bins, has_nan, is_cat, monotone, cegb,
                              contri)
        return s

    def reduce_sum(self, v):
        return v

    def reduce_max(self, v):
        return v

    def shard_key(self, key):
        return key

    def reduce_hist(self, hist):
        return hist

    def fx_rows(self, n: int) -> int:
        return n

    def local_meta(self, feature_mask):
        return (self.num_bins_full, self.has_nan_full, self.is_cat_full,
                feature_mask)

    def get_column(self, X_T: torch.Tensor, feat: torch.Tensor
                   ) -> torch.Tensor:
        """(N,) int32 bin codes of the GLOBAL feature ``feat`` (0-d)."""
        return widen_bins(take_rows(X_T, feat.long().view(1))[0]).to(
            torch.int32)

    def fx_exponents(self, gm: torch.Tensor, hm: torch.Tensor, n: int):
        """The fixed-point exponents of a tree's masked gradients and
        hessians: this rank's maxima reduced over the row shards, and the
        global row count (ops/histogram.py ``fx_exponents``; the chunked
        path shares exponents across chunks the same way).  None in a
        serial run: :func:`pack_weights` picks its own."""
        if not self.rows_sharded:
            return None
        m = torch.stack([gm.abs().max() if gm.numel() else gm.new_zeros(()),
                         hm.abs().max() if hm.numel() else hm.new_zeros(())
                         ]).double()
        gmax, hmax = self.reduce_max(m).tolist()
        return fx_exponents(gmax, hmax, self.fx_rows(n))

    def _options(self, bound, depth, parent_out, cegb=None) -> dict:
        return dict(monotone=self.monotone_full, bound=bound, depth=depth,
                    cegb_penalty=self.cegb_full if cegb is None else cegb,
                    gain_scale=self.contri_full, parent_out=parent_out)

    def leaf_candidates(self, hist, leaf_sum, feature_mask, params,
                        rand_bins=None, bound=None, depth=None,
                        parent_out=None):
        """(gain, feat, bin, default_left, left_sum, right_sum,
        cat_member) of one leaf's (F, B, 3) f32 histogram; ``rand_bins``
        (F,) the node's extra-trees thresholds or None; ``bound`` (2,),
        ``depth`` () and ``parent_out`` () the leaf's monotone bounds,
        depth and own output (read under those options)."""
        def one(t):
            return None if t is None else t.unsqueeze(0)
        out = local_best_candidates(
            hist.unsqueeze(0), leaf_sum.unsqueeze(0), self.num_bins_full,
            self.has_nan_full, feature_mask.unsqueeze(0), params,
            rand_bins=one(rand_bins), is_cat=self.is_cat_full,
            **self._options(one(bound), one(depth), one(parent_out)))
        return tuple(o[0] for o in out)

    def pair_candidates(self, hist_l, hist_r, lsum, rsum, feature_mask,
                        params, rand_bins=None, bounds=None, depth=None,
                        parent_outs=None):
        """Both children's candidates in ONE batched scan;
        ``feature_mask`` (F,) or one row per child (2, F), ``rand_bins``
        (2, F) or None, ``bounds`` (2, 2), ``depth`` () and
        ``parent_outs`` (2,) the children's bounds, depth and outputs."""
        d2 = None if depth is None else depth.expand(2)
        out = local_best_candidates(torch.stack([hist_l, hist_r]),
                                    torch.stack([lsum, rsum]),
                                    self.num_bins_full, self.has_nan_full,
                                    feature_mask.expand(2, -1), params,
                                    rand_bins=rand_bins,
                                    is_cat=self.is_cat_full,
                                    **self._options(bounds, d2, parent_outs))
        return tuple(o[0] for o in out), tuple(o[1] for o in out)


def child_outputs(lsum: torch.Tensor, rsum: torch.Tensor, parent_out,
                  sp: SplitParams):
    """The outputs of a split's two children from their (..., 3) sums:
    smoothed toward ``parent_out`` under ``path_smooth``
    (feature_histogram.hpp USE_SMOOTHING), else the closed form."""
    return tuple(leaf_output_smoothed(v[..., 0], v[..., 1], v[..., 2],
                                      parent_out, sp) for v in (lsum, rsum))


def basic_bounds(out_l, out_r, p_mn, p_mx, m):
    """Basic monotone constraints for a split's children
    (BasicLeafConstraints::Update, monotone_constraints.hpp:487-501): the
    outputs clamped to the parent's bounds, and the midpoint dividing the
    output range between the children along a constrained feature (``m``
    its direction, 0 for none).  Returns (out_l, out_r, (mn_l, mx_l),
    (mn_r, mx_r))."""
    out_l = torch.minimum(torch.maximum(out_l, p_mn), p_mx)
    out_r = torch.minimum(torch.maximum(out_r, p_mn), p_mx)
    mid = (out_l + out_r) / 2.0
    mn_l = torch.where(m < 0, torch.maximum(p_mn, mid), p_mn)
    mx_l = torch.where(m > 0, torch.minimum(p_mx, mid), p_mx)
    mn_r = torch.where(m > 0, torch.maximum(p_mn, mid), p_mn)
    mx_r = torch.where(m < 0, torch.minimum(p_mx, mid), p_mx)
    return out_l, out_r, (mn_l, mx_l), (mn_r, mx_r)


def interaction_allowed(groups: torch.Tensor, path: torch.Tensor):
    """(..., F) features a node may split on under interaction constraints
    (col_sampler.hpp GetByNode): the union of the (C, F) constraint sets
    that contain every feature already used on the (..., F) branch
    ``path``."""
    compat = ~(path.unsqueeze(-2) & ~groups).any(dim=-1)        # (..., C)
    return (groups & compat.unsqueeze(-1)).any(dim=-2)


def interaction_groups_mask(groups: tuple, num_features: int,
                            device) -> torch.Tensor:
    """(C, F) bool membership of the inner-feature constraint sets."""
    g = np.zeros((len(groups), num_features), bool)
    for gi, feats in enumerate(groups):
        for f in feats:
            if 0 <= f < num_features:
                g[gi, f] = True
    return torch.as_tensor(g, device=device)


def resolve_hist_impl(config: Config, device: torch.device) -> str:
    """Pick the histogram implementation: ``auto`` (and the reference's
    ``pallas``) resolve to the hand-written CUDA kernels on a ``cuda``
    device and to their plain PyTorch versions on the CPU.  The wrappers
    dispatch on the tensors' device, so the name only records what ran.
    The kernels' bin layout is the learner's decision: packed 4-bit bins
    under ``tpu_hist_pack4`` unless ``tpu_pallas_pipeline=blockspec``
    (``SerialTreeLearner.pack4``)."""
    impl = str(config.tpu_histogram_impl)
    if impl not in ("auto", "pallas"):
        raise NotImplementedError(
            f"tpu_histogram_impl={impl!r} selects an XLA formulation of the "
            "reference; lightgbm_tpu_torch has the CUDA kernels and their "
            "plain versions only")
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def split_params_from_config(config: Config,
                             num_bins: Optional[np.ndarray] = None,
                             is_cat: Optional[np.ndarray] = None
                             ) -> SplitParams:
    """The scan's parameters (reference serial.py:574-625): the
    sorted-subset search is on when some categorical feature has more
    than ``max_cat_to_onehot`` bins, and ``cat_idx`` lists the
    categorical features (the serial learners scan full feature space,
    reference serial.py:709-716)."""
    mc = config.monotone_constraints or []
    use_cegb = bool(config.cegb_penalty_split > 0.0 or
                    config.cegb_penalty_feature_coupled or
                    config.cegb_penalty_feature_lazy)
    cats = (np.zeros(0, bool) if is_cat is None
            else np.asarray(is_cat, bool))
    use_cat_subset = bool(
        num_bins is not None and
        np.any(cats & (np.asarray(num_bins) > int(config.max_cat_to_onehot))))
    return SplitParams(
        lambda_l1=float(config.lambda_l1),
        lambda_l2=float(config.lambda_l2),
        min_data_in_leaf=int(config.min_data_in_leaf),
        min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
        min_gain_to_split=float(config.min_gain_to_split),
        max_delta_step=float(config.max_delta_step),
        cat_l2=float(config.cat_l2),
        cat_smooth=float(config.cat_smooth),
        path_smooth=float(config.path_smooth),
        use_monotone=any(int(v) != 0 for v in mc),
        monotone_penalty=float(config.monotone_penalty),
        max_cat_to_onehot=int(config.max_cat_to_onehot),
        max_cat_threshold=int(config.max_cat_threshold),
        min_data_per_group=int(config.min_data_per_group),
        use_cat_subset=use_cat_subset,
        cat_idx=tuple(int(j) for j in np.nonzero(cats)[0]),
        use_cegb=use_cegb,
        cegb_tradeoff=float(config.cegb_tradeoff),
        cegb_penalty_split=float(config.cegb_penalty_split),
        feature_fraction_bynode=float(config.feature_fraction_bynode),
        extra_trees=bool(config.extra_trees),
        any_cat=bool(cats.any()))


def resolve_monotone_method(config: Config, use_mc: bool,
                            wave: bool) -> bool:
    """The intermediate-constraint flag for a grower, warning about
    downgrades (reference serial.py:623-643): 'advanced' falls back to
    'intermediate' on the wave grower; the other growers fall back to
    'basic'."""
    method = str(config.monotone_constraints_method)
    if not use_mc or method == "basic":
        return False
    if not wave:
        log_warning(f"monotone_constraints_method='{method}' requires the "
                    "wave grower; falling back to 'basic' (safe but more "
                    "conservative bounds)")
        return False
    if method == "advanced":
        log_warning("monotone_constraints_method='advanced' is not "
                    "implemented; using 'intermediate' (less constraining "
                    "than basic, more than advanced)")
    return True


def hist_pool_fits(config: Config, num_features: int, max_bins: int) -> bool:
    """Keep per-leaf histograms when they fit the budget (reference
    histogram_pool_size, default -1 = a 1 GiB cap).  The budget counts
    the reference's f32 pool, so the port picks the grower it picks; the
    port's partitioned pool holds int64 sums, twice those bytes
    (:func:`pool_bytes`)."""
    pool = config.num_leaves * num_features * max_bins * 3 * 4
    budget = (float(config.histogram_pool_size) * (1 << 20)
              if config.histogram_pool_size > 0 else (1 << 30))
    return pool <= budget


def pool_bytes(config: Config, num_features: int, max_bins: int,
               grow_mode: str) -> int:
    """Bytes of the port's histogram pool: (L, F, B, 3) int64 fixed-point
    sums on the partitioned grower, f32 (exact) or int32 (quantized) on
    the wave grower, none on the masked grower."""
    if grow_mode == "masked":
        return 0
    item = 8 if grow_mode == "partition" else 4
    return config.num_leaves * num_features * max_bins * 3 * item


def make_grow_fn(*, num_leaves: int, num_features: int, max_bins: int,
                 max_depth: int, split_params: SplitParams,
                 strategy: Optional[CommStrategy] = None):
    """Build the pool-less masked grower (reference serial.py:199-538
    with ``use_hist_pool=False``): the exact sequential leaf-wise order
    with no histogram pool and no subtraction; each split builds both
    children's histograms with one full pass each of the single-leaf
    kernel, its fixed-point weights masked to the child's rows.

    Returns ``grow(X_T, grad, hess, bag_mask, num_bins, has_nan,
    feature_mask, is_cat=None, monotone=None) -> GrownTree`` with ``X_T``
    the FEATURE-MAJOR (F, N) uint8 or uint16 bin matrix.  Carries what the
    reference's masked grower carries: basic monotone bounds, path
    smoothing and the CEGB split penalty through the scan; the reference
    passes it no per-feature CEGB penalty, no ``feature_contri`` and no
    forced splits or interaction constraints, and warns that it does not
    apply extra-trees (:216-219).

    ``strategy`` (a parallel learner's, reference :199-212) inserts the
    collectives: row-sharded strategies reduce the root totals and take
    each leaf's RAW int64 shard-local histogram into their scan
    (``scan_merges``), packed on the global fixed-point scale; the
    feature-parallel one histograms its own features and broadcasts the
    winning column.  ``X_T`` is then this rank's rows or features."""
    L = num_leaves
    sp = split_params
    any_cat = bool(sp.any_cat)
    use_mc = sp.use_monotone
    if sp.extra_trees:
        log_warning("extra_trees is not applied on this grower (pool-less "
                    "fallback / parallel learners); growing full scans")

    def grow(X_T: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
             bag_mask: torch.Tensor, num_bins: torch.Tensor,
             has_nan: torch.Tensor, feature_mask: torch.Tensor,
             is_cat=None, monotone=None) -> GrownTree:
        dev = X_T.device
        n = X_T.shape[1]
        nb = num_bins.to(torch.int32)
        hn = has_nan.to(torch.bool)
        fm = feature_mask.to(torch.bool)
        ic = (is_cat.to(torch.bool) if any_cat and is_cat is not None
              else torch.zeros_like(hn))
        mono = (monotone.to(torch.int32) if use_mc
                else torch.zeros_like(nb))
        strat = (strategy.bind if strategy is not None else CommStrategy)(
            nb, hn, ic if any_cat else None,
            monotone=mono if use_mc else None)
        wfx = pack_weights(grad, hess, bag_mask, strat.fx_exponents(
            grad * bag_mask, hess * bag_mask, n))
        Wt, inv = wfx.w, wfx.inv_scale
        strat.fx_inv = inv

        def masked_hist(rows: torch.Tensor) -> torch.Tensor:
            """(F, B, 3) histogram of the rows ``rows`` (N,) bool: one
            full pass, every other row's weights zero; f32, or the raw
            int64 sums a merging strategy reduces in its scan."""
            h = hist_single(X_T, FxWeights(Wt * rows.to(torch.int64), inv),
                            num_bins=max_bins)
            return h if strat.scan_merges else fx_to_f32(h, inv)

        def z(shape, dtype, fill=0):
            return torch.full(shape, fill, dtype=dtype, device=dev)

        s = {
            "row_leaf": z((n,), torch.int32),
            "leaf_sum": z((L, 3), torch.float32),
            "split_feature": z((L - 1,), torch.int32, -1),
            "threshold_bin": z((L - 1,), torch.int32),
            "nan_bin": z((L - 1,), torch.int32, -1),
            "cat_member": z((L - 1, max_bins), torch.bool),
            "decision_type": z((L - 1,), torch.int32),
            "left_child": z((L - 1,), torch.int32),
            "right_child": z((L - 1,), torch.int32),
            "split_gain": z((L - 1,), torch.float32),
            "internal_value": z((L - 1,), torch.float32),
            "internal_weight": z((L - 1,), torch.float32),
            "internal_count": z((L - 1,), torch.float32),
            "leaf_value": z((L,), torch.float32),
            "leaf_weight": z((L,), torch.float32),
            "leaf_count": z((L,), torch.float32),
            "leaf_mn": z((L,), torch.float32, -BIG),
            "leaf_mx": z((L,), torch.float32, BIG),
            "leaf_depth": z((L,), torch.int32),
        }
        cands = [z((L,), torch.float32, NEG_INF), z((L,), torch.int32),
                 z((L,), torch.int32), z((L,), torch.bool),
                 z((L, 3), torch.float32), z((L, 3), torch.float32),
                 z((L, max_bins), torch.bool)]

        # ---- root ----------------------------------------------------------
        root_hist = masked_hist(bag_mask > 0)
        root_sum = fx_to_f32(strat.reduce_sum(Wt.sum(dim=1)), inv)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        root_out = leaf_output_smoothed(root_sum[0], root_sum[1],
                                        root_sum[2], zero, sp)
        cand = strat.leaf_candidates(
            root_hist, root_sum, fm, sp,
            bound=torch.tensor([-BIG, BIG], dtype=torch.float32, device=dev),
            depth=torch.zeros((), dtype=torch.int32, device=dev),
            parent_out=root_out)
        for arr, val in zip(cands, cand):
            arr[0] = val
        s["leaf_sum"][0] = root_sum
        s["leaf_value"][0] = root_out
        s["leaf_weight"][0] = root_sum[1]
        s["leaf_count"][0] = root_sum[2]
        num_leaves_now = 1
        syncs = 2

        for t in range(L - 1):
            b1 = torch.argmax(cands[0]).view(1)
            best, bgain = torch.cat([b1.double(),
                                     cands[0].index_select(0, b1).double()
                                     ]).tolist()
            syncs += 1
            best = int(best)
            if not bgain > 0:
                break
            new_id, node = t + 1, t
            gain, feat, thr, dleft, lsum, rsum, member = (
                a[best].clone() for a in cands)
            psum = s["leaf_sum"][best].clone()
            f1 = feat.long().view(1)
            fnan = hn.index_select(0, f1)[0]
            fcat = ic.index_select(0, f1)[0]
            f_nan_bin = torch.where(fnan, nb.index_select(0, f1)[0] - 1,
                                    torch.full_like(feat, -1))

            # ---- partition update (DataPartition::Split analog) ----------
            col = strat.get_column(X_T, feat)
            go_left = torch.where(col == f_nan_bin, dleft, col <= thr)
            if any_cat:
                go_left = torch.where(fcat, member[col.long()], go_left)
            in_leaf = s["row_leaf"] == best
            s["row_leaf"] = torch.where(in_leaf & ~go_left, new_id,
                                        s["row_leaf"]).to(torch.int32)

            # ---- no pool: one masked full pass per child -----------------
            hist_l = masked_hist(s["row_leaf"] == best)
            hist_r = masked_hist(s["row_leaf"] == new_id)

            # ---- children's outputs and monotone bounds ------------------
            out_l, out_r = child_outputs(lsum, rsum, s["leaf_value"][best],
                                         sp)
            bounds = None
            if use_mc:
                m = torch.where(fcat, 0, mono.index_select(0, f1)[0])
                out_l, out_r, bl, br = basic_bounds(
                    out_l, out_r, s["leaf_mn"][best], s["leaf_mx"][best], m)
                bounds = torch.stack([torch.stack(bl), torch.stack(br)])
                s["leaf_mn"][best], s["leaf_mx"][best] = bl
                s["leaf_mn"][new_id], s["leaf_mx"][new_id] = br
            child_depth = s["leaf_depth"][best] + 1
            cl, cr = strat.pair_candidates(
                hist_l, hist_r, lsum, rsum, fm, sp, bounds=bounds,
                depth=child_depth, parent_outs=torch.stack([out_l, out_r]))
            idx2 = torch.tensor([best, new_id], device=dev)
            for k, arr in enumerate(cands):
                val = torch.stack([cl[k], cr[k]])
                if k == 0 and max_depth > 0:
                    val = torch.where(child_depth < max_depth, val,
                                      torch.full_like(val, NEG_INF))
                arr[idx2] = val.to(arr.dtype)
            s["leaf_sum"][idx2] = torch.stack([lsum, rsum])
            s["leaf_depth"][idx2] = child_depth
            s["leaf_value"][idx2] = torch.stack([out_l, out_r])
            s["leaf_weight"][idx2] = torch.stack([lsum[1], rsum[1]])
            s["leaf_count"][idx2] = torch.stack([lsum[2], rsum[2]])

            # ---- node records ----------------------------------------------
            # a categorical node sends NaN as its member bin 0 goes
            dleft_rec = torch.where(fcat, member[0], dleft)
            dt_bits = (torch.where(fcat, CAT_MASK, 0) |
                       torch.where(dleft_rec, DEFAULT_LEFT_MASK, 0) |
                       torch.where(fnan & ~fcat, MISSING_NAN, 0)
                       ).to(torch.int32)
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
            row_leaf=s["row_leaf"], hist_passes=0, host_syncs=syncs,
            cat_member=s["cat_member"] if any_cat else None)

    return grow


class SerialTreeLearner:
    """Host-side wrapper owning the grower and the dataset's static
    feature descriptors (reference tree_learner.h:27 ``TreeLearner``).
    The split options arrive in inner-feature space
    (models/gbdt.py's parsers): ``monotone`` (F,) directions or None,
    ``forced_splits`` BFS (leaf, feature, bin) triples,
    ``interaction_groups`` feature tuples, ``feature_contri`` (F,) gain
    scales and ``cegb_lazy`` (F,) lazy CEGB penalties (each () when
    off)."""

    def __init__(self, config: Config, num_features: int, max_bins: int,
                 num_bins: np.ndarray, has_nan: np.ndarray,
                 device: torch.device, is_cat: Optional[np.ndarray] = None,
                 efb=None, monotone: Optional[np.ndarray] = None,
                 forced_splits: tuple = (), interaction_groups: tuple = (),
                 feature_contri: tuple = (), cegb_lazy: tuple = (),
                 strategy: Optional[CommStrategy] = None,
                 grow_mode: Optional[str] = None):
        self.config = config
        # a parallel learner's strategy and its grower choice
        # (parallel/data_parallel.py, parallel/voting_parallel.py)
        self._strategy = strategy
        self.device = torch.device(device)
        self.max_bins = int(max_bins)
        self.num_features = num_features
        self.num_bins = torch.as_tensor(num_bins, dtype=torch.int32,
                                        device=self.device)
        self.has_nan = torch.as_tensor(has_nan, dtype=torch.bool,
                                       device=self.device)
        if is_cat is None:
            is_cat = np.zeros(num_features, bool)
        self.is_cat = torch.as_tensor(is_cat, dtype=torch.bool,
                                      device=self.device)
        self.monotone = torch.as_tensor(
            monotone if monotone is not None else np.zeros(num_features),
            dtype=torch.int32, device=self.device)
        any_cat = bool(np.any(is_cat))
        self.split_params = split_params_from_config(config, num_bins, is_cat)
        self.hist_impl = resolve_hist_impl(config, self.device)
        # EFB (dataset.py ``efb``, a BundleInfo): the growers build and
        # pool histograms in bundle space (reference serial.py:688-703)
        self.efb = efb
        from ..efb import efb_arrays
        self._efb = None if efb is None else efb_arrays(efb, self.device)
        pool_f, pool_b = ((efb.n_bundles, efb.bundle_bins) if efb is not None
                          else (num_features, self.max_bins))
        # grower choice (reference serial.py:723-776); both of the port's
        # histogram paths (CUDA kernel, plain version) stand for the
        # reference's pallas impl
        self.use_hist_pool = hist_pool_fits(config, pool_f, pool_b)
        if efb is not None and not self.use_hist_pool:
            raise ValueError("EFB requires the partitioned grower; raise "
                             "histogram_pool_size or disable enable_bundle")
        wave_ok = self.use_hist_pool and int(config.num_leaves) > 2
        mode = str(config.tree_grow_mode)
        if mode == "wave" and not wave_ok:
            log_warning("tree_grow_mode=wave is incompatible with "
                        "num_leaves<=2 / pool-less growth; "
                        "falling back to the partitioned grower")
            mode = "partition"
        elif mode == "auto":
            # uint16 bins (max_bin > 255): the reference's Pallas kernels
            # take uint8 bins, so it histograms with XLA and its 'auto'
            # picks the partitioned grower (reference serial.py:564-570,
            # :759); the port grows the trees it grows
            mode = ("wave" if wave_ok and self.max_bins <= 256
                    else "partition")
        self.grow_mode = mode if self.use_hist_pool else "masked"
        if grow_mode is not None:
            self.grow_mode = grow_mode
        mode = self.grow_mode
        use_mc = self.split_params.use_monotone
        mc_inter = resolve_monotone_method(config, use_mc, wave=mode == "wave")
        self._use_lazy = bool(cegb_lazy) and mode == "wave"
        self._lazy_used = None
        if cegb_lazy and mode != "wave":
            log_warning("cegb_penalty_feature_lazy is applied by the wave "
                        "grower only; this grower ignores it")
        if mode == "wave" and self.max_bins > 256 and np.any(
                np.asarray(is_cat, bool) &
                (np.asarray(num_bins) > 32 * MEMBER_WORDS)):
            raise NotImplementedError(
                f"tree_grow_mode=wave with a categorical feature of more "
                f"than {32 * MEMBER_WORDS} bins: the wave row update's "
                "categorical membership holds 256 bins (ROADMAP queue 1); "
                "use tree_grow_mode=auto (the partitioned grower)")
        self.quantized = bool(config.use_quantized_grad) and mode == "wave"
        if config.use_quantized_grad and not self.quantized:
            log_warning("use_quantized_grad requires the wave grower "
                        "(tree_grow_mode=wave/auto); training with exact "
                        "gradients instead")
        log_info(f"histogram pool: "
                 f"{pool_bytes(config, pool_f, pool_b, mode)} "
                 f"bytes on the {mode} grower")
        # the 4-bit packed bin layout (reference serial.py:777-794): two
        # codes per byte when every feature fits a nibble, on the wave
        # grower only, never under categorical features or EFB.  pack4
        # exists only on the reference's DMA pipeline, so an explicit
        # blockspec request turns it off.
        self.pack4 = bool(mode == "wave" and config.tpu_hist_pack4 and
                          self.max_bins <= PACK4_MAX_BINS and not any_cat and
                          efb is None and strategy is None and
                          config.tpu_pallas_pipeline != "blockspec")
        self._x_src = self._Xp = None
        self._quant_calls = 0
        self._grower = dict(num_leaves=int(config.num_leaves),
                            num_features=num_features,
                            max_bins=self.max_bins,
                            max_depth=int(config.max_depth))
        self._options = dict(
            forced_splits=tuple(tuple(f) for f in forced_splits),
            interaction_groups=tuple(tuple(g) for g in interaction_groups),
            feature_contri=tuple(float(v) for v in feature_contri))
        self._mc_inter = mc_inter
        self._cegb_lazy = tuple(float(v) for v in cegb_lazy)
        # the lanes' growers share the speculative ramp's row subsample
        self._subsample = {}
        self._lane_grows = {}
        self._grow = self._make_grow(self.split_params)

    def _make_grow(self, sp: SplitParams):
        """This learner's grower with the scan parameters ``sp``."""
        config, mode = self.config, self.grow_mode
        if mode == "masked":
            return make_grow_fn(split_params=sp, strategy=self._strategy,
                                **self._grower)
        if mode == "partition":
            from .partitioned import make_partitioned_grow_fn
            return make_partitioned_grow_fn(efb=self._efb, split_params=sp,
                                            **self._grower, **self._options)
        from ..ops.quantize import quant_levels
        gq_max, hq_max = quant_levels(int(config.num_grad_quant_bins))
        from .wave import make_wave_grow_fn
        return make_wave_grow_fn(
            wave_size=int(config.tpu_wave_size), quantized=self.quantized,
            gq_max=gq_max, hq_max=hq_max,
            stochastic=bool(config.stochastic_rounding),
            spec_ramp=bool(config.tpu_speculative_ramp),
            spec_tol=float(config.tpu_spec_tolerance),
            exact_endgame=bool(config.tpu_exact_endgame),
            renew_leaf=bool(config.quant_train_renew_leaf), pack4=self.pack4,
            efb=self._efb, mc_inter=self._mc_inter,
            cegb_lazy=self._cegb_lazy, subsample_cache=self._subsample,
            split_params=sp, strategy=self._strategy, **self._grower,
            **self._options)

    def lane_grower(self, sp: SplitParams):
        """The grower of a lane whose swept scan parameters are ``sp``
        (the reference builds its vmapped grower from each lane's
        parameters, multitrain/batched.py:529-534); lanes with equal
        parameters share one."""
        if sp == self.split_params:
            return self._grow
        if sp not in self._lane_grows:
            self._lane_grows[sp] = self._make_grow(sp)
        return self._lane_grows[sp]

    def train(self, X_T: torch.Tensor, grad: torch.Tensor,
              hess: torch.Tensor, sample_mask: torch.Tensor,
              feature_mask: Optional[torch.Tensor] = None,
              node_key: Optional[torch.Tensor] = None,
              quant_key: Optional[torch.Tensor] = None,
              cegb_penalty: Optional[torch.Tensor] = None) -> GrownTree:
        """Grow one tree.  ``X_T`` is the dataset's padded feature-major
        bin matrix (dataset.py ``device_bins``, or ``device_bins_packed4``
        when :attr:`pack4`: two rows per byte, the only copy of the bins on
        the device); the per-row vectors carry the N real rows and are
        zero-padded here (padded rows are out of the bag and contribute
        nothing).  The partitioned grower reads the ROW-MAJOR copy of
        ``X_T``, built once per dataset.  ``quant_key`` keys the
        quantized tree's stochastic rounding (a per-call stream when None,
        reference serial.py:933-939); ``node_key`` holds the keys of the
        by-node and extra-trees streams (zeros when None); both are host
        keys (utils/random.py).  ``cegb_penalty`` (F,) is the coupled
        CEGB penalty of the features not used yet (zeros when None)."""
        args, kw, n, pad = self._inputs(X_T, grad, hess, sample_mask,
                                        feature_mask, node_key, quant_key,
                                        cegb_penalty)
        grown = self._grow(*args, **kw)
        if self._use_lazy:
            grown, self._lazy_used = grown
        return grown._replace(row_leaf=grown.row_leaf[:n]) if pad else grown

    def train_lanes(self, X_T: torch.Tensor, lanes: list,
                    split_params: list) -> list:
        """Grow one tree per lane in lockstep (learner/lanes.py
        ``run_lanes``): lane l's grower is :meth:`lane_grower` of
        ``split_params[l]`` and its inputs the :meth:`train` keyword
        arguments ``lanes[l]`` (grad, hess, sample_mask, feature_mask,
        node_key, quant_key), over the one shared bin matrix ``X_T``, and
        ``own_rows``, the rows of a lane that trains on a subset (its draws
        over row positions are then a run's on those rows alone; the wave
        grower's ``own_rows``).
        Each kernel the lanes wait on launches once, in its model-axis
        form, for all of them; each lane's tree is the one :meth:`train`
        grows from its inputs."""
        from .lanes import run_lanes
        if self.grow_mode == "masked" or self._use_lazy:
            raise ValueError("the masked grower and lazy CEGB grow no "
                             "lanes")
        gens, cut = [], []
        for lane, sp in zip(lanes, split_params):
            args, kw, n, pad = self._inputs(X_T, **lane)
            gens.append(self.lane_grower(sp).gen(*args, **kw))
            cut.append(n if pad else None)
        return [t if c is None else t._replace(row_leaf=t.row_leaf[:c])
                for t, c in zip(run_lanes(gens), cut)]

    def _inputs(self, X_T, grad, hess, sample_mask, feature_mask=None,
                node_key=None, quant_key=None, cegb_penalty=None,
                own_rows=None):
        """The grower's arguments for one tree: the per-row vectors padded
        to the bin matrix's rows, the defaults filled in, the partitioned
        grower's row-major copy.  Returns (args, kwargs, real rows,
        padded rows)."""
        n = grad.shape[0]
        pad = X_T.shape[1] * (2 if self.pack4 else 1) - n
        if feature_mask is None:
            feature_mask = torch.ones((self.num_features,), dtype=torch.bool,
                                      device=self.device)
        if cegb_penalty is None:
            cegb_penalty = torch.zeros((self.num_features,),
                                       dtype=torch.float32,
                                       device=self.device)
        if pad:
            grad = torch.nn.functional.pad(grad, (0, pad))
            hess = torch.nn.functional.pad(hess, (0, pad))
            sample_mask = torch.nn.functional.pad(sample_mask, (0, pad))
        if node_key is None:
            node_key = ((0, 0), (0, 0))
        if self._x_src is not X_T:  # strong ref: ids can be recycled
            self._lazy_used = None  # fresh data -> fresh used bitmap
            self._Xp = None
            if self.grow_mode == "partition":
                # copied through an int16 view under uint16 bins: the same
                # bits, a copy every device has
                xv = (X_T.view(torch.int16) if X_T.dtype == torch.uint16
                      else X_T)
                self._Xp = xv.t().contiguous().view(X_T.dtype)
            self._x_src = X_T
        if self.grow_mode == "masked":
            if self.split_params.use_cegb or \
                    self.split_params.feature_fraction_bynode < 1.0:
                log_warning("cegb / feature_fraction_bynode are not applied "
                            "on the pool-less fallback grower")
            return ((X_T, grad, hess, sample_mask, self.num_bins,
                     self.has_nan, feature_mask),
                    dict(is_cat=self.is_cat, monotone=self.monotone), n, pad)
        if self.grow_mode == "partition":
            return ((self._Xp, grad, hess, sample_mask, self.num_bins,
                     self.has_nan, feature_mask, node_key),
                    dict(is_cat=self.is_cat, monotone=self.monotone,
                         cegb_penalty=cegb_penalty), n, pad)
        if self.quantized and quant_key is None:
            self._quant_calls += 1
            quant_key = host_key(self._quant_calls)
        lazy = {}
        if self._use_lazy:
            # the used-feature bitmap lasts for the whole training run
            # (the reference's feature_used_in_data_)
            from .wave import lazy_bitmap_init
            if self._lazy_used is None:
                self._lazy_used = lazy_bitmap_init(
                    self.num_features, X_T.shape[1] *
                    (2 if self.pack4 else 1), self.device)
            lazy["lazy_used"] = self._lazy_used
        return ((X_T, grad, hess, sample_mask, self.num_bins, self.has_nan,
                 feature_mask, quant_key, node_key),
                dict(is_cat=self.is_cat, monotone=self.monotone,
                     cegb_penalty=cegb_penalty, own_rows=own_rows, **lazy),
                n, pad)
