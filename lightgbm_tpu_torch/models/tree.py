"""Flat-array decision tree model + tensor prediction.

Port of ``lightgbm_tpu/models/tree.py`` (reference: include/LightGBM/tree.h:25
``Tree`` — flat arrays, child pointers ``~leaf_index`` for leaves).  The
host-side :class:`Tree` is a copy; :class:`TreeBatch` stacks an ensemble
into tensors on the prediction device and :func:`predict_raw` is the plain
vectorized tree walk (every row advances one level per step), deciding
categorical nodes by their bitsets over raw category values, and
evaluating linear leaves (``const + Σ coef·x``, the plain leaf value where
a leaf feature is NaN).  :func:`predict_leaf` gives each row's leaf index
per tree and :func:`predict_raw_early_stop` the margin-based early exit
(reference prediction_early_stop.cpp).  :class:`TreeBatch` also carries
the root-path matrices the dense serving program lowers from
(``path_dir``, ``plen_right``, ``plen_total``; models/dense_predict.py);
``SHAPE_BUCKETS`` / :func:`bucket_rows` / :func:`pad_rows` are the
serving row ladder, and :func:`ensemble_serve_fields` /
:func:`predict_raw_ensemble` the walk route of the compiled predictor
(serve/predictor.py).

decision_type bit layout follows the reference (tree.h decision_type):
  bit0: categorical, bit1: default_left, bits 2-3: missing type
  (0 none, 1 zero, 2 nan).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Tree", "TreeBatch", "predict_raw", "predict_leaf",
           "predict_raw_early_stop", "SHAPE_BUCKETS", "bucket_rows",
           "pad_rows", "ensemble_serve_fields", "predict_raw_ensemble"]

CAT_MASK = 1
DEFAULT_LEFT_MASK = 2
MISSING_ZERO = 1 << 2
MISSING_NAN = 2 << 2

# Row-count ladder for compiled prediction (reference models/tree.py:44):
# requests pad up to the next bucket so arbitrary batch sizes map to a
# handful of program shapes; beyond the ladder, sizes round up to the
# next MULTIPLE of the top bucket (waste under one bucket).
SHAPE_BUCKETS = (1, 8, 64, 512, 4096)


def bucket_rows(n: int, ladder=SHAPE_BUCKETS) -> int:
    """Smallest ladder bucket holding ``n`` rows (multiple of the top
    bucket above the ladder's end)."""
    if n <= 0:
        return ladder[0]
    for b in ladder:
        if n <= b:
            return b
    top = ladder[-1]
    return (n + top - 1) // top * top


def pad_rows(X: np.ndarray, ladder=SHAPE_BUCKETS) -> np.ndarray:
    """Zero-pad ``X`` (N, F) up to its row bucket.  Padding rows cannot
    perturb real rows: every prediction path reduces per row."""
    nb = bucket_rows(X.shape[0], ladder)
    if nb == X.shape[0]:
        return X
    return np.concatenate(
        [X, np.zeros((nb - X.shape[0], X.shape[1]), X.dtype)], axis=0)


@dataclasses.dataclass
class Tree:
    """Host-side view of one trained tree (numpy arrays).

    Internal node arrays have length num_leaves-1 (only the first
    ``num_leaves_actual - 1`` entries are meaningful); leaf arrays have length
    num_leaves.  Child pointers >= 0 index internal nodes; negative pointers
    are leaves encoded as ``~leaf_index`` (reference tree.h convention).
    """

    num_leaves: int                    # actual leaves
    split_feature: np.ndarray          # (L-1,) int32, inner feature index
    threshold_bin: np.ndarray          # (L-1,) int32
    nan_bin: np.ndarray                # (L-1,) int32 bin holding NaN (-1: none)
    threshold: np.ndarray              # (L-1,) float64 raw-value threshold
    decision_type: np.ndarray          # (L-1,) uint8
    left_child: np.ndarray             # (L-1,) int32
    right_child: np.ndarray            # (L-1,) int32
    split_gain: np.ndarray             # (L-1,) float32
    internal_value: np.ndarray         # (L-1,) float64
    internal_weight: np.ndarray        # (L-1,) float64
    internal_count: np.ndarray         # (L-1,) int64
    leaf_value: np.ndarray             # (L,) float64
    leaf_weight: np.ndarray            # (L,) float64
    leaf_count: np.ndarray             # (L,) int64
    shrinkage: float = 1.0
    # Categorical set splits (reference tree.h:85 SplitCategorical):
    # cat nodes store threshold = RANK into cat_boundaries; the flat
    # cat_threshold uint32 words are a bitset over RAW category values
    # (cat_boundaries[rank]..cat_boundaries[rank+1] words per node).
    cat_boundaries: Optional[np.ndarray] = None   # (num_cat+1,) int32
    cat_threshold: Optional[np.ndarray] = None    # flat uint32 words
    # runtime-only binned membership for training-time walks (not
    # serialized; rebuilt from the bin mappers on load): (L-1, B) bool
    cat_member_bins: Optional[np.ndarray] = None
    # Linear-tree fields (reference tree.h is_linear_/leaf_const_/
    # leaf_coeff_/leaf_features_): per-leaf linear models on branch
    # features; leaf_features holds REAL column indices; prediction is
    # leaf_const + sum(coef * x), falling back to leaf_value when any
    # leaf feature is NaN.
    is_linear: bool = False
    leaf_const: Optional[np.ndarray] = None       # (L,) float64
    leaf_coeff: Optional[List[List[float]]] = None
    leaf_features: Optional[List[List[int]]] = None        # REAL indices
    leaf_features_inner: Optional[List[List[int]]] = None  # inner indices

    @property
    def max_leaves(self) -> int:
        return len(self.leaf_value)

    def num_cat_nodes(self) -> int:
        return 0 if self.cat_boundaries is None else \
            len(self.cat_boundaries) - 1

    def cat_values(self, node: int) -> List[int]:
        """Raw category values in the node's LEFT set."""
        if self.cat_boundaries is None:
            return [int(self.threshold[node])]
        rank = int(self.threshold[node])
        lo = int(self.cat_boundaries[rank])
        hi = int(self.cat_boundaries[rank + 1])
        return [w * 32 + b for w in range(hi - lo) for b in range(32)
                if int(self.cat_threshold[lo + w]) & (1 << b)]

    def cat_decision(self, node: int, value: float) -> bool:
        """Set-membership decision for a categorical node on a RAW value
        (reference tree.h FindInBitset + Tree::CategoricalDecision).
        True -> go left."""
        if np.isnan(value):
            return bool(self.decision_type[node] & DEFAULT_LEFT_MASK)
        iv = int(value)
        if iv < 0 or iv != value:
            return False
        if self.cat_boundaries is None:
            return iv == int(self.threshold[node])  # legacy single-category
        rank = int(self.threshold[node])
        lo = int(self.cat_boundaries[rank])
        hi = int(self.cat_boundaries[rank + 1])
        word = iv // 32
        if word >= hi - lo:
            return False
        return bool((int(self.cat_threshold[lo + word]) >> (iv % 32)) & 1)

    def num_internal(self) -> int:
        return max(self.num_leaves - 1, 0)

    def shrink(self, rate: float) -> None:
        """In-place shrinkage (reference tree.h Shrinkage)."""
        self.leaf_value = self.leaf_value * rate
        self.internal_value = self.internal_value * rate
        if self.is_linear:
            self.leaf_const = self.leaf_const * rate
            self.leaf_coeff = [[c * rate for c in cs]
                               for cs in self.leaf_coeff]
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        self.leaf_value = self.leaf_value + val
        self.internal_value = self.internal_value + val
        if self.is_linear:
            self.leaf_const = self.leaf_const + val

    def linear_predict_row(self, leaf: int, row: np.ndarray) -> float:
        """Host reference linear-leaf evaluation (tree.cpp
        PredictionFunLinear): NaN in any leaf feature -> plain output."""
        feats = (self.leaf_features_inner if self.leaf_features_inner
                 is not None else self.leaf_features)[leaf]
        total = float(self.leaf_const[leaf])
        for f, c in zip(feats, self.leaf_coeff[leaf]):
            v = row[f]
            if np.isnan(v):
                return float(self.leaf_value[leaf])
            total += c * v
        return total

    def predict(self, X: np.ndarray) -> np.ndarray:
        """Raw-feature prediction, host reference implementation
        (tree.h:133 Tree::Predict).  Used for testing; batch prediction goes
        through TreeBatch."""
        out = np.empty(len(X), dtype=np.float64)
        for i, row in enumerate(X):
            node = 0
            if self.num_leaves <= 1:
                out[i] = self.leaf_value[0]
                continue
            while node >= 0:
                f = self.split_feature[node]
                v = row[f]
                dt = self.decision_type[node]
                if dt & CAT_MASK:
                    left = self.cat_decision(node, v)
                else:
                    if np.isnan(v):
                        if (dt >> 2) == 2:  # missing nan
                            left = bool(dt & DEFAULT_LEFT_MASK)
                        else:
                            v = 0.0
                            left = v <= self.threshold[node]
                    else:
                        left = v <= self.threshold[node]
                node = self.left_child[node] if left else self.right_child[node]
            out[i] = (self.linear_predict_row(~node, row) if self.is_linear
                      else self.leaf_value[~node])
        return out


class TreeBatch:
    """Stacked tensors for T trees of identical max size on one device.
    Categorical nodes carry their bitset words over raw category values,
    (T, L-1, W) ``cat_words``, and linear leaves their models, (T, L, K)
    ``leaf_feat`` / ``leaf_fmask`` / ``leaf_coef`` and (T, L)
    ``leaf_const`` (reference models/tree.py:252-319)."""

    def __init__(self, trees: List[Tree], device=torch.device("cpu")):
        if not trees:
            raise ValueError("no trees")
        self.num_trees = len(trees)
        self.max_leaves = max(max(t.max_leaves, t.num_leaves) for t in trees)
        ml = self.max_leaves
        dev = torch.device(device)

        def stack(attr, size, dtype, fill=0):
            out = np.full((len(trees), max(size, 1)), fill, dtype)
            for i, t in enumerate(trees):
                a = np.asarray(getattr(t, attr))[:size]
                out[i, :len(a)] = a
            return torch.as_tensor(out, device=dev)

        self.split_feature = stack("split_feature", ml - 1, np.int64)
        self.threshold = stack("threshold", ml - 1, np.float32)
        self.decision_type = stack("decision_type", ml - 1, np.int32)
        self.left_child = stack("left_child", ml - 1, np.int64)
        self.right_child = stack("right_child", ml - 1, np.int64)
        self.leaf_value = stack("leaf_value", ml, np.float32)
        self.num_leaves = torch.as_tensor(
            np.array([t.num_leaves for t in trees], np.int64), device=dev)
        self.has_linear = any(t.is_linear for t in trees)
        if self.has_linear:
            lk = 1
            for t in trees:
                if t.is_linear:
                    lk = max(lk, max((len(f) for f in _leaf_feats(t)),
                                     default=1))
            lconst = np.zeros((len(trees), ml), np.float32)
            lcoef = np.zeros((len(trees), ml, lk), np.float32)
            lfeat = np.zeros((len(trees), ml, lk), np.int64)
            lfmask = np.zeros((len(trees), ml, lk), bool)
            lflag = np.zeros((len(trees),), bool)
            for ti, t in enumerate(trees):
                if not t.is_linear:
                    continue
                lflag[ti] = True
                lconst[ti, :len(t.leaf_const)] = t.leaf_const
                for leaf, (fs, cs) in enumerate(zip(_leaf_feats(t),
                                                    t.leaf_coeff)):
                    lfeat[ti, leaf, :len(fs)] = fs
                    lfmask[ti, leaf, :len(fs)] = True
                    lcoef[ti, leaf, :len(cs)] = cs
            self.leaf_const = torch.as_tensor(lconst, device=dev)
            self.leaf_coef = torch.as_tensor(lcoef, device=dev)
            self.leaf_feat = torch.as_tensor(lfeat, device=dev)
            self.leaf_fmask = torch.as_tensor(lfmask, device=dev)
            self.linear_flag = lflag
        self._path_matrices(trees)
        # None when no tree has a categorical node
        self.cat_words = None
        if not self.has_cat:
            return
        wmax = 1
        for t in trees:
            if t.cat_boundaries is not None:
                wmax = max([wmax] + list(np.diff(t.cat_boundaries)))
            else:  # legacy single-category nodes: threshold IS the category
                for i in range(t.num_internal()):
                    if t.decision_type[i] & CAT_MASK:
                        wmax = max(wmax, int(t.threshold[i]) // 32 + 1)
        words = np.zeros((len(trees), max(ml - 1, 1), int(wmax)), np.int64)
        for ti, t in enumerate(trees):
            for i in range(t.num_internal()):
                if not t.decision_type[i] & CAT_MASK:
                    continue
                if t.cat_boundaries is not None:
                    rank = int(t.threshold[i])
                    lo = int(t.cat_boundaries[rank])
                    hi = int(t.cat_boundaries[rank + 1])
                    words[ti, i, :hi - lo] = t.cat_threshold[lo:hi]
                else:
                    v = int(t.threshold[i])
                    words[ti, i, v // 32] |= 1 << (v % 32)
        self.cat_words = torch.as_tensor(words, device=dev)


    def _path_matrices(self, trees: List[Tree]) -> None:
        """The dense walk's root-path matrices (reference
        models/tree.py:322-356), host numpy: ``path_dir[t, n, l]`` = +1
        when node n sits on leaf l's root path expecting a LEFT decision,
        -1 expecting RIGHT; ``plen_right`` counts a path's right turns
        and ``plen_total`` its length (1e9 for leaf slots beyond
        ``num_leaves``, which no row reaches)."""
        ml = self.max_leaves
        self.has_cat = any(bool(np.bitwise_and(
            np.asarray(t.decision_type[:max(t.num_leaves - 1, 0)],
                       np.uint8), CAT_MASK).any()) for t in trees)
        pd = np.zeros((len(trees), max(ml - 1, 1), ml), np.int8)
        pr = np.zeros((len(trees), ml), np.float32)
        pt = np.full((len(trees), ml), 1e9, np.float32)
        for ti, t in enumerate(trees):
            if t.num_leaves <= 1:
                pt[ti, 0] = 0.0
                continue
            lc = np.asarray(t.left_child)
            rc = np.asarray(t.right_child)
            work = [(0, [])]
            while work:
                node, path = work.pop()
                for child, d in ((int(lc[node]), 1), (int(rc[node]), -1)):
                    p2 = path + [(node, d)]
                    if child < 0:
                        leaf = ~child
                        if leaf < ml:
                            for nn_, dd in p2:
                                pd[ti, nn_, leaf] = dd
                            pr[ti, leaf] = float(
                                sum(1 for _, dd in p2 if dd < 0))
                            pt[ti, leaf] = float(len(p2))
                    else:
                        work.append((child, p2))
        self.path_dir = pd
        self.plen_right = pr
        self.plen_total = pt


def _leaf_feats(t: Tree) -> List[List[int]]:
    """A linear tree's per-leaf features on the prediction matrix's
    columns: inner indices when trained here, the file's for a loaded
    model (its inner map is the identity)."""
    return t.leaf_features_inner if t.leaf_features_inner is not None \
        else t.leaf_features


def _walk_raw(X: torch.Tensor, split_feature, threshold, decision_type,
              left_child, right_child, leaf_value, num_leaves,
              cat_words=None, want_leaf: bool = False):
    """One tree's walk on RAW float features (the reference's
    ``_walk_raw``, models/tree.py:604-654): NaN goes to ``default_left``
    under missing type NaN, otherwise counts as 0.0; a categorical node
    goes left when its bitset ``cat_words`` ((L-1, W) int64 holding
    uint32 words) holds the value, NaN following ``default_left`` and a
    negative or fractional value going right."""
    n = X.shape[0]
    if int(num_leaves) <= 1:
        out = leaf_value[0].expand(n).clone()
        if want_leaf:
            return out, torch.zeros((n,), dtype=torch.long, device=X.device)
        return out
    node = torch.zeros((n,), dtype=torch.long, device=X.device)
    out = torch.zeros((n,), dtype=torch.float32, device=X.device)
    leaf = torch.zeros((n,), dtype=torch.long, device=X.device)
    rows = torch.arange(n, device=X.device)
    active = torch.ones((n,), dtype=torch.bool, device=X.device)
    while bool(active.any()):
        nd = node.clamp(min=0)
        v = X[rows, split_feature[nd]]
        dt = decision_type[nd]
        dleft = (dt & DEFAULT_LEFT_MASK) != 0
        miss_nan = (dt & (3 << 2)) == MISSING_NAN
        is_nan = torch.isnan(v)
        v_num = torch.where(is_nan & ~miss_nan, torch.zeros_like(v), v)
        go_left = torch.where(is_nan & miss_nan, dleft,
                              v_num <= threshold[nd])
        if cat_words is not None:
            w = cat_words.shape[1]
            is_cat = (dt & CAT_MASK) != 0
            # the reference's int32 cast and its integrality check
            vn = torch.where(is_nan, torch.full_like(v, -1.0), v)
            vi = vn.clamp(max=2.0 ** 31 - 128).to(torch.int32)
            in_range = (vi >= 0) & (vi < w * 32) & (vi.to(v.dtype) == vn)
            vc = vi.clamp(0, w * 32 - 1).long()
            word = cat_words.reshape(-1)[nd * w + vc // 32]
            bit = (word >> (vc % 32)) & 1
            go_cat = torch.where(is_nan, dleft, in_range & (bit > 0))
            go_left = torch.where(is_cat, go_cat, go_left)
        nxt = torch.where(go_left, left_child[nd], right_child[nd])
        new_node = torch.where(active, nxt, node)
        hit = active & (new_node < 0)
        out = torch.where(hit, leaf_value[(~new_node).clamp(min=0)], out)
        leaf = torch.where(hit, (~new_node).clamp(min=0), leaf)
        node = new_node
        active = node >= 0
    if want_leaf:
        return out, leaf
    return out


def _tree_out(batch: TreeBatch, X: torch.Tensor, t: int,
              want_leaf: bool = False):
    """Tree ``t``'s output per row on raw features: the plain leaf value,
    or a linear leaf's const + Σ coef·x with the plain value where a leaf
    feature is NaN (reference tree.cpp PredictionFunLinear,
    models/tree.py:722-733); with ``want_leaf`` also the leaf index."""
    linear = batch.has_linear and bool(batch.linear_flag[t])
    val, leaf = _walk_raw(X, batch.split_feature[t], batch.threshold[t],
                          batch.decision_type[t], batch.left_child[t],
                          batch.right_child[t], batch.leaf_value[t],
                          batch.num_leaves[t],
                          None if batch.cat_words is None
                          else batch.cat_words[t], want_leaf=True)
    if linear:
        from ..learner.linear import linear_score_delta
        val = linear_score_delta(X, leaf, batch.leaf_feat[t],
                                 batch.leaf_fmask[t], batch.leaf_coef[t],
                                 batch.leaf_const[t], batch.leaf_value[t])
    return (val, leaf) if want_leaf else val


def predict_raw(batch: TreeBatch, X: torch.Tensor,
                start_iteration: int = 0,
                num_iteration: Optional[int] = None) -> torch.Tensor:
    """Ensemble raw score (reference gbdt_prediction.cpp PredictRaw): the
    per-tree walks summed in tree order, in f32."""
    t_end = batch.num_trees if num_iteration is None else min(
        start_iteration + num_iteration, batch.num_trees)
    X = X.to(torch.float32)
    out = torch.zeros((X.shape[0],), dtype=torch.float32, device=X.device)
    for t in range(start_iteration, t_end):
        out = out + _tree_out(batch, X, t)
    return out


def predict_leaf(batch: TreeBatch, X: torch.Tensor) -> torch.Tensor:
    """(N, T) int32 leaf index of every row in every tree (reference
    models/gbdt.py:1404-1427 ``_predict_leaf``)."""
    X = X.to(torch.float32)
    return torch.stack([_tree_out(batch, X, t, want_leaf=True)[1]
                        for t in range(batch.num_trees)],
                       dim=1).to(torch.int32)


def predict_raw_early_stop(per_class: List[TreeBatch], X: torch.Tensor,
                           margin: float, freq: int,
                           mode: str) -> torch.Tensor:
    """(N, K) raw scores with a per-row margin-based early exit across
    trees (reference prediction_early_stop.cpp:54 binary, stop once
    2|raw| > margin, and :25 multiclass, once the top-2 gap exceeds it;
    checked every ``freq`` trees; models/tree.py:364-411).  A stopped row
    keeps its partial sum; the tree loop ends once every row stopped."""
    X = X.to(torch.float32)
    n = X.shape[0]
    k = len(per_class)
    out = torch.zeros((n, k), dtype=torch.float32, device=X.device)
    stopped = torch.zeros((n,), dtype=torch.bool, device=X.device)
    zero = torch.zeros((), dtype=torch.float32, device=X.device)
    for t in range(per_class[0].num_trees):
        deltas = [torch.where(stopped, zero, _tree_out(b, X, t))
                  for b in per_class]
        out = out + torch.stack(deltas, dim=1)
        if (t + 1) % freq == 0:
            if mode == "binary":
                stop_now = 2.0 * torch.abs(out[:, 0]) > margin
            else:
                top2 = torch.topk(out, 2, dim=1).values
                stop_now = (top2[:, 0] - top2[:, 1]) > margin
            stopped = stopped | stop_now
            if bool(stopped.all()):
                break
    return out


def ensemble_serve_fields(batch: TreeBatch, start: int = 0,
                          end: Optional[int] = None):
    """One class's ensemble for :func:`predict_raw_ensemble` (reference
    models/tree.py:779): ``(kind, batch, (t0, t1))``, ``kind`` a tag of
    the walk it takes: ``const`` for an all-stump ensemble (the
    constants' sum), ``walk`` / ``walk_lin`` for the sequential tree walk
    (``_walk_raw``; linear leaves evaluated), which the port takes for
    numeric and categorical ensembles alike (the reference's per-tree
    path-matrix scan is its MXU form; the dense program of
    serve/compiler.py takes its place)."""
    t1 = batch.num_trees if end is None else min(end, batch.num_trees)
    t0 = min(start, t1)
    if batch.max_leaves <= 1:
        kind = "const"
    else:
        kind = "walk_lin" if batch.has_linear else "walk"
    return kind, batch, (t0, t1)


def predict_raw_ensemble(X: torch.Tensor, per_class, kinds) -> torch.Tensor:
    """(N, K) raw scores of the per-class ensembles from
    :func:`ensemble_serve_fields` (reference models/tree.py:811)."""
    X = X.to(torch.float32)
    cols = []
    for (batch, (t0, t1)), kind in zip(per_class, kinds):
        if kind == "const":
            cols.append(batch.leaf_value[t0:t1, 0].sum().expand(X.shape[0]))
        elif kind in ("walk", "walk_lin"):
            cols.append(predict_raw(batch, X, t0, t1 - t0))
        else:
            raise ValueError(f"unknown ensemble kind: {kind}")
    return torch.stack(cols, dim=1)
