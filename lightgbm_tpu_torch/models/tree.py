"""Flat-array decision tree model + tensor prediction.

Port of ``lightgbm_tpu/models/tree.py`` (reference: include/LightGBM/tree.h:25
``Tree`` — flat arrays, child pointers ``~leaf_index`` for leaves).  The
host-side :class:`Tree` is a copy; :class:`TreeBatch` stacks an ensemble
into tensors on the prediction device and :func:`predict_raw` is the plain
vectorized tree walk (every row advances one level per step).  The
reference's dense matmul walk and serving compiler wait for a later slice
(ROADMAP queue 1, item 8).

decision_type bit layout follows the reference (tree.h decision_type):
  bit0: categorical, bit1: default_left, bits 2-3: missing type
  (0 none, 1 zero, 2 nan).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

__all__ = ["Tree", "TreeBatch", "predict_raw"]

CAT_MASK = 1
DEFAULT_LEFT_MASK = 2
MISSING_ZERO = 1 << 2
MISSING_NAN = 2 << 2


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
    """Stacked tensors for T trees of identical max size on one device
    (numeric trees; categorical and linear trees are not ported yet)."""

    def __init__(self, trees: List[Tree], device=torch.device("cpu")):
        if not trees:
            raise ValueError("no trees")
        for t in trees:
            if t.is_linear or np.any(
                    np.asarray(t.decision_type[:t.num_internal()],
                               np.uint8) & CAT_MASK):
                raise NotImplementedError(
                    "categorical and linear trees are not ported to "
                    "lightgbm_tpu_torch yet (ROADMAP queue 1, item 7)")
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


def _walk_raw(X: torch.Tensor, split_feature, threshold, decision_type,
              left_child, right_child, leaf_value, num_leaves) -> torch.Tensor:
    """One tree's walk on RAW float features (the reference's numeric
    ``_walk_raw``): NaN goes to ``default_left`` under missing type NaN,
    otherwise counts as 0.0."""
    n = X.shape[0]
    if int(num_leaves) <= 1:
        return leaf_value[0].expand(n).clone()
    node = torch.zeros((n,), dtype=torch.long, device=X.device)
    out = torch.zeros((n,), dtype=torch.float32, device=X.device)
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
        nxt = torch.where(go_left, left_child[nd], right_child[nd])
        new_node = torch.where(active, nxt, node)
        hit = active & (new_node < 0)
        out = torch.where(hit, leaf_value[(~new_node).clamp(min=0)], out)
        node = new_node
        active = node >= 0
    return out


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
        out = out + _walk_raw(X, batch.split_feature[t], batch.threshold[t],
                              batch.decision_type[t], batch.left_child[t],
                              batch.right_child[t], batch.leaf_value[t],
                              batch.num_leaves[t])
    return out
