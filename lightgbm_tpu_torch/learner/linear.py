"""Linear trees: per-leaf linear models on the leaf's branch features.

Port of ``lightgbm_tpu/learner/linear.py`` (reference:
src/treelearner/linear_tree_learner.cpp:175 ``CalculateLinear``): per
leaf, coef = -(Xᵀ H X + λ)⁻¹ Xᵀ g over the leaf's rows, X being [the
leaf's numerical branch features | 1]; rows with NaN in a leaf feature
stay out of the fit and predict the plain leaf output; near-zero
coefficients are pruned.

The per-leaf normal-equation moments are one chunked (L, C) x (C,
(K+1)²) product over a weighted leaf one-hot, as in the reference, with
the products and sums in f64 (the reference multiplies in f32 at
``Precision.HIGHEST``): a plain matrix product, no kernel of the
reference's.  Rows go in chunks of :data:`CHUNK`, so the one-hot is never
(N, L) at full N.  The (K+1)-dimensional solves run in f64 on the host.
The moments differ from the reference's f32 sums in the last bits, so
coefficients and later trees drift from the reference's within a
tolerance (``tests/test_torch_linear.py``).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

__all__ = ["branch_features", "fit_linear_leaves", "linear_score_delta",
           "CHUNK"]

_ZERO_THRESHOLD = 1e-35
# rows per moment chunk: the (C, L) one-hot and the (C, (K+1)²) products
# stay a few hundred MB at L = 255 and K + 1 = 29
CHUNK = 1 << 15


def branch_features(split_feature: np.ndarray, left_child: np.ndarray,
                    right_child: np.ndarray, num_leaves: int,
                    is_cat: np.ndarray) -> List[List[int]]:
    """Unique NUMERICAL features on each leaf's root path (reference
    tree.h branch_features with track_branch_features)."""
    feats: List[List[int]] = [[] for _ in range(num_leaves)]
    if num_leaves <= 1:
        return feats

    def walk(node: int, path: List[int]) -> None:
        f = int(split_feature[node])
        path2 = path + ([f] if not bool(is_cat[f]) else [])
        for child in (int(left_child[node]), int(right_child[node])):
            if child < 0:
                leaf = ~child
                if leaf < num_leaves:
                    feats[leaf] = sorted(set(path2))
            else:
                walk(child, path2)

    walk(0, [])
    return feats


def _leaf_rows(Xr, row_leaf, leaf_feat, leaf_fmask):
    """A chunk's leaf-feature values (C, K) with NaN-free zeros where the
    leaf has no feature, and the rows holding NaN in one of their leaf's
    features."""
    rl = row_leaf.long()
    rf = leaf_feat[rl]
    rm = leaf_fmask[rl]
    vals = torch.gather(Xr, 1, rf)
    nan_row = torch.any(torch.isnan(vals) & rm, dim=1)
    vals = torch.where(rm, torch.nan_to_num(vals), torch.zeros_like(vals))
    return vals, nan_row


def _moments(Xr, grad, hess, bag, row_leaf, leaf_feat, leaf_fmask, L: int):
    """Per-leaf XᵀHX (L, K+1, K+1), Xᵀg (L, K+1) and fit-row counts (L,)
    in f64.  Rows whose own leaf features hold NaN stay out (the
    reference's HAS_NAN path)."""
    n = Xr.shape[0]
    k1 = leaf_feat.shape[1] + 1
    dev = Xr.device
    M = torch.zeros((L, k1 * k1), dtype=torch.float64, device=dev)
    b = torch.zeros((L, k1), dtype=torch.float64, device=dev)
    cnt = torch.zeros((L,), dtype=torch.float64, device=dev)
    leaves = torch.arange(L, device=dev)
    for lo in range(0, n, CHUNK):
        hi = min(n, lo + CHUNK)
        rl = row_leaf[lo:hi]
        vals, nan_row = _leaf_rows(Xr[lo:hi], rl, leaf_feat, leaf_fmask)
        w = bag[lo:hi].double() * (~nan_row).double()
        A = torch.cat([vals.double(),
                       torch.ones((hi - lo, 1), dtype=torch.float64,
                                  device=dev)], dim=1)
        onehot = (rl.long()[:, None] == leaves[None, :]).double()
        A2 = (A[:, :, None] * A[:, None, :]).reshape(hi - lo, k1 * k1)
        M += (onehot * (hess[lo:hi].double() * w)[:, None]).t() @ A2
        b += (onehot * (grad[lo:hi].double() * w)[:, None]).t() @ A
        cnt += (onehot * w[:, None]).sum(dim=0)
    return M.reshape(L, k1, k1), b, cnt


def fit_linear_leaves(Xr_dev: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, bag: torch.Tensor,
                      row_leaf: torch.Tensor, split_feature, left_child,
                      right_child, num_leaves: int, is_cat: np.ndarray,
                      linear_lambda: float, leaf_value: np.ndarray
                      ) -> Tuple[List[List[int]], List[List[float]],
                                 np.ndarray]:
    """Fit every leaf's linear model of one grown tree.

    Returns (leaf features per leaf, coefficients per leaf, leaf_const).
    ``leaf_value`` is the plain closed-form output, the constant of a
    leaf whose fit is under-determined or fails
    (linear_tree_learner.cpp:330-340)."""
    feats = branch_features(split_feature, left_child, right_child,
                            num_leaves, is_cat)
    L = max(num_leaves, 1)
    K = max(1, max((len(f) for f in feats), default=1))
    leaf_feat = np.zeros((L, K), np.int64)
    leaf_fmask = np.zeros((L, K), bool)
    for i, f in enumerate(feats):
        leaf_feat[i, :len(f)] = f
        leaf_fmask[i, :len(f)] = True
    dev = Xr_dev.device
    M, b, cnt = _moments(Xr_dev, grad, hess, bag, row_leaf,
                         torch.as_tensor(leaf_feat, device=dev),
                         torch.as_tensor(leaf_fmask, device=dev), L)
    M = M.cpu().numpy()
    b = b.cpu().numpy()
    cnt = cnt.cpu().numpy()

    out_feats: List[List[int]] = []
    out_coefs: List[List[float]] = []
    out_const = np.asarray(leaf_value, np.float64).copy()
    for i in range(L):
        k = len(feats[i]) if i < len(feats) else 0
        if i >= num_leaves or cnt[i] < k + 1:
            out_feats.append([])
            out_coefs.append([])
            continue
        # the reference's slice: the intercept's moments sit at column K,
        # so a leaf with k < K features takes a padded column and its
        # solve fails (it keeps the plain value); kept for parity
        # (ROADMAP queue 3 item 6)
        Mi = M[i, :k + 1, :k + 1].copy()
        Mi[np.arange(k), np.arange(k)] += linear_lambda  # not the intercept
        try:
            coef = -np.linalg.solve(Mi, b[i, :k + 1])
        except np.linalg.LinAlgError:
            out_feats.append([])
            out_coefs.append([])
            continue
        if not np.all(np.isfinite(coef)):
            out_feats.append([])
            out_coefs.append([])
            continue
        keep = [j for j in range(k) if abs(coef[j]) > _ZERO_THRESHOLD]
        out_feats.append([feats[i][j] for j in keep])
        out_coefs.append([float(coef[j]) for j in keep])
        out_const[i] = float(coef[k])
    return out_feats, out_coefs, out_const


def linear_score_delta(Xr: torch.Tensor, row_leaf: torch.Tensor,
                       leaf_feat: torch.Tensor, leaf_fmask: torch.Tensor,
                       leaf_coef: torch.Tensor, leaf_const: torch.Tensor,
                       leaf_value: torch.Tensor) -> torch.Tensor:
    """Per-row score delta of a linear tree, const + Σ coef·x in f32,
    the plain leaf output where a leaf feature is NaN (reference
    tree.cpp PredictionFunLinear), in row chunks."""
    n = Xr.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=Xr.device)
    fmask = leaf_fmask > 0
    for lo in range(0, n, 32 * CHUNK):
        hi = min(n, lo + 32 * CHUNK)
        rl = row_leaf[lo:hi].long()
        vals, nan_row = _leaf_rows(Xr[lo:hi], rl, leaf_feat.long(), fmask)
        lin = leaf_const[rl] + torch.sum(leaf_coef[rl] * vals, dim=1)
        out[lo:hi] = torch.where(nan_row, leaf_value[rl], lin)
    return out
