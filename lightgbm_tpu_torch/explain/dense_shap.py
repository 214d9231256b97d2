"""Dense TreeSHAP: Algorithm 2 lowered to loop-free-in-rows tensor algebra.

Port of ``lightgbm_tpu/explain/dense_shap.py``.  The host walk
(:mod:`..models.shap`) recurses every tree per row chunk in Python, but
the recursion's control structure is row-independent: which nodes each
root path visits, which feature sits at each path level, and every zero
fraction (a count ratio) are model constants; only the per-(row, node)
hot-branch bit varies, and that bit is the condition matrix of the dense
serving program (``models/dense_predict._decision_matrix``).

* **Host lowering** (:func:`lower_explain`, numpy, the reference's)
  walks each tree's leaf root paths once and merges duplicate features
  into at most ``D`` slots per path (a revisited feature's zero fraction
  is the product of its occurrences' count ratios, its one fraction the
  AND of their hot bits), giving padded (tree, leaf, slot) tensors: the
  feature column, the static zero fraction, and a signed node-occurrence
  matrix ``occ_dir`` (+1 left-expected, -1 right-expected).
* **Padding is inert**: a slot with (z=1, o=1) leaves the subset-weight
  algebra invariant, so every path pads to ``D`` slots and every tree to
  ``L`` leaves with zero-valued leaves.
* **The program** (:func:`dense_explain`): one fractions are
  ``relu(dec @ occ_dir + negs - count + 1)``, an exact 0/1 AND over
  integer counts; then the extend recursion and Sum(UNWIND) run as
  elementwise f32 ops over the static (D + 1) position axis.  The
  reference unrolls them in its trace; the port keeps the same
  arithmetic in the same order as a Python loop over positions.
  Per-leaf contributions scatter-add into the phi block at static
  columns, and the program also returns the plain raw score (reach
  indicator times leaf values) for the additivity check.

Parity: within rtol 1e-4 of the f64 host walk (exact f32 leaf values;
the explain path never quantizes leaf tables).  Linear-leaf trees
attribute each leaf's PLAIN output, as the host walk does.  The 0/1
contraction runs in float16 on the card (exact); the class sum is an
elementwise f32 product and sum, so no TF32 setting reaches it.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.dense_predict import (DenseArrays, DenseLoweringError,
                                    DenseMeta, _class_sum, _count_matmul,
                                    _decision_matrix)
from ..models.shap import node_expectations
from ..models.tree import Tree, TreeBatch

__all__ = ["EXPLAIN_DEPTH_BUDGET", "EXPLAIN_TABLE_BUDGET",
           "EXPLAIN_TABLE_BUDGET_CUDA", "ExplainArrays", "ExplainMeta",
           "lower_explain", "dense_explain"]

# Budgets (the reference's; past them the host walk serves with a
# counted reason): depth, the merged slots per path (the unwound-sum
# algebra takes O(D^2) elementwise steps); table, the bytes of the
# (T, Nn, L*D) signed occurrence matrix.
EXPLAIN_DEPTH_BUDGET = 48
EXPLAIN_TABLE_BUDGET = 256 << 20
# On the card the table may take 4 GiB, a twentieth of the 80 GB card: a
# 64-tree x 255-leaf model with 17 or more merged slots a path needs more
# than 256 MiB (chip_smoke.py phase 14c's model).
EXPLAIN_TABLE_BUDGET_CUDA = 4 << 30


class ExplainMeta(NamedTuple):
    """Static half of an explain lowering."""

    num_class: int
    num_trees: int            # real trees
    num_cols: int             # phi block width = feature columns + bias
    depth: int                # D: merged-slot count per root path
    half: bool                # float16 0/1 contraction (the card)


class ExplainArrays(NamedTuple):
    """Device half: padded per-(tree, leaf, slot) root-path tensors."""

    occ_dir: torch.Tensor     # (T, Nn, L*D) f32 +1 left / -1 right / 0
    occ_neg: torch.Tensor     # (T, 1, L*D) f32, right-expected count
    occ_cnt: torch.Tensor     # (T, 1, L*D) f32, occurrences (0 = pad)
    zfrac: torch.Tensor       # (T, 1, L, D) f32, static zero fractions
    leaf_val: torch.Tensor    # (T, 1, L) f32, PLAIN leaf values, exact
    seg: torch.Tensor         # (T*L*D,) int64, phi column per slot
    bias: torch.Tensor        # (K*num_cols,) f32, expected-value row
    class_onehot: torch.Tensor  # (T, K) f32


def _leaf_paths(tree: Tree) -> List[List[Tuple[int, bool]]]:
    """Root path of every leaf as (internal node, went_left) pairs, by
    the DFS of the ``TreeBatch`` path matrices."""
    nl = int(tree.num_leaves)
    if nl <= 1:
        return [[]]
    out: List[Optional[List[Tuple[int, bool]]]] = [None] * nl
    work: List[Tuple[int, List[Tuple[int, bool]]]] = [(0, [])]
    while work:
        node, path = work.pop()
        for child, went_left in ((int(tree.left_child[node]), True),
                                 (int(tree.right_child[node]), False)):
            p2 = path + [(node, went_left)]
            if child < 0:
                out[~child] = p2
            else:
                work.append((child, p2))
    return out  # type: ignore[return-value]


def _node_count(tree: Tree, node: int) -> float:
    if node < 0:
        return float(tree.leaf_count[~node])
    return float(tree.internal_count[node])


def lower_explain(trees: List[Tree], num_class: int, num_cols: int,
                  class_ids: Optional[List[int]] = None, *,
                  half: bool = False, batch: Optional[TreeBatch] = None,
                  depth_budget: int = EXPLAIN_DEPTH_BUDGET,
                  table_budget: int = EXPLAIN_TABLE_BUDGET,
                  device=None) -> Tuple[ExplainArrays, ExplainMeta]:
    """Lower ``trees`` into the dense TreeSHAP tensors on ``device``
    (reference dense_shap.py:117-233).

    ``num_cols`` is the phi block width (``num_features + 1``, the bias in
    the last column, ``models/shap.predict_contrib``'s layout).  Raises
    :class:`DenseLoweringError` with reason ``explain_depth_budget`` or
    ``explain_table_budget`` past the budgets."""
    if not trees:
        raise DenseLoweringError("no_trees")
    b = batch if batch is not None else TreeBatch(trees)
    T = b.num_trees
    L = int(b.max_leaves)
    Nn = max(L - 1, 1)
    if class_ids is None:
        class_ids = [t % num_class for t in range(T)]

    # pass 1: merge duplicate features into slots; find the slot depth D
    merged = []
    depth = 0
    for tree in trees:
        per_leaf = []
        for path in _leaf_paths(tree):
            slots: dict = {}
            feat: List[int] = []
            zfrac: List[float] = []
            occ: List[List[Tuple[int, bool]]] = []
            for node, went_left in path:
                f = int(tree.split_feature[node])
                child = int(tree.left_child[node] if went_left
                            else tree.right_child[node])
                cnt = _node_count(tree, node)
                ratio = _node_count(tree, child) / cnt if cnt > 0 else 0.0
                if f in slots:
                    s = slots[f]
                    zfrac[s] *= ratio
                    occ[s].append((node, went_left))
                else:
                    slots[f] = len(feat)
                    feat.append(f)
                    zfrac.append(ratio)
                    occ.append([(node, went_left)])
            depth = max(depth, len(feat))
            per_leaf.append((feat, zfrac, occ))
        merged.append(per_leaf)
    D = depth
    if D > depth_budget:
        raise DenseLoweringError(
            "explain_depth_budget",
            f"{D} merged path slots > budget {depth_budget}")
    table = 4 * T * Nn * L * max(D, 1)
    if table > table_budget:
        raise DenseLoweringError(
            "explain_table_budget",
            f"occurrence table {table} B > budget {table_budget} B")

    Dp = max(D, 1)
    occ_dir = np.zeros((T, Nn, L * Dp), np.float32)
    occ_neg = np.zeros((T, 1, L * Dp), np.float32)
    occ_cnt = np.zeros((T, 1, L * Dp), np.float32)
    zfr = np.ones((T, 1, L, Dp), np.float32)
    leaf_val = np.zeros((T, 1, L), np.float32)
    # inert pads scatter into their class's bias column (their
    # contribution is exactly zero, so the target only has to be valid)
    seg = np.empty((T, L, Dp), np.int64)
    bias = np.zeros(num_class * num_cols, np.float64)
    class_onehot = np.zeros((T, num_class), np.float32)
    for t, tree in enumerate(trees):
        cid = int(class_ids[t])
        class_onehot[t, cid] = 1.0
        seg[t] = cid * num_cols + (num_cols - 1)
        nl = int(tree.num_leaves)
        if nl <= 1:
            # stump: only the bias moves; its value rides the reach
            # indicator so the raw score includes it
            bias[cid * num_cols + num_cols - 1] += float(tree.leaf_value[0])
            leaf_val[t, 0, 0] = np.float32(tree.leaf_value[0])
            continue
        bias[cid * num_cols + num_cols - 1] += float(
            node_expectations(tree)[0])
        for li in range(nl):
            leaf_val[t, 0, li] = np.float32(tree.leaf_value[li])
            feat, zf, occ = merged[t][li]
            for s in range(len(feat)):
                col = li * D + s
                seg[t, li, s] = cid * num_cols + feat[s]
                zfr[t, 0, li, s] = np.float32(zf[s])
                occ_cnt[t, 0, col] = float(len(occ[s]))
                for node, went_left in occ[s]:
                    if went_left:
                        occ_dir[t, node, col] = 1.0
                    else:
                        occ_dir[t, node, col] = -1.0
                        occ_neg[t, 0, col] += 1.0

    dev = torch.device(device) if device is not None else \
        torch.device("cpu")

    def j(a):
        return torch.as_tensor(a, device=dev)

    arrays = ExplainArrays(
        occ_dir=j(occ_dir), occ_neg=j(occ_neg), occ_cnt=j(occ_cnt),
        zfrac=j(zfr), leaf_val=j(leaf_val), seg=j(seg.reshape(-1)),
        bias=j(bias.astype(np.float32)), class_onehot=j(class_onehot))
    meta = ExplainMeta(num_class=num_class, num_trees=T, num_cols=num_cols,
                       depth=D, half=bool(half))
    return arrays, meta


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def _one_fractions(dec: torch.Tensor, E: ExplainArrays,
                   emeta: ExplainMeta) -> torch.Tensor:
    """(T, N, L, D) exact 0/1 slot one fractions: the signed-occurrence
    contraction counts matching hot bits (right-expected nodes count
    ``1 - dec`` through the folded ``occ_neg``), and ``relu(count -
    total + 1)`` is 1 exactly when every occurrence matches; zero
    occurrence pads come out 1 (reference dense_shap.py:240-257)."""
    hot = _count_matmul(dec.permute(1, 0, 2), E.occ_dir, emeta.half)
    o = torch.relu(hot + E.occ_neg - E.occ_cnt + 1.0)        # (T, N, L*D)
    T, n = o.shape[0], o.shape[1]
    L = E.leaf_val.shape[2]
    return o.reshape(T, n, L, max(emeta.depth, 1))


def _extend_all(O: torch.Tensor, Z: torch.Tensor,
                emeta: ExplainMeta) -> torch.Tensor:
    """Algorithm 2's EXTEND over the full path: pweight state (T, N, L,
    D+1) over the static position axis, step ``s`` folding slot ``s``'s
    fractions in with the (l-i)/(l+1), (i+1)/(l+1) coefficient rows
    (reference dense_shap.py:260-281, same operations in the same
    order)."""
    D = emeta.depth
    T, n, L = O.shape[0], O.shape[1], O.shape[2]
    dev = O.device
    w = torch.cat([torch.ones((T, n, L, 1), dtype=torch.float32, device=dev),
                   torch.zeros((T, n, L, D), dtype=torch.float32,
                               device=dev)], dim=-1)
    pos = np.arange(D + 1, dtype=np.float64)
    for s in range(1, D + 1):
        pz = Z[..., s - 1:s]                                  # (T,1,L,1)
        po = O[..., s - 1:s]                                  # (T,N,L,1)
        keep = torch.as_tensor(np.maximum(s - pos, 0.0) / (s + 1.0),
                               dtype=torch.float32, device=dev)
        shift = torch.as_tensor(pos / (s + 1.0), dtype=torch.float32,
                                device=dev)
        shifted = torch.cat([torch.zeros_like(w[..., :1]), w[..., :-1]],
                            dim=-1)
        w = pz * w * keep + po * shifted * shift
    return w


def _unwound_contribs(w: torch.Tensor, O: torch.Tensor, Z: torch.Tensor,
                      E: ExplainArrays, emeta: ExplainMeta) -> torch.Tensor:
    """(T, N, L, D) per-slot contributions ``Sum(UNWIND(w, i)) * (o_i -
    z_i) * leaf_value``, the host walk's ``unwound_sum`` with both loops
    over the static slot and position axes (reference
    dense_shap.py:284-309).  Inert pads have o == z == 1: factor 0."""
    D = emeta.depth
    out = []
    one = torch.ones((), dtype=torch.float32, device=O.device)
    for i in range(1, D + 1):
        o = O[..., i - 1]                                     # (T,N,L)
        z = Z[..., i - 1]                                     # (T,1,L)
        o_nz = o != 0
        o_safe = torch.where(o_nz, o, one)
        z_safe = torch.where(z != 0, z, one)
        nn = w[..., D]
        total = torch.zeros_like(o)
        for j in range(D - 1, -1, -1):
            t = nn * np.float32((D + 1.0) / (j + 1.0)) / o_safe
            total = total + torch.where(
                o_nz, t, w[..., j] * np.float32((D + 1.0) / (D - j)) / z_safe)
            nn = torch.where(
                o_nz, w[..., j] - t * z * np.float32((D - j) / (D + 1.0)),
                nn)
        out.append(total * (o - z))
    c = torch.stack(out, dim=-1) if out else \
        torch.zeros(O.shape[:3] + (0,), dtype=torch.float32, device=O.device)
    return c * E.leaf_val[..., None]


def dense_explain(X: torch.Tensor, A: DenseArrays, dmeta: DenseMeta,
                  E: ExplainArrays, emeta: ExplainMeta
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense TreeSHAP of a row block: ``(phi (N, K*num_cols) f32, raw
    (N, K) f32)``, ``raw`` the plain-leaf raw score the phi rows must sum
    to (reference dense_shap.py:312-342)."""
    X = X.to(torch.float32)
    n = X.shape[0]
    dec = _decision_matrix(X, A, dmeta)                       # (N, T, Nn)
    O = _one_fractions(dec, E, emeta)
    if emeta.depth == 0:
        # all-stump ensemble: one inert slot per leaf, zero contribution
        c = torch.zeros(O.shape[:3] + (1,), dtype=torch.float32,
                        device=X.device)
    else:
        w = _extend_all(O, E.zfrac, emeta)
        c = _unwound_contribs(w, O, E.zfrac, E, emeta)        # (T,N,L,D)
    T, L = c.shape[0], c.shape[2]
    flat = c.permute(1, 0, 2, 3).reshape(n, T * L * max(emeta.depth, 1))
    phi = torch.zeros((n, emeta.num_class * emeta.num_cols),
                      dtype=torch.float32, device=X.device)
    phi = phi.index_add_(1, E.seg, flat) + E.bias[None, :]
    # the plain raw score for the additivity check: the product of a
    # path's slot one fractions is its reach indicator (pads are 1)
    reach = torch.prod(O, dim=-1)                             # (T, N, L)
    per_tree = torch.sum(reach * E.leaf_val, dim=-1)          # (T, N)
    return phi, _class_sum(per_tree, E.class_onehot)
