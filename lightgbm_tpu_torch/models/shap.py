"""SHAP feature contributions (reference: src/io/tree.cpp PredictContrib —
the TreeSHAP algorithm of Lundberg, Erion & Lee, "Consistent Individualized
Feature Attribution for Tree Ensembles" (Algorithm 2); exposed via
predict(..., pred_contrib=True), c_api predict type C_API_PREDICT_CONTRIB).

ROW-VECTORIZED TreeSHAP: the recursion's control structure (which nodes are
visited, in which order, and which feature sits at each path level) is
row-independent — only the hot/cold weight assignment differs per row — so
one traversal per tree carries the whole batch: every path-state scalar of
Algorithm 2 (zero fraction, one fraction, pweight) becomes an (N,) vector
and the extend/unwind algebra becomes elementwise numpy.  Rows are chunked
to bound the path-state working set.  (The round-2 implementation recursed
per row in Python: ~rows× slower.)

Copy of ``lightgbm_tpu/models/shap.py`` (numpy only) kept inside the
PyTorch port so the port never imports the JAX package: the float64 host
walk, the reference's own fallback of the dense explain program.
"""

from __future__ import annotations

import numpy as np

from .tree import CAT_MASK, DEFAULT_LEFT_MASK, Tree

_CHUNK = 4096


def _go_left_vec(tree: Tree, node: int, v: np.ndarray) -> np.ndarray:
    """Vectorized per-row decision at one node (matches tree walks)."""
    dt = tree.decision_type[node]
    nanmask = np.isnan(v)
    if dt & CAT_MASK:
        dleft = bool(dt & DEFAULT_LEFT_MASK)
        iv = np.where(nanmask, -1.0, v)
        ivi = iv.astype(np.int64)
        exact = (ivi >= 0) & (ivi.astype(np.float64) == iv)
        cats = np.asarray(tree.cat_values(node), dtype=np.int64)
        member = np.isin(ivi, cats) & exact
        return np.where(nanmask, dleft, member)
    thr = tree.threshold[node]
    if (dt >> 2) & 3 == 2:  # missing nan
        dleft = bool(dt & DEFAULT_LEFT_MASK)
        return np.where(nanmask, dleft, v <= thr)
    return np.where(nanmask, 0.0 <= thr, v <= thr)


def _tree_shap_batch(tree: Tree, X: np.ndarray, phi: np.ndarray) -> None:
    """Accumulate one tree's SHAP values for a row chunk into phi
    (shape (n, num_features + 1); last slot = expected value)."""
    n = X.shape[0]
    if tree.num_leaves <= 1:
        phi[:, -1] += tree.leaf_value[0]
        return
    phi[:, -1] += _expected_value(tree, 0)

    def node_count(node):
        if node < 0:
            return float(tree.leaf_count[~node])
        return float(tree.internal_count[node])

    ones = np.ones(n)

    # path state: parallel lists of (feature index, z (n,), o (n,), pw (n,))
    def extend(m, pz, po, pi):
        l = len(m)
        m = [(f, z, o, w.copy()) for f, z, o, w in m]
        m.append((pi, pz, po, ones.copy() if l == 0 else np.zeros(n)))
        for i in range(l - 1, -1, -1):
            f_i1, z_i1, o_i1, w_i1 = m[i + 1]
            f_i, z_i, o_i, w_i = m[i]
            w_i1 += po * w_i * (i + 1) / (l + 1)
            m[i] = (f_i, z_i, o_i, pz * w_i * (l - i) / (l + 1))
        return m

    def unwound_sum(m, i):
        l = len(m) - 1
        o, z = m[i][2], m[i][1]
        nn = m[l][3].copy()
        total = np.zeros(n)
        o_nz = o != 0
        o_safe = np.where(o_nz, o, 1.0)
        z_safe = np.where(z != 0, z, 1.0)
        for j in range(l - 1, -1, -1):
            t = nn * (l + 1) / ((j + 1) * o_safe)
            total += np.where(o_nz, t,
                              m[j][3] * (l + 1) / (z_safe * (l - j)))
            nn = np.where(o_nz, m[j][3] - t * z * (l - j) / (l + 1), nn)
        return total

    def unwind(m, i):
        l = len(m) - 1
        o, z = m[i][2], m[i][1]
        nn = m[l][3].copy()
        m = [(f, zz, oo, w.copy()) for f, zz, oo, w in m]
        o_nz = o != 0
        o_safe = np.where(o_nz, o, 1.0)
        z_safe = np.where(z != 0, z, 1.0)
        for j in range(l - 1, -1, -1):
            f_j, z_j, o_j, w_j = m[j]
            t = nn * (l + 1) / ((j + 1) * o_safe)
            nn = np.where(o_nz, w_j - t * z * (l - j) / (l + 1), nn)
            new_w = np.where(o_nz, t, w_j * (l + 1) / (z_safe * (l - j)))
            m[j] = (f_j, z_j, o_j, new_w)
        for j in range(i, l):
            # shift feature/z/o down, KEEP this slot's pweight (Algorithm 2)
            m[j] = (m[j + 1][0], m[j + 1][1], m[j + 1][2], m[j][3])
        m.pop()
        return m

    def recurse(node, m, pz, po, pi):
        m = extend(m, pz, po, pi)
        if node < 0:
            v = float(tree.leaf_value[~node])
            for i in range(1, len(m)):
                w = unwound_sum(m, i)
                phi[:, m[i][0]] += w * (m[i][2] - m[i][1]) * v
            return
        f = int(tree.split_feature[node])
        l_, r_ = int(tree.left_child[node]), int(tree.right_child[node])
        hot_left = _go_left_vec(tree, node, X[:, f]).astype(bool)
        iz, io = ones, ones
        k = -1
        for i in range(1, len(m)):
            if m[i][0] == f:
                k = i
                break
        if k >= 0:
            iz, io = m[k][1], m[k][2]
            m = unwind(m, k)
        cnt = node_count(node)
        lf = node_count(l_) / cnt if cnt > 0 else 0.0
        rf = node_count(r_) / cnt if cnt > 0 else 0.0
        # the zero fraction of a child is its count share either way; the
        # one fraction is io where the child is the row's hot side, else 0
        recurse(l_, m, iz * lf, np.where(hot_left, io, 0.0), f)
        recurse(r_, m, iz * rf, np.where(hot_left, 0.0, io), f)

    recurse(0, [], ones, ones, -1)


def node_expectations(tree: Tree) -> np.ndarray:
    """Leaf-count-weighted expected value of every INTERNAL node, in one
    bottom-up pass (shape (num_leaves - 1,)).  Memoized on the tree; the
    token guards against in-place leaf mutation (refit decay,
    ``LGBM_BoosterSetLeafValue``) so a stale memo can never survive a
    value edit."""
    nl = int(tree.num_leaves)
    if nl <= 1:
        return np.zeros(0, np.float64)
    token = hash((tree.leaf_value.tobytes(), tree.leaf_count.tobytes(),
                  tree.internal_count.tobytes()))
    memo = getattr(tree, "_expected_memo", None)
    if memo is not None and memo[0] == token:
        return memo[1]
    exp = np.zeros(nl - 1, np.float64)
    # iterative post-order: reversed preorder visits children before
    # parents without assuming any index ordering (and without Python
    # recursion limits on deep trees)
    order = []
    stack = [0]
    while stack:
        node = stack.pop()
        order.append(node)
        for ch in (int(tree.left_child[node]), int(tree.right_child[node])):
            if ch >= 0:
                stack.append(ch)

    def val(ch: int) -> float:
        return float(tree.leaf_value[~ch]) if ch < 0 else exp[ch]

    def cnt(ch: int) -> float:
        return float(tree.leaf_count[~ch]) if ch < 0 \
            else float(tree.internal_count[ch])

    for node in reversed(order):
        l, r = int(tree.left_child[node]), int(tree.right_child[node])
        c = float(tree.internal_count[node])
        exp[node] = ((cnt(l) * val(l) + cnt(r) * val(r)) / c) if c > 0 \
            else 0.0
    tree._expected_memo = (token, exp)
    return exp


def _expected_value(tree: Tree, node: int) -> float:
    if node < 0:
        return float(tree.leaf_value[~node])
    return float(node_expectations(tree)[node])


def trees_window(gbdt, start_iteration: int = 0,
                 num_iteration=None):
    """The (t0, t1) tree-index window of an iteration range — the same
    slice ``_tree_batch`` serves, so contrib/leaf/raw predictions all
    window identically."""
    k = gbdt.num_tree_per_iteration
    t0 = start_iteration * k
    t1 = len(gbdt.models) if num_iteration is None else min(
        len(gbdt.models), (start_iteration + num_iteration) * k)
    return t0, max(t0, t1)


def predict_contrib(gbdt, Xi: np.ndarray, start_iteration: int = 0,
                    num_iteration=None) -> np.ndarray:
    """Per-feature SHAP contributions + bias column
    (reference predictor contrib path; output (N, num_features+1), or
    num_class stacked blocks for multiclass).  Respects the
    start_iteration/num_iteration window exactly like raw prediction
    (the reference windows its contrib path too)."""
    k = gbdt.num_tree_per_iteration
    t0, t1 = trees_window(gbdt, start_iteration, num_iteration)
    models = gbdt.models[t0:t1]
    if any(t.is_linear for t in models):
        from ..utils.log import log_warning
        log_warning("pred_contrib on linear trees attributes each leaf's "
                    "PLAIN output (per-leaf linear terms are not decomposed)")
    n = Xi.shape[0]
    nf = gbdt.num_features
    out = np.zeros((n, (nf + 1) * k), np.float64)
    for lo in range(0, n, _CHUNK):
        hi = min(lo + _CHUNK, n)
        chunk = Xi[lo:hi]
        for t, tree in enumerate(models, start=t0):
            cid = t % k
            _tree_shap_batch(tree, chunk,
                             out[lo:hi, cid * (nf + 1):(cid + 1) * (nf + 1)])
    return out
