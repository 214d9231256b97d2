"""Fused dense ensemble prediction: the serving compiler's program.

Port of ``lightgbm_tpu/models/dense_predict.py``.  A whole trained
ensemble (every tree, every class) lowers into ONE loop-free program of
path-condition contractions (the "Booster" accelerator formulation,
PAPERS.md arXiv:2011.02022):

* the per-node feature lookup is an ``index_select`` of the row block's
  columns over all ``T*(L-1)`` nodes at once (the reference's non-MXU
  form; never a one-hot product, which would round the values);
* numeric thresholds are one broadcast compare against the stacked
  threshold row; NaN, default-direction and missing-type bits fold into
  the same condition matrix;
* categorical splits are a bitset-membership contraction: the per-node
  ``cat_words`` unpack to a dense ``(cat_features * 32W, cat_nodes)`` 0/1
  table, and membership is the row's category one-hot times that table;
* the leaf is the satisfied-path-condition count: one batched contraction
  ``dec @ path_dir`` per tree and an exact ``relu(S - (plen_total -
  plen_right - 1))`` hit indicator (S is integer-valued and bounded by
  the path length, so the ReLU is a 0/1 one-hot over leaves);
* leaf tables may be quantized to int8 / int16 codes with a per-tree
  scale (per-tree error at most scale / 2);
* linear leaves are a dense ``(T, L, F)`` coefficient table contracted
  with the rows, with the reference's NaN fallback to the plain value.

Precision.  The contractions whose operands are 0/1 or small counts
(the hit count, categorical membership, the linear leaves' NaN count)
are exact in any floating type: on the card (``DenseMeta.half``) they
run in float16 on the tensor cores.  Every product of real values is
kept away from TF32, so ``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision`` set by a caller cannot change a
prediction: node values are gathered, the leaf and class sums are
elementwise products and sums in f32, and the linear leaves' products
run in float64 (the reference runs these at ``Precision.HIGHEST``).

Row blocks.  The program's temporaries grow with rows x trees x nodes
(:func:`dense_row_bytes`); :class:`~..serve.compiler.DenseExecutable`
runs it over row blocks that fit :data:`DENSE_WORKSET_BUDGET`.  Results
are per row, so blocking changes nothing.

``shard`` pads the tree axis as the reference's does, and the program
runs on the one device, as the reference's does when it sees one.  The
reference's mesh-sharded forms (``make_sharded_predict``,
``make_stacked_sharded_predict``), which split the tree axis over
several devices, come with distributed training (ROADMAP queue 1 item
10).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .tree import CAT_MASK, DEFAULT_LEFT_MASK, MISSING_NAN, Tree, TreeBatch

__all__ = ["DenseLoweringError", "DenseMeta", "DenseArrays",
           "lower_ensemble", "dense_predict_raw", "dense_predict_leaf",
           "dense_table_bytes", "dense_row_bytes", "stack_dense_arrays",
           "stacked_predict_raw", "CAT_TABLE_BUDGET", "LINEAR_TABLE_BUDGET",
           "DENSE_WORKSET_BUDGET"]

# Lowering budgets (the reference's): a categorical bitset table or a
# linear-leaf coefficient table past these sizes would dominate device
# memory for no win; the compiler falls back to the walk with a reason.
CAT_TABLE_BUDGET = 128 << 20       # bytes of (Fc*C, NC) + top-bucket V block
LINEAR_TABLE_BUDGET = 256 << 20    # bytes of the dense (T, L, F) tables
# Bytes of one row block's temporaries (dense_row_bytes x rows): 4 GiB
# keeps a 64-tree x 255-leaf program at ~12K rows a block, a twentieth of
# the 80 GB card.
DENSE_WORKSET_BUDGET = 4 << 30


class DenseLoweringError(ValueError):
    """The ensemble cannot (or should not) lower to the dense program.

    ``reason`` is a short machine-usable tag (``cat_table_budget``,
    ``linear_table_budget`` ...) that the serving compiler counts."""

    def __init__(self, reason: str, detail: str = "") -> None:
        self.reason = reason
        super().__init__(f"dense lowering unavailable ({reason})"
                         + (f": {detail}" if detail else ""))


class DenseMeta(NamedTuple):
    """Static half of a lowered ensemble."""

    num_class: int
    num_trees: int            # REAL trees
    has_cat: bool
    has_linear: bool
    leaf_bits: int            # 0 = exact f32 leaf table, else 8 | 16
    half: bool                # True: the 0/1 and small-count contractions
                              # in float16 (the card); False: float32


class DenseArrays(NamedTuple):
    """Device half of a lowered ensemble (``None`` fields absent)."""

    split_feature: torch.Tensor    # (T, Nn) int64 inner feature per node
    threshold: torch.Tensor        # (T, Nn) f32
    dleft: torch.Tensor            # (T, Nn) bool, default-left bit
    miss_nan: torch.Tensor         # (T, Nn) bool, missing type == nan
    is_cat: torch.Tensor           # (T, Nn) bool
    path_dir: torch.Tensor         # (T, Nn, L) int8, +1 left / -1 right
    qthresh: torch.Tensor          # (T, L) f32 = plen_total - plen_right - 1
    leaf_codes: torch.Tensor       # (T, L) f32 | int8 | int16
    leaf_scale: torch.Tensor       # (T, 1) f32 dequant scale (1.0 when f32)
    class_onehot: torch.Tensor     # (T, K) f32
    cat_feats: Optional[torch.Tensor] = None      # (Fc,) int64 inner idx
    cat_table: Optional[torch.Tensor] = None      # (Fc*C, NCp) f32
    node_cat_slot: Optional[torch.Tensor] = None  # (T, Nn) int64, 0 = none
    lin_w: Optional[torch.Tensor] = None          # (T, L, F) f32
    lin_mask: Optional[torch.Tensor] = None       # (T, L, F) f32 0/1
    lin_const: Optional[torch.Tensor] = None      # (T, L) f32
    lin_flag: Optional[torch.Tensor] = None       # (T, 1) f32


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _unpack_bits32(words: np.ndarray) -> np.ndarray:
    """uint32 word vector -> (32 * len,) 0/1 float32 (LSB first)."""
    words = np.asarray(words).astype(np.uint32)
    bits = (words[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    return bits.reshape(-1).astype(np.float32)


def dense_table_bytes(arrays: DenseArrays) -> int:
    """Total bytes of the lowered model tables."""
    return int(sum(a.numel() * a.element_size() for a in arrays
                   if a is not None))


def dense_row_bytes(arrays: DenseArrays, meta: DenseMeta) -> int:
    """Bytes of the program's temporaries per row, from the table shapes:
    the node values, NaN bits and conditions, T*Nn each (f32, bool, bool,
    and the contraction's f16 / f32 copy), and the hit count, one-hot
    and leaf product, T*L f32 each, plus the linear leaves' three
    (T, L) blocks and the categorical one-hot row."""
    T, Nn = arrays.split_feature.shape
    L = arrays.qthresh.shape[1]
    per = T * Nn * (4 + 1 + 1 + (2 if meta.half else 4)) + 3 * 4 * T * L
    if meta.has_linear:
        per += 3 * 8 * T * L
    if meta.has_cat:
        per += 4 * int(arrays.cat_table.shape[0] + arrays.cat_table.shape[1])
    return int(per)


def lower_ensemble(trees: List[Tree], num_class: int, num_features: int,
                   class_ids: Optional[List[int]] = None, *,
                   leaf_bits: int = 0, half: bool = False,
                   shard: int = 1,
                   batch: Optional[TreeBatch] = None,
                   cat_budget: int = CAT_TABLE_BUDGET,
                   linear_budget: int = LINEAR_TABLE_BUDGET,
                   device=None) -> Tuple[DenseArrays, DenseMeta]:
    """Lower ``trees`` (classes interleaved ``t % num_class`` unless
    ``class_ids`` is given) into the dense program's tables on
    ``device`` (reference dense_predict.py:134-290; host numpy, the
    reference's arithmetic).  ``shard > 1`` pads the tree axis to a
    multiple of ``shard`` with inert trees (no reachable leaf, a zero
    class row), as the reference's does.  Raises
    :class:`DenseLoweringError` when a table would blow its budget."""
    if not trees:
        raise DenseLoweringError("no_trees")
    if leaf_bits not in (0, 8, 16):
        raise DenseLoweringError("leaf_bits", f"{leaf_bits} not in 0|8|16")
    b = batch if batch is not None else TreeBatch(trees)
    T = b.num_trees
    ml = b.max_leaves
    L = ml
    Nn = max(ml - 1, 1)
    if class_ids is None:
        class_ids = [t % num_class for t in range(T)]

    sf = np.zeros((T, Nn), np.int64)
    thr = np.zeros((T, Nn), np.float32)
    dt = np.zeros((T, Nn), np.uint8)
    sf[:, :max(ml - 1, 0)] = _host(b.split_feature)[:, :max(ml - 1, 0)]
    thr[:, :max(ml - 1, 0)] = _host(b.threshold)[:, :max(ml - 1, 0)]
    dt[:, :max(ml - 1, 0)] = _host(b.decision_type)[:, :max(ml - 1, 0)]
    # only the first num_leaves-1 node slots of each tree are real
    nl = _host(b.num_leaves)
    real = np.arange(Nn)[None, :] < np.maximum(nl - 1, 0)[:, None]
    dt = np.where(real, dt, 0).astype(np.uint8)
    # a padding slot of a tree that stopped short reads column 0: its
    # split_feature is -1, which index_select refuses (no path reaches
    # the slot, so its decision is never used)
    sf = np.where(real, sf, 0)
    is_cat = (dt & CAT_MASK) != 0
    dleft = (dt & DEFAULT_LEFT_MASK) != 0
    miss_nan = (dt & (3 << 2)) == MISSING_NAN

    pd = np.asarray(b.path_dir, np.int8)
    qt = (np.asarray(b.plen_total, np.float32) -
          np.asarray(b.plen_right, np.float32) - 1.0)

    # quantized leaf table: int8 / int16 codes and a per-tree scale
    leaf = _host(b.leaf_value).astype(np.float32)
    if leaf_bits:
        qmax = float((1 << (leaf_bits - 1)) - 1)
        maxabs = np.max(np.abs(leaf), axis=1)
        scale = np.where(maxabs > 0, maxabs / qmax, 1.0).astype(np.float32)
        codes = np.rint(leaf / scale[:, None]).astype(
            np.int8 if leaf_bits == 8 else np.int16)
    else:
        scale = np.ones(T, np.float32)
        codes = leaf

    cls = np.zeros((T, num_class), np.float32)
    cls[np.arange(T), np.asarray(class_ids, np.int64)] = 1.0

    # --- categorical bitsets -> a dense membership table ------------------
    has_cat = bool(is_cat.any())
    cat_feats = cat_table = node_slot = None
    if has_cat:
        words = _host(b.cat_words)                     # (T, Nn', W)
        W = words.shape[2]
        C = 32 * W
        feats = np.unique(sf[is_cat])
        slot_of = {int(f): j for j, f in enumerate(feats)}
        Fc = len(feats)
        cat_idx = np.argwhere(is_cat)                  # (NC, 2)
        NC = len(cat_idx)
        NCp = max(8, -(-NC // 8) * 8)
        top_bucket = 4096
        table_b = 4 * Fc * C * NCp + 4 * top_bucket * Fc * C
        if table_b > cat_budget:
            raise DenseLoweringError(
                "cat_table_budget",
                f"{Fc} cat features x {C} categories x {NC} cat nodes "
                f"needs ~{table_b >> 20} MiB (> {cat_budget >> 20} MiB)")
        K = np.zeros((Fc * C, NCp), np.float32)
        node_slot = np.zeros((T, Nn), np.int64)
        for m, (ti, ni) in enumerate(cat_idx):
            j = slot_of[int(sf[ti, ni])]
            K[j * C:(j + 1) * C, m] = _unpack_bits32(
                words[ti, ni] if ni < words.shape[1]
                else np.zeros(W, np.uint32))
            node_slot[ti, ni] = m + 1
        cat_feats = feats.astype(np.int64)
        cat_table = K

    # --- linear leaves as dense (T, L, F) tables --------------------------
    has_linear = bool(b.has_linear)
    lin_w = lin_mask = lin_const = lin_flag = None
    if has_linear:
        table_b = 2 * 4 * T * L * num_features
        if table_b > linear_budget:
            raise DenseLoweringError(
                "linear_table_budget",
                f"(T={T}, L={L}, F={num_features}) linear tables need "
                f"~{table_b >> 20} MiB (> {linear_budget >> 20} MiB)")
        lin_w = np.zeros((T, L, num_features), np.float32)
        lin_mask = np.zeros((T, L, num_features), np.float32)
        lin_const = np.zeros((T, L), np.float32)
        lin_flag = np.zeros((T, 1), np.float32)
        for ti, t in enumerate(trees):
            if not t.is_linear:
                continue
            lin_flag[ti, 0] = 1.0
            lin_const[ti, :len(t.leaf_const)] = np.asarray(
                t.leaf_const, np.float32)
            feats_per_leaf = (t.leaf_features_inner
                              if t.leaf_features_inner is not None
                              else t.leaf_features)
            for leaf_i, (fs, cs) in enumerate(zip(feats_per_leaf,
                                                  t.leaf_coeff)):
                for f, c in zip(fs, cs):
                    lin_w[ti, leaf_i, f] += np.float32(c)
                    lin_mask[ti, leaf_i, f] = 1.0

    # --- shard padding (reference :257-277): inert trees -----------------
    if shard > 1 and T % shard:
        pad = shard - T % shard
        sf = np.pad(sf, ((0, pad), (0, 0)))
        thr = np.pad(thr, ((0, pad), (0, 0)))
        dleft = np.pad(dleft, ((0, pad), (0, 0)))
        miss_nan = np.pad(miss_nan, ((0, pad), (0, 0)))
        is_cat = np.pad(is_cat, ((0, pad), (0, 0)))
        pd = np.pad(pd, ((0, pad), (0, 0), (0, 0)))
        qt = np.pad(qt, ((0, pad), (0, 0)), constant_values=np.float32(1e9))
        codes = np.pad(codes, ((0, pad), (0, 0)))
        scale = np.pad(scale, (0, pad), constant_values=np.float32(1.0))
        cls = np.pad(cls, ((0, pad), (0, 0)))
        if node_slot is not None:
            node_slot = np.pad(node_slot, ((0, pad), (0, 0)))
        if lin_w is not None:
            lin_w = np.pad(lin_w, ((0, pad), (0, 0), (0, 0)))
            lin_mask = np.pad(lin_mask, ((0, pad), (0, 0), (0, 0)))
            lin_const = np.pad(lin_const, ((0, pad), (0, 0)))
            lin_flag = np.pad(lin_flag, ((0, pad), (0, 0)))

    dev = torch.device(device) if device is not None else \
        torch.device("cpu")

    def j(a):
        return None if a is None else torch.as_tensor(a, device=dev)

    arrays = DenseArrays(
        split_feature=j(sf), threshold=j(thr), dleft=j(dleft),
        miss_nan=j(miss_nan), is_cat=j(is_cat), path_dir=j(pd),
        qthresh=j(qt), leaf_codes=j(codes),
        leaf_scale=j(scale.reshape(-1, 1)), class_onehot=j(cls),
        cat_feats=j(cat_feats), cat_table=j(cat_table),
        node_cat_slot=j(node_slot), lin_w=j(lin_w), lin_mask=j(lin_mask),
        lin_const=j(lin_const), lin_flag=j(lin_flag))
    meta = DenseMeta(num_class=num_class, num_trees=T, has_cat=has_cat,
                     has_linear=has_linear, leaf_bits=leaf_bits,
                     half=bool(half))
    return arrays, meta


# ---------------------------------------------------------------------------
# the program
# ---------------------------------------------------------------------------

def _count_matmul(a: torch.Tensor, b: torch.Tensor, half: bool
                  ) -> torch.Tensor:
    """``a @ b`` of operands holding 0/1 or small integers, in float16
    on the card (exact: the products and partial sums are integers well
    inside float16's 2048), else float32; the result as float32."""
    dt = torch.float16 if half else torch.float32
    return torch.matmul(a.to(dt), b.to(dt)).float()


def _decision_matrix(X: torch.Tensor, A: DenseArrays, meta: DenseMeta
                     ) -> torch.Tensor:
    """The fused condition matrix ``dec`` (N, T, Nn) bool: numeric
    compares, NaN / default-direction bits and the categorical bitset
    contraction folded in (reference dense_predict.py:319-361)."""
    n = X.shape[0]
    T, Nn = A.split_feature.shape
    flat_sf = A.split_feature.reshape(-1)
    isnan = torch.isnan(X)
    P = torch.index_select(torch.nan_to_num(X), 1, flat_sf)
    isn = torch.index_select(isnan, 1, flat_sf)
    dec = P <= A.threshold.reshape(-1)[None, :]
    if meta.has_cat:
        Fc = A.cat_feats.shape[0]
        C = A.cat_table.shape[0] // Fc
        # the row's category one-hot over (feature, category); NaN and
        # non-integer or out-of-range values one-hot to zero rows, which
        # contract to "not a member" (go right) as FindInBitset does
        Xc = torch.index_select(X, 1, A.cat_feats)
        Xc = torch.where(torch.isnan(Xc), torch.full_like(Xc, -1.0), Xc)
        V = (Xc[:, :, None] ==
             torch.arange(C, dtype=X.dtype, device=X.device)[None, None, :])
        member = _count_matmul(V.reshape(n, Fc * C), A.cat_table, meta.half)
        member = torch.cat([torch.zeros((n, 1), dtype=member.dtype,
                                        device=X.device), member], dim=1)
        member = torch.index_select(member, 1, A.node_cat_slot.reshape(-1))
        dec = torch.where(A.is_cat.reshape(-1)[None, :], member > 0.5, dec)
    # NaN routing: categorical and missing-nan numeric nodes take the
    # default direction; other numeric nodes compare the sanitized 0.0
    nan_default = (A.miss_nan | A.is_cat).reshape(-1)
    dec = torch.where(isn & nan_default[None, :],
                      A.dleft.reshape(-1)[None, :], dec)
    return dec.reshape(n, T, Nn)


def _hit_matrix(dec: torch.Tensor, A: DenseArrays, meta: DenseMeta
                ) -> torch.Tensor:
    """(T, N, L) exact 0/1 leaf one-hot from the satisfied-condition
    count S: ``relu(S - (len - 1))`` is 1 exactly on the reached leaf
    (reference dense_predict.py:364-377)."""
    S = _count_matmul(dec.permute(1, 0, 2), A.path_dir, meta.half)
    # right-expected nodes contribute (1 - dec); their +1 per right turn
    # is folded into qthresh = plen_total - plen_right - 1
    return torch.relu(S - A.qthresh[:, None, :])


def _per_tree_scores(X: torch.Tensor, hit: torch.Tensor, A: DenseArrays,
                     meta: DenseMeta) -> torch.Tensor:
    """(T, N) per-tree outputs: quantized leaf tables dequantized in the
    sum; linear leaves as const + coef . x with the NaN fallback
    (reference dense_predict.py:380-404)."""
    leaf_deq = A.leaf_codes.float() * A.leaf_scale            # (T, L)
    if not meta.has_linear:
        # hit is an exact one-hot: one nonzero term per row
        return torch.sum(hit * leaf_deq[:, None, :], dim=2)
    Xs = torch.nan_to_num(X)
    isnX = torch.isnan(X)
    lin_vals = torch.matmul(A.lin_w.double(), Xs.double().T).float()
    lin_nan = _count_matmul(A.lin_mask, isnX.T, meta.half) > 0.5
    lin_out = A.lin_const[:, :, None] + lin_vals             # (T, L, N)
    use_lin = (A.lin_flag[:, :, None] > 0) & ~lin_nan
    vals = torch.where(use_lin, lin_out, leaf_deq[:, :, None])
    return torch.sum(hit * vals.permute(0, 2, 1), dim=2)


def _class_sum(per_tree: torch.Tensor, class_onehot: torch.Tensor
               ) -> torch.Tensor:
    """(N, K) = per_tree.T @ class_onehot, accumulated tree by tree in
    f32: no matmul (so no TF32), and the order of the walk's sum, so a
    row's score does not depend on how many rows share its block (a
    reduction over the tree axis may order its adds by the tensor's
    shape)."""
    out = torch.zeros((per_tree.shape[1], class_onehot.shape[1]),
                      dtype=torch.float32, device=per_tree.device)
    for t in range(per_tree.shape[0]):
        out = out + per_tree[t][:, None] * class_onehot[t][None, :]
    return out


def dense_predict_raw(X: torch.Tensor, A: DenseArrays, meta: DenseMeta
                      ) -> torch.Tensor:
    """(N, num_class) f32 raw scores: the whole ensemble in one loop-free
    program (reference dense_predict.py:407-420)."""
    X = X.to(torch.float32)
    dec = _decision_matrix(X, A, meta)
    hit = _hit_matrix(dec, A, meta)
    return _class_sum(_per_tree_scores(X, hit, A, meta), A.class_onehot)


def dense_predict_leaf(X: torch.Tensor, A: DenseArrays, meta: DenseMeta
                       ) -> torch.Tensor:
    """(N, T) int32 leaf index per tree (the hit one-hot's argmax)."""
    X = X.to(torch.float32)
    hit = _hit_matrix(_decision_matrix(X, A, meta), A, meta)
    return torch.argmax(hit, dim=2).to(torch.int32).T


def stack_dense_arrays(arrays_list: List[DenseArrays]) -> DenseArrays:
    """Stack M same-signature models' tables on a new leading model axis
    (reference dense_predict.py:432-439)."""
    first = arrays_list[0]
    return DenseArrays(*[
        None if getattr(first, name) is None else
        torch.stack([getattr(a, name) for a in arrays_list])
        for name in DenseArrays._fields])


def stacked_predict_raw(Xs: torch.Tensor, stacked: DenseArrays,
                        meta: DenseMeta) -> torch.Tensor:
    """(M, N, K) raw scores of M same-signature models, lane m on the row
    block ``Xs[m]``; each lane is its solo :func:`dense_predict_raw`
    (reference dense_predict.py:442-453)."""
    return torch.stack([
        dense_predict_raw(Xs[m], DenseArrays(*[
            None if a is None else a[m] for a in stacked]), meta)
        for m in range(Xs.shape[0])])
