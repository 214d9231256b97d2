"""GBDT boosting driver.

Port of ``lightgbm_tpu/models/gbdt.py`` ``GBDT`` for the serial learner
(reference: src/boosting/gbdt.cpp — ``TrainOneIter`` at :369, bagging at
:228, ``BoostFromAverage`` at :344 with the init score folded into the
first tree via AddBias at :414-427, score updates at :491): every
objective, K trees per iteration for multiclass ((N, K) scores, class
trees interleaved in the model), the percentile leaf refit of L1,
quantile and MAPE, and the device RNG keys of each tree (stochastic
rounding, by-node sampling, extra-trees), drawn as the reference draws
them (reference gbdt.py:866-881), and the split options in inner-feature
space (monotone constraints, forced splits, interaction constraints,
``feature_contri``, lazy CEGB; reference models/gbdt.py:584-670), with
the coupled CEGB penalties charged until each feature's first use.

The boosting loop is host-driven; gradients, sampling masks, tree growth
and the score update run on the training device.  On a ``cuda`` device with
``tpu_histogram_impl=auto`` and a small binned matrix, the histogram
autotuner (``learner/autotune.py``, reference gbdt.py:393-420) picks the
kernels' bin layout first.  Each grown tree is
pulled to the host once, when it is recorded.  Trees that stopped
splitting are popped one iteration later, as the reference's deferred
path does (gbdt.cpp:430-450), so both packages keep the same trees;
objectives that renew leaves, and coupled CEGB, record each tree at
once and stop in the iteration whose trees are all stumps, as the
reference's undeferred path does.
"""

from __future__ import annotations

import copy
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..learner.autotune import (AUTOTUNE_MAX_CELLS, apply_winner,
                                pick_hist_impl)
from ..learner.serial import GrownTree, SerialTreeLearner
from ..metric import Metric, create_metrics
from ..objective import ObjectiveFunction, create_objective
from ..objective.base import weighted_percentile
from ..utils.log import log_info, log_warning
from ..utils.random import fold_in, host_key, host_rng
from ..utils.timer import FunctionTimer
from ..efb import make_bundle_decode
from .tree import CAT_MASK, DEFAULT_LEFT_MASK, Tree, TreeBatch, predict_raw

__all__ = ["GBDT", "bagging_mask_np", "feature_mask_np", "learner_config"]

EPSILON = 1e-12


def _grown_to_tree(grown: GrownTree, shrinkage: float, dataset: Dataset,
                   leaf_value_override: Optional[np.ndarray] = None) -> Tree:
    """Pull one grown tree to host, attach raw-value thresholds and the
    categorical bitsets (reference models/gbdt.py:44-100, tree.h:85
    SplitCategorical: a categorical node stores a rank into
    ``cat_boundaries``; its ``cat_threshold`` words are a bitset over raw
    category values); ``leaf_value_override`` replaces the leaf values
    (renewal)."""
    num_leaves = int(grown.num_leaves)

    def host(t):
        return t.detach().cpu().numpy()

    split_feature = host(grown.split_feature)
    threshold_bin = host(grown.threshold_bin)
    decision_type = host(grown.decision_type)
    member = None if grown.cat_member is None else host(grown.cat_member)
    mappers = [dataset.bin_mappers[j] for j in dataset.used_feature_map]
    thresh = np.zeros(len(split_feature), dtype=np.float64)
    cat_boundaries: List[int] = [0]
    cat_words: List[int] = []
    has_cat = False
    for i in range(num_leaves - 1):
        f = int(split_feature[i])
        if f < 0:
            continue
        if decision_type[i] & CAT_MASK:
            has_cat = True
            b2c = mappers[f].bin_to_cat
            cats = [int(b2c[b]) for b in np.nonzero(member[i])[0]
                    if b < len(b2c)] or [0]
            wd = np.zeros(max(cats) // 32 + 1, np.uint32)
            for c in cats:
                wd[c // 32] |= np.uint32(1 << (c % 32))
            thresh[i] = float(len(cat_boundaries) - 1)   # rank
            cat_words.extend(int(w) for w in wd)
            cat_boundaries.append(len(cat_words))
        else:
            thresh[i] = mappers[f].bin_to_value(int(threshold_bin[i]))
    tree = Tree(
        num_leaves=max(num_leaves, 1),
        split_feature=split_feature.astype(np.int32),
        threshold_bin=threshold_bin.astype(np.int32),
        nan_bin=host(grown.nan_bin).astype(np.int32),
        threshold=thresh,
        decision_type=decision_type.astype(np.uint8),
        left_child=host(grown.left_child).astype(np.int32),
        right_child=host(grown.right_child).astype(np.int32),
        split_gain=host(grown.split_gain),
        internal_value=host(grown.internal_value).astype(np.float64),
        internal_weight=host(grown.internal_weight).astype(np.float64),
        internal_count=host(grown.internal_count).astype(np.int64),
        leaf_value=(host(grown.leaf_value).astype(np.float64)
                    if leaf_value_override is None
                    else np.asarray(leaf_value_override, np.float64)),
        leaf_weight=host(grown.leaf_weight).astype(np.float64),
        leaf_count=host(grown.leaf_count).astype(np.int64),
        cat_boundaries=(np.asarray(cat_boundaries, np.int32)
                        if has_cat else None),
        cat_threshold=(np.asarray(cat_words, np.uint32)
                       if has_cat else None),
        cat_member_bins=member[:max(num_leaves - 1, 1)] if has_cat else None,
    )
    if shrinkage != 1.0:
        tree.shrink(shrinkage)
    return tree


def _tree_cat_member(tree: Tree) -> np.ndarray:
    """Binned categorical membership of a host tree's binned walk
    (reference models/gbdt.py:104-110): width-1 zeros when the tree has
    no categorical node."""
    if tree.cat_member_bins is not None:
        return np.asarray(tree.cat_member_bins, bool)
    return np.zeros((max(len(tree.split_feature), 1), 1), bool)


def _update_score(score: torch.Tensor, row_leaf: torch.Tensor,
                  leaf_value: torch.Tensor, shrinkage: float) -> torch.Tensor:
    """score + (leaf_value * shrinkage)[row_leaf]: the multiply and the add
    stay two f32 operations, each rounded, as in the reference (a fused
    multiply-add drifts 1 ulp from it)."""
    lv = leaf_value * shrinkage
    return score + lv[row_leaf.long()]


def bagging_mask_np(cfg, n: int, iteration: int,
                    label: Optional[np.ndarray] = None,
                    rows: Optional[np.ndarray] = None
                    ) -> Optional[np.ndarray]:
    """Per-iteration bagging mask (gbdt.cpp:228 Bagging, resampled every
    bagging_freq iters with a deterministic per-block seed).  Copy of the
    reference's host sampler: returns a float32 (n,) 0/1 mask, or None
    when bagging is inactive.  ``rows`` restricts the draw to those rows:
    the draws a standalone run on the compacted ``dataset[rows]`` makes,
    scattered back to full length (the masked folds of train_many)."""
    pos_neg = (cfg.objective == "binary" and
               (cfg.pos_bagging_fraction < 1.0 or
                cfg.neg_bagging_fraction < 1.0))
    if not (cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0 or pos_neg)):
        return None
    block = iteration // cfg.bagging_freq
    rng = host_rng(cfg.bagging_seed, block)
    nn = n if rows is None else len(rows)
    sub = np.zeros(nn, np.float32)
    if pos_neg:
        lab = label if rows is None else label[rows]
        pos = np.nonzero(lab > 0)[0]
        neg = np.nonzero(lab <= 0)[0]
        kp = int(len(pos) * cfg.pos_bagging_fraction)
        kn = int(len(neg) * cfg.neg_bagging_fraction)
        if kp:
            sub[rng.choice(pos, size=kp, replace=False)] = 1.0
        if kn:
            sub[rng.choice(neg, size=kn, replace=False)] = 1.0
    else:
        k = int(nn * cfg.bagging_fraction)
        sub[rng.choice(nn, size=k, replace=False)] = 1.0
    if rows is None:
        return sub
    mask = np.zeros(n, np.float32)
    mask[rows] = sub
    return mask


def feature_mask_np(cfg, num_features: int,
                    iteration: int) -> Optional[np.ndarray]:
    """Per-iteration feature_fraction mask (ColSampler per-tree draw), or
    None when feature_fraction is 1.0.  Copy of the reference's."""
    if cfg.feature_fraction >= 1.0:
        return None
    rng = host_rng(cfg.feature_fraction_seed, iteration)
    k = max(1, int(np.ceil(num_features * cfg.feature_fraction)))
    idx = rng.choice(num_features, size=k, replace=False)
    mask = np.zeros(num_features, bool)
    mask[idx] = True
    return mask


def _walk_binned(bins: torch.Tensor, tree: Tree, leaf_value: torch.Tensor,
                 efb=None) -> torch.Tensor:
    """One tree's walk on a BINNED row-major (N, G) matrix (valid-set score
    updates, reference models/tree.py ``_walk_impl``): the NaN bin follows
    ``default_left``, other bins compare with the threshold bin, and a
    categorical node goes left on its member bins.  Under EFB (``efb``,
    an ``efb.EfbArrays``) each node reads its feature's bundle column and
    decodes it (reference ``_walk_binned_efb``)."""
    n = bins.shape[0]
    dev = bins.device
    if tree.num_leaves <= 1:
        return leaf_value[0].expand(n).clone()
    k = tree.num_leaves - 1
    sf = torch.as_tensor(tree.split_feature[:k], dtype=torch.long, device=dev)
    tb = torch.as_tensor(tree.threshold_bin[:k], dtype=torch.int32,
                         device=dev)
    nb = torch.as_tensor(tree.nan_bin[:k], dtype=torch.int32, device=dev)
    dl = torch.as_tensor((tree.decision_type[:k] & DEFAULT_LEFT_MASK) != 0,
                         device=dev)
    ic = torch.as_tensor((tree.decision_type[:k] & CAT_MASK) != 0,
                         device=dev)
    mem = torch.as_tensor(_tree_cat_member(tree)[:k], device=dev)
    bm = mem.shape[1]
    lc = torch.as_tensor(tree.left_child[:k], dtype=torch.long, device=dev)
    rc = torch.as_tensor(tree.right_child[:k], dtype=torch.long, device=dev)
    col_of = sf if efb is None else efb.f_bundle[sf].long()
    decode = make_bundle_decode(efb)
    rows = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.long, device=dev)
    out = torch.zeros((n,), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    while bool(active.any()):
        nd = node.clamp(min=0)
        b = decode(bins[rows, col_of[nd]].to(torch.int32), sf[nd])
        go_left = torch.where(b == nb[nd], dl[nd], b <= tb[nd])
        go_left = torch.where(ic[nd], mem[nd, b.long().clamp(max=bm - 1)],
                              go_left)
        new_node = torch.where(active, torch.where(go_left, lc[nd], rc[nd]),
                               node)
        hit = active & (new_node < 0)
        out = torch.where(hit, leaf_value[(~new_node).clamp(min=0)], out)
        node = new_node
        active = node >= 0
    return out


def learner_config(cfg: Config, train_set: Dataset, max_bins: int,
                   device: torch.device) -> Config:
    """The learner's config: on a ``cuda`` device with
    ``tpu_histogram_impl=auto`` and a small binned matrix, a COPY with the
    histogram autotuner's bin layout (so the user's 'auto' survives param
    round-trips); else ``cfg``."""
    if (device.type == "cuda" and cfg.tpu_histogram_impl == "auto" and
            train_set.efb is None and
            train_set.X_binned.size <= AUTOTUNE_MAX_CELLS):
        # small shapes: time the single-leaf kernel on uint8 and on
        # packed bins on the real data once (reference
        # models/gbdt.py:393-420, dataset.cpp:659-670's ShareStates
        # timing); winners persist per shape in the autotune disk cache
        learner_cfg = copy.copy(cfg)
        apply_winner(learner_cfg, pick_hist_impl(train_set.X_binned,
                                                 max_bins, device))
        return learner_cfg
    return cfg


class GBDT:
    """Boosting driver (reference src/boosting/gbdt.h:540 ``GBDT``)."""

    name = "gbdt"

    def __init__(self, config: Config, train_set: Optional[Dataset],
                 objective: Optional[ObjectiveFunction] = None,
                 device: Optional[torch.device] = None) -> None:
        self.config = config
        self.device = torch.device(device or "cpu")
        self.models: List[Tree] = []
        self.train_set: Optional[Dataset] = None
        self.valid_sets: List[Tuple[str, Dataset]] = []
        self.valid_scores: List[torch.Tensor] = []
        self.valid_metrics: List[List[Metric]] = []
        self.train_metrics: List[Metric] = []
        self.objective = objective
        self.iter_ = 0
        self.best_iteration = -1
        self.num_tree_per_iteration = 1
        self._prev_iter_leaves: Optional[List[int]] = None
        if train_set is not None:
            self._init_train(train_set)

    # -- setup ---------------------------------------------------------------
    def _init_train(self, train_set: Dataset) -> None:
        cfg = self.config
        from ..utils.log import set_verbosity
        set_verbosity(int(cfg.verbosity))
        if cfg.tree_learner not in ("serial", "auto"):
            raise NotImplementedError(
                f"tree_learner={cfg.tree_learner!r}: the parallel learners "
                "are not ported to lightgbm_tpu_torch yet (ROADMAP queue 1)")
        train_set.construct(cfg)
        self.train_set = train_set
        self.num_data = train_set.num_data()
        self.num_features = train_set.num_feature()
        mappers = [train_set.bin_mappers[j] for j in train_set.used_feature_map]
        from ..binning import MissingType
        self.max_bins = int(max(m.num_bin for m in mappers))
        num_bins = np.array([m.num_bin for m in mappers], np.int32)
        has_nan = np.array([m.missing_type == MissingType.NAN
                            for m in mappers], bool)
        is_cat = np.array([m.is_categorical for m in mappers], bool)
        if self.num_data > (1 << 24) and not cfg.use_quantized_grad:
            log_warning(f"num_data={self.num_data} exceeds the f32 "
                        "histogram count channel's 2^24-row exactness "
                        "range; set use_quantized_grad=true for exact "
                        "int32 counts at this scale")
        self.learner = SerialTreeLearner(
            learner_config(cfg, train_set, self.max_bins, self.device),
            self.num_features, self.max_bins, num_bins,
            has_nan, self.device, is_cat=is_cat, efb=train_set.efb,
            monotone=self._inner_monotone(),
            forced_splits=self._parse_forced_splits(),
            interaction_groups=self._parse_interaction_constraints(),
            feature_contri=self._inner_contri(),
            cegb_lazy=self._inner_cegb_lazy())
        # coupled CEGB penalties charge a feature until its first use,
        # tracked on the host across trees (reference models/gbdt.py
        # :482-497); the used set is updated per tree, so every tree is
        # recorded at once (the reference's undeferred path)
        self._cegb_coupled = None
        if cfg.cegb_penalty_feature_coupled:
            full = np.zeros(train_set.num_total_features, np.float64)
            cpl = cfg.cegb_penalty_feature_coupled
            full[:len(cpl)] = [float(v) for v in cpl]
            self._cegb_coupled = (full[train_set.used_feature_map] *
                                  float(cfg.cegb_tradeoff))
            self._cegb_used = np.zeros(self.num_features, bool)
        # under pack4 only the nibble-packed half-width matrix lives on
        # the device (reference learner/serial.py:911-920)
        self.X_T = (train_set.device_bins_packed4(self.device)
                    if self.learner.pack4
                    else train_set.device_bins(self.device))

        if self.objective is None and cfg.objective != "none":
            self.objective = create_objective(cfg.objective, cfg,
                                              self.device)
        if self.objective is not None:
            self.objective.init(train_set.metadata, self.num_data)
        self.num_tree_per_iteration = (
            self.objective.num_model_per_iteration if self.objective else
            max(1, cfg.num_class))
        k = self.num_tree_per_iteration

        # initial scores: user init_score > boost_from_average > zero
        self._pending_bias = np.zeros(k)
        score0 = np.zeros(self._score_shape(self.num_data), np.float32)
        md = train_set.metadata
        if md.init_score is not None:
            score0 = score0 + md.init_score.reshape(score0.shape).astype(
                np.float32)
        elif cfg.boost_from_average and self.objective is not None:
            for cid in range(k):
                s = self.objective.boost_from_score(cid)
                self._pending_bias[cid] = s
                if abs(s) > EPSILON:
                    log_info(f"Start training from score {s:.6f}")
            score0 = score0 + (np.float32(self._pending_bias[0]) if k == 1
                               else self._pending_bias[None, :]
                               .astype(np.float32))
        self.score = torch.as_tensor(score0, device=self.device)
        self._bag_mask = torch.ones(self.num_data, dtype=torch.float32,
                                    device=self.device)

        self.train_metrics = []
        if cfg.is_provide_training_metric:
            self.train_metrics = create_metrics(cfg)
            for m in self.train_metrics:
                m.init(md, self.num_data)

    # -- the split options in inner-feature space (copies of the
    # reference's host parsers, models/gbdt.py:584-670) ----------------------
    def _inner_monotone(self) -> Optional[np.ndarray]:
        """config.monotone_constraints (original column indexing, may be
        shorter than the column count) on the inner used-feature axis."""
        mc = self.config.monotone_constraints
        if not mc or not any(int(v) != 0 for v in mc):
            return None
        ts = self.train_set
        full = np.zeros(ts.num_total_features, np.int32)
        full[:len(mc)] = [int(v) for v in mc]
        return full[ts.used_feature_map]

    def _parse_forced_splits(self) -> tuple:
        """forcedsplits_filename JSON -> BFS-ordered (leaf, inner feature,
        threshold bin) triples (reference serial_tree_learner.cpp:450
        ForceSplits)."""
        fn = self.config.forcedsplits_filename
        if not fn:
            return ()
        import json
        from collections import deque
        with open(fn) as fh:
            root = json.load(fh)
        ts = self.train_set
        inner_of_real = {int(r): i for i, r in enumerate(ts.used_feature_map)}
        mappers = [ts.bin_mappers[j] for j in ts.used_feature_map]
        out = []
        q = deque([(root, 0)])
        next_id = 1
        while q and len(out) < self.config.num_leaves - 1:
            node, leaf = q.popleft()
            if not node or "feature" not in node:
                continue
            rf = int(node["feature"])
            if rf not in inner_of_real:
                log_warning(f"forced split on trivial/unknown feature {rf} "
                            f"skipped (with its subtree)")
                continue
            f = inner_of_real[rf]
            b = int(mappers[f].value_to_bin(
                np.array([float(node["threshold"])]))[0])
            out.append((leaf, f, b))
            new_id = next_id
            next_id += 1
            if "left" in node:
                q.append((node["left"], leaf))
            if "right" in node:
                q.append((node["right"], new_id))
        return tuple(out)

    def _inner_cegb_lazy(self) -> tuple:
        """cegb_penalty_feature_lazy on the inner features, pre-scaled by
        cegb_tradeoff (like the coupled penalties)."""
        lz = self.config.cegb_penalty_feature_lazy
        if not lz:
            return ()
        full = np.zeros(self.train_set.num_total_features, np.float64)
        full[:len(lz)] = [float(v) for v in lz]
        inner = full[self.train_set.used_feature_map] * \
            float(self.config.cegb_tradeoff)
        if not np.any(inner):
            return ()  # numerically a no-op: skip the bitmap
        return tuple(float(v) for v in inner)

    def _inner_contri(self) -> tuple:
        """config.feature_contri (original column indexing) -> per-inner-
        feature gain multipliers (feature_histogram.hpp:94 penalty)."""
        fc = self.config.feature_contri
        if not fc:
            return ()
        ts = self.train_set
        full = np.ones(ts.num_total_features, np.float64)
        full[:len(fc)] = [float(v) for v in fc]
        return tuple(full[ts.used_feature_map])

    def _parse_interaction_constraints(self) -> tuple:
        """config.interaction_constraints "[0,1],[2,3]" -> tuples of INNER
        feature indices (reference col_sampler.hpp constraint sets)."""
        spec = self.config.interaction_constraints
        if not spec:
            return ()
        import re
        ts = self.train_set
        inner_of_real = {int(r): i for i, r in enumerate(ts.used_feature_map)}
        groups = []
        for grp in re.findall(r"\[([^\]]*)\]", str(spec)):
            feats = [inner_of_real[int(v)] for v in grp.split(",")
                     if v.strip() and int(v) in inner_of_real]
            if feats:
                groups.append(tuple(sorted(set(feats))))
        return tuple(groups)

    def _score_shape(self, n: int) -> tuple:
        k = self.num_tree_per_iteration
        return (n,) if k == 1 else (n, k)

    def add_valid(self, valid_set: Dataset, name: str) -> None:
        if valid_set is not self.train_set and \
                valid_set.reference is not self.train_set and \
                not valid_set.constructed:
            valid_set.reference = self.train_set
        valid_set.construct(self.config)
        if valid_set.bin_mappers is not self.train_set.bin_mappers:
            raise ValueError(
                "cannot add validation data: it was constructed without "
                "reference to the training Dataset (different bin "
                "mappers); pass reference=train_set when creating it")
        n = valid_set.num_data()
        k = self.num_tree_per_iteration
        score0 = np.zeros(self._score_shape(n), np.float32)
        if valid_set.metadata.init_score is not None:
            score0 = score0 + valid_set.metadata.init_score.reshape(
                score0.shape).astype(np.float32)
        elif self.config.boost_from_average and self.objective is not None:
            score0 = score0 + (np.float32(self._pending_bias[0]) if k == 1
                               else self._pending_bias[None, :]
                               .astype(np.float32))
        metrics = create_metrics(self.config)
        for m in metrics:
            m.init(valid_set.metadata, n)
        self.valid_sets.append((name, valid_set))
        bins = torch.as_tensor(valid_set.X_binned, device=self.device)
        valid_set._device_cache["bins_rm"] = bins
        # continued training: the loaded trees' scores (reference
        # models/gbdt.py:764-778)
        self.valid_scores.append(self._score_models(
            torch.as_tensor(score0, device=self.device), bins))
        self.valid_metrics.append(metrics)

    def _score_models(self, score: torch.Tensor,
                      bins: torch.Tensor) -> torch.Tensor:
        """``score`` plus every recorded tree's output on the binned
        row-major ``bins`` (class c's trees at i * K + c)."""
        k = self.num_tree_per_iteration
        for t, tree in enumerate(self.models):
            delta = _walk_binned(
                bins, tree, torch.as_tensor(tree.leaf_value.astype(
                    np.float32), device=self.device), self.learner._efb)
            if k == 1:
                score = score + delta
            else:
                score[:, t % k] += delta
        return score

    # -- continued training (reference models/gbdt.py:1432-1497) -------------
    def _align_loaded_tree(self, tree: Tree) -> Tree:
        """Re-key a loaded tree (real feature indices, raw thresholds) onto
        this training Dataset: inner feature indices, and threshold_bin,
        nan_bin and the categorical nodes' member bins recovered through
        the bin mappers, so the binned walks can score it."""
        from ..binning import MissingType
        ds = self.train_set
        inner_of_real = {int(r): i for i, r in
                         enumerate(ds.used_feature_map)}
        t = copy.copy(tree)
        t.split_feature = np.array(tree.split_feature, np.int32, copy=True)
        t.threshold_bin = np.zeros_like(t.split_feature)
        t.nan_bin = np.full_like(t.split_feature, -1)
        member_bins = None
        for i in range(t.num_leaves - 1):
            rf = int(tree.split_feature[i])
            if rf not in inner_of_real:
                raise ValueError(
                    f"loaded model splits on feature {rf}, which is trivial "
                    f"(constant) in the continued-training dataset")
            f = inner_of_real[rf]
            t.split_feature[i] = f
            m = ds.bin_mappers[int(ds.used_feature_map[f])]
            if m.is_categorical:
                if member_bins is None:
                    member_bins = np.zeros((max(t.num_leaves - 1, 1),
                                            self.max_bins), bool)
                bins = [m.cat_to_bin[c] for c in tree.cat_values(i)
                        if c in m.cat_to_bin]
                member_bins[i, bins] = True
                t.threshold_bin[i] = bins[0] if bins else 0
            else:
                t.threshold_bin[i] = int(
                    m.value_to_bin(np.array([tree.threshold[i]]))[0])
            if m.missing_type == MissingType.NAN:
                t.nan_bin[i] = m.num_bin - 1
        t.cat_member_bins = member_bins
        return t

    def init_from_model(self, other: "GBDT") -> None:
        """Prime this booster with an existing model's trees and keep
        boosting (continued training, reference models/gbdt.py:1482):
        the loaded trees stay in the model and score the training rows."""
        k = self.num_tree_per_iteration
        ok = getattr(other, "num_tree_per_iteration", 1)
        if ok != k:
            raise ValueError(f"init_model has {ok} trees/iteration, this "
                             f"training configuration needs {k}")
        self.models = [self._align_loaded_tree(t) for t in other.models]
        self.iter_ = len(self.models) // max(k, 1)
        # the loaded first tree already carries any boost-from-average bias
        self._pending_bias[:] = 0.0
        score0 = np.zeros(self._score_shape(self.num_data), np.float32)
        md = self.train_set.metadata
        if md.init_score is not None:
            score0 = score0 + md.init_score.reshape(score0.shape).astype(
                np.float32)
        self.score = self._score_models(
            torch.as_tensor(score0, device=self.device),
            torch.as_tensor(self.train_set.X_binned, device=self.device))

    # -- one boosting iteration (gbdt.cpp:369 TrainOneIter) ------------------
    def train_one_iter(self) -> bool:
        cfg = self.config
        k = self.num_tree_per_iteration
        with FunctionTimer("GBDT::train_one_iter"):
            if self.objective is None:
                raise NotImplementedError(
                    "custom objectives (objective='none') are not ported to "
                    "lightgbm_tpu_torch yet (ROADMAP queue 1)")
            grad, hess = self.objective.get_gradients(self.score)
            # lagged no-split stop, as the reference's deferred-tree path:
            # when the previous iteration grew only stumps, pop them (the
            # first iteration's are kept: they carry the boost-from-average
            # constant, gbdt.cpp:443-450) and stop
            prev = self._prev_iter_leaves
            if prev is not None and all(x <= 1 for x in prev):
                self._prev_iter_leaves = None
                if len(self.models) > k:
                    del self.models[-k:]
                    self.iter_ = max(0, self.iter_ - 1)
                log_warning("Stopped training because there are no more "
                            "leaves that meet the split requirements")
                return True

            fm = feature_mask_np(cfg, self.num_features, self.iter_)
            fmask = None if fm is None else torch.as_tensor(
                fm, device=self.device)
            label = (self.train_set.metadata.label
                     if cfg.objective == "binary" else None)
            bag = bagging_mask_np(cfg, self.num_data, self.iter_,
                                  label=label)
            if bag is not None:
                self._bag_mask = torch.as_tensor(bag, device=self.device)
            leaves = []
            for cid in range(k):
                g = grad if k == 1 else grad[:, cid].contiguous()
                h = hess if k == 1 else hess[:, cid].contiguous()
                extra = self._tree_keys(self.iter_ * k + cid)
                if self._cegb_coupled is not None:
                    extra["cegb_penalty"] = torch.as_tensor(
                        np.where(self._cegb_used, 0.0, self._cegb_coupled),
                        dtype=torch.float32, device=self.device)
                grown = self.learner.train(self.X_T, g, h, self._bag_mask,
                                           feature_mask=fmask, **extra)
                self.last_hist_passes = grown.hist_passes
                self.last_host_syncs = grown.host_syncs
                tree = self._record_tree(grown, cid)
                if self._cegb_coupled is not None:
                    sf = tree.split_feature[:tree.num_leaves - 1]
                    self._cegb_used[sf[sf >= 0]] = True
                leaves.append(tree.num_leaves)
            self.iter_ += 1
            if self._undeferred:
                # recorded at once, as the reference's undeferred path: no
                # lagged pop, the stump iteration stays and training stops
                self._prev_iter_leaves = None
                if all(x <= 1 for x in leaves):
                    log_warning("Stopped training because there are no "
                                "more leaves that meet the split "
                                "requirements")
                    return True
                return False
            self._prev_iter_leaves = leaves
            return False

    def _tree_keys(self, it: int) -> dict:
        """The device RNG keys of tree ``it`` = iteration * K + class
        (reference gbdt.py:859-881): the by-node stream from
        ``feature_fraction_seed`` and the extra-trees stream from
        ``extra_seed`` (``node_key[0]`` and ``[1]``), and the stochastic
        rounding stream from ``seed``: host keys, folded without a device
        op (utils/random.py)."""
        cfg = self.config
        out = {}
        if cfg.feature_fraction_bynode < 1.0 or cfg.extra_trees:
            out["node_key"] = (fold_in(host_key(cfg.feature_fraction_seed),
                                       it),
                               fold_in(host_key(cfg.extra_seed), it))
        if self.learner.quantized:
            out["quant_key"] = fold_in(host_key(cfg.seed), it)
        return out

    @property
    def _renews(self) -> bool:
        return bool(getattr(self.objective, "is_renew_tree_output", False))

    @property
    def _undeferred(self) -> bool:
        """Trees recorded at once and the stump iteration kept, as the
        reference's undeferred path runs leaf renewal and coupled CEGB
        (models/gbdt.py:498, :1013-1016)."""
        return self._renews or self._cegb_coupled is not None

    def _current_shrinkage(self) -> float:
        return float(self.config.learning_rate)

    def _renew_leaf_values(self, grown: GrownTree,
                           class_id: int) -> np.ndarray:
        """Percentile leaf refit for L1/quantile/MAPE (reference
        models/gbdt.py:953-986, serial_tree_learner.cpp:684
        RenewTreeOutput): each leaf's value becomes the weighted
        alpha-percentile of the residuals of its in-bag rows.  Rows are
        grouped by leaf with a stable sort, so each leaf sees its rows in
        row order, as the reference's boolean selection does."""
        obj = self.objective
        alpha = float(obj.renew_alpha)
        score = self.score if self.num_tree_per_iteration == 1 \
            else self.score[:, class_id]
        label = np.asarray(self.train_set.metadata.label)
        resid = label - score.cpu().numpy()
        w = getattr(obj, "label_weight", None)  # MAPE folds weights here
        if w is not None:
            w = w.cpu().numpy()
        elif self.train_set.metadata.weight is not None:
            w = np.asarray(self.train_set.metadata.weight)
        row_leaf = grown.row_leaf.cpu().numpy()
        rows = np.nonzero(self._bag_mask.cpu().numpy() > 0)[0]
        rows = rows[np.argsort(row_leaf[rows], kind="stable")]
        bounds = np.searchsorted(row_leaf[rows],
                                 np.arange(int(grown.num_leaves) + 1))
        out = grown.leaf_value.cpu().numpy().astype(np.float64)
        for leaf in range(int(grown.num_leaves)):
            sel = rows[bounds[leaf]:bounds[leaf + 1]]
            if len(sel):
                out[leaf] = weighted_percentile(
                    resid[sel], None if w is None else w[sel], alpha)
        return out

    def _record_tree(self, grown: GrownTree, class_id: int = 0) -> Tree:
        shrinkage = self._current_shrinkage()
        renewed = (self._renew_leaf_values(grown, class_id)
                   if self._renews else None)
        tree = _grown_to_tree(grown, shrinkage, self.train_set,
                              leaf_value_override=renewed)
        bias = self._pending_bias[class_id] if self.iter_ == 0 else 0.0
        if abs(bias) > EPSILON:
            # fold the init score into the first tree (gbdt.cpp:414-427)
            tree.add_bias(bias)
        self.models.append(tree)
        leaf_value = grown.leaf_value if renewed is None else \
            torch.as_tensor(renewed.astype(np.float32), device=self.device)
        k = self.num_tree_per_iteration
        if k == 1:
            self.score = _update_score(self.score, grown.row_leaf,
                                       leaf_value, shrinkage)
        else:
            self.score[:, class_id] = _update_score(
                self.score[:, class_id], grown.row_leaf, leaf_value,
                shrinkage)
        lv = leaf_value * shrinkage
        for vi, (_, vset) in enumerate(self.valid_sets):
            delta = _walk_binned(vset._device_cache["bins_rm"], tree, lv,
                                 self.learner._efb)
            if k == 1:
                self.valid_scores[vi] = self.valid_scores[vi] + delta
            else:
                self.valid_scores[vi][:, class_id] += delta
        return tree

    # -- evaluation ------------------------------------------------------------
    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        if self.train_metrics:
            score = self.score.cpu().numpy()
            for m in self.train_metrics:
                for name, val, hib in m.eval(score):
                    out.append(("training", name, val, hib))
        return out

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        for vi, (vname, _) in enumerate(self.valid_sets):
            score = self.valid_scores[vi].cpu().numpy()
            for m in self.valid_metrics[vi]:
                for name, val, hib in m.eval(score):
                    out.append((vname, name, val, hib))
        return out

    # -- prediction ------------------------------------------------------------
    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0,
                num_iteration: Optional[int] = None) -> np.ndarray:
        """(N,) predictions, or (N, K) for a K-class model (class c's trees
        are at indices i * K + c), through the objective's output
        transform unless ``raw_score``."""
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        used = self.train_set.used_feature_map \
            if self.train_set is not None else np.arange(X.shape[1])
        Xi = torch.as_tensor(np.ascontiguousarray(X[:, used]),
                             device=self.device)
        k = self.num_tree_per_iteration
        t0 = start_iteration * k
        t1 = len(self.models) if num_iteration is None else min(
            len(self.models), (start_iteration + num_iteration) * k)
        cols = []
        for c in range(k):
            trees = [self.models[t] for t in range(t0, t1) if t % k == c]
            cols.append(predict_raw(TreeBatch(trees, self.device), Xi)
                        if trees else
                        torch.zeros((X.shape[0],), dtype=torch.float32,
                                    device=self.device))
        raw = cols[0] if k == 1 else torch.stack(cols, dim=1)
        if raw_score or self.objective is None:
            return raw.cpu().numpy()
        return self.objective.convert_output(raw).cpu().numpy()

    @property
    def current_iteration(self) -> int:
        return self.iter_

    def num_trees(self) -> int:
        return len(self.models)

    def save_model_to_string(self, start_iteration: int = 0,
                             num_iteration: int = -1) -> str:
        from .model_text import model_to_string
        return model_to_string(self, start_iteration, num_iteration)

    def feature_importance(self, importance_type: str = "split") -> np.ndarray:
        """Reference Booster::FeatureImportance: a full-length array over
        the ORIGINAL columns."""
        imp = np.zeros(self.num_features, np.float64)
        for tree in self.models:
            for i in range(tree.num_leaves - 1):
                f = tree.split_feature[i]
                if f >= 0:
                    if importance_type == "split":
                        imp[f] += 1.0
                    else:
                        imp[f] += max(tree.split_gain[i], 0.0)
        real_map, num_total, _ = self.feature_mapping()
        full = np.zeros(num_total, np.float64)
        full[real_map] = imp
        return full

    def feature_mapping(self):
        """(inner->original index map, num original columns, names)."""
        ts = self.train_set
        if ts is not None and ts.used_feature_map is not None:
            return (np.asarray(ts.used_feature_map),
                    int(ts.num_total_features), list(ts.feature_names_))
        num_total = int(getattr(self, "loaded_num_total", self.num_features))
        real_map = np.asarray(getattr(self, "loaded_real_map",
                                      np.arange(self.num_features)))
        names = getattr(self, "loaded_feature_names", None) or \
            [f"Column_{i}" for i in range(num_total)]
        return real_map, num_total, names

