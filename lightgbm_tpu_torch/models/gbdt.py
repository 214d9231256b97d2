"""GBDT boosting driver.

Port of ``lightgbm_tpu/models/gbdt.py`` ``GBDT`` as far as the main path
needs it (reference: src/boosting/gbdt.cpp — ``TrainOneIter`` at :369,
bagging at :228, ``BoostFromAverage`` at :344 with the init score folded
into the first tree via AddBias at :414-427, score updates at :491).

The boosting loop is host-driven; gradients, sampling masks, tree growth
and the score update run on the training device.  Each grown tree is
pulled to the host once, when it is recorded.  Trees that stopped
splitting are popped one iteration later, as the reference's deferred
path does (gbdt.cpp:430-450), so both packages keep the same trees.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..learner.serial import GrownTree, SerialTreeLearner
from ..metric import Metric, create_metrics
from ..objective import ObjectiveFunction, create_objective
from ..utils.log import log_info, log_warning
from ..utils.random import host_rng
from ..utils.timer import FunctionTimer
from .tree import DEFAULT_LEFT_MASK, Tree, TreeBatch, predict_raw

__all__ = ["GBDT", "bagging_mask_np", "feature_mask_np"]

EPSILON = 1e-12


def _grown_to_tree(grown: GrownTree, shrinkage: float,
                   dataset: Dataset) -> Tree:
    """Pull one grown tree to host and attach raw-value thresholds
    (numeric nodes; the reference's categorical bitsets are not ported)."""
    num_leaves = int(grown.num_leaves)

    def host(t):
        return t.detach().cpu().numpy()

    split_feature = host(grown.split_feature)
    threshold_bin = host(grown.threshold_bin)
    mappers = [dataset.bin_mappers[j] for j in dataset.used_feature_map]
    thresh = np.zeros(len(split_feature), dtype=np.float64)
    for i in range(num_leaves - 1):
        f = int(split_feature[i])
        if f >= 0:
            thresh[i] = mappers[f].bin_to_value(int(threshold_bin[i]))
    tree = Tree(
        num_leaves=max(num_leaves, 1),
        split_feature=split_feature.astype(np.int32),
        threshold_bin=threshold_bin.astype(np.int32),
        nan_bin=host(grown.nan_bin).astype(np.int32),
        threshold=thresh,
        decision_type=host(grown.decision_type).astype(np.uint8),
        left_child=host(grown.left_child).astype(np.int32),
        right_child=host(grown.right_child).astype(np.int32),
        split_gain=host(grown.split_gain),
        internal_value=host(grown.internal_value).astype(np.float64),
        internal_weight=host(grown.internal_weight).astype(np.float64),
        internal_count=host(grown.internal_count).astype(np.int64),
        leaf_value=host(grown.leaf_value).astype(np.float64),
        leaf_weight=host(grown.leaf_weight).astype(np.float64),
        leaf_count=host(grown.leaf_count).astype(np.int64),
    )
    if shrinkage != 1.0:
        tree.shrink(shrinkage)
    return tree


def _update_score(score: torch.Tensor, row_leaf: torch.Tensor,
                  leaf_value: torch.Tensor, shrinkage: float) -> torch.Tensor:
    """score + (leaf_value * shrinkage)[row_leaf]: the multiply and the add
    stay two f32 operations, each rounded, as in the reference (a fused
    multiply-add drifts 1 ulp from it)."""
    lv = leaf_value * shrinkage
    return score + lv[row_leaf.long()]


def bagging_mask_np(cfg, n: int, iteration: int,
                    label: Optional[np.ndarray] = None
                    ) -> Optional[np.ndarray]:
    """Per-iteration bagging mask (gbdt.cpp:228 Bagging, resampled every
    bagging_freq iters with a deterministic per-block seed).  Copy of the
    reference's host sampler (``rows=`` restriction omitted): returns a
    float32 (n,) 0/1 mask, or None when bagging is inactive."""
    pos_neg = (cfg.objective == "binary" and
               (cfg.pos_bagging_fraction < 1.0 or
                cfg.neg_bagging_fraction < 1.0))
    if not (cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0 or pos_neg)):
        return None
    block = iteration // cfg.bagging_freq
    rng = host_rng(cfg.bagging_seed, block)
    sub = np.zeros(n, np.float32)
    if pos_neg:
        pos = np.nonzero(label > 0)[0]
        neg = np.nonzero(label <= 0)[0]
        kp = int(len(pos) * cfg.pos_bagging_fraction)
        kn = int(len(neg) * cfg.neg_bagging_fraction)
        if kp:
            sub[rng.choice(pos, size=kp, replace=False)] = 1.0
        if kn:
            sub[rng.choice(neg, size=kn, replace=False)] = 1.0
    else:
        k = int(n * cfg.bagging_fraction)
        sub[rng.choice(n, size=k, replace=False)] = 1.0
    return sub


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


def _walk_binned(bins: torch.Tensor, tree: Tree,
                 leaf_value: torch.Tensor) -> torch.Tensor:
    """One tree's walk on a BINNED row-major (N, F) matrix (valid-set score
    updates, reference models/tree.py ``_walk_impl``): the NaN bin follows
    ``default_left``, other bins compare with the threshold bin."""
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
    lc = torch.as_tensor(tree.left_child[:k], dtype=torch.long, device=dev)
    rc = torch.as_tensor(tree.right_child[:k], dtype=torch.long, device=dev)
    rows = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.long, device=dev)
    out = torch.zeros((n,), dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    while bool(active.any()):
        nd = node.clamp(min=0)
        b = bins[rows, sf[nd]].to(torch.int32)
        go_left = torch.where(b == nb[nd], dl[nd], b <= tb[nd])
        new_node = torch.where(active, torch.where(go_left, lc[nd], rc[nd]),
                               node)
        hit = active & (new_node < 0)
        out = torch.where(hit, leaf_value[(~new_node).clamp(min=0)], out)
        node = new_node
        active = node >= 0
    return out


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
                "are not ported to lightgbm_tpu_torch yet (ROADMAP queue 1, "
                "item 12)")
        if cfg.objective in ("multiclass", "multiclassova") or \
                cfg.num_class > 1:
            raise NotImplementedError(
                "multiclass training is not ported to lightgbm_tpu_torch "
                "yet (ROADMAP queue 1, item 3)")
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
        if self.num_data > (1 << 24) and not cfg.use_quantized_grad:
            log_warning(f"num_data={self.num_data} exceeds the f32 "
                        "histogram count channel's 2^24-row exactness "
                        "range; set use_quantized_grad=true for exact "
                        "int32 counts at this scale")
        self.learner = SerialTreeLearner(cfg, self.num_features,
                                         self.max_bins, num_bins, has_nan,
                                         self.device)
        self.X_T = train_set.device_bins(self.device)

        if self.objective is None and cfg.objective != "none":
            self.objective = create_objective(cfg.objective, cfg,
                                              self.device)
        if self.objective is not None:
            self.objective.init(train_set.metadata, self.num_data)

        # initial scores: user init_score > boost_from_average > zero
        self._pending_bias = 0.0
        score0 = np.zeros((self.num_data,), np.float32)
        md = train_set.metadata
        if md.init_score is not None:
            score0 = score0 + md.init_score.astype(np.float32)
        elif cfg.boost_from_average and self.objective is not None:
            s = self.objective.boost_from_score(0)
            self._pending_bias = s
            if abs(s) > EPSILON:
                log_info(f"Start training from score {s:.6f}")
            score0 = score0 + np.float32(s)
        self.score = torch.as_tensor(score0, device=self.device)
        self._bag_mask = torch.ones(self.num_data, dtype=torch.float32,
                                    device=self.device)

        self.train_metrics = []
        if cfg.is_provide_training_metric:
            self.train_metrics = create_metrics(cfg)
            for m in self.train_metrics:
                m.init(md, self.num_data)

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
        score0 = np.zeros((n,), np.float32)
        if valid_set.metadata.init_score is not None:
            score0 = score0 + valid_set.metadata.init_score.astype(np.float32)
        elif self.config.boost_from_average and self.objective is not None:
            score0 = score0 + np.float32(self._pending_bias)
        metrics = create_metrics(self.config)
        for m in metrics:
            m.init(valid_set.metadata, n)
        self.valid_sets.append((name, valid_set))
        self.valid_scores.append(torch.as_tensor(score0, device=self.device))
        self.valid_metrics.append(metrics)
        valid_set._device_cache["bins_rm"] = torch.as_tensor(
            valid_set.X_binned, device=self.device)

    # -- one boosting iteration (gbdt.cpp:369 TrainOneIter) ------------------
    def train_one_iter(self) -> bool:
        cfg = self.config
        with FunctionTimer("GBDT::train_one_iter"):
            if self.objective is None:
                raise NotImplementedError(
                    "custom objectives (objective='none') are not ported to "
                    "lightgbm_tpu_torch yet")
            grad, hess = self.objective.get_gradients(self.score)
            # lagged no-split stop, as the reference's deferred-tree path:
            # when the previous iteration grew only stumps, pop them (the
            # first iteration's are kept: they carry the boost-from-average
            # constant, gbdt.cpp:443-450) and stop
            prev = self._prev_iter_leaves
            if prev is not None and all(x <= 1 for x in prev):
                self._prev_iter_leaves = None
                if len(self.models) > 1:
                    self.models.pop()
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
            grown = self.learner.train(self.X_T, grad, hess, self._bag_mask,
                                       feature_mask=fmask)
            self.last_hist_passes = grown.hist_passes
            self._record_tree(grown)
            self._prev_iter_leaves = [int(grown.num_leaves)]
            self.iter_ += 1
            return False

    def _current_shrinkage(self) -> float:
        return float(self.config.learning_rate)

    def _record_tree(self, grown: GrownTree) -> Tree:
        shrinkage = self._current_shrinkage()
        tree = _grown_to_tree(grown, shrinkage, self.train_set)
        bias = self._pending_bias if self.iter_ == 0 else 0.0
        if abs(bias) > EPSILON:
            # fold the init score into the first tree (gbdt.cpp:414-427)
            tree.add_bias(bias)
        self.models.append(tree)
        self.score = _update_score(self.score, grown.row_leaf,
                                   grown.leaf_value, shrinkage)
        lv = grown.leaf_value * shrinkage
        for vi, (_, vset) in enumerate(self.valid_sets):
            self.valid_scores[vi] = self.valid_scores[vi] + _walk_binned(
                vset._device_cache["bins_rm"], tree, lv)
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
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        used = self.train_set.used_feature_map \
            if self.train_set is not None else np.arange(X.shape[1])
        Xi = torch.as_tensor(np.ascontiguousarray(X[:, used]),
                             device=self.device)
        if not self.models:
            raw = torch.zeros((X.shape[0],), dtype=torch.float32,
                              device=self.device)
        else:
            batch = TreeBatch(self.models, self.device)
            raw = predict_raw(batch, Xi, start_iteration, num_iteration)
        if raw_score:
            return raw.cpu().numpy()
        if self.objective is None:
            if str(self.config.objective) not in ("none", "", "regression"):
                raise NotImplementedError(
                    f"output transform of objective "
                    f"{self.config.objective!r} is not ported to "
                    "lightgbm_tpu_torch yet; pass raw_score=True")
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

