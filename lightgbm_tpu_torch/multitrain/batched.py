"""Multi-model training: the lockstep batch boosting driver.

Port of ``lightgbm_tpu/multitrain/batched.py`` (reference :212-1071).  M
boosters train together over ONE binned dataset: per-model state (scores,
gradients, bagging and feature masks, RNG keys, swept hyperparameters) is
kept per lane, and every tree of an iteration grows in lockstep through
``SerialTreeLearner.train_lanes`` (learner/lanes.py): each lane runs the
standalone grower's own ops, and each kernel the lanes wait on launches
once for all of them in its model-axis form (ops/histogram_cuda.py
``*_lanes``), the counterpart of the reference's ``jax.vmap`` of one
grower over the model axis.

Bit-identity contract: model m of a batch writes the model text a
standalone ``train(variants[m])`` writes.  This holds because

* every lane's grower is built from its own variant's ``SplitParams``
  (``SerialTreeLearner.lane_grower``) and runs the standalone grower's
  ops; the model-axis kernels give each lane the single launch's bits;
* the host draws (``models/gbdt.py`` ``bagging_mask_np`` /
  ``feature_mask_np``) and the device RNG keys (``it * K + class``,
  ``GBDT._tree_keys``) are the standalone's, keyed by each variant's
  own seeds;
* the per-lane gradient, score update (the multiply, then the add:
  ``gbdt._update_score``) and valid-set walk are the standalone's own
  functions on that lane's tensors.

A model with a sample mask trains over all N rows with the masked rows'
weights zero, and its draws over row positions (bagging, stochastic
rounding, the speculative ramp's subsample) are those of a run on its
rows alone, so it grows the tree a standalone ``train()`` on that row
subset grows (the reference's masked models draw over all N rows and
match their subset runs only where no such draw enters).

Multiclass runs as an (M, K) grid of lanes, class-major (lane = m*K + c);
ranking runs over the shared query layout.  GOSS and DART batch too
(reference batched.py:607-830): a GOSS lane takes the standalone's host
draw (``gbdt.goss_sample_np``) over its own rows and never bags; a DART
model draws its drops as the standalone does (``boosting.dart_drops``)
and drops, re-adds and rescales its trees with the standalone's axpys on
its own lanes' scores.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..basic import Booster, device_from
from ..callback import CallbackEnv, EarlyStopException, early_stopping
from ..config import Config
from ..dataset import Dataset, Metadata
from ..learner.serial import SerialTreeLearner, split_params_from_config
from ..metric import create_metrics
from ..models.boosting import dart_drops, dart_factor, dart_shrinkage
from ..models.gbdt import (EPSILON, GBDT, _grown_to_tree, _update_score,
                           _walk_binned, bagging_mask_np, feature_mask_np,
                           goss_sample_np, learner_config, true_divide)
from ..objective import create_objective
from ..utils.random import fold_in, host_key

__all__ = ["MultiTrainError", "BatchTrainer", "batch_reject_reason"]


class MultiTrainError(ValueError):
    """The configuration cannot train on the model axis."""


# objectives the model axis cannot express: "none" means a custom fobj
_UNSUPPORTED_OBJECTIVES = ("none",)


def batch_reject_reason(cfg: Config, train_set: Dataset) -> Optional[str]:
    """Why this config cannot ride the model axis (None = it can): the
    reference's reasons, verbatim (reference batched.py:127-150)."""
    if cfg.boosting not in ("gbdt", "goss", "dart", ""):
        return f"boosting={cfg.boosting} (averaged-score training)"
    if cfg.objective in _UNSUPPORTED_OBJECTIVES:
        return f"objective={cfg.objective}"
    if cfg.tree_learner not in ("serial", ""):
        return f"tree_learner={cfg.tree_learner} (mesh collectives)"
    if cfg.linear_tree:
        return "linear_tree (host-side leaf fits)"
    if (cfg.cegb_penalty_split > 0 or cfg.cegb_penalty_feature_coupled or
            cfg.cegb_penalty_feature_lazy):
        return "CEGB penalties (cross-tree used-feature state)"
    if getattr(train_set, "distributed_rows", False):
        return "pre_partition-ed multi-process dataset"
    return None


def _objective_reject_reason(objective) -> Optional[str]:
    if objective is None:
        return "custom objective (fobj)"
    if getattr(objective, "is_renew_tree_output", False):
        return (f"objective {type(objective).__name__} renews leaf values "
                "host-side per tree")
    return None


def _subset_metadata(md: Metadata, rows: np.ndarray,
                     mask_vals: Optional[np.ndarray] = None) -> Metadata:
    """Metadata restricted to ``rows`` (the standalone counterpart's
    ``Dataset.subset``); fractional mask values fold into the weights
    (reference batched.py:162-178)."""
    sub = Metadata()
    if md.label is not None:
        sub.set_label(np.asarray(md.label)[rows])
    w = None if md.weight is None else np.asarray(md.weight)[rows]
    if mask_vals is not None and not np.all(mask_vals == 1.0):
        w = mask_vals if w is None else w * mask_vals
    if w is not None:
        sub.set_weight(w)
    if md.init_score is not None:
        sub.set_init_score(np.asarray(md.init_score)[rows])
    return sub


class _ModelState:
    """Host bookkeeping of one model (all K class lanes)."""

    __slots__ = ("cfg", "params", "rows", "own_rows", "mask_vals", "bias",
                 "active",
                 "kept_iters", "best_iteration", "best_score", "stopper",
                 "history", "metrics_per_valid", "stop_reason", "trees",
                 "leaves",
                 # DART (models/boosting.py DART's state, per model)
                 "weights", "sum_weight", "cur_shrinkage", "drops",
                 "base", "vbase", "hbase")

    def __init__(self, cfg: Config, params: Dict[str, Any]) -> None:
        self.cfg = cfg
        self.params = params
        self.rows: Optional[np.ndarray] = None
        self.own_rows: Optional[torch.Tensor] = None   # rows, on the device
        self.mask_vals: Optional[np.ndarray] = None
        self.bias: Optional[np.ndarray] = None   # (K,) per-class init bias
        self.active = True
        self.kept_iters = 0
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        self.stopper = None
        self.history: Dict[str, Dict[str, List[float]]] = {}
        self.metrics_per_valid: List[list] = []
        self.stop_reason = ""
        self.trees: list = []                # host Trees, it * K + c
        self.leaves: List[List[int]] = []    # per iteration, per class
        self.weights: List[float] = []       # DART: each iteration's weight
        self.sum_weight = 0.0
        self.cur_shrinkage = float(cfg.learning_rate)
        self.drops: List[int] = []           # DART: this iteration's drops
        self.base: list = []     # DART, per iteration, per class: (N,) raw
        self.vbase: list = []    # ... per valid set, per class
        self.hbase: list = []    # ... held-out rows (cv), per class


class BatchTrainer:
    """Trains one same-structure group of M variants in lockstep.

    Drivers (``train_many``, the ``cv`` fast path) construct it, call
    :meth:`run` or drive :meth:`step_once` themselves, then
    :meth:`finalize` for per-model standalone ``Booster``\\ s."""

    def __init__(self, variant_params: List[Dict[str, Any]],
                 train_set: Dataset,
                 sample_masks: Optional[np.ndarray] = None,
                 valid_sets: Optional[List[Dataset]] = None,
                 valid_names: Optional[List[str]] = None,
                 device=None) -> None:
        self.M = len(variant_params)
        if self.M == 0:
            raise MultiTrainError("empty variant batch")
        self.params = [dict(p) for p in variant_params]
        self.device = device_from(self.params[0], device)
        self.cfgs = [Config(p) for p in self.params]
        cfg = self.cfgs[0]
        self.cfg = cfg
        train_set.construct(cfg)
        reason = batch_reject_reason(cfg, train_set)
        if reason:
            raise MultiTrainError(reason)
        self._shim = GBDT(cfg, None, device=self.device)
        self._goss = cfg.boosting == "goss"
        self._dart = cfg.boosting == "dart"
        self.train_set = train_set
        self.n = train_set.num_data()
        self.num_features = train_set.num_feature()

        # one objective on the FULL metadata serves every model: gradients
        # are per row (or per query), so per-model row masks never reach
        # their values (reference batched.py:250-259)
        self.objective = (create_objective(cfg.objective, cfg, self.device)
                          if cfg.objective != "none" else None)
        reason = _objective_reject_reason(self.objective)
        if reason:
            raise MultiTrainError(reason)
        self.objective.init(train_set.metadata, self.n)
        self.K = int(self.objective.num_model_per_iteration)
        self.L = self.M * self.K
        self._ranking = train_set.metadata.group is not None
        if cfg.objective == "rank_xendcg" and \
                len({int(c.seed) for c in self.cfgs}) > 1:
            raise MultiTrainError(
                "rank_xendcg seed sweep (the sampled-lambda stream is "
                "shared across lanes)")

        # the learner: the standalone's selection path (GBDT._init_train)
        shim = self._shim
        shim.config = cfg
        shim.train_set = train_set
        shim.num_features = self.num_features
        from ..binning import MissingType
        mappers = [train_set.bin_mappers[j]
                   for j in train_set.used_feature_map]
        shim.max_bins = int(max(m.num_bin for m in mappers))
        num_bins = np.array([m.num_bin for m in mappers], np.int32)
        has_nan = np.array([m.missing_type == MissingType.NAN
                            for m in mappers], bool)
        is_cat = np.array([m.is_categorical for m in mappers], bool)
        self.learner = SerialTreeLearner(
            learner_config(cfg, train_set, shim.max_bins, self.device),
            self.num_features, shim.max_bins, num_bins, has_nan,
            self.device, is_cat=is_cat, efb=train_set.efb,
            monotone=GBDT._inner_monotone(shim),
            forced_splits=GBDT._parse_forced_splits(shim),
            interaction_groups=GBDT._parse_interaction_constraints(shim),
            feature_contri=GBDT._inner_contri(shim), cegb_lazy=())
        if self.learner.grow_mode == "masked":
            raise MultiTrainError(
                "pool-less (masked) grower: histogram pool exceeds budget")
        # each lane's scan parameters: its own variant's (the swept
        # lambda_l1/l2, min_data_in_leaf, ... differ per lane)
        self.split_params = [
            split_params_from_config(c, num_bins, is_cat) for c in self.cfgs]
        self.X_T = (train_set.device_bins_packed4(self.device)
                    if self.learner.pack4
                    else train_set.device_bins(self.device))

        self.states = [_ModelState(c, p)
                       for c, p in zip(self.cfgs, self.params)]
        if sample_masks is not None:
            sample_masks = np.asarray(sample_masks, np.float32)
            if sample_masks.shape != (self.M, self.n):
                raise MultiTrainError(
                    f"sample_masks shape {sample_masks.shape} != "
                    f"({self.M}, {self.n})")
            for m, st in enumerate(self.states):
                nz = np.nonzero(sample_masks[m] > 0)[0]
                st.rows = nz
                st.own_rows = torch.as_tensor(nz, device=self.device)
                st.mask_vals = sample_masks[m][nz]
        any_rows = any(st.rows is not None for st in self.states)
        if any_rows and cfg.is_unbalance and \
                cfg.objective in ("binary", "multiclassova"):
            # the shared objective derives is_unbalance's label_weight
            # from the FULL dataset's pos/neg counts; a fold/cohort
            # model's standalone counterpart derives it from ITS rows —
            # masked gradients would silently weight wrong
            raise MultiTrainError(
                "is_unbalance with per-model sample masks (label_weight "
                "depends on the fold's own pos/neg counts)")
        if any_rows and self._ranking:
            # a fold's standalone counterpart re-segments ITS rows into
            # queries; the shared padded segment layout spans the full
            # dataset and cannot express per-lane query subsets
            raise MultiTrainError(
                "ranking objectives with per-model sample masks (query "
                "segments derive from the full dataset)")

        self._init_scores()
        self._init_valid(valid_sets or [], valid_names or [])
        self.hscores: Optional[List[torch.Tensor]] = None
        self.heldout: Optional[List[torch.Tensor]] = None
        self._steps = 0
        self._masks: Optional[List[torch.Tensor]] = None

    def track_heldout(self, rows: List[np.ndarray]) -> None:
        """DART: score model m's held-out ``rows[m]`` as the per-fold
        loop scores its valid set (the tree's delta, then the drops'
        rescale by the weight's change), not as its training score (the
        drop, then the re-add); the cv fast path reads them here.  Other
        boostings' held-out rows take the valid set's ops in the training
        score already."""
        if not self._dart:
            return
        K = self.K
        self.heldout = [torch.as_tensor(np.asarray(r, np.int64),
                                        device=self.device) for r in rows]
        self.hscores = [self.score[m * K + c][self.heldout[m]].clone()
                        for m in range(self.M) for c in range(K)]

    # -- setup ---------------------------------------------------------------
    def _lane_vec(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a.astype(np.float32), device=self.device)

    def _init_scores(self) -> None:
        """Per-lane (N,) scores: the user's init score, else each model's
        boost-from-average over its own rows (reference
        batched.py:383-407)."""
        md = self.train_set.metadata
        K, n = self.K, self.n
        self.score: List[torch.Tensor] = []
        init = None
        if md.init_score is not None:
            init = md.init_score.reshape(n, K) if K > 1 else \
                md.init_score.reshape(n, 1)
        for st in self.states:
            st.bias = np.zeros(K)
            if init is None and st.cfg.boost_from_average:
                if st.rows is None:
                    obj = self.objective
                else:
                    obj = create_objective(st.cfg.objective, st.cfg,
                                           self.device)
                    obj.init(_subset_metadata(md, st.rows, st.mask_vals),
                             len(st.rows))
                st.bias = np.array([obj.boost_from_score(c)
                                    for c in range(K)])
            for c in range(K):
                s0 = np.zeros(n, np.float32)
                if init is not None:
                    s0 = s0 + init[:, c].astype(np.float32)
                else:
                    s0 = s0 + np.float32(st.bias[c])
                self.score.append(self._lane_vec(s0))

    def _init_valid(self, valid_sets: List[Dataset],
                    valid_names: List[str]) -> None:
        self.valid_sets: List[tuple] = []
        self.vscores: List[List[torch.Tensor]] = []
        K = self.K
        for i, vs in enumerate(valid_sets):
            if vs is self.train_set:
                raise MultiTrainError(
                    "valid_sets containing the train set (training "
                    "metrics) is not batched; drop it or use train()")
            name = (valid_names[i] if i < len(valid_names)
                    else f"valid_{i}")
            if not vs.constructed and vs.reference is not self.train_set:
                vs.reference = self.train_set
            vs.construct(self.cfg)
            if vs.bin_mappers is not self.train_set.bin_mappers:
                raise ValueError(
                    "cannot add validation data: it was constructed "
                    "without reference to the training Dataset")
            nv = vs.num_data()
            init = vs.metadata.init_score
            if init is not None:
                init = init.reshape(nv, K) if K > 1 else init.reshape(nv, 1)
            lanes = []
            for st in self.states:
                for c in range(K):
                    v0 = np.zeros(nv, np.float32)
                    if init is not None:
                        v0 = v0 + init[:, c].astype(np.float32)
                    elif st.cfg.boost_from_average:
                        v0 = v0 + np.float32(st.bias[c])
                    lanes.append(self._lane_vec(v0))
            bins = torch.as_tensor(vs.X_binned, device=self.device)
            vs._device_cache["bins_rm"] = bins
            self.valid_sets.append((name, vs, bins))
            self.vscores.append(lanes)
            for st in self.states:
                metrics = create_metrics(st.cfg)
                for mt in metrics:
                    mt.init(vs.metadata, nv)
                st.metrics_per_valid.append(metrics)

    # -- per-iteration host inputs ------------------------------------------
    def _lane_masks(self, it: int) -> List[torch.Tensor]:
        """(N,) f32 training-row mask of each model: its bag over its own
        rows (the draws a standalone run on the compacted rows makes),
        times its sample-mask values."""
        label = None
        if self.cfg.objective == "binary" and \
                self.train_set.metadata.label is not None:
            label = np.asarray(self.train_set.metadata.label)
        out = []
        for st in self.states:
            # GOSS never bags (the standalone's sampling replaces it)
            base = None if self._goss else bagging_mask_np(
                st.cfg, self.n, it, label=label, rows=st.rows)
            if base is None:
                if st.rows is None:
                    out.append(None)
                    continue
                base = np.zeros(self.n, np.float32)
                base[st.rows] = 1.0
            if st.mask_vals is not None:
                sub = base[st.rows] * st.mask_vals
                base = np.zeros(self.n, np.float32)
                base[st.rows] = sub
            out.append(base)
        return out

    def _tree_keys(self, cfg: Config, it: int) -> dict:
        """The standalone's device RNG keys of tree ``it`` = iteration * K
        + class (``GBDT._tree_keys``), from this lane's seeds."""
        out = {}
        if cfg.feature_fraction_bynode < 1.0 or cfg.extra_trees:
            out["node_key"] = (fold_in(host_key(cfg.feature_fraction_seed),
                                       it),
                               fold_in(host_key(cfg.extra_seed), it))
        if self.learner.quantized:
            out["quant_key"] = fold_in(host_key(cfg.seed), it)
        return out

    def _gradients(self, m: int):
        """Model m's per-class (N,) gradients: the shared objective on its
        score, (N,) or the standalone's (N, K) layout."""
        K = self.K
        if K == 1:
            return self.objective.get_gradients(self.score[m]), None
        sc = torch.stack(self.score[m * K:(m + 1) * K], dim=1)
        return self.objective.get_gradients(sc), K

    def check_stumps(self, it: int) -> None:
        """Before stepping iteration ``it``: a model whose ENTIRE previous
        iteration grew stumps stops, and that iteration's trees go unless
        they are the model's only ones (the standalone's lagged pop,
        gbdt.cpp:430-450; reference batched.py:920-941)."""
        if it < 1:
            return
        for st in self.states:
            if st.active and len(st.leaves) >= it and \
                    all(x <= 1 for x in st.leaves[it - 1]):
                st.active = False
                st.stop_reason = "no-split"
                # DART records each tree at once and keeps the stump
                # iteration (models/boosting.py); the others pop it unless
                # it is the model's only one
                st.kept_iters = it if self._dart else max(1, it - 1)

    def step_once(self, it: int) -> None:
        """One boosting iteration of every active model: all their trees
        (M x K lanes) grow in lockstep."""
        K = self.K
        masks = self._lane_masks(it)
        if self._dart:
            self._dart_drop(it)
        lanes, sps, owner = [], [], []
        for m, st in enumerate(self.states):
            if not st.active:
                continue
            (grad, hess), k = self._gradients(m)
            fm = feature_mask_np(st.cfg, self.num_features, it)
            fmask = None if fm is None else torch.as_tensor(
                fm, device=self.device)
            base = masks[m]
            if self._goss:
                grad, hess, base = self._goss_lane(m, it, grad, hess, base)
            bag = (torch.ones(self.n, dtype=torch.float32,
                              device=self.device)
                   if base is None else self._lane_vec(base))
            for c in range(K):
                g = grad if k is None else grad[:, c].contiguous()
                h = hess if k is None else hess[:, c].contiguous()
                lanes.append(dict(grad=g, hess=h, sample_mask=bag,
                                  feature_mask=fmask, own_rows=st.own_rows,
                                  **self._tree_keys(st.cfg, it * K + c)))
                sps.append(self.split_params[m])
                owner.append((m, c))
        grown = self.learner.train_lanes(self.X_T, lanes, sps)
        for (m, c), gt in zip(owner, grown):
            self._record(m, c, gt, it)
        if self._dart:
            self._dart_normalize()
        self._steps += 1
        for st in self.states:
            if st.active:
                st.kept_iters = self._steps

    # -- GOSS and DART (the standalone's host state, per model) -------------
    def _goss_lane(self, m: int, it: int, grad, hess, base):
        """The standalone ``GOSS._prepare_iter_sampling`` of model m over
        its own rows: the amplified gradients and the row mask (its base
        mask, the rows indicator, times the survivorship)."""
        st = self.states[m]
        gm = goss_sample_np(st.cfg, grad.cpu().numpy(), hess.cpu().numpy(),
                            it, rows=st.rows)
        if gm is None:
            return grad, hess, base
        mask, mult = gm
        scale = torch.as_tensor(mult, device=self.device)
        if grad.dim() == 2:
            scale = scale[:, None]
        return grad * scale, hess * scale, (mask if base is None
                                            else base * mask)

    def _dart_drop(self, it: int) -> None:
        """Each active model's drops (``boosting.dart_drops``, its own
        seeds and weights): the dropped trees leave its lanes' TRAIN
        scores, and its new tree's shrinkage follows (the standalone
        ``DART.train_one_iter``)."""
        K = self.K
        for m, st in enumerate(self.states):
            st.drops = []
            if not st.active:
                continue
            st.drops = dart_drops(st.cfg, it, st.weights, st.sum_weight)
            for d in st.drops:
                for c in range(K):
                    lane = m * K + c
                    self.score[lane] = self.score[lane] - \
                        st.base[d][c] * st.weights[d]
            st.cur_shrinkage = dart_shrinkage(st.cfg, len(st.drops))

    def _dart_normalize(self) -> None:
        """The standalone ``DART._normalize`` of each model that dropped:
        each dropped tree rescales by k/(k+1) (its host trees shrink in
        place), its train score re-adds it at the new weight, and the
        valid (and held-out) scores move by the weight's change."""
        K = self.K
        for m, st in enumerate(self.states):
            if not st.drops:
                continue
            factor = dart_factor(st.cfg, len(st.drops))
            for d in st.drops:
                old_w = st.weights[d]
                new_w = old_w * factor
                st.weights[d] = new_w
                st.sum_weight -= old_w - new_w
                for c in range(K):
                    lane = m * K + c
                    st.trees[d * K + c].shrink(factor)
                    self.score[lane] = self.score[lane] + \
                        st.base[d][c] * new_w
                    for vi in range(len(self.valid_sets)):
                        self.vscores[vi][lane] = self.vscores[vi][lane] + \
                            st.vbase[d][vi][c] * (new_w - old_w)
                    if self.hscores is not None:
                        self.hscores[lane] = self.hscores[lane] + \
                            st.hbase[d][c] * (new_w - old_w)

    def _record(self, m: int, c: int, grown, it: int) -> None:
        """The standalone's ``GBDT._record_tree`` on lane (m, c), and
        DART's bookkeeping of the new tree."""
        st = self.states[m]
        lane = m * self.K + c
        shrinkage = (st.cur_shrinkage if self._dart
                     else float(st.cfg.learning_rate))
        tree = _grown_to_tree(grown, shrinkage, self.train_set)
        if it == 0 and abs(st.bias[c]) > EPSILON:
            tree.add_bias(st.bias[c])
        st.trees.append(tree)
        if c == 0:
            st.leaves.append([])
        st.leaves[-1].append(tree.num_leaves)
        self.score[lane] = _update_score(self.score[lane], grown.row_leaf,
                                         grown.leaf_value, shrinkage)
        lv = grown.leaf_value * shrinkage
        vb = []
        for vi, (_, _, bins) in enumerate(self.valid_sets):
            delta = _walk_binned(bins, tree, lv, self.learner._efb)
            before = self.vscores[vi][lane]
            self.vscores[vi][lane] = before + delta
            if self._dart:
                vb.append(true_divide(self.vscores[vi][lane] - before,
                                      shrinkage))
        if not self._dart:
            return
        if c == 0:
            st.weights.append(shrinkage)
            st.sum_weight += shrinkage
            st.base.append([])
            st.vbase.append([[] for _ in self.valid_sets])
            st.hbase.append([])
        st.base[-1].append(grown.leaf_value[grown.row_leaf.long()])
        for vi, v in enumerate(vb):
            st.vbase[-1][vi].append(v)
        if self.hscores is not None:
            before = self.hscores[lane]
            self.hscores[lane] = before + lv[
                grown.row_leaf.long()[self.heldout[m]]]
            st.hbase[-1].append(true_divide(self.hscores[lane] - before,
                                            shrinkage))

    # -- evaluation / early stopping ----------------------------------------
    def _model_score(self, lanes: List[torch.Tensor], m: int,
                     rows=None) -> np.ndarray:
        """Model m's score on the host: (n,) or the standalone's (n, K)."""
        K = self.K
        cols = [lanes[m * K + c] if rows is None else lanes[m * K + c][rows]
                for c in range(K)]
        out = cols[0] if K == 1 else torch.stack(cols, dim=1)
        return out.cpu().numpy()

    def host_lane_score(self, m: int, rows=None) -> np.ndarray:
        """Model m's current TRAIN score, optionally at row indices
        ``rows`` (the cv fast path reads held-out rows here)."""
        return self._model_score(self.score, m, rows)

    def host_heldout_score(self, m: int, rows) -> np.ndarray:
        """Model m's scores on its held-out ``rows``: the DART held-out
        lanes when :meth:`track_heldout` keeps them, else the training
        score there."""
        if self.hscores is None:
            return self.host_lane_score(m, rows)
        return self._model_score(self.hscores, m)

    def eval_all(self, it: int, num_boost_round: int) -> None:
        if not self.valid_sets:
            return
        for m, st in enumerate(self.states):
            if not st.active:
                continue
            rows = []
            for vi, (vname, _, _) in enumerate(self.valid_sets):
                sc = self._model_score(self.vscores[vi], m)
                for mt in st.metrics_per_valid[vi]:
                    for name, val, hib in mt.eval(sc):
                        rows.append((vname, name, val, hib))
            for dn, en, val, _ in rows:
                st.history.setdefault(dn, {}).setdefault(en, []).append(val)
            if st.stopper is None and st.cfg.early_stopping_round and \
                    int(st.cfg.early_stopping_round) > 0:
                st.stopper = early_stopping(
                    int(st.cfg.early_stopping_round),
                    st.cfg.first_metric_only, verbose=False)
            if st.stopper is not None:
                env = CallbackEnv(None, st.params, it, 0, num_boost_round,
                                  rows)
                try:
                    st.stopper(env)
                except EarlyStopException as e:
                    st.active = False
                    st.stop_reason = "early-stop"
                    st.kept_iters = it + 1
                    st.best_iteration = e.best_iteration + 1
                    for dn, en, sc, _ in e.best_score:
                        st.best_score.setdefault(dn, {})[en] = sc

    def run(self, num_boost_round: int) -> "BatchTrainer":
        for it in range(num_boost_round):
            self.check_stumps(it)
            if not any(st.active for st in self.states):
                break
            self.step_once(it)
            self.eval_all(it, num_boost_round)
            if not any(st.active for st in self.states):
                break
        return self

    # -- extraction ----------------------------------------------------------
    def finalize(self) -> List[Booster]:
        """Per-model standalone ``Booster``\\ s (reference
        batched.py:1016-1071)."""
        K = self.K
        boosters = []
        for m, st in enumerate(self.states):
            bst = Booster(params=st.params, train_set=self.train_set,
                          device=self.device)
            gb = bst._gbdt
            gb.models = list(st.trees[:st.kept_iters * K])
            gb.iter_ = st.kept_iters
            lanes = self.score[m * K:(m + 1) * K]
            gb.score = lanes[0] if K == 1 else torch.stack(lanes, dim=1)
            if self._dart:
                kept = st.kept_iters
                gb._weights = list(st.weights[:kept])
                gb._sum_weight = float(sum(st.weights[:kept]))
                gb._cur_shrinkage = st.cur_shrinkage
            bst.best_iteration = st.best_iteration
            bst.best_score = st.best_score
            boosters.append(bst)
        return boosters
