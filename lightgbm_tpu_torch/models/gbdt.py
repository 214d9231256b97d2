"""GBDT boosting driver.

Port of ``lightgbm_tpu/models/gbdt.py`` ``GBDT`` (reference: src/boosting/gbdt.cpp — ``TrainOneIter`` at :369, bagging at
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

``tree_learner=data / voting / feature`` take the parallel learners of
``parallel/`` over the process group of ``distributed.init`` (``auto``
picks by world size, reference :369-388).  Every rank holds the (N,)
scores and gradients of every row, so the boosting loop is the same on
every rank; under ``pre_partition`` the labels, weights and init scores
are gathered at construct and the padding rows are masked out of every
tree (reference :452-470, :850-853).

Each run keeps a ``TrainRecord`` (``telemetry/train_record.py``: phase
times, histogram passes and leaves per tree) and a flight recorder
(``telemetry/flight.py``) whose per-iteration best gain stays on the
device until the tape is read, as the reference's do.
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
from ..telemetry.flight import FlightRecorder
from ..telemetry.train_record import TrainRecord, set_last_train_record
from ..utils.log import log_info, log_warning
from ..utils.random import fold_in, host_key, host_rng
from ..utils.timer import FunctionTimer
from ..efb import make_bundle_decode
from ..ops.histogram import widen_bins
from .tree import (CAT_MASK, DEFAULT_LEFT_MASK, Tree, TreeBatch, predict_leaf,
                   predict_raw, predict_raw_early_stop)

__all__ = ["GBDT", "bagging_mask_np", "goss_sample_np", "feature_mask_np",
           "learner_config", "true_divide"]

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


def true_divide(x: torch.Tensor, w: float) -> torch.Tensor:
    """``x / f32(w)`` rounded as one division on every device.  PyTorch's
    CUDA ``tensor / python_scalar`` multiplies by the scalar's reciprocal
    (two roundings) and its CPU one divides; the reference's eager ``jnp``
    division divides.  A 0-dim divisor on ``x``'s own device takes the
    division kernel on both."""
    return x / torch.full((), w, dtype=torch.float32, device=x.device)


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


def goss_sample_np(cfg, grad: np.ndarray, hess: np.ndarray, iteration: int,
                   rows: Optional[np.ndarray] = None):
    """Host GOSS draw (goss.hpp:103-152): keep the top ``top_rate`` rows by
    |grad*hess|, Bernoulli-sample ``other_rate`` of the rest at b/(1-a) and
    amplify the survivors' gradients by (1-a)/b; sampling is skipped for the
    first 1/learning_rate iterations (goss.hpp:157).  Copy of the
    reference's ``goss_sample_np`` (lightgbm_tpu/models/gbdt.py:223-270),
    drawing from the same Philox stream (``host_rng``), so the standalone
    GOSS trainer and the multi-model batch thin the same rows.  ``rows``
    restricts the draw to those rows (a masked fold): thresholds and draws
    over the compacted subset, scattered back to full length.

    Returns ``(mask, mult)`` float32 (n,) arrays, 0/1 survivorship and the
    per-row gradient multiplier, or None when sampling is inactive this
    iteration (warm-up, or top_rate + other_rate >= 1)."""
    a, b = float(cfg.top_rate), float(cfg.other_rate)
    warmup = int(1.0 / max(float(cfg.learning_rate), 1e-12))
    if iteration < warmup or a + b >= 1.0:
        return None
    grad = np.asarray(grad)
    hess = np.asarray(hess)
    score = np.abs(grad * hess)
    if score.ndim == 2:  # multiclass: sum |g*h| over classes (goss.hpp:118)
        score = score.sum(axis=1)
    n = len(score)
    sub = score if rows is None else score[rows]
    nn = len(sub)
    k = max(1, int(nn * a))
    thr = np.partition(sub, nn - k)[nn - k]
    top = sub >= thr
    rng = host_rng(cfg.bagging_seed, iteration)
    rest_p = b / max(1.0 - a, 1e-12)
    keep_rest = (~top) & (rng.random(nn) < rest_p)
    amp = (1.0 - a) / max(b, 1e-12)
    sub_mask = (top | keep_rest).astype(np.float32)
    sub_mult = np.where(keep_rest, np.float32(amp),
                        np.float32(1.0)).astype(np.float32)
    if rows is None:
        return sub_mask, sub_mult
    mask = np.zeros(n, np.float32)
    mask[rows] = sub_mask
    mult = np.ones(n, np.float32)
    mult[rows] = sub_mult
    return mask, mult


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
    # uint16 codes are gathered through an int16 view (the same bits)
    src = bins.view(torch.int16) if bins.dtype == torch.uint16 else bins
    while bool(active.any()):
        nd = node.clamp(min=0)
        b = decode(widen_bins(src[rows, col_of[nd]].view(bins.dtype))
                   .to(torch.int32), sf[nd])
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
    round-trips); else ``cfg`` (uint16 bins and the parallel learners
    keep the static choice, as the reference's gate,
    models/gbdt.py:393-400)."""
    if (device.type == "cuda" and cfg.tpu_histogram_impl == "auto" and
            cfg.tree_learner in ("serial", "") and
            train_set.efb is None and max_bins <= 256 and
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
    # Trees whose stump iteration the lagged check pops one iteration
    # later (the reference's deferred path); DART and RF record each tree
    # at once and keep the stump iteration (reference models/gbdt.py:323,
    # models/boosting.py:68, :222), as do linear trees, leaf renewal and
    # coupled CEGB (``_undeferred``).
    _defer_trees = True

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
        self._linear = False
        self.X_raw_dev: Optional[torch.Tensor] = None
        self._row_valid: Optional[torch.Tensor] = None
        # loaded (train-set-less) models keep an inert record and a
        # disabled flight recorder; _init_train replaces both with the
        # run's (reference models/gbdt.py:339-345)
        self.train_record = TrainRecord(meta={"boosting": self.name})
        self.flight = FlightRecorder(capacity=1, enabled=False)
        if train_set is not None:
            self._init_train(train_set)

    # -- setup ---------------------------------------------------------------
    def _init_train(self, train_set: Dataset) -> None:
        cfg = self.config
        from ..utils.log import set_verbosity
        set_verbosity(int(cfg.verbosity))
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
        from .. import distributed as _dist
        if cfg.tree_learner == "auto":
            # world-size + modeled-bytes learner choice (reference
            # models/gbdt.py:369-388; PV-Tree, arXiv:1611.01276): voting
            # when its modeled cross-node histogram bytes per pass
            # undercut the reduce-scatter path's, data-parallel otherwise;
            # a world of one process is the serial learner.  Resolved in
            # place so every later gate sees the concrete learner.
            from ..parallel.voting_parallel import voting_favored
            _world = _dist.process_count()
            if _world <= 1:
                cfg.tree_learner = "serial"
            elif voting_favored(self.num_features, self.max_bins,
                                int(cfg.top_k), _world):
                cfg.tree_learner = "voting"
            else:
                cfg.tree_learner = "data"
            log_info(f"tree_learner=auto resolved to "
                     f"'{cfg.tree_learner}' (world={_world}, "
                     f"features={self.num_features}, "
                     f"top_k={int(cfg.top_k)})")
        # count-channel exactness per row shard (reference
        # models/gbdt.py:425-450): f32 counts to 2^24 rows, quantized
        # int32 channel sums to 2^31 / gq_max rows
        _shards = _dist.process_count() \
            if cfg.tree_learner in ("data", "voting") else 1
        if self.num_data > (1 << 24) * _shards and \
                not cfg.use_quantized_grad:
            log_warning(f"num_data={self.num_data} exceeds the f32 "
                        "histogram count channel's 2^24-rows-per-shard "
                        "exactness range; set use_quantized_grad=true for "
                        "exact int32 counts at this scale")
        if cfg.use_quantized_grad:
            from ..ops.quantize import quant_levels
            _gq = max(quant_levels(int(cfg.num_grad_quant_bins)))
            if self.num_data > (1 << 31) // _gq * _shards:
                log_warning(
                    f"num_data={self.num_data} exceeds the quantized "
                    f"histogram's int32 channel-sum exactness bound "
                    f"(2^31/{_gq} rows per shard at num_grad_quant_bins="
                    f"{cfg.num_grad_quant_bins}); lower num_grad_quant_bins "
                    "or shard rows across more devices")
        dist_rows = bool(getattr(train_set, "distributed_rows", False))
        if dist_rows and cfg.tree_learner not in ("data", "voting"):
            raise ValueError("pre_partition-ed training requires "
                             "tree_learner=data or voting")
        lcfg = learner_config(cfg, train_set, self.max_bins, self.device)
        options = dict(
            is_cat=is_cat, monotone=self._inner_monotone(),
            forced_splits=self._parse_forced_splits(),
            interaction_groups=self._parse_interaction_constraints(),
            feature_contri=self._inner_contri(),
            cegb_lazy=self._inner_cegb_lazy())
        if cfg.tree_learner in ("data", "voting", "feature"):
            from ..parallel import create_parallel_learner
            self.learner = create_parallel_learner(
                lcfg, self.num_features, self.max_bins, num_bins, has_nan,
                self.device, efb=train_set.efb, num_data=self.num_data,
                block=train_set._dist_pad_to if dist_rows else None,
                **options)
        else:
            self.learner = SerialTreeLearner(
                lcfg, self.num_features, self.max_bins, num_bins, has_nan,
                self.device, efb=train_set.efb, **options)
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
        # the device (reference learner/serial.py:911-920); a parallel
        # learner keeps only its rank's block of rows or features there
        if hasattr(self.learner, "local_bins"):
            self.X_T = self.learner.local_bins(train_set, self.device)
        else:
            self.X_T = (train_set.device_bins_packed4(self.device)
                        if self.learner.pack4
                        else train_set.device_bins(self.device))
        # pre_partition's padding rows never enter a tree (reference
        # models/gbdt.py:452-470, :850-853)
        self._row_valid = (torch.as_tensor(_dist.allgather_host(
            train_set._dist_valid_local), device=self.device)
            if dist_rows else None)
        self._is_cat_np = is_cat
        # linear leaves fit on the raw values of the used columns, kept on
        # the device (reference models/gbdt.py:503-523)
        self._linear = bool(cfg.linear_tree)
        if self._linear and self.name != "gbdt":
            log_warning(f"linear_tree is not supported with "
                        f"boosting={self.name}; training plain trees")
            self._linear = False
        self.X_raw_dev = None
        if self._linear:
            self._defer_trees = False
            # a pre_partition shard's raw rows are gathered: every rank
            # fits the leaves' linear models on all rows
            raw = (_dist.allgather_host(train_set.raw_used) if dist_rows
                   else train_set.raw_used)
            self.X_raw_dev = torch.as_tensor(raw, device=self.device)

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
        self._last_sample_mask = self._bag_mask

        self.train_metrics = []
        if cfg.is_provide_training_metric:
            self.train_metrics = create_metrics(cfg)
            for m in self.train_metrics:
                m.init(md, self.num_data)

        # telemetry (reference models/gbdt.py:560-580): one TrainRecord per
        # run, published as the process's freshest for /metrics, and the
        # flight recorder's per-iteration ring.  Both only observe.
        self.train_record = TrainRecord(meta={
            "boosting": self.name,
            "objective": str(cfg.objective),
            "tree_learner": str(cfg.tree_learner) or "serial",
            "num_leaves": int(cfg.num_leaves),
            "num_data": int(self.num_data),
            "num_features": int(self.num_features),
        }, device=self.device)
        set_last_train_record(self.train_record)
        self.flight = FlightRecorder(
            capacity=int(cfg.flight_events),
            enabled=bool(cfg.flight_recorder),
            meta={"boosting": self.name, "objective": str(cfg.objective),
                  "num_data": int(self.num_data)},
            device=self.device)

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
        if self._row_valid is not None and valid_set is not self.train_set:
            # pre_partition evaluates valid metrics per process with no
            # cross-process reduction (reference models/gbdt.py:715-731):
            # every rank must hold the SAME validation data, or
            # metric-driven decisions (early stopping) would diverge and
            # desync the collectives.  Checked by label checksum.
            from .. import distributed as _dist
            lab = valid_set.metadata.label
            sig = np.asarray([0.0 if lab is None else float(lab.sum()),
                              0.0 if lab is None else float(len(lab))],
                             np.float64)
            sigs = _dist.allgather_host(sig).reshape(-1, 2)
            if not np.allclose(sigs, sigs[0]):
                raise ValueError(
                    "under pre_partition every process must pass the SAME "
                    "validation data (metrics are evaluated per process); "
                    "got differing label checksums across ranks")
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
            torch.as_tensor(score0, device=self.device), bins,
            lambda: torch.as_tensor(valid_set.raw_used, device=self.device)))
        self.valid_metrics.append(metrics)

    def _score_models(self, score: torch.Tensor, bins: torch.Tensor,
                      raw) -> torch.Tensor:
        """``score`` plus every recorded tree's output on the binned
        row-major ``bins``, tree by tree in f32 (class c's trees at i * K +
        c); a linear tree reads the rows' raw used columns, ``raw()``."""
        from ..learner.linear import linear_score_delta
        k = self.num_tree_per_iteration
        for t, tree in enumerate(self.models):
            if tree.is_linear:
                delta = linear_score_delta(
                    raw(), self._leaf_index_walk(bins, tree),
                    *self._linear_device_arrays(tree))
            else:
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
        self._rebuild_scores()

    # -- checkpoint/resume (resilience/checkpoint.py rides these;
    #    reference models/gbdt.py:1641-1706) ---------------------------------
    def capture_checkpoint_arrays(self) -> dict:
        """The mutable boosting state beyond the model text, copied to the
        host with its exact bits: the f32 train and valid scores
        (rebuilding them from trees re-rounds in another order and can
        move the last ulp, forking the rest of the run), the coupled CEGB
        used-feature set and the lagged stump-stop bookkeeping.  Every
        other draw is a function of (seed, iteration): bagging redraws
        its block's mask each iteration, GOSS counts its warm-up from
        ``iter_``, and the tree keys fold the tree index."""
        prev = self._prev_iter_leaves
        return {
            "score": self.score.cpu().numpy(),
            "valid_names": [name for name, _ in self.valid_sets],
            "valid_scores": [s.cpu().numpy() for s in self.valid_scores],
            "cegb_used": (None if self._cegb_coupled is None
                          else self._cegb_used.copy()),
            "prev_iter_leaves": (None if prev is None
                                 else [int(x) for x in prev]),
        }

    def restore_boosting_state(self, model_text: str, iteration: int,
                               score: np.ndarray,
                               valid_scores: List[np.ndarray],
                               cegb_used: Optional[np.ndarray] = None,
                               prev_iter_leaves: Optional[List[int]] = None
                               ) -> None:
        """Continue boosting from a checkpoint: the trees reload from model
        text (%.17g round-trips every double) and re-key onto this
        dataset's binning (``_align_loaded_tree``); the scores restore
        from their saved f32 bits, not from a walk over the trees."""
        if self.name in ("dart", "rf"):
            raise ValueError(
                f"checkpoint/resume is not supported for boosting="
                f"{self.name}: its per-tree weight/averaging caches "
                f"(DART drop weights, RF running tree sums) are not part "
                f"of the model text")
        from .model_text import string_to_model
        loaded = string_to_model(model_text, self.config)
        k = self.num_tree_per_iteration
        ok = getattr(loaded, "num_tree_per_iteration", 1)
        if ok != k:
            raise ValueError(f"checkpoint model has {ok} trees/iteration, "
                             f"this training configuration needs {k}")
        self.models = [self._align_loaded_tree(t) for t in loaded.models]
        self.iter_ = int(iteration)
        # tree 0 already carries any boost-from-average bias
        self._pending_bias[:] = 0.0
        score = np.asarray(score, np.float32)
        want = self._score_shape(self.num_data)
        if score.shape != want:
            raise ValueError(f"checkpoint score shape {score.shape} does "
                             f"not match this dataset ({want})")
        self.score = torch.as_tensor(score, device=self.device)
        if len(valid_scores) != len(self.valid_scores):
            raise ValueError(
                f"checkpoint carries {len(valid_scores)} validation score "
                f"sets, this run registered {len(self.valid_scores)} "
                f"valid sets")
        self.valid_scores = [
            torch.as_tensor(np.asarray(vs, np.float32), device=self.device)
            for vs in valid_scores]
        if cegb_used is not None and self._cegb_coupled is not None:
            self._cegb_used[:] = np.asarray(cegb_used, bool)
        self._prev_iter_leaves = (None if prev_iter_leaves is None else
                                  [int(x) for x in prev_iter_leaves])

    # -- sampling (bagging / GOSS hooks) -------------------------------------
    def _prepare_iter_sampling(self, grad: torch.Tensor, hess: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
        """Per-iteration row sampling: (grad, hess, mask).  Plain GBDT
        bags (gbdt.cpp:228, resampled every bagging_freq iterations);
        GOSS overrides (reference models/gbdt.py:777-792)."""
        cfg = self.config
        label = (self.train_set.metadata.label
                 if cfg.objective == "binary" else None)
        bag = bagging_mask_np(cfg, self.num_data, self.iter_, label=label)
        if bag is not None:
            self._bag_mask = torch.as_tensor(bag, device=self.device)
        return grad, hess, self._bag_mask

    def _coerce_gradients(self, a) -> torch.Tensor:
        """Explicit (custom objective) gradients as f32 on the device:
        (N,), or for K classes (N, K), (K, N) or the flat CLASS-MAJOR
        layout of length N * K (the reference's ``_coerce``,
        models/gbdt.py:812-830; c_api.cpp UpdateOneIterCustom)."""
        k = self.num_tree_per_iteration
        n = self.num_data
        a = np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a,
                       np.float32)
        if k == 1:
            a = a.reshape((n,))
        elif a.ndim == 2:
            if a.shape == (k, n) and a.shape != (n, k):
                a = a.T
            elif a.shape != (n, k):
                raise ValueError(
                    f"custom objective gradients have shape {a.shape}; "
                    f"expected ({n}, {k}) or flat class-major length "
                    f"{n * k}")
        else:
            a = a.reshape((k, n)).T
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    # -- one boosting iteration (gbdt.cpp:369 TrainOneIter) ------------------
    def train_one_iter(self, grad=None, hess=None) -> bool:
        """One boosting iteration; ``grad`` / ``hess`` are a custom
        objective's gradients (boosting.h:85), else the objective's."""
        cfg = self.config
        k = self.num_tree_per_iteration
        rec = self.train_record
        with FunctionTimer("GBDT::train_one_iter"):
            if grad is None or hess is None:
                if self.objective is None:
                    raise ValueError("no objective: pass gradients "
                                     "explicitly (custom objective path, "
                                     "boosting.h:85)")
                with rec.phase("gradients"):
                    grad, hess = self.objective.get_gradients(self.score)
            else:
                grad = self._coerce_gradients(grad)
                hess = self._coerce_gradients(hess)
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
            grad, hess, mask = self._prepare_iter_sampling(grad, hess)
            if self._row_valid is not None:
                mask = mask * self._row_valid
            self._last_sample_mask = mask
            leaves = []
            fl_gain = None   # the flight event's best gain (last class)
            for cid in range(k):
                g = grad if k == 1 else grad[:, cid].contiguous()
                h = hess if k == 1 else hess[:, cid].contiguous()
                self._cur_gh = (g, h)
                extra = self._tree_keys(self.iter_ * k + cid)
                if self._cegb_coupled is not None:
                    extra["cegb_penalty"] = torch.as_tensor(
                        np.where(self._cegb_used, 0.0, self._cegb_coupled),
                        dtype=torch.float32, device=self.device)
                with rec.phase("grow"):
                    grown = self.learner.train(self.X_T, g, h, mask,
                                               feature_mask=fmask, **extra)
                self.last_hist_passes = grown.hist_passes
                self.last_host_syncs = grown.host_syncs
                rec.add_tree(self.iter_, cid, grown.hist_passes,
                             grown.num_leaves)
                if self.flight.enabled:
                    # a device scalar, read with the tape (one stacked
                    # copy), never here
                    fl_gain = torch.max(grown.split_gain)
                with rec.phase("record"):
                    tree = self._record_tree(grown, cid)
                if self._cegb_coupled is not None:
                    sf = tree.split_feature[:tree.num_leaves - 1]
                    self._cegb_used[sf[sf >= 0]] = True
                leaves.append(tree.num_leaves)
            self.iter_ += 1
            if self.flight.enabled:
                self.flight.note_iter(
                    self.iter_, hist_passes=self.last_hist_passes,
                    num_leaves=leaves[-1], best_gain=fl_gain)
            if self.iter_ % 16 == 1:
                # periodic watermark sample (an allocator counter read)
                rec.note_memory()
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
        reference's undeferred path runs DART, RF, linear trees, leaf
        renewal and coupled CEGB (models/gbdt.py:498, :511, :1013-1016)."""
        return (not self._defer_trees or self._renews or
                self._cegb_coupled is not None)

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
        rows = np.nonzero(self._last_sample_mask.cpu().numpy() > 0)[0]
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
        if self._linear:
            return self._record_tree_linear(grown, class_id)
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

    def _linear_device_arrays(self, tree: Tree):
        """A linear tree's per-leaf models padded into device tensors:
        (L, K) features, feature mask and coefficients, (L,) constants and
        plain leaf values (reference models/gbdt.py:1061-1076)."""
        L = tree.max_leaves
        feats = tree.leaf_features_inner
        K = max(1, max((len(f) for f in feats), default=1))
        lf = np.zeros((L, K), np.int64)
        fm = np.zeros((L, K), np.float32)
        co = np.zeros((L, K), np.float32)
        for i, (fs, cs) in enumerate(zip(feats, tree.leaf_coeff)):
            lf[i, :len(fs)] = fs
            fm[i, :len(fs)] = 1.0
            co[i, :len(cs)] = cs
        dev = self.device
        return (torch.as_tensor(lf, device=dev),
                torch.as_tensor(fm, device=dev),
                torch.as_tensor(co, device=dev),
                torch.as_tensor(np.asarray(tree.leaf_const, np.float32),
                                device=dev),
                torch.as_tensor(np.asarray(tree.leaf_value, np.float32),
                                device=dev))

    def _leaf_index_walk(self, bins: torch.Tensor, tree: Tree) -> torch.Tensor:
        """Each row's leaf in ``tree`` on a binned row-major matrix."""
        idx = torch.arange(tree.max_leaves, dtype=torch.float32,
                           device=self.device)
        return _walk_binned(bins, tree, idx, self.learner._efb).long()

    def _record_tree_linear(self, grown: GrownTree, class_id: int) -> Tree:
        """``_record_tree`` of a linear tree: fit each leaf's linear model
        on the raw branch features (learner/linear.py), then record
        (reference models/gbdt.py:1078-1137)."""
        from ..learner.linear import fit_linear_leaves, linear_score_delta
        shrinkage = self._current_shrinkage()
        g, h = self._cur_gh
        nl = max(int(grown.num_leaves), 1)
        tree = _grown_to_tree(grown, 1.0, self.train_set)
        feats_i, coefs, const = fit_linear_leaves(
            self.X_raw_dev, g, h, self._last_sample_mask, grown.row_leaf,
            tree.split_feature, tree.left_child, tree.right_child, nl,
            self._is_cat_np, float(self.config.linear_lambda),
            tree.leaf_value)
        real_map, _, _ = self.feature_mapping()
        tree.is_linear = True
        tree.leaf_const = np.asarray(const, np.float64)
        tree.leaf_coeff = coefs
        tree.leaf_features_inner = feats_i
        tree.leaf_features = [[int(real_map[f]) for f in fs]
                              for fs in feats_i]
        if shrinkage != 1.0:
            tree.shrink(shrinkage)
        # score updates with the shrunk values before the bias (the scores
        # already carry the boost-from-average bias)
        arrs = self._linear_device_arrays(tree)
        delta = linear_score_delta(self.X_raw_dev, grown.row_leaf, *arrs)
        k = self.num_tree_per_iteration
        if k == 1:
            self.score = self.score + delta
        else:
            self.score[:, class_id] += delta
        for vi, (_, vset) in enumerate(self.valid_sets):
            vleaf = self._leaf_index_walk(vset._device_cache["bins_rm"],
                                          tree)
            vraw = vset._device_cache.get("raw")
            if vraw is None:
                vraw = torch.as_tensor(vset.raw_used, device=self.device)
                vset._device_cache["raw"] = vraw
            vdelta = linear_score_delta(vraw, vleaf, *arrs)
            if k == 1:
                self.valid_scores[vi] = self.valid_scores[vi] + vdelta
            else:
                self.valid_scores[vi][:, class_id] += vdelta
        bias = self._pending_bias[class_id] if self.iter_ == 0 else 0.0
        if abs(bias) > EPSILON:
            tree.add_bias(bias)
        self.models.append(tree)
        return tree

    # -- model surgery (reference models/gbdt.py:1534-1770) -------------------
    def rollback_one_iter(self) -> None:
        """Drop the last iteration's trees and rebuild the scores
        (reference gbdt.cpp:454 RollbackOneIter)."""
        if self.iter_ <= 0:
            return
        for _ in range(self.num_tree_per_iteration):
            if self.models:
                self.models.pop()
        self.iter_ -= 1
        self._rebuild_scores()

    def merge_from(self, other: "GBDT") -> None:
        """Append another booster's trees to this model (reference
        models/gbdt.py:1499, LightGBM c_api.h:489 LGBM_BoosterMerge,
        GBDT::MergeFrom).  Thresholds re-bin against THIS dataset's
        mappers so the appended trees join the binned score walk."""
        k = self.num_tree_per_iteration
        ok = getattr(other, "num_tree_per_iteration", 1)
        if ok != k:
            raise ValueError(f"cannot merge: {ok} trees/iteration vs {k}")
        self.models = self.models + [self._align_loaded_tree(t)
                                     for t in other.models]
        self.iter_ = len(self.models) // max(k, 1)
        self._rebuild_scores()

    def shuffle_models(self, start_iter: int = 0,
                       end_iter: int = -1) -> None:
        """Shuffle the order of the iterations in [start_iter, end_iter)
        (reference models/gbdt.py:1514, c_api.h:497
        LGBM_BoosterShuffleModels), with the reference's draw: numpy's
        ``RandomState(seed + 1)``."""
        k = max(self.num_tree_per_iteration, 1)
        models = self.models
        n_iter = len(models) // k
        s = max(0, int(start_iter))
        e = n_iter if end_iter <= 0 else min(int(end_iter), n_iter)
        if e - s <= 1:
            return
        order = np.arange(n_iter)
        rng = np.random.RandomState(int(self.config.seed) + 1)
        mid = order[s:e].copy()
        rng.shuffle(mid)
        order[s:e] = mid
        self.models = [models[i * k + j] for i in order for j in range(k)]
        self._rebuild_scores()

    def _rebuild_scores(self) -> None:
        """The training scores from the init score and every recorded
        tree, walked on the binned rows tree by tree in f32 (reference
        models/gbdt.py:1720-1769); with no tree left, the pending
        boost-from-average bias comes back."""
        k = self.num_tree_per_iteration
        score0 = np.zeros(self._score_shape(self.num_data), np.float32)
        md = self.train_set.metadata
        if md.init_score is not None:
            score0 += md.init_score.reshape(score0.shape).astype(np.float32)
        elif not self.models and self.config.boost_from_average and \
                self.objective is not None:
            score0 += (np.float32(self._pending_bias[0]) if k == 1 else
                       self._pending_bias[None, :].astype(np.float32))
        self.score = self._score_models(
            torch.as_tensor(score0, device=self.device),
            torch.as_tensor(self.train_set.X_binned, device=self.device),
            self._raw_train)

    def _raw_train(self) -> torch.Tensor:
        """The training rows' raw used columns on the device (linear
        leaves predict from them)."""
        if self.X_raw_dev is None:
            if self.train_set.raw_used is None:
                raise ValueError(
                    "refit of a linear-tree model needs raw feature "
                    "values; construct the dataset with linear_tree=true")
            self.X_raw_dev = torch.as_tensor(self.train_set.raw_used,
                                             device=self.device)
        return self.X_raw_dev

    def reset_train_data(self, new_train: Dataset) -> None:
        """Swap the training dataset under the model (reference
        GBDT::ResetTrainingData, models/gbdt.py:1534-1559): the new rows
        take this model's bin mappers, the learner, objective and metrics
        rebuild, the trees re-key onto the new rows and the scores
        rebuild."""
        if not new_train.constructed and new_train.reference is None \
                and self.train_set is not None:
            new_train.reference = self.train_set
        models = self.models
        valid_state = (self.valid_sets, self.valid_scores,
                       self.valid_metrics)
        self._init_train(new_train)
        self.valid_sets, self.valid_scores, self.valid_metrics = valid_state
        if models:
            k = max(self.num_tree_per_iteration, 1)
            self.models = [self._align_loaded_tree(t) for t in models]
            self.iter_ = len(self.models) // k
            self._pending_bias[:] = 0.0
            self._rebuild_scores()

    def refit_trees(self, source: "GBDT", leaf_preds: np.ndarray) -> None:
        """Re-learn every tree's leaf values on this dataset with the
        structures fixed (reference gbdt.cpp:285 RefitTree,
        models/gbdt.py:1561-1638): scores restart from the init score,
        gradients are recomputed per iteration, and each leaf's value
        becomes decay * old + (1 - decay) * the closed-form output of its
        rows, scaled by the tree's shrinkage."""
        from ..ops.split import leaf_output
        from ..learner.linear import linear_score_delta
        if self.objective is None:
            raise ValueError("cannot refit without an objective")
        k = self.num_tree_per_iteration
        trees = [self._align_loaded_tree(t) for t in source.models]
        n = self.num_data
        if leaf_preds.shape != (n, len(trees)):
            raise ValueError(f"leaf_preds shape {leaf_preds.shape} != "
                             f"({n}, {len(trees)})")
        decay = float(self.config.refit_decay_rate)
        sp = self.learner.split_params
        md = self.train_set.metadata
        score = np.zeros(self._score_shape(n), np.float32)
        if md.init_score is not None:
            score = score + md.init_score.reshape(score.shape).astype(
                np.float32)
        for it in range(len(trees) // max(k, 1)):
            grad, hess = self.objective.get_gradients(
                torch.as_tensor(score, device=self.device))
            grad = grad.cpu().numpy()
            hess = hess.cpu().numpy()
            for cid in range(k):
                ti = it * k + cid
                tree = trees[ti]
                g = grad if k == 1 else grad[:, cid]
                h = hess if k == 1 else hess[:, cid]
                lp = leaf_preds[:, ti]
                nl = tree.num_leaves
                sum_g = np.bincount(lp, weights=g, minlength=nl)[:nl]
                sum_h = np.bincount(lp, weights=h, minlength=nl)[:nl] + \
                    EPSILON
                new_out = leaf_output(
                    torch.as_tensor(sum_g.astype(np.float32)),
                    torch.as_tensor(sum_h.astype(np.float32)),
                    sp).numpy().astype(np.float64)
                new_out *= tree.shrinkage
                old_vals = tree.leaf_value[:len(new_out)].copy()
                tree.leaf_value = decay * old_vals + (1.0 - decay) * new_out
                tree.leaf_count = np.bincount(
                    lp, minlength=nl)[:nl].astype(np.int64)
                if tree.is_linear:
                    # linear leaves keep their coefficients (the reference
                    # refits the leaf output only); the constant shifts by
                    # the output's change
                    shift = tree.leaf_value - old_vals
                    tree.leaf_const = tree.leaf_const[:len(shift)] + shift
                    delta = linear_score_delta(
                        self._raw_train(),
                        torch.as_tensor(lp, device=self.device),
                        *self._linear_device_arrays(tree)).cpu().numpy()
                else:
                    delta = tree.leaf_value[lp].astype(np.float32)
                if k == 1:
                    score += delta
                else:
                    score[:, cid] += delta
        self.models = trees
        self.iter_ = len(trees) // max(k, 1)
        self._pending_bias[:] = 0.0
        self.score = torch.as_tensor(score, device=self.device)

    # -- evaluation ------------------------------------------------------------
    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        if self.train_metrics:
            with self.train_record.phase("eval"):
                score = self.score.cpu().numpy()
                for m in self.train_metrics:
                    for name, val, hib in m.eval(score):
                        out.append(("training", name, val, hib))
        return out

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        out = []
        if not self.valid_sets:
            return out
        with self.train_record.phase("eval"):
            for vi, (vname, _) in enumerate(self.valid_sets):
                score = self.valid_scores[vi].cpu().numpy()
                for m in self.valid_metrics[vi]:
                    for name, val, hib in m.eval(score):
                        out.append((vname, name, val, hib))
        return out

    # -- prediction ------------------------------------------------------------
    def _dense_program(self, t0: int, t1: int, num_features: int):
        """The serving compiler's fused program for trees [t0, t1) on this
        booster's device, or None when the walk serves this call (mode,
        cost model or lowering budget; serve/compiler.py counts the
        reason).  Memoized per predict call, so row chunks lower once
        (reference models/gbdt.py:1184-1207)."""
        cache = self._predict_cache
        ck = ("dense", t0, t1)
        if cache is not None and ck in cache:
            return cache[ck]
        from ..serve.compiler import compile_ensemble
        cfg = self.config
        k = self.num_tree_per_iteration
        dense, _reason = compile_ensemble(
            self.models[t0:t1], k, num_features,
            class_ids=[t % k for t in range(t0, t1)],
            mode=cfg.tpu_predict_compiler,
            leaf_bits=int(cfg.tpu_predict_leaf_bits),
            shard=int(cfg.tpu_predict_shard), device=self.device)
        if cache is not None:
            cache[ck] = dense
        return dense

    def _explain_program(self, t0: int, t1: int, num_features: int):
        """The explain compiler's dense TreeSHAP program for trees
        [t0, t1), or None when the host walk serves (reason counted by
        explain/compiler.py); memoized per call (reference
        models/gbdt.py:1209-1230)."""
        cache = self._predict_cache
        ck = ("explain", t0, t1)
        if cache is not None and ck in cache:
            return cache[ck]
        from ..explain.compiler import compile_explain
        k = self.num_tree_per_iteration
        exe, _reason = compile_explain(
            self.models[t0:t1], k, num_features,
            class_ids=[t % k for t in range(t0, t1)],
            mode=self.config.tpu_explain_compiler,
            num_cols=self.num_features + 1, device=self.device)
        if cache is not None:
            cache[ck] = exe
        return exe

    def _predict_contrib(self, Xi: np.ndarray, start_iteration: int,
                         num_iteration: Optional[int]) -> np.ndarray:
        """SHAP contributions through ``tpu_explain_compiler``: the dense
        TreeSHAP program when it lowers, else the host walk; the dense
        result is additivity-checked, and a failed check falls back with
        a counted reason (reference models/gbdt.py:1232-1253)."""
        from .shap import predict_contrib, trees_window
        t0, t1 = trees_window(self, start_iteration, num_iteration)
        exe = self._explain_program(t0, t1, Xi.shape[1]) if t1 > t0 \
            else None
        if exe is not None:
            from ..explain.compiler import (ExplainAdditivityError,
                                            note_explain_fallback_batch)
            if any(t.is_linear for t in self.models[t0:t1]):
                log_warning("pred_contrib on linear trees attributes each "
                            "leaf's PLAIN output (per-leaf linear terms "
                            "are not decomposed)")
            try:
                return exe.explain(Xi)
            except ExplainAdditivityError:
                note_explain_fallback_batch("additivity", "")
        return predict_contrib(self, Xi, start_iteration, num_iteration)

    _predict_cache = None

    def predict(self, X: np.ndarray, raw_score: bool = False,
                start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                pred_leaf: bool = False, pred_contrib: bool = False,
                pred_early_stop: bool = False,
                pred_early_stop_freq: Optional[int] = None,
                pred_early_stop_margin: Optional[float] = None
                ) -> np.ndarray:
        """(N,) predictions, or (N, K) for a K-class model (class c's trees
        are at indices i * K + c), through the objective's output
        transform unless ``raw_score``; ``pred_leaf`` gives the (N, T)
        leaf indices, ``pred_contrib`` the (N, (F + 1) * K) SHAP values
        and ``pred_early_stop`` the margin-based early exit (reference
        models/gbdt.py:1255-1427).  Raw scores and leaves go through the
        serving compiler's dense program (``tpu_predict_compiler``) or
        the walk, SHAP values through ``tpu_explain_compiler``."""
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        # one lowering per call however the call chunks
        own_cache = self._predict_cache is None
        if own_cache:
            self._predict_cache = {}
        try:
            return self._predict_cached(
                X, raw_score, start_iteration, num_iteration, pred_leaf,
                pred_contrib, pred_early_stop, pred_early_stop_freq,
                pred_early_stop_margin)
        finally:
            if own_cache:
                self._predict_cache = None

    def _predict_cached(self, X, raw_score, start_iteration, num_iteration,
                        pred_leaf, pred_contrib, pred_early_stop,
                        pred_early_stop_freq, pred_early_stop_margin
                        ) -> np.ndarray:
        # very large batches predict in row chunks, smaller for wide
        # models (the reference's rule, models/gbdt.py:1290); the dense
        # program blocks its rows further by its byte budget
        chunk = min(1 << 20,
                    max(1 << 14, (1 << 28) //
                        max(int(self.config.num_leaves), 256)))
        if X.shape[0] > chunk:
            return np.concatenate([self._predict_cached(
                X[lo:lo + chunk], raw_score, start_iteration,
                num_iteration, pred_leaf, pred_contrib, pred_early_stop,
                pred_early_stop_freq, pred_early_stop_margin)
                for lo in range(0, X.shape[0], chunk)], axis=0)
        used = self.train_set.used_feature_map \
            if self.train_set is not None else np.arange(X.shape[1])
        Xi_np = np.ascontiguousarray(X[:, used])
        if pred_contrib:
            return self._predict_contrib(Xi_np, start_iteration,
                                         num_iteration)
        Xi = torch.as_tensor(Xi_np, device=self.device)
        k = self.num_tree_per_iteration
        t0 = start_iteration * k
        t1 = len(self.models) if num_iteration is None else min(
            len(self.models), (start_iteration + num_iteration) * k)
        if pred_leaf:
            if t1 <= t0:
                return np.zeros((X.shape[0], 0), np.int32)
            # pred-leaf rides the dense program too (the hit one-hot's
            # argmax is the leaf index)
            dense = self._dense_program(t0, t1, Xi.shape[1])
            if dense is not None:
                return dense.predict_leaf(Xi).cpu().numpy()
            return predict_leaf(TreeBatch(self.models[t0:t1], self.device),
                                Xi).cpu().numpy()
        raw = None
        if pred_early_stop or self.config.pred_early_stop:
            raw = self._predict_early_stop(
                Xi, t0, t1,
                pred_early_stop_freq or self.config.pred_early_stop_freq,
                pred_early_stop_margin if pred_early_stop_margin is not None
                else self.config.pred_early_stop_margin)
            if raw is not None and k == 1:
                raw = raw[:, 0]
        if raw is None:
            dense = self._dense_program(t0, t1, Xi.shape[1]) \
                if t1 > t0 else None
            if dense is not None:
                raw = dense.predict_raw(Xi)
                raw = raw[:, 0] if k == 1 else raw
            else:
                cols = []
                for c in range(k):
                    trees = [self.models[t] for t in range(t0, t1)
                             if t % k == c]
                    cols.append(predict_raw(TreeBatch(trees, self.device),
                                            Xi)
                                if trees else
                                torch.zeros((X.shape[0],),
                                            dtype=torch.float32,
                                            device=self.device))
                raw = cols[0] if k == 1 else torch.stack(cols, dim=1)
        if raw_score or self.objective is None:
            return raw.cpu().numpy()
        return self.objective.convert_output(raw).cpu().numpy()

    def _predict_early_stop(self, Xi: torch.Tensor, t0: int, t1: int,
                            freq: int, margin: float
                            ) -> Optional[torch.Tensor]:
        """Margin-based prediction early stop (prediction_early_stop.cpp),
        binary and multiclass only: (N, K) raw scores, or None where it
        does not apply (reference models/gbdt.py:1365-1402)."""
        k = self.num_tree_per_iteration
        if k > 1:
            mode = "multiclass"
        elif self.config.objective == "binary":
            mode = "binary"
        else:
            log_warning("pred_early_stop applies to binary/multiclass "
                        "objectives only; predicting normally")
            return None
        if t1 <= t0:
            return torch.zeros((Xi.shape[0], k), dtype=torch.float32,
                               device=self.device)
        if any(t.is_linear for t in self.models):
            log_warning("pred_early_stop is not supported with linear "
                        "trees; predicting normally")
            return None
        per_class = [TreeBatch(self.models[t0 + c:t1:k], self.device)
                     for c in range(k)]
        return predict_raw_early_stop(per_class, Xi, float(margin),
                                      max(1, int(freq)), mode)

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

