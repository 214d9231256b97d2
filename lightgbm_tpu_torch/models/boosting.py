"""Boosting variants (GOSS, DART, RF) and the factory.

Port of ``lightgbm_tpu/models/boosting.py`` (reference:
src/boosting/boosting.cpp:35 ``Boosting::CreateBoosting``, goss.hpp:25
``GOSS``, dart.hpp ``DART``, rf.hpp:25 ``RF``).  Each variant changes only
what the boosting driver feeds the ported growers: GOSS thins and
amplifies the gradients, DART drops trees from the scores and rescales
them, RF averages trees grown on bagged rows with no shrinkage.

Rounding follows the reference's eager ``jnp`` ops: every multiply and
add is its own f32 op, and the divisions by a weight or a tree count
divide (``gbdt.true_divide``), where PyTorch's CUDA ``tensor / scalar``
would multiply by the reciprocal.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..utils.log import log_warning
from ..utils.random import host_rng
from .gbdt import GBDT, _grown_to_tree, _walk_binned, goss_sample_np, \
    true_divide

__all__ = ["GOSS", "DART", "RF", "create_boosting", "dart_drops",
           "dart_shrinkage", "dart_factor"]


class GOSS(GBDT):
    """Gradient-based One-Side Sampling (reference goss.hpp: keep the top
    ``top_rate`` rows by |g*h|, Bernoulli-sample ``other_rate`` of the
    rest and amplify their gradients by (1-a)/b, :103-152; no sampling in
    the first 1/learning_rate iterations, :157).  The draw is the host's
    (``gbdt.goss_sample_np``), one Philox stream per (bagging_seed,
    iteration), shared with the multi-model batch."""

    name = "goss"

    def __init__(self, config: Config, train_set: Optional[Dataset],
                 objective=None, device=None) -> None:
        super().__init__(config, train_set, objective, device=device)
        if config.bagging_freq > 0 and config.bagging_fraction < 1.0:
            log_warning("cannot use bagging in GOSS (ignored)")

    def _prepare_iter_sampling(self, grad, hess):
        gm = goss_sample_np(self.config, grad.cpu().numpy(),
                            hess.cpu().numpy(), self.iter_)
        if gm is None:
            return grad, hess, torch.ones(self.num_data, dtype=torch.float32,
                                          device=self.device)
        mask, mult = gm
        scale = torch.as_tensor(mult, device=self.device)
        if grad.dim() == 2:
            scale = scale[:, None]
        return grad * scale, hess * scale, torch.as_tensor(
            mask, device=self.device)


def dart_drops(cfg: Config, t: int, weights: List[float],
               sum_weight: float) -> List[int]:
    """The iterations DART drops at iteration ``t`` (reference dart.hpp:97
    DroppingTrees; models/boosting.py:86-110): skipped with probability
    ``skip_drop``, else each earlier tree uniformly at ``drop_rate`` or,
    weighted, in proportion to its weight, at most ``max_drop``."""
    rng = host_rng(cfg.drop_seed, t)
    drop: List[int] = []
    if t > 0 and not (rng.random() < cfg.skip_drop):
        if cfg.uniform_drop:
            p = cfg.drop_rate
            if cfg.max_drop > 0:
                p = min(p, cfg.max_drop / float(t))
            for i in range(t):
                if rng.random() < p:
                    drop.append(i)
                    if cfg.max_drop > 0 and len(drop) >= cfg.max_drop:
                        break
        else:
            inv_avg = t / max(sum_weight, 1e-12)
            p = cfg.drop_rate
            if cfg.max_drop > 0:
                p = min(p, cfg.max_drop * inv_avg / max(sum_weight, 1e-12))
            for i in range(t):
                if rng.random() < p * weights[i] * inv_avg:
                    drop.append(i)
                    if cfg.max_drop > 0 and len(drop) >= cfg.max_drop:
                        break
    return drop


def dart_shrinkage(cfg: Config, kd: int) -> float:
    """The new tree's shrinkage with ``kd`` trees dropped: lr/(1+k), or
    under ``xgboost_dart_mode`` lr/(lr+k)."""
    lr = float(cfg.learning_rate)
    if cfg.xgboost_dart_mode:
        return lr if not kd else lr / (lr + kd)
    return lr / (1.0 + kd)


def dart_factor(cfg: Config, kd: int) -> float:
    """The rescale of each dropped tree (dart.hpp:158 Normalize):
    k/(k+1), or k/(k+lr) under ``xgboost_dart_mode``."""
    kd = float(kd)
    return kd / (kd + float(cfg.learning_rate)) if cfg.xgboost_dart_mode \
        else kd / (kd + 1.0)


class DART(GBDT):
    """Dropouts meet MART (reference dart.hpp: ``DroppingTrees`` at :97,
    weighted drop selection, train-score subtraction and per-iteration
    shrinkage lr/(1+k); ``Normalize`` at :158, dropped trees rescaled to
    weight*k/(k+1)).  Each iteration's raw train prediction and each valid
    set's are kept on the device, so a drop or rescale is an axpy on the
    scores, not a tree walk: one (N,) f32 tensor per iteration (times K
    classes) for the training rows."""

    name = "dart"
    _defer_trees = False

    def __init__(self, config: Config, train_set: Optional[Dataset],
                 objective=None, device=None) -> None:
        super().__init__(config, train_set, objective, device=device)
        self._base_pred: list = []        # per iteration: raw train pred
        self._valid_base_pred: list = []  # per iteration: per valid set
        self._weights: List[float] = []   # current weight (with shrinkage)
        self._sum_weight = 0.0
        self._cur_shrinkage = float(config.learning_rate)
        self._drop_idx: List[int] = []

    def _current_shrinkage(self) -> float:
        return self._cur_shrinkage

    def train_one_iter(self, grad=None, hess=None) -> bool:
        drop = dart_drops(self.config, self.iter_, self._weights,
                          self._sum_weight)
        self._drop_idx = drop
        # the dropped trees leave the TRAIN score (the valid scores move
        # in _normalize, as the reference's)
        for d in drop:
            self.score = self.score - self._base_pred[d] * self._weights[d]
        self._cur_shrinkage = dart_shrinkage(self.config, len(drop))
        res = super().train_one_iter(grad, hess)
        self._normalize(drop)
        return res

    def _record_tree(self, grown, class_id: int = 0):
        before = [v.clone() for v in self.valid_scores]
        tree = super()._record_tree(grown, class_id)
        w = self._cur_shrinkage
        base = grown.leaf_value[grown.row_leaf.long()]   # raw, unshrunk
        if self.num_tree_per_iteration == 1:
            pred = base
        else:
            pred = torch.zeros(self.score.shape, dtype=torch.float32,
                               device=self.device)
            pred[:, class_id] = base
        if class_id == 0:
            self._base_pred.append(pred)
            self._weights.append(w)
            self._sum_weight += w
            self._valid_base_pred.append(
                [true_divide(v - b, w)
                 for v, b in zip(self.valid_scores, before)])
        else:
            self._base_pred[-1] = self._base_pred[-1] + pred
            for vi, (v, b) in enumerate(zip(self.valid_scores, before)):
                self._valid_base_pred[-1][vi] = \
                    self._valid_base_pred[-1][vi] + true_divide(v - b, w)
        return tree

    def _normalize(self, drop_idx: List[int]) -> None:
        kd = len(drop_idx)
        if kd == 0:
            return
        factor = dart_factor(self.config, kd)
        kk = self.num_tree_per_iteration
        for d in drop_idx:
            old_w = self._weights[d]
            new_w = old_w * factor
            self._weights[d] = new_w
            self._sum_weight -= old_w - new_w
            for c in range(kk):
                self.models[d * kk + c].shrink(factor)
            # the train score re-adds the tree at its new weight (it was
            # removed in full); a valid score moves by the weight's change
            self.score = self.score + self._base_pred[d] * new_w
            for vi in range(len(self.valid_sets)):
                self.valid_scores[vi] = self.valid_scores[vi] + \
                    self._valid_base_pred[d][vi] * (new_w - old_w)


class RF(GBDT):
    """Random forest (reference rf.hpp:25): bagging is mandatory, there
    is no shrinkage, the score is the average of the trees' outputs and
    the gradients are taken at that average.  The boost-from-average
    score is folded into EVERY tree, so the average keeps it and a loaded
    model predicts with a plain tree average."""

    name = "rf"
    _defer_trees = False

    def __init__(self, config: Config, train_set: Optional[Dataset],
                 objective=None, device=None) -> None:
        if train_set is not None and \
                not (config.bagging_freq > 0 and
                     config.bagging_fraction < 1.0) \
                and config.feature_fraction >= 1.0:
            raise ValueError("RF mode requires bagging "
                             "(bagging_freq > 0 and bagging_fraction < 1) "
                             "or feature_fraction < 1")
        super().__init__(config, train_set, objective, device=device)
        self._tree_sum: Optional[torch.Tensor] = None
        self._valid_tree_sum: list = []
        self._valid_base: list = []
        if train_set is not None:
            md = self.train_set.metadata
            if md.init_score is not None:
                self._rf_base = torch.as_tensor(
                    md.init_score.reshape(self.score.shape).astype(
                        np.float32), device=self.device)
            else:
                self._rf_base = torch.zeros(self.score.shape,
                                            dtype=torch.float32,
                                            device=self.device)

    def _current_shrinkage(self) -> float:
        return 1.0

    def add_valid(self, valid_set: Dataset, name: str) -> None:
        super().add_valid(valid_set, name)
        md = valid_set.metadata
        shape = self.valid_scores[-1].shape
        self._valid_base.append(
            torch.as_tensor(md.init_score.reshape(shape).astype(np.float32),
                            device=self.device)
            if md.init_score is not None else
            torch.zeros(shape, dtype=torch.float32, device=self.device))
        self._valid_tree_sum.append(None)

    def _record_tree(self, grown, class_id: int = 0):
        tree = _grown_to_tree(grown, 1.0, self.train_set)
        bias = float(self._pending_bias[class_id])
        if abs(bias) > 1e-12:
            tree.add_bias(bias)
        self.models.append(tree)
        k = self.num_tree_per_iteration
        lv = grown.leaf_value + bias
        pred = lv[grown.row_leaf.long()]
        t = self.iter_ + 1
        if self._tree_sum is None:
            self._tree_sum = torch.zeros(self.score.shape,
                                         dtype=torch.float32,
                                         device=self.device)
        if k == 1:
            self._tree_sum = self._tree_sum + pred
        else:
            self._tree_sum[:, class_id] += pred
        self.score = self._rf_base + true_divide(self._tree_sum, t)
        for vi, (_, vset) in enumerate(self.valid_sets):
            delta = _walk_binned(vset._device_cache["bins_rm"], tree, lv,
                                 self.learner._efb)
            if self._valid_tree_sum[vi] is None:
                self._valid_tree_sum[vi] = torch.zeros(
                    self.valid_scores[vi].shape, dtype=torch.float32,
                    device=self.device)
            if k == 1:
                self._valid_tree_sum[vi] = self._valid_tree_sum[vi] + delta
            else:
                self._valid_tree_sum[vi][:, class_id] += delta
            self.valid_scores[vi] = self._valid_base[vi] + \
                true_divide(self._valid_tree_sum[vi], t)
        return tree

    def predict(self, X, raw_score=False, start_iteration=0,
                num_iteration=None, pred_leaf=False, pred_contrib=False,
                **kwargs):
        out = super().predict(X, raw_score=True,
                              start_iteration=start_iteration,
                              num_iteration=num_iteration,
                              pred_leaf=pred_leaf, pred_contrib=pred_contrib)
        if pred_leaf or pred_contrib:
            return out
        k = self.num_tree_per_iteration
        t = max(1, len(self.models) // k)
        out = out / t    # numpy f32 division, as the reference's
        if raw_score or self.objective is None:
            return out
        return self.objective.convert_output(
            torch.as_tensor(out, device=self.device)).cpu().numpy()


def create_boosting(config: Config, train_set: Optional[Dataset],
                    device: torch.device, objective=None) -> GBDT:
    """Factory (reference src/boosting/boosting.cpp:35 CreateBoosting)."""
    kind = config.boosting
    cls = {"gbdt": GBDT, "goss": GOSS, "dart": DART, "rf": RF}.get(kind)
    if cls is None:
        raise ValueError(f"Unknown boosting type: {kind}")
    return cls(config, train_set, objective, device=device)
