"""Training and cross-validation entry points.

Port of ``lightgbm_tpu/engine.py``: ``train`` (reference engine.py:15),
continued training from ``init_model`` and custom objectives and metrics
(``fobj``, ``feval``) included, without checkpoint/resume, continuous
publishing or the flight recorder (later slices); and ``cv`` with ``CVBooster``, ``CVAggregator`` and
``_make_n_folds`` (reference engine.py:400-590), whose folds train as one
batch (multitrain/cv.py) when ``tpu_cv_many`` and the configuration
allow it.  Training runs on ``device`` (default ``cuda``); when no card
is usable and the CPU was not asked for, it raises.
"""

from __future__ import annotations

import collections
import copy
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from .basic import Booster, device_from
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       print_evaluation)
from .config import Config
from .dataset import Dataset
from .utils.log import log_info

__all__ = ["train", "cv", "CVBooster", "CVAggregator"]


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          init_model=None, callbacks: Optional[List[Callable]] = None,
          device=None, **kwargs) -> Booster:
    """Train a boosted model (reference engine.py:145-400).
    ``init_model`` (a Booster or a model file) continues training: its
    trees stay in the returned model, as the reference's ``init_model``
    keeps them.  ``fobj(preds, train_set) -> (grad, hess)`` replaces the
    objective (it gets the raw scores as host numpy); ``feval(preds,
    dataset) -> (name, value, higher_is_better)`` adds a metric on the
    training set and every valid set."""
    params = dict(params or {})
    params.update(kwargs)
    dev = device_from(params, device)
    cfg = Config(params)
    if any(k in params for k in ("num_iterations", "num_iteration",
                                 "n_iter", "num_boost_round", "num_round",
                                 "num_rounds", "num_trees", "num_tree",
                                 "n_estimators")):
        num_boost_round = cfg.num_iterations
    if fobj is not None:
        params["objective"] = "none"
    booster = Booster(params=params, train_set=train_set, device=dev)
    if init_model is not None:
        init_bst = init_model if isinstance(init_model, Booster) else \
            Booster(model_file=str(init_model), params=params, device=dev)
        booster._gbdt.init_from_model(init_bst._gbdt)
    if valid_sets is not None:
        if not isinstance(valid_sets, (list, tuple)):
            valid_sets = [valid_sets]
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                booster._gbdt.config = booster.config.update(
                    {"is_provide_training_metric": True})
                from .metric import create_metrics
                booster._gbdt.train_metrics = create_metrics(
                    booster._gbdt.config)
                for m in booster._gbdt.train_metrics:
                    m.init(train_set.metadata, train_set.num_data())
                continue
            name = (valid_names[i] if valid_names is not None and
                    i < len(valid_names) else f"valid_{i}")
            booster.add_valid(vs, name)

    callbacks = list(callbacks or [])
    cfg2 = booster.config
    if cfg2.verbosity >= 1 and cfg2.metric_freq > 0:
        callbacks.append(print_evaluation(cfg2.metric_freq))
    if cfg2.early_stopping_round and cfg2.early_stopping_round > 0:
        callbacks.append(early_stopping(cfg2.early_stopping_round,
                                        cfg2.first_metric_only,
                                        verbose=cfg2.verbosity >= 1))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))
    for it in range(num_boost_round):
        for cb in before:
            cb(CallbackEnv(booster, params, it, 0, num_boost_round, None))
        if booster.update(fobj=fobj):
            break
        results = []
        if booster._gbdt.train_metrics or booster._gbdt.valid_sets or \
                feval:
            results = booster.eval_train(feval) + booster.eval_valid(feval)
        try:
            for cb in after:
                cb(CallbackEnv(booster, params, it, 0, num_boost_round,
                               results))
        except EarlyStopException as e:
            booster.best_iteration = e.best_iteration + 1
            for ds_name, eval_name, score, _ in e.best_score:
                booster.best_score.setdefault(ds_name, {})[eval_name] = score
            break
    return booster


class CVBooster:
    """Container of per-fold boosters (reference engine.py:400)."""

    def __init__(self) -> None:
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


class CVAggregator:
    """Per-iteration fold-metric aggregation and aggregated early stopping,
    shared by ``cv``'s fold loop and the batched fast path
    (multitrain/cv.py) so the two cannot fork semantics (reference
    engine.py:417-475).  Early stopping tracks VALIDATION metrics only;
    ``first_metric_only`` restricts it to the first; it stops as soon as
    any tracked metric stalls ``early_stopping_round`` rounds."""

    def __init__(self, cfg: Config, num_boost_round: int) -> None:
        self._es_round = cfg.early_stopping_round
        self._first_only = bool(cfg.first_metric_only)
        self.results: Dict[str, List[float]] = collections.defaultdict(list)
        self.best_iter = num_boost_round
        self.stopped = False
        self._best_signed: Dict[str, float] = {}
        self._best_it: Dict[str, int] = {}

    def update(self, it: int, agg: Dict[str, List[float]],
               hib_map: Dict[str, bool]) -> bool:
        """Fold one iteration's per-fold metric lists in; True = stop."""
        es_keys = [k for k in agg if not k.startswith("train ")]
        if self._first_only and es_keys:
            es_keys = es_keys[:1]
        for key, vals in agg.items():
            self.results[f"{key}-mean"].append(float(np.mean(vals)))
            self.results[f"{key}-stdv"].append(float(np.std(vals)))
            if key not in es_keys:
                continue
            cur = float(np.mean(vals))
            signed = -cur if hib_map.get(key, False) else cur
            if key not in self._best_signed or signed < self._best_signed[key]:
                self._best_signed[key] = signed
                self._best_it[key] = it + 1
        if self._es_round and self._es_round > 0:
            for key in es_keys:
                if it + 1 - self._best_it.get(key, it + 1) >= self._es_round:
                    self.stopped = True
                    self.best_iter = self._best_it[key]
                    break
        return self.stopped

    def finalize(self, cvbooster: CVBooster) -> Dict[str, List[float]]:
        """Truncated results dict; stamps best_iteration when stopped."""
        out = dict(self.results)
        if self.stopped:
            for k in out:
                out[k] = out[k][:self.best_iter]
            cvbooster.best_iteration = self.best_iter
        return out


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict[str, Any],
                  seed: int, stratified: bool, shuffle: bool):
    """(train_idx, test_idx) of each fold (reference engine.py:478-520):
    query-aware for ranking, stratified by label, or shuffled."""
    full_data.construct(Config(params))
    num_data = full_data.num_data()
    rng = np.random.RandomState(seed)
    label = full_data.get_label()
    group = full_data.metadata.group
    if group is not None:
        qb = full_data.metadata.query_boundaries
        nq = len(group)
        q_order = rng.permutation(nq) if shuffle else np.arange(nq)
        q_fold = np.empty(nq, np.int32)
        q_fold[q_order] = np.arange(nq) % nfold
        for k in range(nfold):
            test_idx = np.concatenate([np.arange(qb[q], qb[q + 1])
                                       for q in range(nq) if q_fold[q] == k])
            train_idx = np.concatenate([np.arange(qb[q], qb[q + 1])
                                        for q in range(nq) if q_fold[q] != k])
            yield np.sort(train_idx), np.sort(test_idx)
        return
    if stratified and label is not None:
        order = np.argsort(label, kind="stable")
        folds_assign = np.empty(num_data, np.int32)
        folds_assign[order] = np.arange(num_data) % nfold
        if shuffle:
            perm = rng.permutation(nfold)
            folds_assign = perm[folds_assign]
    else:
        idx = rng.permutation(num_data) if shuffle else np.arange(num_data)
        folds_assign = np.empty(num_data, np.int32)
        folds_assign[idx] = np.arange(num_data) % nfold
    for k in range(nfold):
        yield (np.nonzero(folds_assign != k)[0],
               np.nonzero(folds_assign == k)[0])


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, fpreproc=None, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False, return_cvbooster: bool = False,
       device=None, **kwargs) -> Dict[str, List[float]]:
    """Cross-validation (reference engine.py:523).  With ``tpu_cv_many``
    (default true) the folds train as one batch over the parent
    dataset's bins (multitrain/cv.py); configurations the batch cannot
    take run the per-fold loop, which, as the reference's, calls no
    ``callbacks`` and starts from no ``init_model``; a custom objective
    or metric (``fobj``, ``feval``) takes that loop."""
    params = dict(params or {})
    params.update(kwargs)
    if metrics is not None:
        params["metric"] = metrics
    dev = device_from(params, device)
    cfg = Config(params)
    if cfg.objective in ("lambdarank", "rank_xendcg"):
        stratified = False
    train_set.construct(cfg)
    if folds is None:
        folds = list(_make_n_folds(
            train_set, nfold, params, seed,
            stratified and cfg.objective in ("binary", "multiclass",
                                             "multiclassova"), shuffle))
    else:
        folds = list(folds)

    if cfg.tpu_cv_many:
        from .multitrain.batched import MultiTrainError
        from .multitrain.cv import cv_many, cv_reject_reason
        reason = cv_reject_reason(fobj, feval, fpreproc, init_model,
                                  callbacks)
        if reason is None:
            try:
                return cv_many(params, train_set, num_boost_round, folds,
                               cfg, eval_train_metric=eval_train_metric,
                               return_cvbooster=return_cvbooster,
                               device=dev)
            except MultiTrainError as e:
                reason = str(e)
        log_info(f"cv: per-fold loop (batched fold driver unavailable: "
                 f"{reason})")

    cvbooster = CVBooster()
    for train_idx, test_idx in folds:
        tr = train_set.subset(train_idx)
        te = train_set.subset(test_idx)
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, copy.deepcopy(params))
        else:
            fold_params = params
        if eval_train_metric:
            fold_params = {**params, "is_provide_training_metric": True}
        bst = Booster(params=fold_params, train_set=tr, device=dev)
        bst.add_valid(te, "valid")
        cvbooster.append(bst)

    aggr = CVAggregator(cfg, num_boost_round)
    for it in range(num_boost_round):
        agg = collections.defaultdict(list)
        hib_map: Dict[str, bool] = {}
        for bst in cvbooster.boosters:
            bst.update(fobj=fobj)
            for ds, name, val, hib in bst.eval_valid(feval):
                agg[f"{ds} {name}"].append(val)
                hib_map[f"{ds} {name}"] = hib
            if eval_train_metric:
                for ds, name, val, hib in bst.eval_train(feval):
                    agg[f"train {name}"].append(val)
        if aggr.update(it, agg, hib_map):
            break
    out = aggr.finalize(cvbooster)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
