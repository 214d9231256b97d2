"""Training entry point.

Port of ``lightgbm_tpu/engine.py`` ``train`` (reference engine.py:15)
without checkpoint/resume, continuous publishing or the flight recorder
(later slices).  Training runs on ``device`` (default ``cuda``); when no
card is usable and the CPU was not asked for, it raises.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from .basic import Booster, device_from
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       print_evaluation)
from .config import Config
from .dataset import Dataset

__all__ = ["train"]


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          callbacks: Optional[List[Callable]] = None,
          device=None, **kwargs) -> Booster:
    """Train a boosted model."""
    params = dict(params or {})
    params.update(kwargs)
    dev = device_from(params, device)
    cfg = Config(params)
    if any(k in params for k in ("num_iterations", "num_iteration",
                                 "n_iter", "num_boost_round", "num_round",
                                 "num_rounds", "num_trees", "num_tree",
                                 "n_estimators")):
        num_boost_round = cfg.num_iterations
    booster = Booster(params=params, train_set=train_set, device=dev)
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
        if booster.update():
            break
        results = []
        if booster._gbdt.train_metrics or booster._gbdt.valid_sets:
            results = booster.eval_train() + booster.eval_valid()
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
