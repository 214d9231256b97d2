"""scikit-learn API wrappers: ``LGBMModel``, ``LGBMRegressor``,
``LGBMClassifier`` and ``LGBMRanker``.

Port of ``lightgbm_tpu/sklearn.py`` (LightGBM python-package sklearn.py):
estimator params map to Config names, fit / predict with eval sets,
custom objective and metric adapters, the same params and so the same
model text as ``train()``.  The estimators train through
:func:`lightgbm_tpu_torch.train` on the card unless constructed with
``device="cpu"`` (a constructor argument, so ``get_params`` / ``clone``
carry it; it never enters the model's params).

This module imports no sklearn: the estimators duck-type its protocol
(``get_params`` / ``set_params``, ``fit`` / ``predict``) and import it
only in :meth:`LGBMModel.__sklearn_tags__`, the one hook sklearn 1.6+
asks of an estimator it scores (``check_scoring``), so a machine
without sklearn trains them all the same.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster
from .callback import early_stopping as early_stopping_cb
from .dataset import Dataset
from .engine import train as engine_train

__all__ = ["LGBMModel", "LGBMClassifier", "LGBMRegressor", "LGBMRanker"]


class LGBMModel:
    """Base sklearn-style estimator (reference sklearn.py LGBMModel).
    ``device``: where :meth:`fit` trains (None: ``cuda``, as ``train``)."""

    _objective_default: Optional[str] = None
    _estimator_type: Optional[str] = None

    def __init__(self, boosting_type: str = "gbdt", num_leaves: int = 31,
                 max_depth: int = -1, learning_rate: float = 0.1,
                 n_estimators: int = 100, subsample_for_bin: int = 200000,
                 objective: Optional[Union[str, Callable]] = None,
                 class_weight: Optional[Union[Dict, str]] = None,
                 min_split_gain: float = 0.0, min_child_weight: float = 1e-3,
                 min_child_samples: int = 20, subsample: float = 1.0,
                 subsample_freq: int = 0, colsample_bytree: float = 1.0,
                 reg_alpha: float = 0.0, reg_lambda: float = 0.0,
                 random_state: Optional[int] = None, n_jobs: int = -1,
                 importance_type: str = "split", device: Any = None,
                 **kwargs: Any) -> None:
        self.boosting_type = boosting_type
        self.num_leaves = num_leaves
        self.max_depth = max_depth
        self.learning_rate = learning_rate
        self.n_estimators = n_estimators
        self.subsample_for_bin = subsample_for_bin
        self.objective = objective
        self.class_weight = class_weight
        self.min_split_gain = min_split_gain
        self.min_child_weight = min_child_weight
        self.min_child_samples = min_child_samples
        self.subsample = subsample
        self.subsample_freq = subsample_freq
        self.colsample_bytree = colsample_bytree
        self.reg_alpha = reg_alpha
        self.reg_lambda = reg_lambda
        self.random_state = random_state
        self.n_jobs = n_jobs
        self.importance_type = importance_type
        self.device = device
        self._other_params = dict(kwargs)
        self._Booster: Optional[Booster] = None
        self._evals_result: Dict = {}
        self._n_features = -1
        self._classes = None

    # sklearn plumbing ------------------------------------------------------
    def get_params(self, deep: bool = True) -> Dict[str, Any]:
        params = {k: getattr(self, k) for k in (
            "boosting_type", "num_leaves", "max_depth", "learning_rate",
            "n_estimators", "subsample_for_bin", "objective", "class_weight",
            "min_split_gain", "min_child_weight", "min_child_samples",
            "subsample", "subsample_freq", "colsample_bytree", "reg_alpha",
            "reg_lambda", "random_state", "n_jobs", "importance_type",
            "device")}
        params.update(self._other_params)
        return params

    def set_params(self, **params: Any) -> "LGBMModel":
        for key, value in params.items():
            if hasattr(self, key):
                setattr(self, key, value)
            else:
                self._other_params[key] = value
        return self

    def __sklearn_tags__(self):
        """What sklearn (1.6+) reads of an estimator it scores or clones:
        its kind, a required target and NaN-tolerant input."""
        from sklearn.utils import (ClassifierTags, InputTags, RegressorTags,
                                   Tags, TargetTags)
        kind = self._estimator_type
        return Tags(estimator_type=kind,
                    target_tags=TargetTags(required=True),
                    classifier_tags=(ClassifierTags()
                                     if kind == "classifier" else None),
                    regressor_tags=(RegressorTags()
                                    if kind == "regressor" else None),
                    input_tags=InputTags(allow_nan=True))

    def _make_params(self) -> Dict[str, Any]:
        p = {
            "boosting": self.boosting_type,
            "num_leaves": self.num_leaves,
            "max_depth": self.max_depth,
            "learning_rate": self.learning_rate,
            "bin_construct_sample_cnt": self.subsample_for_bin,
            "min_gain_to_split": self.min_split_gain,
            "min_sum_hessian_in_leaf": self.min_child_weight,
            "min_data_in_leaf": self.min_child_samples,
            "bagging_fraction": self.subsample,
            "bagging_freq": self.subsample_freq,
            "feature_fraction": self.colsample_bytree,
            "lambda_l1": self.reg_alpha,
            "lambda_l2": self.reg_lambda,
            "verbosity": -1,
        }
        if self.random_state is not None:
            p["seed"] = int(self.random_state)
        obj = self.objective or self._objective_default
        if obj is not None and not callable(obj):
            p["objective"] = obj
        p.update(self._other_params)
        return p

    # fitting ----------------------------------------------------------------
    def fit(self, X, y, sample_weight=None, init_score=None, group=None,
            eval_set=None, eval_names=None, eval_sample_weight=None,
            eval_init_score=None, eval_group=None, eval_metric=None,
            early_stopping_rounds=None, feature_name="auto",
            categorical_feature="auto", callbacks=None) -> "LGBMModel":
        params = self._make_params()
        if eval_metric is not None and not callable(eval_metric):
            params["metric"] = eval_metric

        fobj = None
        if callable(self.objective):
            fobj = _wrap_sklearn_objective(self.objective)
            params["objective"] = "none"

        y_arr = np.asarray(y).ravel()
        y_fit, extra = self._process_label(y_arr, params)
        params.update(extra)
        if self.class_weight is not None and "is_unbalance" not in params:
            if self.class_weight == "balanced":
                params["is_unbalance"] = True
            elif isinstance(self.class_weight, dict):
                cw = np.asarray([self.class_weight.get(int(c), 1.0)
                                 for c in y_fit.astype(int)])
                sample_weight = (cw if sample_weight is None
                                 else np.asarray(sample_weight) * cw)

        train_set = Dataset(X, label=y_fit, weight=sample_weight,
                            group=group, init_score=init_score,
                            feature_name=feature_name,
                            categorical_feature=categorical_feature,
                            params=params)
        valid_sets: List[Dataset] = []
        valid_names: List[str] = []
        if eval_set is not None:
            if isinstance(eval_set, tuple):
                eval_set = [eval_set]
            for i, (vx, vy) in enumerate(eval_set):
                vy_arr = self._transform_eval_label(np.asarray(vy).ravel())
                vw = eval_sample_weight[i] if eval_sample_weight else None
                vg = eval_group[i] if eval_group else None
                vi = eval_init_score[i] if eval_init_score else None
                valid_sets.append(train_set.create_valid(
                    vx, label=vy_arr, weight=vw, group=vg, init_score=vi))
                valid_names.append(eval_names[i] if eval_names else f"valid_{i}")

        callbacks = list(callbacks or [])
        if early_stopping_rounds is not None and early_stopping_rounds > 0:
            callbacks.append(early_stopping_cb(early_stopping_rounds))

        feval = _wrap_sklearn_metric(eval_metric) if callable(eval_metric) else None
        self._evals_result = {}
        from .callback import record_evaluation
        callbacks.append(record_evaluation(self._evals_result))

        self._Booster = engine_train(
            params, train_set, num_boost_round=self.n_estimators,
            valid_sets=valid_sets or None,
            valid_names=valid_names or None,
            fobj=fobj, feval=feval, callbacks=callbacks, device=self.device)
        self._n_features = self._Booster.num_feature()
        return self

    def _process_label(self, y, params):
        return y, {}

    def _transform_eval_label(self, y):
        return y

    # prediction -------------------------------------------------------------
    def predict(self, X, raw_score: bool = False, start_iteration: int = 0,
                num_iteration: Optional[int] = None, pred_leaf: bool = False,
                pred_contrib: bool = False, **kwargs) -> np.ndarray:
        self._check_fitted()
        return self._Booster.predict(X, raw_score=raw_score,
                                     start_iteration=start_iteration,
                                     num_iteration=num_iteration,
                                     pred_leaf=pred_leaf,
                                     pred_contrib=pred_contrib)

    def _check_fitted(self):
        if self._Booster is None:
            raise RuntimeError("Estimator not fitted, call fit first")

    # attributes -------------------------------------------------------------
    @property
    def booster_(self) -> Booster:
        self._check_fitted()
        return self._Booster

    @property
    def evals_result_(self) -> Dict:
        self._check_fitted()
        return self._evals_result

    @property
    def best_iteration_(self) -> int:
        self._check_fitted()
        return self._Booster.best_iteration

    @property
    def best_score_(self) -> Dict:
        self._check_fitted()
        return self._Booster.best_score

    @property
    def n_features_(self) -> int:
        self._check_fitted()
        return self._n_features

    @property
    def n_features_in_(self) -> int:
        return self.n_features_

    @property
    def feature_importances_(self) -> np.ndarray:
        self._check_fitted()
        return self._Booster.feature_importance(self.importance_type)

    @property
    def feature_name_(self) -> List[str]:
        self._check_fitted()
        return self._Booster.feature_name()


class LGBMRegressor(LGBMModel):
    _objective_default = "regression"
    _estimator_type = "regressor"

    def fit(self, X, y, **kwargs) -> "LGBMRegressor":
        super().fit(X, y, **kwargs)
        return self


class LGBMClassifier(LGBMModel):
    _objective_default = "binary"
    _estimator_type = "classifier"

    def _process_label(self, y, params):
        self._classes, y_enc = np.unique(y, return_inverse=True)
        n_classes = len(self._classes)
        extra = {}
        if n_classes > 2:
            obj = self.objective or "multiclass"
            if not callable(obj):
                extra["objective"] = obj if obj in ("multiclass", "multiclassova") \
                    else "multiclass"
            extra["num_class"] = n_classes
        return y_enc.astype(np.float64), extra

    def _transform_eval_label(self, y):
        if self._classes is not None:
            lookup = {c: i for i, c in enumerate(self._classes)}
            return np.asarray([lookup[v] for v in y], np.float64)
        return y

    @property
    def classes_(self):
        self._check_fitted()
        return self._classes

    @property
    def n_classes_(self) -> int:
        self._check_fitted()
        return len(self._classes)

    def predict(self, X, raw_score=False, start_iteration=0,
                num_iteration=None, pred_leaf=False, pred_contrib=False,
                **kwargs):
        result = self.predict_proba(X, raw_score=raw_score,
                                    start_iteration=start_iteration,
                                    num_iteration=num_iteration,
                                    pred_leaf=pred_leaf,
                                    pred_contrib=pred_contrib, **kwargs)
        if raw_score or pred_leaf or pred_contrib:
            return result
        if result.ndim == 1:
            idx = (result > 0.5).astype(int)
        else:
            idx = np.argmax(result, axis=1)
        return self._classes[idx]

    def predict_proba(self, X, raw_score=False, start_iteration=0,
                      num_iteration=None, pred_leaf=False, pred_contrib=False,
                      **kwargs):
        self._check_fitted()
        res = self._Booster.predict(X, raw_score=raw_score,
                                    start_iteration=start_iteration,
                                    num_iteration=num_iteration,
                                    pred_leaf=pred_leaf,
                                    pred_contrib=pred_contrib)
        if raw_score or pred_leaf or pred_contrib:
            return res
        if res.ndim == 1:
            return np.stack([1.0 - res, res], axis=1) if not raw_score else res
        return res


class LGBMRanker(LGBMModel):
    _objective_default = "lambdarank"

    def fit(self, X, y, group=None, **kwargs) -> "LGBMRanker":
        if group is None:
            raise ValueError("LGBMRanker.fit requires group")
        super().fit(X, y, group=group, **kwargs)
        return self


def _wrap_sklearn_objective(func):
    """sklearn custom objective (y_true, y_pred) -> engine fobj(preds, ds)."""
    def fobj(preds, dataset):
        label = dataset.get_label()
        out = func(label, preds)
        return out
    return fobj


def _wrap_sklearn_metric(func):
    def feval(preds, dataset):
        label = dataset.get_label()
        return func(label, preds)
    return feval
