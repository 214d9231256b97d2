"""``GridSearchCVMany``: an sklearn ``GridSearchCV``-compatible
hyperparameter sweep where every (combo, fold) model trains in one
``train_many`` batch.

Port of ``lightgbm_tpu/multitrain/sweep.py``.  sklearn's ``GridSearchCV``
refits the estimator from scratch for every parameter combination and
fold — ``n_combos * n_folds`` boosting loops, each re-binning the data.
Here the whole sweep is ONE ``train_many`` call: the dataset is binned
once, folds become per-model sample masks, sweepable parameters
(lambda_l1/l2, min_child_weight/samples, min_split_gain, learning_rate,
seeds) ride the model axis, and structurally differing combos
(num_leaves, max_depth, ...) group into one batch per structure.  The
batch trains on the wrapped estimator's ``device``.  sklearn is imported
when the sweep runs, never with the module.

    from lightgbm_tpu_torch.multitrain import GridSearchCVMany
    gs = GridSearchCVMany(LGBMRegressor(n_estimators=50),
                          {"reg_lambda": [0, 0.1, 1.0],
                           "min_child_samples": [10, 20]}, cv=5)
    gs.fit(X, y)
    gs.best_params_, gs.best_score_, gs.cv_results_["mean_test_score"]

GOSS, DART, multiclass and ranking estimators all ride the model axis;
only combos it cannot express (RF, CEGB, linear trees, custom
objectives, dataset-construction params, ...) fall back to sequential
per-fold fits of the wrapped estimator, with a logged warning.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..dataset import Dataset
from ..utils.log import log_info, log_warning
from .batched import MultiTrainError

__all__ = ["GridSearchCVMany"]

# params fixed at Dataset.construct time: the batched sweep shares ONE
# binned dataset, so combos differing here must refit sequentially
# (each sequential est.fit re-bins its own Dataset, like sklearn's
# GridSearchCV semantics)
_DATASET_PARAMS = ("max_bin", "bin_construct_sample_cnt",
                   "min_data_in_bin", "data_random_seed", "enable_bundle",
                   "feature_pre_filter", "zero_as_missing", "use_missing",
                   "categorical_feature", "linear_tree", "pre_partition")


class GridSearchCVMany:
    """Drop-in for ``sklearn.model_selection.GridSearchCV`` over the
    lightgbm_tpu_torch sklearn estimators, batching the whole sweep
    through :func:`~lightgbm_tpu_torch.multitrain.train_many`.

    Exposes the sklearn result surface: ``cv_results_`` (params,
    split scores, mean/std/rank), ``best_index_``, ``best_params_``,
    ``best_score_``, and — with ``refit=True`` — ``best_estimator_``
    fitted on the full data."""

    def __init__(self, estimator, param_grid, *, cv: int = 5,
                 scoring=None, refit: bool = True,
                 return_train_score: bool = False) -> None:
        self.estimator = estimator
        self.param_grid = param_grid
        self.cv = cv
        self.scoring = scoring
        self.refit = refit
        self.return_train_score = return_train_score

    # -- sklearn plumbing ----------------------------------------------------
    def _make_estimator(self, combo: Dict[str, Any]):
        base = self.estimator.get_params()
        base.update(combo)
        return type(self.estimator)(**base)

    def _scorer(self):
        from sklearn.metrics import check_scoring
        scoring = self.scoring
        if scoring is None:
            from ..sklearn import LGBMClassifier
            scoring = ("accuracy" if isinstance(self.estimator,
                                                LGBMClassifier) else "r2")
        return check_scoring(self.estimator, scoring=scoring)

    def fit(self, X, y, sample_weight=None) -> "GridSearchCVMany":
        from sklearn.model_selection import ParameterGrid, check_cv
        from ..sklearn import LGBMClassifier

        combos: List[Dict[str, Any]] = list(ParameterGrid(self.param_grid))
        if not combos:
            raise ValueError("empty param_grid")
        X = np.asarray(X)
        y_arr = np.asarray(y).ravel()
        is_clf = isinstance(self.estimator, LGBMClassifier)
        splitter = check_cv(self.cv, y_arr, classifier=is_clf)
        folds = list(splitter.split(X, y_arr))
        nfold = len(folds)
        scorer = self._scorer()

        # label encoding + base params from a template estimator (the
        # encoding is combo-independent)
        tmpl = self._make_estimator(combos[0])
        y_fit, extra = tmpl._process_label(y_arr, tmpl._make_params())
        classes = getattr(tmpl, "_classes", None)

        # one (combo, fold) model per lane; masks select the fold's rows
        n = len(y_fit)
        M = len(combos) * nfold
        variants: List[Dict[str, Any]] = []
        masks = np.zeros((M, n), np.float32)
        for ci, combo in enumerate(combos):
            est_c = self._make_estimator(combo)
            vp = est_c._make_params()
            vp.update(extra)
            for k, (train_idx, _) in enumerate(folds):
                variants.append(dict(vp))
                masks[ci * nfold + k, np.asarray(train_idx, np.int64)] = 1.0

        base_params = dict(tmpl._make_params())
        base_params.update(extra)
        n_estimators = int(self.estimator.n_estimators)
        ds = Dataset(X, label=y_fit, weight=sample_weight,
                     params=base_params)

        try:
            for vp in variants:
                drift = [k for k in _DATASET_PARAMS
                         if vp.get(k) != base_params.get(k)]
                if drift:
                    raise MultiTrainError(
                        f"grid sweeps dataset-construction params {drift}")
            from . import train_many
            mb = train_many({}, ds, num_boost_round=n_estimators,
                            variants=variants, sample_masks=masks,
                            allow_fallback=False,
                            device=getattr(self.estimator, "device", None))
            fitted = []
            for m, bst in enumerate(mb):
                est = self._make_estimator(combos[m // nfold])
                est._Booster = bst
                est._n_features = bst.num_feature()
                est._classes = classes
                fitted.append(est)
        except MultiTrainError as e:
            log_warning(f"GridSearchCVMany: sweep cannot batch ({e}); "
                        f"fitting {M} models sequentially")
            fitted = []
            for ci, combo in enumerate(combos):
                for train_idx, _ in folds:
                    est = self._make_estimator(combo)
                    sw = (None if sample_weight is None
                          else np.asarray(sample_weight)[train_idx])
                    est.fit(X[train_idx], y_arr[train_idx],
                            sample_weight=sw)
                    fitted.append(est)

        # sklearn-shaped cv_results_
        results: Dict[str, Any] = {"params": combos}
        for key in combos[0] if combos[0] else ():
            results[f"param_{key}"] = [c.get(key) for c in combos]
        test_scores = np.zeros((len(combos), nfold))
        train_scores = np.zeros((len(combos), nfold))
        for ci in range(len(combos)):
            for k, (train_idx, test_idx) in enumerate(folds):
                est = fitted[ci * nfold + k]
                test_scores[ci, k] = scorer(est, X[test_idx],
                                            y_arr[test_idx])
                if self.return_train_score:
                    train_scores[ci, k] = scorer(est, X[train_idx],
                                                 y_arr[train_idx])
        for k in range(nfold):
            results[f"split{k}_test_score"] = test_scores[:, k]
        results["mean_test_score"] = test_scores.mean(axis=1)
        results["std_test_score"] = test_scores.std(axis=1)
        order = np.argsort(-results["mean_test_score"], kind="stable")
        ranks = np.empty(len(combos), np.int32)
        ranks[order] = np.arange(1, len(combos) + 1)
        results["rank_test_score"] = ranks
        if self.return_train_score:
            for k in range(nfold):
                results[f"split{k}_train_score"] = train_scores[:, k]
            results["mean_train_score"] = train_scores.mean(axis=1)
            results["std_train_score"] = train_scores.std(axis=1)

        self.cv_results_ = results
        self.best_index_ = int(np.argmax(results["mean_test_score"]))
        self.best_params_ = combos[self.best_index_]
        self.best_score_ = float(
            results["mean_test_score"][self.best_index_])
        self.n_splits_ = nfold
        if self.refit:
            self.best_estimator_ = self._make_estimator(self.best_params_)
            self.best_estimator_.fit(X, y_arr, sample_weight=sample_weight)
        log_info(f"GridSearchCVMany: {len(combos)} combos x {nfold} folds "
                 f"= {M} models; best {self.best_params_} "
                 f"(score {self.best_score_:.6g})")
        return self

    # -- post-fit conveniences ----------------------------------------------
    def _check_fitted(self):
        if not hasattr(self, "best_index_"):
            raise RuntimeError("GridSearchCVMany not fitted, call fit first")

    def predict(self, X):
        self._check_fitted()
        if not self.refit:
            raise RuntimeError("predict requires refit=True")
        return self.best_estimator_.predict(X)

    def score(self, X, y):
        self._check_fitted()
        if not self.refit:
            raise RuntimeError("score requires refit=True")
        return float(self._scorer()(self.best_estimator_, np.asarray(X),
                                    np.asarray(y).ravel()))
