"""Booster: the trained-model handle.

Port of ``lightgbm_tpu/basic.py`` ``Booster`` (reference python-package
basic.py Booster): train from a Dataset, or load from a model file or
string; update with a custom objective, evaluate with a custom metric,
roll back, refit, reset the data or the parameters; predict (leaf
indices and the early exit too), ``model_to_string`` and ``save_model``.
The model runs on ``device`` (default ``cuda``; pass ``device="cpu"``
for the plain PyTorch path).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .config import Config
from .dataset import Dataset
from .models.boosting import create_boosting
from .utils.device import resolve_device

__all__ = ["Booster"]


def device_from(params: Optional[Dict[str, Any]], device=None):
    """The device a call runs on: the explicit ``device`` argument, else a
    ``device_type``/``device`` param naming cpu or cuda, else ``cuda``."""
    if device is None and params:
        for key in ("device_type", "device"):
            val = str(params.get(key, "")).lower()
            if val in ("cpu", "cuda", "gpu"):
                device = val
                break
    return resolve_device(device)


class Booster:
    """Trained-model handle."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None,
                 device=None) -> None:
        self.params = dict(params or {})
        self.device = device_from(self.params, device)
        self.best_iteration = -1
        self.best_score: Dict[str, Dict[str, float]] = {}
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("train_set must be a Dataset")
            self.config = Config(self.params)
            train_set.construct(self.config)
            self._gbdt = create_boosting(self.config, train_set, self.device)
        elif model_file is not None:
            with open(model_file, "rb") as fh:
                raw = fh.read()
            try:
                text = raw.decode("utf-8")
            except UnicodeDecodeError as exc:
                from .models.model_text import ModelCorruptError
                raise ModelCorruptError(str(model_file), exc.start,
                                        "not utf-8 text") from exc
            self._load_from_string(text, source=str(model_file))
        elif model_str is not None:
            self._load_from_string(model_str)
        else:
            raise ValueError("Booster needs train_set, model_file or model_str")

    def _load_from_string(self, model_str: str,
                          source: str = "<model string>") -> None:
        from .models.model_text import string_to_model
        self.config = Config(self.params)
        self._gbdt = string_to_model(model_str, self.config, source=source,
                                     device=self.device)

    # -- training ------------------------------------------------------------
    def update(self, train_set: Optional[Dataset] = None,
               fobj=None) -> bool:
        """One boosting iteration; True when training should stop
        (reference basic.py Booster.update).  ``fobj(preds, train_set) ->
        (grad, hess)`` is a custom objective: it gets the raw training
        scores as host numpy, as the reference hands them."""
        if train_set is not None and train_set is not self._gbdt.train_set:
            self.reset_train_data(train_set)
        if fobj is not None:
            preds = self._gbdt.score.cpu().numpy()
            grad, hess = fobj(preds, self._gbdt.train_set)
            return self._gbdt.train_one_iter(np.asarray(grad),
                                             np.asarray(hess))
        return self._gbdt.train_one_iter()

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees (reference
        LGBM_BoosterRollbackOneIter)."""
        self._gbdt.rollback_one_iter()
        return self

    def reset_train_data(self, train_set: Dataset) -> "Booster":
        """Swap the training dataset under the model (reference
        Booster::ResetTrainingData): the trees stay, the scores rebuild on
        the new rows, and ``update()`` boosts on from there."""
        if not isinstance(train_set, Dataset):
            raise TypeError("train_set must be a Dataset")
        self._gbdt.reset_train_data(train_set)
        return self

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """Refit the tree structures on new data (reference basic.py
        Booster.refit -> GBDT::RefitTree): every tree keeps its splits,
        and a leaf's value becomes ``decay_rate * old + (1 - decay_rate) *
        new``, the new value the closed-form output of its rows in
        ``data``.  The new Booster runs on this one's device."""
        if self._gbdt.objective is None:
            raise ValueError("Cannot refit due to null objective function.")
        leaf_preds = self.predict(data, pred_leaf=True, **kwargs)
        new_params = dict(self.params)
        new_params["refit_decay_rate"] = decay_rate
        train_set = Dataset(data, label)
        new_booster = Booster(params=new_params, train_set=train_set,
                              device=self.device)
        new_booster._gbdt.refit_trees(self._gbdt, np.asarray(leaf_preds))
        return new_booster

    def reset_parameter(self, params: Dict[str, Any]) -> "Booster":
        """Change parameters between iterations (reference
        LGBM_BoosterResetParameter), for example a learning-rate
        schedule."""
        self.params.update(params)
        self.config = self.config.update(params)
        self._gbdt.config = self.config
        return self

    @property
    def train_record(self):
        """Telemetry record of this booster's training run
        (:class:`~lightgbm_tpu_torch.telemetry.TrainRecord`): per-tree
        histogram passes and leaves, per-phase wall time, the device
        memory watermark.  ``.snapshot()`` gives a JSON-ready dict; the
        serve ``/metrics`` endpoint exports the same record as the
        process's last training run."""
        return self._gbdt.train_record

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def num_model_per_iteration(self) -> int:
        return self._gbdt.num_tree_per_iteration

    def num_feature(self) -> int:
        return self._gbdt.feature_mapping()[1]

    def feature_name(self) -> List[str]:
        """The ORIGINAL columns' names, as many as ``num_feature()``."""
        return self._gbdt.feature_mapping()[2]

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self._gbdt.add_valid(data, name)
        return self

    # -- evaluation ----------------------------------------------------------
    def eval_train(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        out = self._gbdt.eval_train()
        if feval is not None:
            out = out + self._run_feval(feval, "training",
                                        self._gbdt.score.cpu().numpy(),
                                        self._gbdt.train_set)
        return out

    def eval_valid(self, feval=None) -> List[Tuple[str, str, float, bool]]:
        out = self._gbdt.eval_valid()
        if feval is not None:
            for vi, (vname, vset) in enumerate(self._gbdt.valid_sets):
                out = out + self._run_feval(
                    feval, vname, self._gbdt.valid_scores[vi].cpu().numpy(),
                    vset)
        return out

    @staticmethod
    def _run_feval(feval, name, score, dset):
        """``feval(score, dataset) -> (name, value, higher_is_better)`` or
        a list of them, as (dataset, name, value, higher_is_better)."""
        res = feval(score, dset)
        if isinstance(res, tuple):
            res = [res]
        return [(name, r[0], float(r[1]), bool(r[2])) for r in res]

    # -- prediction ----------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, pred_early_stop: bool = False,
                pred_early_stop_freq: Optional[int] = None,
                pred_early_stop_margin: Optional[float] = None,
                **kwargs) -> np.ndarray:
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else None
        if hasattr(data, "to_numpy"):
            data = data.to_numpy(dtype=np.float64, na_value=np.nan)
        if hasattr(data, "todense"):   # scipy sparse, as the reference
            data = np.asarray(data.todense())
        return self._gbdt.predict(np.asarray(data, dtype=np.float64),
                                  raw_score=raw_score,
                                  start_iteration=start_iteration,
                                  num_iteration=num_iteration,
                                  pred_leaf=pred_leaf,
                                  pred_contrib=pred_contrib,
                                  pred_early_stop=pred_early_stop,
                                  pred_early_stop_freq=pred_early_stop_freq,
                                  pred_early_stop_margin=pred_early_stop_margin)

    def to_predictor(self, num_iteration: Optional[int] = None,
                     warmup: bool = False, **kwargs):
        """Serving handle for this model (reference basic.py:201): a
        :class:`~lightgbm_tpu_torch.serve.CompiledPredictor` holding the
        ensemble's compiled program on the booster's device
        (``warmup=True`` runs every shape bucket ahead of the first
        request)."""
        from .serve import CompiledPredictor
        pred = CompiledPredictor(self, num_iteration=num_iteration, **kwargs)
        if warmup:
            pred.warmup()
        return pred

    # -- model IO ------------------------------------------------------------
    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        return self._gbdt.save_model_to_string(
            start_iteration, -1 if num_iteration is None else num_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        """Write the model text through a temporary file and an atomic
        rename, so a crash never leaves a truncated model file."""
        text = self.model_to_string(num_iteration, start_iteration)
        d = os.path.dirname(os.path.abspath(filename))
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".model.", suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                fh.write(text)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, filename)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return self

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> Dict[str, Any]:
        """The model as a JSON-ready dict (reference basic.py:233,
        LightGBM gbdt_model_text.cpp:24 DumpModel)."""
        from .models.model_text import model_to_dict
        return model_to_dict(self._gbdt, start_iteration,
                             -1 if num_iteration is None else num_iteration)

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type)
