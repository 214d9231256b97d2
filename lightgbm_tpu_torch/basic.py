"""Booster: the trained-model handle.

Port of ``lightgbm_tpu/basic.py`` ``Booster`` (reference python-package
basic.py Booster): train from a Dataset, or load from a model file or
string; predict, ``model_to_string`` and ``save_model``.  The model runs
on ``device`` (default ``cuda``; pass ``device="cpu"`` for the plain
PyTorch path).
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
    def update(self) -> bool:
        """One boosting iteration; True when training should stop."""
        return self._gbdt.train_one_iter()

    @property
    def current_iteration(self) -> int:
        return self._gbdt.current_iteration

    def num_trees(self) -> int:
        return self._gbdt.num_trees()

    def num_feature(self) -> int:
        return self._gbdt.feature_mapping()[1]

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        self._gbdt.add_valid(data, name)
        return self

    def eval_train(self) -> List[Tuple[str, str, float, bool]]:
        return self._gbdt.eval_train()

    def eval_valid(self) -> List[Tuple[str, str, float, bool]]:
        return self._gbdt.eval_valid()

    # -- prediction ----------------------------------------------------------
    def predict(self, data, start_iteration: int = 0,
                num_iteration: Optional[int] = None,
                raw_score: bool = False) -> np.ndarray:
        if num_iteration is None:
            num_iteration = self.best_iteration if self.best_iteration > 0 \
                else None
        if hasattr(data, "to_numpy"):
            data = data.to_numpy(dtype=np.float64, na_value=np.nan)
        return self._gbdt.predict(np.asarray(data, dtype=np.float64),
                                  raw_score=raw_score,
                                  start_iteration=start_iteration,
                                  num_iteration=num_iteration)

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

    def feature_importance(self, importance_type: str = "split"
                           ) -> np.ndarray:
        return self._gbdt.feature_importance(importance_type)
