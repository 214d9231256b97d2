"""Objective functions: gradients/hessians as torch math on the training
device (reference include/LightGBM/objective_function.h:19, factory
src/objective/objective_function.cpp:15).  Port of
``lightgbm_tpu/objective/__init__.py`` for the objectives this slice of
the port carries: binary and L2 regression."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .regression import RegressionL2

__all__ = ["create_objective", "ObjectiveFunction"]

_REGISTRY = {
    "regression": RegressionL2,
    "binary": BinaryLogloss,
}

# objectives the JAX package has and the port does not yet carry
_NOT_PORTED = ("regression_l1", "huber", "fair", "poisson", "quantile",
               "mape", "gamma", "tweedie", "multiclass", "multiclassova",
               "cross_entropy", "cross_entropy_lambda", "lambdarank",
               "rank_xendcg")


def create_objective(name: str, config: Config,
                     device=torch.device("cpu")
                     ) -> Optional[ObjectiveFunction]:
    """Factory.  Returns None for objective='none' (the caller supplies
    gradients)."""
    if name in ("none", None, ""):
        return None
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"objective '{name}' is not ported to lightgbm_tpu_torch yet "
            "(ROADMAP queue 1, item 3: objectives)")
    if name not in _REGISTRY:
        raise ValueError(f"Unknown objective: {name}. "
                         f"Known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](config, device)
