"""Objective functions: gradients/hessians as torch math on the training
device (reference include/LightGBM/objective_function.h:19, factory
src/objective/objective_function.cpp:15).  Port of
``lightgbm_tpu/objective/__init__.py``: all 16 objectives."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from .base import ObjectiveFunction
from .binary import BinaryLogloss
from .multiclass import MulticlassOVA, MulticlassSoftmax
from .rank import LambdarankNDCG, RankXENDCG
from .regression import (Fair, Gamma, Huber, Mape, Poisson, Quantile,
                         RegressionL1, RegressionL2, Tweedie)
from .xentropy import CrossEntropy, CrossEntropyLambda

__all__ = ["create_objective", "ObjectiveFunction"]

_REGISTRY = {
    "regression": RegressionL2,
    "regression_l1": RegressionL1,
    "huber": Huber,
    "fair": Fair,
    "poisson": Poisson,
    "quantile": Quantile,
    "mape": Mape,
    "gamma": Gamma,
    "tweedie": Tweedie,
    "binary": BinaryLogloss,
    "multiclass": MulticlassSoftmax,
    "multiclassova": MulticlassOVA,
    "cross_entropy": CrossEntropy,
    "cross_entropy_lambda": CrossEntropyLambda,
    "lambdarank": LambdarankNDCG,
    "rank_xendcg": RankXENDCG,
}


def create_objective(name: str, config: Config,
                     device=torch.device("cpu")
                     ) -> Optional[ObjectiveFunction]:
    """Factory.  Returns None for objective='none' (the caller supplies
    gradients)."""
    if name in ("none", None, ""):
        return None
    if name not in _REGISTRY:
        raise ValueError(f"Unknown objective: {name}. "
                         f"Known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](config, device)
