"""Boosting-mode factory.

Port of ``lightgbm_tpu/models/boosting.py`` ``create_boosting`` for plain
GBDT; GOSS, DART and RF are a later slice of the port (ROADMAP
queue 1)."""

from __future__ import annotations

from typing import Optional

import torch

from ..config import Config
from ..dataset import Dataset
from .gbdt import GBDT

__all__ = ["create_boosting"]


def create_boosting(config: Config, train_set: Optional[Dataset],
                    device: torch.device) -> GBDT:
    """Factory (reference src/boosting/boosting.cpp CreateBoosting)."""
    if config.boosting != "gbdt":
        raise NotImplementedError(
            f"boosting={config.boosting!r} is not ported to "
            "lightgbm_tpu_torch yet (GOSS, DART and RF: ROADMAP queue 1)")
    return GBDT(config, train_set, device=device)
