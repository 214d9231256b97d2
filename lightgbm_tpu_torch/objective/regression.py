"""Regression L2 objective (reference src/objective/
regression_objective.hpp:132 with BoostFromScore).  Port of the L2 class of
``lightgbm_tpu/objective/regression.py``; the rest of that family waits
for a later slice of the port (see ROADMAP queue 1, item 3)."""

from __future__ import annotations

import numpy as np
import torch

from .base import ObjectiveFunction, weighted_mean


class RegressionL2(ObjectiveFunction):
    name = "regression"
    is_constant_hessian = True

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.sqrt = bool(config.reg_sqrt)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.sqrt:
            lab = np.asarray(metadata.label, np.float64)
            self.label = torch.as_tensor(
                (np.sign(lab) * np.sqrt(np.abs(lab))).astype(np.float32),
                device=self.device)

    def _grad_hess(self, score):
        return score - self.label, torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_mean(self._np_label(), self._np_weight())

    def convert_output(self, score):
        if self.sqrt:
            return torch.sign(score) * score * score
        return score
