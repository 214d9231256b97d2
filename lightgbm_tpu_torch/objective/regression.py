"""Regression objective family (reference src/objective/
regression_objective.hpp — L2:132, L1:223, Huber:320, Fair:368, Poisson:445,
Quantile:497, MAPE:616, Gamma:692, Tweedie:728, with BoostFromScore and the
percentile leaf-renewal hooks ``is_renew_tree_output`` / ``renew_alpha``).
Port of ``lightgbm_tpu/objective/regression.py``: the same f32 ops in the
same order (see ``objective/base.py`` on scalars), with XLA:CPU's ``exp``
(``ops/fmath.exp_f32``), so every gradient is the reference's bit for bit."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fmath import exp_f32
from .base import (ObjectiveFunction, f32_const, weighted_mean,
                   weighted_percentile)


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


class RegressionL1(RegressionL2):
    name = "regression_l1"
    # reference IsRenewTreeOutput: leaf values are refit to the residual
    # median (RenewTreeOutput), models/gbdt.py ``_renew_leaf_values``
    is_renew_tree_output = True
    renew_alpha = 0.5

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.sqrt = False

    def _grad_hess(self, score):
        return torch.sign(score - self.label), torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self._np_label(), self._np_weight(), 0.5)


class Huber(RegressionL2):
    name = "huber"

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.sqrt = False
        self.alpha = float(config.alpha)

    def _grad_hess(self, score):
        diff = score - self.label
        a = f32_const(self.alpha, diff)
        grad = torch.where(torch.abs(diff) <= a, diff, torch.sign(diff) * a)
        return grad, torch.ones_like(score)


class Fair(RegressionL2):
    name = "fair"
    is_constant_hessian = False

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.sqrt = False
        self.c = float(config.fair_c)

    def _grad_hess(self, score):
        x = score - self.label
        denom = torch.abs(x) + self.c
        # c * c is a double product rounded to f32 once, as the reference's
        # Python scalar is
        return (self.c * x / denom,
                f32_const(self.c * self.c, x) / (denom * denom))

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self._np_label(), self._np_weight(), 0.5)


class Poisson(RegressionL2):
    name = "poisson"
    is_constant_hessian = False

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.sqrt = False
        self.max_delta_step = float(config.poisson_max_delta_step)

    def check_label(self, label):
        if (label < 0).any():
            raise ValueError("poisson objective requires non-negative labels")

    def _grad_hess(self, score):
        return (exp_f32(score) - self.label,
                exp_f32(score + self.max_delta_step))

    def boost_from_score(self, class_id: int = 0) -> float:
        mean = weighted_mean(self._np_label(), self._np_weight())
        return float(np.log(max(mean, 1e-15)))

    def convert_output(self, score):
        return exp_f32(score)


class Quantile(RegressionL2):
    name = "quantile"
    is_renew_tree_output = True

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.sqrt = False
        self.alpha = float(config.alpha)

    @property
    def renew_alpha(self):
        return self.alpha

    def _grad_hess(self, score):
        # reference regression_objective.hpp:496-499: (1 - alpha) where the
        # residual is >= 0, else -alpha (pinball loss d/ds)
        diff = score - self.label
        grad = torch.where(diff >= 0, f32_const(1.0 - self.alpha, diff),
                           f32_const(-self.alpha, diff))
        return grad, torch.ones_like(score)

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self._np_label(), self._np_weight(),
                                   self.alpha)


class Mape(RegressionL2):
    name = "mape"
    is_renew_tree_output = True
    renew_alpha = 0.5

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.sqrt = False

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lab = np.abs(np.asarray(metadata.label, np.float64))
        lw = 1.0 / np.maximum(1.0, lab)
        if metadata.weight is not None:
            lw = lw * metadata.weight
        self.label_weight = torch.as_tensor(lw.astype(np.float32),
                                            device=self.device)

    def get_gradients(self, score):
        # label_weight already folds user weights (regression_objective.hpp:616)
        grad = torch.sign(score - self.label) * self.label_weight
        hess = (torch.ones_like(score) if self.weight is None
                else self.weight.expand(score.shape).clone())
        return grad.float(), hess.float()

    def boost_from_score(self, class_id: int = 0) -> float:
        return weighted_percentile(self._np_label(),
                                   self.label_weight.cpu().numpy(), 0.5)


class Gamma(Poisson):
    name = "gamma"

    def check_label(self, label):
        if (label <= 0).any():
            raise ValueError("gamma objective requires positive labels")

    def _grad_hess(self, score):
        enx = exp_f32(-score)
        return 1.0 - self.label * enx, self.label * enx


class Tweedie(Poisson):
    name = "tweedie"

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.rho = float(config.tweedie_variance_power)

    def check_label(self, label):
        if (label < 0).any():
            raise ValueError("tweedie objective requires non-negative labels")

    def _grad_hess(self, score):
        e1 = exp_f32((1.0 - self.rho) * score)
        e2 = exp_f32((2.0 - self.rho) * score)
        grad = -self.label * e1 + e2
        hess = -self.label * (1.0 - self.rho) * e1 + (2.0 - self.rho) * e2
        return grad, hess
