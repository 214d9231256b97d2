"""Cross-entropy objectives for probabilistic labels in [0, 1]
(reference src/objective/xentropy_objective.hpp: CrossEntropy gradients at
:82-92, CrossEntropyLambda weighted parameterization at :195-216, init scores
at :134/:262).  Port of ``lightgbm_tpu/objective/xentropy.py``.

``cross_entropy`` and unweighted ``cross_entropy_lambda`` are the
reference's gradients bit for bit (XLA:CPU's ``exp``, ops/fmath.py).  The
weighted ``cross_entropy_lambda`` gradient also takes ``log1p``, which the
port runs as ``torch.log1p``: that op is not XLA:CPU's, so those gradients
agree within f32 rounding, not bitwise."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fmath import exp_f32, sigmoid_f32
from .base import EPS, ObjectiveFunction, f32_const, weighted_mean


class CrossEntropy(ObjectiveFunction):
    name = "cross_entropy"

    def check_label(self, label):
        if (label < 0).any() or (label > 1).any():
            raise ValueError("cross_entropy labels must be in [0, 1]")

    def get_gradients(self, score):
        z = sigmoid_f32(score)
        grad = z - self.label
        hess = z * (1.0 - z)
        if self.weight is not None:
            grad = grad * self.weight
            hess = hess * self.weight
        return grad.float(), hess.float()

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = weighted_mean(self._np_label(), self._np_weight())
        pavg = min(max(pavg, EPS), 1.0 - EPS)
        return float(np.log(pavg / (1.0 - pavg)))

    def convert_output(self, score):
        return sigmoid_f32(score)


class CrossEntropyLambda(ObjectiveFunction):
    name = "cross_entropy_lambda"

    def check_label(self, label):
        if (label < 0).any() or (label > 1).any():
            raise ValueError("cross_entropy_lambda labels must be in [0, 1]")

    def get_gradients(self, score):
        y = self.label
        if self.weight is None:
            z = sigmoid_f32(score)
            grad = z - y
            hess = z * (1.0 - z)
        else:
            w = self.weight
            one = f32_const(1.0, score)
            epf = exp_f32(score)
            hhat = torch.log1p(epf)
            z = 1.0 - exp_f32(-w * hhat)
            enf = one / epf
            grad = (1.0 - y / torch.clamp(z, min=EPS)) * w / (1.0 + enf)
            c = one / torch.clamp(1.0 - z, min=EPS)
            d = 1.0 + epf
            a = w * epf / (d * d)
            d2 = torch.clamp(c - 1.0, min=EPS)
            b = (c / (d2 * d2)) * (1.0 + w * epf - c)
            hess = a * (1.0 + y * b)
        return grad.float(), hess.float()

    def boost_from_score(self, class_id: int = 0) -> float:
        # havg = weighted mean label; initscore = log(exp(havg) - 1)
        # (xentropy_objective.hpp:262)
        havg = weighted_mean(self._np_label(), self._np_weight())
        return float(np.log(max(np.exp(havg) - 1.0, EPS)))

    def convert_output(self, score):
        # output is the exponential parameter lambda (xentropy_objective.hpp:234)
        return torch.log1p(exp_f32(score))
