"""Binary log-loss objective (reference src/objective/binary_objective.hpp:
gradients at :105-133, unbalance label weights at :90-102, BoostFromScore at
:139-159).  Port of ``lightgbm_tpu/objective/binary.py``."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fmath import sigmoid_f32
from .base import EPS, ObjectiveFunction, weighted_mean


class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.sigmoid = float(config.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and self.scale_pos_weight != 1.0:
            raise ValueError("cannot set both is_unbalance and scale_pos_weight")

    def check_label(self, label):
        u = np.unique(label)
        if not np.all(np.isin(u, [0.0, 1.0])):
            raise ValueError("binary objective requires labels in {0, 1}")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lab = np.asarray(metadata.label)
        cnt_pos = float((lab > 0).sum())
        cnt_neg = float((lab <= 0).sum())
        w0 = w1 = 1.0
        if self.is_unbalance and cnt_pos > 0 and cnt_neg > 0:
            if cnt_pos > cnt_neg:
                w0 = cnt_pos / cnt_neg
            else:
                w1 = cnt_neg / cnt_pos
        w1 *= self.scale_pos_weight
        self.label_weight = (w0, w1)
        # the per-row label weight is fixed for the run: built once
        self._lw = torch.where(self.label > 0,
                               torch.tensor(w1, dtype=torch.float32,
                                            device=self.device),
                               torch.tensor(w0, dtype=torch.float32,
                                            device=self.device))

    def get_gradients(self, score):
        # same op order as the reference, one f32 op at a time; the
        # sigmoid's exp is XLA:CPU's, bit for bit (ops/fmath.py)
        y = self.label
        sig = self.sigmoid
        p = sigmoid_f32(sig * score)
        grad = sig * (p - y) * self._lw
        hess = sig * sig * p * (1.0 - p) * self._lw
        if self.weight is not None:
            grad = grad * self.weight
            hess = hess * self.weight
        return grad.float(), hess.float()

    def boost_from_score(self, class_id: int = 0) -> float:
        pavg = weighted_mean(self._np_label(), self._np_weight())
        pavg = min(max(pavg, EPS), 1.0 - EPS)
        return float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)

    def convert_output(self, score):
        return sigmoid_f32(self.sigmoid * score)
