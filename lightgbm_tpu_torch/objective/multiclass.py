"""Multiclass objectives (reference src/objective/multiclass_objective.hpp:
softmax gradients at :86-126 with hessian factor num_class/(num_class-1) at
:31, OVA wrapper at :228, BoostFromScore log(class prob) at :155).  Port of
``lightgbm_tpu/objective/multiclass.py``.

Scores are (N, K).  The softmax runs the reference's ops in its order with
XLA:CPU's ``exp`` (ops/fmath.py) and sums the K class terms of a row left
to right, the order XLA:CPU's row reduction takes, so the gradients are
the reference's bit for bit; one-vs-all runs K binary objectives."""

from __future__ import annotations

import numpy as np
import torch

from ..dataset import Metadata
from ..ops.fmath import exp_f32, sigmoid_f32
from .base import EPS, ObjectiveFunction
from .binary import BinaryLogloss


def _row_sum(p: torch.Tensor) -> torch.Tensor:
    """(N, 1) sum over the class axis, left to right."""
    acc = p[:, 0]
    for k in range(1, p.shape[1]):
        acc = acc + p[:, k]
    return acc.unsqueeze(1)


def softmax_f32(score: torch.Tensor) -> torch.Tensor:
    """Row softmax of (N, K) scores in the reference's op order."""
    p = exp_f32(score - torch.amax(score, dim=-1, keepdim=True))
    return p / _row_sum(p)


class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.num_class = int(config.num_class)
        self.factor = self.num_class / (self.num_class - 1.0)

    def check_label(self, label):
        if (label < 0).any() or (label >= self.num_class).any():
            raise ValueError(f"multiclass labels must be in [0, {self.num_class})")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        lab = np.asarray(metadata.label).astype(np.int32)
        w = metadata.weight
        probs = np.zeros(self.num_class)
        for k in range(self.num_class):
            sel = lab == k
            probs[k] = (w[sel].sum() / w.sum()) if w is not None else sel.mean()
        self.class_init_probs = probs
        self.onehot = torch.as_tensor(
            np.eye(self.num_class, dtype=np.float32)[lab], device=self.device)

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def get_gradients(self, score):
        p = softmax_f32(score)
        grad = p - self.onehot
        hess = self.factor * p * (1.0 - p)
        if self.weight is not None:
            grad = grad * self.weight[:, None]
            hess = hess * self.weight[:, None]
        return grad.float(), hess.float()

    def boost_from_score(self, class_id: int = 0) -> float:
        return float(np.log(max(EPS, self.class_init_probs[class_id])))

    def convert_output(self, score):
        return softmax_f32(score)


class MulticlassOVA(ObjectiveFunction):
    name = "multiclassova"

    def __init__(self, config, device=torch.device("cpu")):
        super().__init__(config, device)
        self.num_class = int(config.num_class)
        self.sigmoid = float(config.sigmoid)
        self._binary = [BinaryLogloss(config, device)
                        for _ in range(self.num_class)]

    def check_label(self, label):
        if (label < 0).any() or (label >= self.num_class).any():
            raise ValueError(f"multiclassova labels must be in [0, {self.num_class})")

    def init(self, metadata, num_data):
        if metadata.label is None:
            raise ValueError("multiclassova requires labels")
        self.check_label(metadata.label)
        lab = np.asarray(metadata.label).astype(np.int32)
        self.label = torch.as_tensor(lab.astype(np.float32),
                                     device=self.device)
        self.weight = (torch.as_tensor(np.asarray(metadata.weight,
                                                  np.float32),
                                       device=self.device)
                       if metadata.weight is not None else None)
        self.num_data = num_data
        for k, b in enumerate(self._binary):
            md = Metadata()
            md.set_label((lab == k).astype(np.float32))
            if metadata.weight is not None:
                md.set_weight(metadata.weight)
            b.init(md, num_data)

    @property
    def num_model_per_iteration(self) -> int:
        return self.num_class

    def get_gradients(self, score):
        gh = [b.get_gradients(score[:, k]) for k, b in enumerate(self._binary)]
        return (torch.stack([g for g, _ in gh], dim=1),
                torch.stack([h for _, h in gh], dim=1))

    def boost_from_score(self, class_id: int = 0) -> float:
        return self._binary[class_id].boost_from_score(0)

    def convert_output(self, score):
        return sigmoid_f32(self.sigmoid * score)
