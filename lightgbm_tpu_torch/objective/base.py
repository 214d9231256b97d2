"""Objective base class (reference include/LightGBM/objective_function.h:19).

Port of ``lightgbm_tpu/objective/base.py``: gradients are torch math on
the training device; ``init``/``boost_from_score`` stay numpy, and
``weighted_percentile`` (numpy) is copied as it is.

Bitwise parity.  The reference computes most gradients eagerly, one XLA
op at a time, so each torch op here must round as that op does: its
``exp`` is ``ops/fmath.exp_f32``; a Python float scalar is rounded to f32
before it meets a tensor (:func:`f32_const`), and a scalar divided BY a
tensor is a true division of the f32 constant (torch turns ``s / t``
into ``t.reciprocal() * s``, which rounds twice)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..dataset import Metadata

EPS = 1e-15


class ObjectiveFunction:
    """Base: holds device copies of label/weight and exposes gradient math.

    Subclasses implement ``_grad_hess(score) -> (grad, hess)`` over device
    tensors; scores and gradients are (N,) float32, or (N, K) for
    multiclass.
    """

    name = "base"
    is_constant_hessian = False
    need_group = False

    def __init__(self, config, device: torch.device = torch.device("cpu")
                 ) -> None:
        self.config = config
        self.device = torch.device(device)
        self.label: Optional[torch.Tensor] = None
        self.weight: Optional[torch.Tensor] = None
        self.num_data = 0

    # -- lifecycle (reference ObjectiveFunction::Init) -----------------------
    def init(self, metadata: Metadata, num_data: int) -> None:
        if metadata.label is None:
            raise ValueError(f"objective {self.name} requires labels")
        self.check_label(metadata.label)
        self.label = torch.as_tensor(np.asarray(metadata.label, np.float32),
                                     device=self.device)
        self.weight = (torch.as_tensor(np.asarray(metadata.weight,
                                                  np.float32),
                                       device=self.device)
                       if metadata.weight is not None else None)
        self.num_data = num_data

    def check_label(self, label: np.ndarray) -> None:
        pass

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    # -- gradients (reference GetGradients, objective_function.h:37) ---------
    def get_gradients(self, score: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        grad, hess = self._grad_hess(score)
        if self.weight is not None:
            w = self.weight if grad.dim() == 1 else self.weight[:, None]
            grad, hess = grad * w, hess * w
        return grad.float(), hess.float()

    def _grad_hess(self, score):
        raise NotImplementedError

    # -- init score (reference BoostFromScore) -------------------------------
    def boost_from_score(self, class_id: int = 0) -> float:
        return 0.0

    # -- output transform (reference ConvertOutput) --------------------------
    def convert_output(self, score: torch.Tensor) -> torch.Tensor:
        return score

    def _np_label(self) -> np.ndarray:
        return self.label.cpu().numpy()

    def _np_weight(self) -> Optional[np.ndarray]:
        return None if self.weight is None else self.weight.cpu().numpy()


def weighted_mean(values: np.ndarray, weights: Optional[np.ndarray]) -> float:
    if weights is None:
        return float(np.mean(values))
    return float(np.sum(values * weights) / np.sum(weights))


def f32_const(x: float, like: torch.Tensor) -> torch.Tensor:
    """The Python float ``x`` as a 0-d f32 tensor on ``like``'s device (a
    fill, not a host copy)."""
    return torch.full((), x, dtype=torch.float32, device=like.device)


def weighted_percentile(values: np.ndarray, weights: Optional[np.ndarray],
                        alpha: float) -> float:
    """Weighted percentile (reference regression_objective.hpp:24
    ``PercentileFun``/``WeightedPercentileFun``).  Copy of the reference's
    ``objective/base.py`` function (numpy)."""
    order = np.argsort(values, kind="stable")
    v = values[order]
    if weights is None:
        n = len(v)
        if n == 0:
            return 0.0
        pos = alpha * n
        idx = int(np.floor(pos))
        if idx >= n:
            return float(v[-1])
        if abs(pos - idx) < 1e-12 and idx > 0:
            return float((v[idx - 1] + v[idx]) / 2.0)
        return float(v[idx])
    w = weights[order]
    cum = np.cumsum(w) - 0.5 * w
    total = np.sum(w)
    if total <= 0:
        return 0.0
    target = alpha * total
    idx = int(np.searchsorted(cum, target))
    idx = min(idx, len(v) - 1)
    return float(v[idx])
