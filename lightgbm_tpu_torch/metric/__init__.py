"""Evaluation metrics (reference src/metric/: factory ``Metric::CreateMetric``
in metric.cpp:16-65; regression_metric.hpp, binary_metric.hpp,
multiclass_metric.hpp, rank_metric.hpp + dcg_calculator.cpp, map_metric.hpp,
xentropy_metric.hpp — 24 metrics).

Metrics run host-side on numpy copies of the scores once per ``metric_freq``
iterations — they are O(N) or O(N log N) and off the training hot path, so
device residency buys nothing (the reference likewise evaluates metrics on
CPU outside the tree-growing loop).

Copy of ``lightgbm_tpu/metric/__init__.py`` (numpy only) kept inside the PyTorch port so
the port never imports the JAX package."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..config import Config
from ..dataset import Metadata

__all__ = ["create_metrics", "Metric", "METRIC_ALIASES"]

METRIC_ALIASES = {
    "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "mean_squared_error": "l2", "mse": "l2", "regression": "l2",
    "regression_l2": "l2",
    "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "mean_absolute_percentage_error": "mape",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg", "xendcg": "ndcg",
    "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg", "xendcg_mart": "ndcg",
    "mean_average_precision": "map",
    "xentropy": "cross_entropy", "xentlambda": "cross_entropy_lambda",
    "kldiv": "kullback_leibler",
    "multi_logloss": "multi_logloss", "softmax": "multi_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss", "ovr": "multi_logloss",
}


class Metric:
    """Base metric (reference include/LightGBM/metric.h:24)."""

    name = "base"
    is_higher_better = False

    def __init__(self, config: Config) -> None:
        self.config = config

    def init(self, metadata: Metadata, num_data: int) -> None:
        self.label = metadata.label
        self.weight = metadata.weight
        self.sum_weight = (float(np.sum(self.weight))
                           if self.weight is not None else float(num_data))
        self.query_boundaries = metadata.query_boundaries
        self.num_data = num_data

    def eval(self, score: np.ndarray) -> List[Tuple[str, float, bool]]:
        """score: raw (untransformed) ensemble score, (N,) or (N, K)."""
        raise NotImplementedError

    @property
    def eval_names(self) -> List[str]:
        """One entry per value ``eval`` returns (the reference's
        Metric::GetName() vector — multi-position metrics like ndcg/map
        report one value per eval_at position, c_api.cpp GetEvalCounts)."""
        return [self.name]

    # helpers
    def _avg(self, pointwise: np.ndarray) -> float:
        if self.weight is not None:
            return float(np.sum(pointwise * self.weight) / self.sum_weight)
        return float(np.mean(pointwise))


def _sigmoid(x: np.ndarray, k: float = 1.0) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-k * np.clip(x, -500, 500)))


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(axis=-1, keepdims=True))
    return e / e.sum(axis=-1, keepdims=True)


EPS = 1e-15


# ---------------------------------------------------------------- regression
class L2Metric(Metric):
    name = "l2"

    def eval(self, score):
        return [("l2", self._avg((score - self.label) ** 2), False)]


class RMSEMetric(Metric):
    name = "rmse"

    def eval(self, score):
        return [("rmse", float(np.sqrt(self._avg((score - self.label) ** 2))), False)]


class L1Metric(Metric):
    name = "l1"

    def eval(self, score):
        return [("l1", self._avg(np.abs(score - self.label)), False)]


class QuantileMetric(Metric):
    name = "quantile"

    def eval(self, score):
        a = float(self.config.alpha)
        d = self.label - score
        loss = np.where(d >= 0, a * d, (a - 1.0) * d)
        return [("quantile", self._avg(loss), False)]


class MapeMetric(Metric):
    name = "mape"

    def eval(self, score):
        loss = np.abs((self.label - score) / np.maximum(1.0, np.abs(self.label)))
        return [("mape", self._avg(loss), False)]


class HuberMetric(Metric):
    name = "huber"

    def eval(self, score):
        a = float(self.config.alpha)
        d = np.abs(score - self.label)
        loss = np.where(d <= a, 0.5 * d * d, a * (d - 0.5 * a))
        return [("huber", self._avg(loss), False)]


class FairMetric(Metric):
    name = "fair"

    def eval(self, score):
        c = float(self.config.fair_c)
        x = np.abs(score - self.label)
        loss = c * x - c * c * np.log1p(x / c)
        return [("fair", self._avg(loss), False)]


class PoissonMetric(Metric):
    name = "poisson"

    def eval(self, score):
        # score is log-mean (regression_metric.hpp PoissonMetric: eval on exp)
        mu = np.exp(score)
        loss = mu - self.label * score
        return [("poisson", self._avg(loss), False)]


class GammaMetric(Metric):
    name = "gamma"

    def eval(self, score):
        mu = np.exp(score)
        psi = self.label / mu + score  # -log likelihood up to const
        return [("gamma", self._avg(psi), False)]


class GammaDevianceMetric(Metric):
    name = "gamma_deviance"

    def eval(self, score):
        mu = np.exp(score)
        eps = 1e-9
        d = 2.0 * (-np.log((self.label + eps) / mu) + (self.label + eps) / mu - 1.0)
        return [("gamma_deviance", self._avg(d), False)]


class TweedieMetric(Metric):
    name = "tweedie"

    def eval(self, score):
        rho = float(self.config.tweedie_variance_power)
        mu = np.exp(score)
        a = self.label * np.power(mu, 1.0 - rho) / (1.0 - rho)
        b = np.power(mu, 2.0 - rho) / (2.0 - rho)
        return [("tweedie", self._avg(-a + b), False)]


# -------------------------------------------------------------------- binary
class BinaryLoglossMetric(Metric):
    name = "binary_logloss"

    def eval(self, score):
        p = np.clip(_sigmoid(score, float(self.config.sigmoid)), EPS, 1 - EPS)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [("binary_logloss", self._avg(loss), False)]


class BinaryErrorMetric(Metric):
    name = "binary_error"

    def eval(self, score):
        p = _sigmoid(score, float(self.config.sigmoid))
        err = ((p > 0.5) != (self.label > 0)).astype(np.float64)
        return [("binary_error", self._avg(err), False)]


def _weighted_auc(label: np.ndarray, score: np.ndarray,
                  weight: Optional[np.ndarray]) -> float:
    """Weighted ROC-AUC with tie handling (reference binary_metric.hpp
    AUCMetric::Eval — cumulative trapezoids over score-sorted groups)."""
    w = weight if weight is not None else np.ones_like(label, dtype=np.float64)
    order = np.argsort(-score, kind="stable")
    s, y, ww = score[order], label[order], w[order]
    wpos = ww * (y > 0)
    wneg = ww * (y <= 0)
    tp = np.cumsum(wpos)
    fp = np.cumsum(wneg)
    # group boundaries: last index of each tied score run
    is_end = np.r_[s[1:] != s[:-1], True]
    tp_e = tp[is_end]
    fp_e = fp[is_end]
    tp_prev = np.r_[0.0, tp_e[:-1]]
    fp_prev = np.r_[0.0, fp_e[:-1]]
    area = np.sum((fp_e - fp_prev) * (tp_e + tp_prev) * 0.5)
    denom = tp_e[-1] * fp_e[-1]
    return float(area / denom) if denom > 0 else 0.5


class AUCMetric(Metric):
    name = "auc"
    is_higher_better = True

    def eval(self, score):
        return [("auc", _weighted_auc(self.label, score, self.weight), True)]


class AveragePrecisionMetric(Metric):
    name = "average_precision"
    is_higher_better = True

    def eval(self, score):
        w = self.weight if self.weight is not None else np.ones_like(self.label,
                                                                     np.float64)
        order = np.argsort(-score, kind="stable")
        y, ww = self.label[order], w[order]
        tp = np.cumsum(ww * (y > 0))
        total = np.cumsum(ww)
        pos_total = tp[-1]
        if pos_total <= 0:
            return [("average_precision", 0.0, True)]
        precision = tp / np.maximum(total, EPS)
        rec_delta = np.diff(np.r_[0.0, tp]) / pos_total
        return [("average_precision", float(np.sum(precision * rec_delta)), True)]


# ---------------------------------------------------------------- multiclass
class MultiLoglossMetric(Metric):
    name = "multi_logloss"

    def eval(self, score):
        if self.config.objective == "multiclassova":
            p = _sigmoid(score, float(self.config.sigmoid))
            p = p / np.maximum(p.sum(axis=1, keepdims=True), EPS)
        else:
            p = _softmax(score)
        y = self.label.astype(np.int64)
        py = np.clip(p[np.arange(len(y)), y], EPS, 1.0)
        return [("multi_logloss", self._avg(-np.log(py)), False)]


class MultiErrorMetric(Metric):
    name = "multi_error"

    def eval(self, score):
        y = self.label.astype(np.int64)
        k = int(self.config.multi_error_top_k)
        if k <= 1:
            err = (np.argmax(score, axis=1) != y).astype(np.float64)
        else:
            topk = np.argsort(-score, axis=1)[:, :k]
            err = (~(topk == y[:, None]).any(axis=1)).astype(np.float64)
        return [(f"multi_error{'@' + str(k) if k > 1 else ''}",
                 self._avg(err), False)]


class AucMuMetric(Metric):
    """auc_mu multiclass AUC (reference multiclass_metric.hpp:368 region;
    Kleiman & Page, "AUC-mu")."""
    name = "auc_mu"
    is_higher_better = True

    def eval(self, score):
        y = self.label.astype(np.int64)
        k = score.shape[1]
        w = self.weight if self.weight is not None else np.ones(len(y))
        aucs = []
        for a in range(k):
            for b in range(a + 1, k):
                sel = (y == a) | (y == b)
                if sel.sum() == 0 or len(np.unique(y[sel])) < 2:
                    continue
                # partition by score difference along the (a,b) direction
                s = score[sel, a] - score[sel, b]
                lab = (y[sel] == a).astype(np.float64)
                aucs.append(_weighted_auc(lab, s, w[sel]))
        val = float(np.mean(aucs)) if aucs else 0.5
        return [("auc_mu", val, True)]


# ------------------------------------------------------------------- ranking
class NDCGMetric(Metric):
    name = "ndcg"
    is_higher_better = True

    @property
    def eval_names(self):
        return [f"ndcg@{int(k)}" for k in self.config.eval_at]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            raise ValueError("ndcg metric requires query data")
        self.label_gain = np.asarray(self.config.label_gain, dtype=np.float64)

    def eval(self, score):
        eval_at = [int(k) for k in self.config.eval_at]
        qb = self.query_boundaries
        results = {k: [] for k in eval_at}
        for i in range(len(qb) - 1):
            lab = self.label[qb[i]:qb[i + 1]].astype(np.int64)
            s = score[qb[i]:qb[i + 1]]
            order = np.argsort(-s, kind="stable")
            ideal = np.sort(lab)[::-1]
            for k in eval_at:
                kk = min(k, len(lab))
                disc = 1.0 / np.log2(np.arange(kk) + 2.0)
                dcg = float((self.label_gain[lab[order[:kk]]] * disc).sum())
                idcg = float((self.label_gain[ideal[:kk]] * disc).sum())
                results[k].append(dcg / idcg if idcg > 0 else 1.0)
        return [(f"ndcg@{k}", float(np.mean(results[k])), True) for k in eval_at]


class MapMetric(Metric):
    name = "map"

    @property
    def eval_names(self):
        return [f"map@{int(k)}" for k in self.config.eval_at]
    is_higher_better = True

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.query_boundaries is None:
            raise ValueError("map metric requires query data")

    def eval(self, score):
        eval_at = [int(k) for k in self.config.eval_at]
        qb = self.query_boundaries
        results = {k: [] for k in eval_at}
        for i in range(len(qb) - 1):
            lab = (self.label[qb[i]:qb[i + 1]] > 0).astype(np.float64)
            s = score[qb[i]:qb[i + 1]]
            order = np.argsort(-s, kind="stable")
            rel = lab[order]
            hits = np.cumsum(rel)
            prec = hits / (np.arange(len(rel)) + 1.0)
            for k in eval_at:
                kk = min(k, len(rel))
                npos = rel[:kk].sum()
                ap = float((prec[:kk] * rel[:kk]).sum() / npos) if npos > 0 else 0.0
                results[k].append(ap)
        return [(f"map@{k}", float(np.mean(results[k])), True) for k in eval_at]


# ------------------------------------------------------------- cross-entropy
class CrossEntropyMetric(Metric):
    name = "cross_entropy"

    def eval(self, score):
        p = np.clip(_sigmoid(score), EPS, 1 - EPS)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [("cross_entropy", self._avg(loss), False)]


class CrossEntropyLambdaMetric(Metric):
    name = "cross_entropy_lambda"

    def eval(self, score):
        # p = 1 - exp(-w * log1p(exp(score))) (xentropy_metric.hpp)
        w = self.weight if self.weight is not None else 1.0
        hhat = np.log1p(np.exp(np.clip(score, -500, 500)))
        p = np.clip(1.0 - np.exp(-w * hhat), EPS, 1 - EPS)
        y = self.label
        loss = -(y * np.log(p) + (1 - y) * np.log(1 - p))
        return [("cross_entropy_lambda", float(np.mean(loss)), False)]


class KullbackLeiblerMetric(Metric):
    name = "kullback_leibler"

    def eval(self, score):
        p = np.clip(_sigmoid(score), EPS, 1 - EPS)
        y = np.clip(self.label, EPS, 1 - EPS)
        kl = y * np.log(y / p) + (1 - y) * np.log((1 - y) / (1 - p))
        return [("kullback_leibler", self._avg(kl), False)]


_REGISTRY = {
    "l1": L1Metric, "l2": L2Metric, "rmse": RMSEMetric,
    "quantile": QuantileMetric, "mape": MapeMetric, "huber": HuberMetric,
    "fair": FairMetric, "poisson": PoissonMetric, "gamma": GammaMetric,
    "gamma_deviance": GammaDevianceMetric, "tweedie": TweedieMetric,
    "binary_logloss": BinaryLoglossMetric, "binary_error": BinaryErrorMetric,
    "auc": AUCMetric, "average_precision": AveragePrecisionMetric,
    "multi_logloss": MultiLoglossMetric, "multi_error": MultiErrorMetric,
    "auc_mu": AucMuMetric, "ndcg": NDCGMetric, "map": MapMetric,
    "cross_entropy": CrossEntropyMetric,
    "cross_entropy_lambda": CrossEntropyLambdaMetric,
    "kullback_leibler": KullbackLeiblerMetric,
}

_DEFAULT_FOR_OBJECTIVE = {
    "regression": "l2", "regression_l1": "l1", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "quantile": "quantile", "mape": "mape",
    "gamma": "gamma", "tweedie": "tweedie", "binary": "binary_logloss",
    "multiclass": "multi_logloss", "multiclassova": "multi_logloss",
    "cross_entropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda",
    "lambdarank": "ndcg", "rank_xendcg": "ndcg",
}


def create_metrics(config: Config) -> List[Metric]:
    """Factory (reference src/metric/metric.cpp:16).  Resolves the metric
    list from config (default = the objective's own metric)."""
    names = config.metric
    if names in (None, [], ""):
        default = _DEFAULT_FOR_OBJECTIVE.get(config.objective)
        names = [default] if default else []
    if isinstance(names, str):
        names = [names]
    out = []
    seen = set()
    for raw in names:
        name = METRIC_ALIASES.get(str(raw), str(raw))
        if name in ("none", "null", "na", "custom", ""):
            continue
        if name in seen:
            continue
        seen.add(name)
        if name not in _REGISTRY:
            raise ValueError(f"Unknown metric: {raw}")
        out.append(_REGISTRY[name](config))
    return out
