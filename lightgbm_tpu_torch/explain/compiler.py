"""Explain compile entry: the serving-compiler contract for TreeSHAP.

Port of ``lightgbm_tpu/explain/compiler.py``.  :func:`compile_explain`
returns an :class:`ExplainExecutable` or ``(None, reason)`` with the
reason counted in ``serve_explain_fallback``: a fallback to the host
walk is never silent.  The executable runs the :mod:`.dense_shap`
program on row chunks sized by its working-set budget
(:meth:`ExplainExecutable.max_rows`) and enforces the additivity
invariant (phi rows sum to the plain raw score) on every batch it
returns.

There is no cost model: the host TreeSHAP walk is a Python recursion
per tree, so the dense program wins on every device whenever it lowers;
``auto`` falls back only on the lowering budgets.  The reference's
``memory_budget`` contract comes with the contract checks (ROADMAP
queue 1 item 12).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.dense_predict import (DenseArrays, DenseLoweringError,
                                    DenseMeta, lower_ensemble)
from ..models.tree import SHAPE_BUCKETS, Tree, TreeBatch, pad_rows
from ..telemetry.metrics import default_registry
from ..telemetry.slo import register_metric_ensurer
from .dense_shap import (EXPLAIN_DEPTH_BUDGET, EXPLAIN_TABLE_BUDGET,
                         EXPLAIN_TABLE_BUDGET_CUDA, ExplainArrays,
                         ExplainMeta, dense_explain, lower_explain)

__all__ = ["EXPLAIN_FALLBACK_COUNTER", "EXPLAIN_FALLBACK_BATCHES",
           "EXPLAIN_WORKSET_BUDGET", "EXPLAIN_WORKSET_BUDGET_CUDA",
           "ExplainAdditivityError", "ExplainExecutable",
           "check_additivity", "compile_explain", "explain_fallback_counts",
           "note_explain_fallback_batch"]

# The pweight state (T, rows, L, D+1) f32 is the program's working set;
# rows are chunked so the few live copies the extend / unwind chain keeps
# stay under this: the reference's 256 MiB on the CPU, 8 GiB (a tenth of
# the 80 GB card) on the card, where chunks of 8 rows would leave a
# 64 x 255-leaf model's 4,096 rows launch-bound.
EXPLAIN_WORKSET_BUDGET = 256 << 20
EXPLAIN_WORKSET_BUDGET_CUDA = 8 << 30

# additivity slack: f32 accumulation over the tree axis against the
# exact sum; generous for legitimate programs, tight enough that a wrong
# unwind (systematic, O(leaf value)) always trips it
ADDITIVITY_RTOL = 5e-3
ADDITIVITY_ATOL = 1e-3

# ---------------------------------------------------------------------------
# fallback telemetry: never silent
# ---------------------------------------------------------------------------

EXPLAIN_FALLBACK_COUNTER = "serve_explain_fallback"
EXPLAIN_FALLBACK_BATCHES = "serve_explain_fallback_batches_total"
_fb_lock = threading.Lock()
_fb_counts: Dict[str, int] = {}


def _note_fallback(reason: str, model: str = "") -> None:
    with _fb_lock:
        _fb_counts[reason] = _fb_counts.get(reason, 0) + 1
    default_registry().counter(
        EXPLAIN_FALLBACK_COUNTER,
        "dense-explain compiler fallbacks to the host TreeSHAP walk, "
        "by reason", labels=("reason", "model")).inc(
        reason=reason, model=model or "-")


def note_explain_fallback_batch(reason: str, model: str) -> None:
    """One explain batch answered by the host walk (counted per
    dispatch, so the fallback rate is measured in traffic)."""
    default_registry().counter(
        EXPLAIN_FALLBACK_BATCHES,
        "explain batches served by the host-walk fallback, by reason",
        labels=("reason", "model")).inc(1, reason=reason,
                                        model=model or "-")


@register_metric_ensurer
def _ensure_explain_metrics(reg) -> None:
    reg.counter(EXPLAIN_FALLBACK_COUNTER,
                "dense-explain compiler fallbacks to the host TreeSHAP "
                "walk, by reason", labels=("reason", "model"))
    reg.counter(EXPLAIN_FALLBACK_BATCHES,
                "explain batches served by the host-walk fallback, by "
                "reason", labels=("reason", "model"))


def explain_fallback_counts() -> Dict[str, int]:
    """Process-wide explain-fallback tally by reason (mirrors the
    labeled ``serve_explain_fallback`` counter series)."""
    with _fb_lock:
        return dict(_fb_counts)


class ExplainAdditivityError(RuntimeError):
    """The dense program's phi rows failed to sum to its raw score, the
    invariant of every TreeSHAP result.  Callers fall back to the host
    walk and count reason ``additivity``."""


class ExplainExecutable:
    """A lowered dense-TreeSHAP program bound to one ensemble, its tables
    on the prediction device."""

    def __init__(self, arrays: DenseArrays, dmeta: DenseMeta,
                 exp: ExplainArrays, emeta: ExplainMeta) -> None:
        self.arrays = arrays
        self.dmeta = dmeta
        self.exp = exp
        self.emeta = emeta
        self._leaves = int(exp.leaf_val.shape[2])
        self._nodes = int(arrays.split_feature.shape[1])

    @property
    def device(self) -> torch.device:
        return self.exp.leaf_val.device

    @property
    def signature(self):
        return ("explain", self.emeta,
                tuple((tuple(a.shape), str(a.dtype)) for a in self.exp))

    def max_rows(self, budget: Optional[int] = None) -> int:
        """Largest shape bucket whose working set fits ``budget`` (by
        default the device's): 4 * T * (3 * Nn + 8 * L * (D + 1)) bytes a
        row, the condition blocks and the live pweight copies
        (reference compiler.py:172-182)."""
        if budget is None:
            budget = (EXPLAIN_WORKSET_BUDGET_CUDA
                      if self.device.type == "cuda"
                      else EXPLAIN_WORKSET_BUDGET)
        d = max(self.emeta.depth, 1)
        t = max(self.emeta.num_trees, 1)
        per_row = 4 * t * (3 * self._nodes + 8 * self._leaves * (d + 1))
        best = SHAPE_BUCKETS[0]
        for b in SHAPE_BUCKETS:
            if b * per_row <= budget:
                best = b
        return best

    def explain_padded(self, Xp) -> Tuple[torch.Tensor, torch.Tensor]:
        """(phi, raw) on the device for an already-padded row block."""
        Xp = torch.as_tensor(np.asarray(Xp, np.float32)) \
            if not isinstance(Xp, torch.Tensor) else Xp
        return dense_explain(Xp.to(self.device, torch.float32), self.arrays,
                             self.dmeta, self.exp, self.emeta)

    def explain(self, X: np.ndarray, check: bool = True, buckets=None,
                max_rows: Optional[int] = None) -> np.ndarray:
        """Chunked, padded, additivity-checked phi (float64 host array)
        for any number of rows (the Booster's and the predictor's
        entry).  ``max_rows`` overrides the budget's chunk."""
        n = X.shape[0]
        chunk = max_rows or self.max_rows()
        outs = []
        for lo in range(0, n, chunk):
            Xc = np.asarray(X[lo:lo + chunk], np.float32)
            nc = Xc.shape[0]
            Xp = pad_rows(Xc, buckets) if buckets is not None \
                else pad_rows(Xc)
            phi, raw = self.explain_padded(np.ascontiguousarray(Xp))
            phi = phi[:nc].cpu().numpy().astype(np.float64)
            if check:
                check_additivity(phi, raw[:nc].cpu().numpy().astype(
                    np.float64), self.emeta.num_cols)
            outs.append(phi)
        return outs[0] if len(outs) == 1 else np.concatenate(outs, axis=0)

    def info(self) -> Dict[str, object]:
        return {"compiled": True, "trees": self.emeta.num_trees,
                "depth": self.emeta.depth, "leaves": self._leaves,
                "num_class": self.emeta.num_class,
                "cols": self.emeta.num_cols, "half": self.emeta.half,
                "max_rows": self.max_rows(), "device": str(self.device)}


def check_additivity(phi: np.ndarray, raw: np.ndarray, num_cols: int,
                     rtol: float = ADDITIVITY_RTOL,
                     atol: float = ADDITIVITY_ATOL) -> None:
    """Enforce ``sum(phi block) == raw score`` per class; raises
    :class:`ExplainAdditivityError` with the worst row's numbers."""
    n = phi.shape[0]
    k = max(phi.shape[1] // num_cols, 1)
    sums = phi.reshape(n, k, num_cols).sum(axis=2)
    err = np.abs(sums - raw)
    lim = atol + rtol * np.abs(raw)
    if np.all(err <= lim):
        return
    i = int(np.unravel_index(np.argmax(err - lim), err.shape)[0])
    raise ExplainAdditivityError(
        f"phi rows do not sum to the raw score: worst row {i}: "
        f"sum={sums[i].tolist()} raw={raw[i].tolist()}")


def compile_explain(trees: List[Tree], num_class: int, num_features: int,
                    class_ids: Optional[List[int]] = None, *,
                    mode: str = "auto", num_cols: Optional[int] = None,
                    batch: Optional[TreeBatch] = None,
                    depth_budget: int = EXPLAIN_DEPTH_BUDGET,
                    table_budget: Optional[int] = None,
                    model_label: str = "", device=None,
                    ) -> Tuple[Optional[ExplainExecutable], Optional[str]]:
    """Compile the dense TreeSHAP program on ``device`` (default the
    CPU), or report why not (reference compiler.py:218-257).

    ``num_features`` is the inner (used-column) width the condition
    matrix reads; ``num_cols`` the phi block width (default
    ``num_features + 1``; Boosters pass their full feature count + 1 so
    the layout matches the host ``predict_contrib``).  ``table_budget``
    defaults to the reference's 256 MiB on the CPU and
    :data:`~.dense_shap.EXPLAIN_TABLE_BUDGET_CUDA` on the card.  Returns
    ``(executable, None)`` or ``(None, reason)`` with the reason counted
    in ``serve_explain_fallback``."""
    if mode not in ("auto", "dense", "walk"):
        raise ValueError(f"tpu_explain_compiler must be auto|dense|walk, "
                         f"got {mode!r}")
    if mode == "walk":
        _note_fallback("forced_walk", model_label)
        return None, "forced_walk"
    if not trees:
        _note_fallback("no_trees", model_label)
        return None, "no_trees"
    dev = torch.device(device) if device is not None else \
        torch.device("cpu")
    half = dev.type == "cuda"
    if table_budget is None:
        table_budget = EXPLAIN_TABLE_BUDGET_CUDA if half \
            else EXPLAIN_TABLE_BUDGET
    cols = num_features + 1 if num_cols is None else num_cols
    try:
        arrays, dmeta = lower_ensemble(
            trees, num_class, num_features, class_ids, leaf_bits=0,
            half=half, batch=batch, device=dev)
        exp, emeta = lower_explain(
            trees, num_class, cols, class_ids, half=half, batch=batch,
            depth_budget=depth_budget, table_budget=table_budget,
            device=dev)
    except DenseLoweringError as e:
        if mode == "dense":
            raise
        _note_fallback(e.reason, model_label)
        return None, e.reason
    return ExplainExecutable(arrays, dmeta, exp, emeta), None
