"""Inference compiler: lower a trained ensemble into one fused dense
program for serving.

Port of ``lightgbm_tpu/serve/compiler.py``.  :func:`compile_ensemble`
takes a model's trees and returns a :class:`DenseExecutable` (the
lowered tables of :mod:`..models.dense_predict` on the prediction
device) or the walk with a counted reason.  ``CompiledPredictor`` and
``Booster.predict`` both route through it behind
``tpu_predict_compiler=dense|walk|auto``:

* ``dense``: force the fused program; raise if the ensemble cannot lower
  (a table budget would blow);
* ``walk``: keep the sequential per-tree walk;
* ``auto``: dense whenever the ensemble lowers and the device profits.
  The reference decides by its JAX backend; the port by the device the
  tables would live on.  On ``cuda`` that is always dense, as the
  reference's accelerator is (reference :174-175); on the CPU the
  reference's cost model (:176-179) keeps the walk where it measured
  faster, so CPU runs choose what the reference chooses on its CPU.

A route away from dense is always one of the counted reasons
(``serve_compiler_fallback{reason}``: ``cpu_cost_model``, ``no_trees``,
the lowering budgets; ``forced_walk`` is returned, not counted, as in
the reference), never a silent change of device.

``tpu_predict_shard=W`` > 1 pads the tree axis to a multiple of W with
inert trees and runs the program on the predictor's one device: what
the reference does when it sees one device (reference :213-222, ``k =
min(shard, devices)``).  The padding is the envelope that
:meth:`DenseExecutable.extended` splices delta trees into without a new
program shape.  Splitting the tree axis over several cards is ROADMAP
queue 1 item 10.

Left out: the reference's program contracts (``analysis.contracts``
``memory_budget`` and ``collective_contract``), which come with the
contract checks (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..models.dense_predict import (DENSE_WORKSET_BUDGET, DenseArrays,
                                    DenseLoweringError, DenseMeta,
                                    dense_predict_leaf, dense_predict_raw,
                                    dense_row_bytes, dense_table_bytes,
                                    lower_ensemble, stack_dense_arrays,
                                    stacked_predict_raw)
from ..models.tree import TreeBatch
from ..telemetry.metrics import default_registry
from ..telemetry.slo import register_metric_ensurer, slo as _slo

__all__ = ["DenseExecutable", "StackedExecutable", "compile_ensemble",
           "DenseLoweringError", "dense_cost_model", "fallback_counts",
           "FALLBACK_COUNTER"]

# ---------------------------------------------------------------------------
# fallback telemetry: never a silent slow path
# ---------------------------------------------------------------------------

FALLBACK_COUNTER = "serve_compiler_fallback"
FALLBACK_BATCHES = "serve_fallback_batches_total"
_fb_lock = threading.Lock()
_fb_counts: Dict[str, int] = {}

# The fallback budget (reference :100-116): device batches served by a
# walk that a blown lowering budget forced, against all batches.
_slo("serve/compiler_fallback_rate", metric=FALLBACK_BATCHES,
     total_metric="serve_batches_total", kind="ratio", target=0.99,
     bad_labels={"reason": "*_budget"}, min_events=50,
     note="share of device batches served by budget-blown walk "
          "fallbacks")


def note_fallback_batch(reason: str, model: str) -> None:
    """One dispatched batch served by a fallback-built walk predictor
    (the predictor calls this per device call, so the fallback rate is
    measured in traffic, not in compiles)."""
    default_registry().counter(
        FALLBACK_BATCHES,
        "device batches served by a dense-compiler fallback, by reason",
        labels=("reason", "model")).inc(1, reason=reason,
                                        model=model or "-")


@register_metric_ensurer
def _ensure_fallback_metric(reg) -> None:
    reg.counter(FALLBACK_COUNTER,
                "auto-mode dense-compiler fallbacks to the sequential "
                "walk, by reason", labels=("reason", "model"))
    reg.counter(FALLBACK_BATCHES,
                "device batches served by a dense-compiler fallback, "
                "by reason", labels=("reason", "model"))


def _note_fallback(reason: str, model: str = "") -> None:
    with _fb_lock:
        _fb_counts[reason] = _fb_counts.get(reason, 0) + 1
    default_registry().counter(
        FALLBACK_COUNTER,
        "auto-mode dense-compiler fallbacks to the sequential walk, "
        "by reason", labels=("reason", "model")).inc(
        reason=reason, model=model or "-")


def fallback_counts() -> Dict[str, int]:
    """Process-wide auto-fallback tally by reason (mirrors the labeled
    ``serve_compiler_fallback`` counter series)."""
    with _fb_lock:
        return dict(_fb_counts)


# ---------------------------------------------------------------------------
# the device's cost model for auto mode
# ---------------------------------------------------------------------------

def dense_cost_model(num_trees: int, max_leaves: int, max_depth: int,
                     device_type: str = "cpu") -> bool:
    """True when the fused dense program should beat the sequential walk
    on this device (reference :162-179).  On the card always: a row
    walk is a chain of small gathers and launches.  On the CPU the
    walk's gathers run near memory speed while the dense program pays
    O(T * Nn * L) work per row, so dense wins only when that is small
    next to the walk's depth loop (the reference's constants)."""
    if device_type == "cuda":
        return True
    nn = max(max_leaves - 1, 1)
    dense_units = num_trees * nn * (2 + max_leaves)
    walk_units = num_trees * (max_depth + 1) * 24
    return dense_units < walk_units


def _max_depth(batch: TreeBatch) -> int:
    """Deepest real leaf across the ensemble (from the path lengths)."""
    pt = np.asarray(batch.plen_total)
    real = pt < 1e8
    return int(pt[real].max()) if real.any() else 0


# ---------------------------------------------------------------------------
# the executable
# ---------------------------------------------------------------------------

class DenseExecutable:
    """One compiled-dense model version: the lowered tables on the
    prediction device, run over row blocks of at most :attr:`max_rows`
    rows (:data:`~..models.dense_predict.DENSE_WORKSET_BUDGET` over
    :func:`~..models.dense_predict.dense_row_bytes`).

    Immutable once built.  ``real_trees`` tracks the live tree count
    apart from ``meta.num_trees`` so :meth:`extended` can splice appended
    trees into the shard padding's spare tree rows; tables lowered
    without padding have none, so an extension asks for a rebuild, as
    the reference's do."""

    def __init__(self, arrays: DenseArrays, meta: DenseMeta,
                 workset_budget: int = DENSE_WORKSET_BUDGET) -> None:
        self.meta = meta
        self.arrays = arrays
        self.real_trees = meta.num_trees
        self.shard = 0
        self.table_bytes = dense_table_bytes(arrays)
        self.max_rows = max(1, int(workset_budget) //
                            max(dense_row_bytes(arrays, meta), 1))

    @property
    def device(self) -> torch.device:
        return self.arrays.path_dir.device

    @property
    def signature(self) -> tuple:
        """Shape/dtype signature of the tables (the compile-key mirror
        of the serving stats counts per (signature, bucket))."""
        return ("dense", self.meta, self.shard,
                tuple((tuple(a.shape), str(a.dtype)) for a in self.arrays
                      if a is not None))

    def _blocks(self, X, fn) -> torch.Tensor:
        X = torch.as_tensor(np.asarray(X, np.float32)) \
            if not isinstance(X, torch.Tensor) else X
        X = X.to(self.device, torch.float32)
        n = X.shape[0]
        if n <= self.max_rows:
            return fn(X, self.arrays, self.meta)
        return torch.cat([fn(X[lo:lo + self.max_rows], self.arrays,
                             self.meta)
                          for lo in range(0, n, self.max_rows)], dim=0)

    def predict_raw(self, Xp) -> torch.Tensor:
        """(N, num_class) raw scores of a row block."""
        return self._blocks(Xp, dense_predict_raw)

    def predict_leaf(self, Xp) -> torch.Tensor:
        """(N, num_trees) leaf indices."""
        return self._blocks(Xp, dense_predict_leaf)[:, :self.real_trees]

    @property
    def capacity(self) -> int:
        """Tree rows in the lowered tables: the envelope of
        :meth:`extended`."""
        return int(self.arrays.path_dir.shape[0])

    def extended(self, new_trees: List[Any], num_features: int
                 ) -> Optional["DenseExecutable"]:
        """Splice ``new_trees`` into spare tree rows (reference
        :284-362): a NEW executable with the same ``meta``, or ``None``
        when an in-place extension cannot stay exact (the envelope is
        exhausted, the new trees are wider or deeper than the tables, or
        they need table kinds the lowering did not build).  ``None``
        means "rebuild", never an approximation."""
        n = len(new_trees)
        if n == 0:
            return self
        r = self.real_trees
        if r + n > self.capacity:
            return None
        meta = self.meta
        class_ids = [(r + i) % meta.num_class for i in range(n)]
        try:
            na, nm = lower_ensemble(
                new_trees, meta.num_class, num_features, class_ids,
                leaf_bits=meta.leaf_bits, half=meta.half)
        except DenseLoweringError:
            return None
        if nm.has_cat:
            return None
        if nm.has_linear and not meta.has_linear:
            return None
        host = DenseArrays(*[None if a is None else a.cpu().numpy()
                             for a in self.arrays])
        Nn = host.split_feature.shape[1]
        L = host.qthresh.shape[1]
        if int(na.split_feature.shape[1]) > Nn or \
                int(na.qthresh.shape[1]) > L:
            return None

        def _pad(a, shape, fill=0.0):
            a = a.cpu().numpy()
            out = np.full(shape, fill, dtype=a.dtype)
            out[tuple(slice(0, s) for s in a.shape)] = a
            return out

        vals = {k: None if v is None else np.array(v, copy=True)
                for k, v in host._asdict().items()}
        vals["split_feature"][r:r + n] = _pad(na.split_feature, (n, Nn))
        vals["threshold"][r:r + n] = _pad(na.threshold, (n, Nn))
        vals["dleft"][r:r + n] = _pad(na.dleft, (n, Nn))
        vals["miss_nan"][r:r + n] = _pad(na.miss_nan, (n, Nn))
        vals["is_cat"][r:r + n] = _pad(na.is_cat, (n, Nn))
        vals["path_dir"][r:r + n] = _pad(na.path_dir, (n, Nn, L))
        # unreal leaf slots keep the 1e9 sentinel so they never hit
        vals["qthresh"][r:r + n] = _pad(na.qthresh, (n, L),
                                        fill=np.float32(1e9))
        vals["leaf_codes"][r:r + n] = _pad(na.leaf_codes, (n, L))
        vals["leaf_scale"][r:r + n] = na.leaf_scale.cpu().numpy()
        vals["class_onehot"][r:r + n] = na.class_onehot.cpu().numpy()
        if meta.has_cat:
            vals["node_cat_slot"][r:r + n] = 0
        if meta.has_linear:
            if nm.has_linear:
                F = vals["lin_w"].shape[2]
                vals["lin_w"][r:r + n] = _pad(na.lin_w, (n, L, F))
                vals["lin_mask"][r:r + n] = _pad(na.lin_mask, (n, L, F))
                vals["lin_const"][r:r + n] = _pad(na.lin_const, (n, L))
                vals["lin_flag"][r:r + n] = na.lin_flag.cpu().numpy()
            else:
                for k in ("lin_w", "lin_mask", "lin_const", "lin_flag"):
                    vals[k][r:r + n] = 0.0
        dev = self.device
        ex = DenseExecutable(DenseArrays(**{
            k: None if v is None else torch.as_tensor(v, device=dev)
            for k, v in vals.items()}), meta)
        ex.real_trees = r + n
        return ex

    def info(self) -> Dict[str, Any]:
        return {
            "mode": "dense",
            "num_trees": self.real_trees,
            "num_class": self.meta.num_class,
            "capacity": self.capacity,
            "has_cat": self.meta.has_cat,
            "has_linear": self.meta.has_linear,
            "leaf_bits": self.meta.leaf_bits,
            "half": self.meta.half,
            "shard": self.shard,
            "table_bytes": self.table_bytes,
            "max_rows": self.max_rows,
            "device": str(self.device),
        }


class StackedExecutable:
    """M same-signature :class:`DenseExecutable`\\ s on a leading model
    axis (reference :375-459): ``predict_raw`` takes an (M, N, F) block
    and returns (M, N, K), each lane its member's solo result.  The zoo
    (``serve/zoo.py``) groups same-signature tenants into stacks."""

    def __init__(self, names: List[str],
                 exes: List["DenseExecutable"]) -> None:
        if len(names) != len(exes) or not exes:
            raise ValueError("stack needs one name per executable")
        sig = exes[0].signature
        for e in exes[1:]:
            if e.signature != sig:
                raise ValueError("stack members must share one signature")
        self.names = tuple(names)
        self.meta = exes[0].meta
        self.member_sig = sig
        self.stacked = stack_dense_arrays([e.arrays for e in exes])

    @property
    def device(self) -> torch.device:
        return self.stacked.path_dir.device

    @property
    def width(self) -> int:
        return len(self.names)

    @property
    def signature(self) -> tuple:
        return ("zoo_stack", self.width, self.member_sig)

    def lane(self, name: str) -> int:
        return self.names.index(name)

    def predict_raw(self, Xs) -> torch.Tensor:
        """(M, N, K) raw scores for an (M, N, F) lane block."""
        return stacked_predict_raw(Xs, self.stacked, self.meta)

    def splice(self, name: str, exe: "DenseExecutable"
               ) -> "StackedExecutable":
        """A NEW stack with ``name``'s lane replaced by ``exe``'s tables
        (same signature required)."""
        if exe.signature != self.member_sig:
            raise ValueError("spliced member changed signature; "
                             "rebuild the stack")
        i = self.lane(name)
        out = StackedExecutable.__new__(StackedExecutable)
        out.names = self.names
        out.meta = self.meta
        out.member_sig = self.member_sig
        vals = []
        for S, a in zip(self.stacked, exe.arrays):
            if S is None:
                vals.append(None)
            else:
                S = S.clone()
                S[i] = a
                vals.append(S)
        out.stacked = DenseArrays(*vals)
        return out

    def info(self) -> Dict[str, Any]:
        return {"mode": "zoo_stack", "width": self.width,
                "members": list(self.names),
                "num_class": self.meta.num_class,
                "leaf_bits": self.meta.leaf_bits}


def compile_ensemble(trees: List[Any], num_class: int, num_features: int,
                     class_ids: Optional[List[int]] = None, *,
                     mode: str = "auto", leaf_bits: int = 0,
                     shard: int = 0, batch: Optional[TreeBatch] = None,
                     model_label: str = "", device=None
                     ) -> Tuple[Optional[DenseExecutable], Optional[str]]:
    """Compile ``trees`` into a :class:`DenseExecutable` on ``device``
    (default the CPU), or decide the walk and say why (reference
    :432-471).

    Returns ``(executable, None)`` on a dense lowering and ``(None,
    reason)`` on the walk.  ``mode='dense'`` raises
    :class:`DenseLoweringError` instead of falling back; auto-mode
    fallbacks bump ``serve_compiler_fallback{reason}``."""
    if mode not in ("auto", "dense", "walk"):
        raise ValueError(f"tpu_predict_compiler must be auto|dense|walk, "
                         f"got '{mode}'")
    if mode == "walk":
        return None, "forced_walk"
    if not trees:
        if mode == "dense":
            raise DenseLoweringError("no_trees")
        _note_fallback("no_trees", model_label)
        return None, "no_trees"
    dev = torch.device(device) if device is not None else \
        torch.device("cpu")
    b = batch if batch is not None else TreeBatch(trees)
    if mode == "auto" and not dense_cost_model(
            b.num_trees, b.max_leaves, _max_depth(b), dev.type):
        _note_fallback("cpu_cost_model", model_label)
        return None, "cpu_cost_model"
    try:
        arrays, meta = lower_ensemble(
            trees, num_class, num_features, class_ids,
            leaf_bits=leaf_bits, half=(dev.type == "cuda"),
            shard=max(1, int(shard or 0)), batch=b, device=dev)
    except DenseLoweringError as exc:
        if mode == "dense":
            raise
        _note_fallback(exc.reason, model_label)
        return None, exc.reason
    return DenseExecutable(arrays, meta), None
