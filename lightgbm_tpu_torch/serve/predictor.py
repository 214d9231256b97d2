"""CompiledPredictor: a trained model held warm for low-latency inference.

Port of ``lightgbm_tpu/serve/predictor.py``.  Wraps a ``GBDT``,
``Booster``, model file or model text as the compiled dense program of
:mod:`.compiler` on the model's device (``cuda`` unless the model was
loaded for the CPU), or, where the compiler chose the walk, as the
per-class tree batches of :func:`..models.tree.predict_raw_ensemble`.
Request rows pad up the ``SHAPE_BUCKETS`` ladder, so arbitrary batch
sizes map to a handful of program shapes; ``warmup()`` runs every bucket
ahead of the first request.

The process-wide ``_COMPILE_KEYS`` set counts each (shape signature,
bucket) pair the first time any predictor dispatches it (the ``/stats``
recompile counter of the reference, which mirrors XLA's jit cache; the
port has no jit cache, so here it counts the distinct program shapes
served).  ``release_compile_keys`` drops a signature's entries when the
last model of that shape leaves a registry.  Each device call runs under
a ``serve/predict/b<bucket>`` span.

Threads: the HTTP handlers and the micro-batchers' dispatch threads all
call one predictor.  Every call runs under ``torch.cuda.device`` of the
predictor's card, on the default stream, and ends in a copy to the
host; a hot swap or an eviction that drops the last reference to a
table therefore never frees memory that a queued launch still reads
(the caching allocator hands a freed block only to later work on the
same stream).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..analysis.contracts import memory_budget
from ..models.tree import (SHAPE_BUCKETS, TreeBatch, bucket_rows,
                           ensemble_serve_fields, pad_rows,
                           predict_raw_ensemble)
from ..telemetry.trace import span
from .compiler import DenseExecutable, compile_ensemble
from .stats import ModelStats

__all__ = ["CompiledPredictor", "SHAPE_BUCKETS", "compile_key_count",
           "release_compile_keys", "serve_ladder_hbm_bytes"]


def serve_ladder_hbm_bytes(ctx):
    """Per-device memory curve of one serve-bucket program (reference
    :38-52): the padded request block with ~3 block-sized temporaries
    beside it, plus the resident ensemble tables (~16 B per tree-leaf)."""
    bucket = int(ctx.get("bucket", max(SHAPE_BUCKETS)))
    f = int(ctx["features"])
    it = int(ctx.get("itemsize", 4))
    trees = int(ctx.get("trees", 1000))
    leaves = int(ctx.get("leaves", 255))
    request = 4 * bucket * f * it
    model = 16 * trees * leaves
    return request + model + (1 << 20)


memory_budget("serve/bucket_ladder", ("serve",), serve_ladder_hbm_bytes,
              note="4 request-block temporaries + resident ensemble")

# (shape-signature, bucket) pairs already dispatched in this process
_COMPILE_KEYS: set = set()
_COMPILE_LOCK = threading.Lock()


def _note_dispatch(key) -> bool:
    """True when ``key`` is new to the process."""
    with _COMPILE_LOCK:
        if key in _COMPILE_KEYS:
            return False
        _COMPILE_KEYS.add(key)
        return True


def release_compile_keys(sig) -> int:
    """Drop every ``(sig, bucket)`` entry of one shape signature from the
    dispatch mirror (reference :74-85).  The registry calls this when the
    LAST model of a shape leaves it, so zoo churn cannot grow the mirror
    without bound.  Returns the entries removed."""
    with _COMPILE_LOCK:
        doomed = [k for k in _COMPILE_KEYS
                  if isinstance(k, tuple) and len(k) == 2 and k[0] == sig]
        for k in doomed:
            _COMPILE_KEYS.discard(k)
    return len(doomed)


def compile_key_count() -> int:
    """Current size of the process-wide dispatch mirror."""
    with _COMPILE_LOCK:
        return len(_COMPILE_KEYS)


def _resolve_gbdt(source, device=None):
    """Accept a Booster, a GBDT, a model file path, or a model string; a
    path or a string loads on ``device`` (``cuda`` unless the CPU is
    asked for), a Booster or GBDT keeps its own device."""
    from ..basic import Booster
    from ..models.gbdt import GBDT
    if isinstance(source, Booster):
        return source._gbdt
    if isinstance(source, GBDT):
        return source
    if isinstance(source, str):
        if "\n" in source:  # model TEXT always spans lines
            return Booster(model_str=source, device=device)._gbdt
        if not os.path.exists(source):
            raise FileNotFoundError(f"no such model file: {source}")
        return Booster(model_file=source, device=device)._gbdt
    raise TypeError(f"cannot build a predictor from {type(source).__name__}")


def _on_device(device):
    """``torch.cuda.device(device)`` for a card (a handler or dispatch
    thread starts on card 0), else a no-op context."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class CompiledPredictor:
    """Shape-bucketed compiled inference handle for one model version.

    Immutable once built (a hot swap replaces the whole object), so
    concurrent ``predict`` calls share its tables without a lock."""

    def __init__(self, source, num_iteration: Optional[int] = None,
                 buckets: Tuple[int, ...] = SHAPE_BUCKETS,
                 stats: Optional[ModelStats] = None,
                 compiler: Optional[str] = None,
                 leaf_bits: Optional[int] = None,
                 shard: Optional[int] = None,
                 explain_compiler: Optional[str] = None,
                 device=None) -> None:
        gbdt = _resolve_gbdt(source, device)
        self._gbdt = gbdt          # kept for delta appends (extended)
        self.device = gbdt.device
        self.buckets = tuple(sorted(buckets))
        self.stats = stats if stats is not None else ModelStats()
        self.objective = gbdt.objective
        self.num_class = k = gbdt.num_tree_per_iteration
        self.num_features = gbdt.feature_mapping()[1]
        models = gbdt.models
        self.num_trees = len(models) if num_iteration is None else min(
            len(models), num_iteration * k)
        # RF models predict the MEAN of tree outputs over the FULL model
        self._avg_div = (max(1, len(models) // k)
                         if getattr(gbdt, "name", "gbdt") == "rf" else 1)
        ts = gbdt.train_set
        self._used = (np.asarray(ts.used_feature_map)
                      if ts is not None else None)
        # routing: explicit kwargs, then the model's params, then the
        # defaults (auto, exact leaves, unsharded)
        cfg = getattr(gbdt, "config", None)
        self._compiler_mode = compiler if compiler is not None else \
            getattr(cfg, "tpu_predict_compiler", "auto")
        self._leaf_bits = leaf_bits if leaf_bits is not None else \
            int(getattr(cfg, "tpu_predict_leaf_bits", 0))
        self._shard = shard if shard is not None else \
            int(getattr(cfg, "tpu_predict_shard", 0))
        self._explain_mode = explain_compiler if explain_compiler is not None \
            else getattr(cfg, "tpu_explain_compiler", "auto")
        # the explain program compiles on the first explain() call: most
        # predictors never serve explanations
        self._explain_lock = threading.Lock()
        self._explain_state: Optional[tuple] = None
        self._dense: Optional[DenseExecutable] = None
        self._fallback_reason: Optional[str] = None
        self._per_class = None
        sel = [models[t] for t in range(self.num_trees)]
        if not sel or self.num_trees < k:
            raise ValueError("predictor needs at least one tree per class")
        self._dense, self._fallback_reason = compile_ensemble(
            sel, k, self._inner_width(),
            mode=self._compiler_mode, leaf_bits=self._leaf_bits,
            shard=self._shard,
            model_label=getattr(self.stats, "model", "") or "",
            device=self.device)
        if self._dense is not None:
            self._kinds = ("dense_compiled",)
            self._sig = self._dense.signature
            return
        per_class, kinds = [], []
        for c in range(k):
            selc = [models[t] for t in range(self.num_trees) if t % k == c]
            kind, batch, span = ensemble_serve_fields(
                TreeBatch(selc, self.device))
            kinds.append(kind)
            per_class.append((batch, span))
        self._per_class = tuple(per_class)
        self._kinds = tuple(kinds)
        self._sig = (self._kinds, tuple(
            (b.num_trees, b.max_leaves) for b, _ in per_class),
            self._inner_width())

    def _inner_width(self) -> int:
        return len(self._used) if self._used is not None \
            else self.num_features

    @property
    def signature(self) -> tuple:
        """The shape signature the dispatch mirror keys on: the dense
        executable's, or the walk kinds and tree-batch shapes."""
        return self._sig

    @property
    def group_key(self) -> str:
        """Short stable digest of :attr:`signature`."""
        import hashlib
        return hashlib.sha1(repr(self._sig).encode()).hexdigest()[:12]

    @property
    def stackable(self) -> bool:
        """Whether this predictor can join a cross-model stack: a dense
        program (a walk-path model never stacks)."""
        return self._dense is not None

    def _rows(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[1] != self.num_features:
            raise ValueError(
                f"request has {X.shape[1]} features; model expects "
                f"{self.num_features}")
        return X[:, self._used] if self._used is not None else X

    # -- core ---------------------------------------------------------------
    def predict_raw(self, X: np.ndarray,
                    request_ids: tuple = ()) -> np.ndarray:
        """Bucketed raw-score prediction: (N,) for single-class models,
        (N, k) for multiclass; equal to ``Booster.predict(raw_score=
        True)`` through the same program."""
        Xi = self._rows(X)
        n = Xi.shape[0]
        nb = bucket_rows(n, self.buckets)
        new = _note_dispatch((self._sig, nb))
        t0 = time.perf_counter()
        with _on_device(self.device), span(f"serve/predict/b{nb}"):
            Xp = torch.as_tensor(
                np.ascontiguousarray(pad_rows(Xi, self.buckets)),
                device=self.device)
            if self._dense is not None:
                out = self._dense.predict_raw(Xp)[:n].cpu().numpy()
            else:
                out = predict_raw_ensemble(Xp, self._per_class,
                                           self._kinds)[:n].cpu().numpy()
        self.stats.record_batch(n, nb, (time.perf_counter() - t0) * 1e3,
                                recompiled=new, request_ids=request_ids)
        if self._dense is None and self._fallback_reason:
            # the fallback rate in traffic: every batch a fallback-built
            # walk serves counts (compiler.py)
            from .compiler import note_fallback_batch
            note_fallback_batch(self._fallback_reason,
                                getattr(self.stats, "model", "") or "")
        if self._avg_div != 1:
            out = out / np.float32(self._avg_div)
        return out[:, 0] if self.num_class == 1 else out

    # -- explanation lane ---------------------------------------------------
    def _explain_program(self) -> tuple:
        """``(executable | None, fallback_reason | None)``, compiled on
        first use and kept for the predictor's lifetime."""
        st = self._explain_state
        if st is not None:
            return st
        with self._explain_lock:
            if self._explain_state is None:
                from ..explain.compiler import compile_explain
                models = self._gbdt.models
                sel = [models[t] for t in range(self.num_trees)]
                self._explain_state = compile_explain(
                    sel, self.num_class, self._inner_width(),
                    mode=self._explain_mode,
                    num_cols=self.num_features + 1,
                    model_label=getattr(self.stats, "model", "") or "",
                    device=self.device)
            return self._explain_state

    def explain(self, X: np.ndarray,
                request_ids: tuple = ()) -> np.ndarray:
        """Bucketed SHAP contributions ``(N, (num_features + 1) *
        num_class)``, the layout of ``Booster.predict(pred_contrib=True)``.
        The dense TreeSHAP program serves when it lowers. A model it does
        not lower (past its depth or table budget, or
        ``tpu_explain_compiler=walk``) is served by the float64 host walk,
        with the reason in ``serve_explain_fallback_batches_total``, as
        the reference does. A dense result that fails its additivity
        check raises :class:`ExplainAdditivityError`: the request fails,
        it is not answered by the walk (the reference falls back here)."""
        Xi = self._rows(X)
        nb = bucket_rows(Xi.shape[0], self.buckets)
        exe, reason = self._explain_program()
        if exe is not None:
            with _on_device(self.device), span(f"serve/explain/b{nb}"):
                return exe.explain(Xi, buckets=self.buckets)
        from ..explain.compiler import note_explain_fallback_batch
        note_explain_fallback_batch(reason or "unknown",
                                    getattr(self.stats, "model", "") or "")
        from ..models.shap import predict_contrib
        with span(f"serve/explain_walk/b{nb}"):
            return predict_contrib(self._gbdt, Xi, 0,
                                   self.num_trees // max(1, self.num_class))

    def predict(self, X: np.ndarray, raw_score: bool = False,
                request_ids: tuple = ()) -> np.ndarray:
        """Prediction through the objective's output transform (the
        ``Booster.predict`` contract without the special modes)."""
        raw = self.predict_raw(X, request_ids=request_ids)
        if raw_score or self.objective is None:
            return raw
        return self.convert_output(raw)

    def convert_output(self, raw: np.ndarray) -> np.ndarray:
        """The objective's output transform of host raw scores, on the
        predictor's device (the zoo applies it to a stacked lane)."""
        with _on_device(self.device):
            return self.objective.convert_output(
                torch.as_tensor(raw, device=self.device)).cpu().numpy()

    # -- delta append -------------------------------------------------------
    def extended(self, new_trees) -> Tuple["CompiledPredictor", str]:
        """A NEW predictor serving this model plus ``new_trees`` (appended
        rounds with real feature indices), and ``"extend"`` when the dense
        tables took them in place or ``"rebuild"`` when a full compile
        was needed (reference :300-349).  ``self`` is never mutated."""
        import copy as _copy
        new_trees = list(new_trees)
        if not new_trees:
            return self, "noop"
        if self._used is not None:
            # a train-set-attached model stores INNER feature indices;
            # appended trees carry real ones
            raise ValueError(
                "extended() needs a file/text-loaded predictor (real "
                "feature indices); this one is train-set-attached")
        g2 = _copy.copy(self._gbdt)
        g2.models = list(self._gbdt.models[:self.num_trees]) + new_trees
        g2.iter_ = len(g2.models) // max(1, self.num_class)
        if self._avg_div == 1 and self._dense is not None:
            ex = self._dense.extended(new_trees, self.num_features)
            if ex is not None:
                p2 = _copy.copy(self)
                p2._gbdt = g2
                p2._dense = ex
                p2.num_trees = self.num_trees + len(new_trees)
                p2._sig = ex.signature
                p2._explain_lock = threading.Lock()
                p2._explain_state = None
                return p2, "extend"
        p2 = CompiledPredictor(
            g2, buckets=self.buckets, stats=self.stats,
            compiler=self._compiler_mode, leaf_bits=self._leaf_bits,
            shard=self._shard, explain_compiler=self._explain_mode)
        return p2, "rebuild"

    # -- warmup -------------------------------------------------------------
    def warmup(self, buckets: Optional[Tuple[int, ...]] = None) -> int:
        """Run every shape bucket once ahead of the first request.
        Returns the number of (signature, bucket) pairs new to the
        process."""
        before = self.stats.snapshot()["recompiles"]
        for b in (buckets if buckets is not None else self.buckets):
            self.predict_raw(np.zeros((b, self.num_features), np.float32))
        return self.stats.snapshot()["recompiles"] - before

    def info(self) -> dict:
        out = {
            "num_trees": self.num_trees,
            "num_class": self.num_class,
            "num_features": self.num_features,
            "kinds": list(self._kinds),
            "buckets": list(self.buckets),
            "device": str(self.device),
            "compiler": "dense" if self._dense is not None else "walk",
            "compiler_mode": self._compiler_mode,
            "fallback_reason": self._fallback_reason,
            "group_key": self.group_key,
            "stackable": self.stackable,
            "explain_mode": self._explain_mode,
            "explain_compiler": (
                "lazy" if self._explain_state is None else
                "dense" if self._explain_state[0] is not None else "walk"),
            "explain_fallback_reason": (
                None if self._explain_state is None
                else self._explain_state[1]),
        }
        if self._dense is not None:
            out["dense"] = self._dense.info()
        if self._explain_state is not None and \
                self._explain_state[0] is not None:
            out["explain"] = self._explain_state[0].info()
        return out
