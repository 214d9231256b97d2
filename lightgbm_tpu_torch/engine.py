"""Training and cross-validation entry points.

Port of ``lightgbm_tpu/engine.py``: ``train`` (reference engine.py:145),
continued training from ``init_model``, custom objectives and metrics
(``fobj``, ``feval``) and fault tolerance; and ``cv`` with ``CVBooster``,
``CVAggregator`` and ``_make_n_folds`` (reference engine.py:400-590),
whose folds train as one batch (multitrain/cv.py) when ``tpu_cv_many``
and the configuration allow it.  A ``StreamedDataset`` under
``tpu_ingest_mode=chunked`` trains out of core through
``ingest.train_streamed`` (reference engine.py:174-197).  Training runs
on ``device`` (default ``cuda``); when no card is usable and the CPU was
not asked for, it raises.

Fault tolerance (reference engine.py:40-145, :245-400): with
``snapshot_freq > 0`` (or ``checkpoint_dir`` set) the loop writes the
reference's ``output_model.snapshot_iter_N`` model text every
``snapshot_freq`` rounds and flushes a full-state checkpoint bundle
through :mod:`.resilience.checkpoint` (atomic, a bounded ring with a
``LATEST`` pointer, the reference's on-disk format); ``train(...,
resume_from=...)`` or ``resume=latest`` continues a preempted run
bit-identically.  While checkpointing is on, a SIGTERM or SIGINT drains
the iteration in flight, flushes one final bundle and raises
:class:`TrainingPreempted`.

The continuous-learning lane (reference engine.py:258-263, :372-393):
with ``publish_dir`` set, every ``publish_every`` rounds (and on the
drain path and at completion) the new trees go into a delta journal
(:mod:`.publish`) whose head is always what ``save_model`` would write.
The flight recorder's tape (``telemetry/flight.py``) is dumped as
``flight.jsonl`` into ``flight_dir`` (else next to the checkpoints) on a
crash or a preemption, and into an explicit ``flight_dir`` on success
too.  The chaos layer's training fault points
(``resilience/faults.py``) fire entering each iteration.
"""

from __future__ import annotations

import collections
import copy
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np

from .basic import Booster, device_from
from .callback import (CallbackEnv, EarlyStopException, early_stopping,
                       print_evaluation)
from .config import Config
from .dataset import Dataset
from .resilience.checkpoint import (CKPT_SOFT_KEYS, CKPT_STRUCTURAL_KEYS,
                                    Checkpoint, CheckpointError,
                                    CheckpointManager, PreemptionGuard,
                                    TrainingPreempted, load_checkpoint,
                                    resolve_checkpoint)
from .resilience.faults import faults
from .telemetry.metrics import default_registry
from .utils.log import log_info, log_warning
from .utils.random import rng_checkpoint_state

__all__ = ["train", "cv", "CVBooster", "CVAggregator"]

# params whose drift across a resume either breaks the continuation or
# its bit-identity; recorded into every checkpoint bundle
_CKPT_PARAM_KEYS = CKPT_STRUCTURAL_KEYS + CKPT_SOFT_KEYS


def reject_publishing(cfg: Config, context: str,
                      flight_lane: bool = False) -> None:
    """Refuse the continuous-learning parameters in an entry point that,
    as the reference's, has no publish lane (``cv``, ``train_many``,
    ``train_streamed``), and ``flight_dir`` where it has no flight
    recorder either (``flight_lane=False``): never train silently
    without what the parameters asked for."""
    offending = [k for k, v in (
        ("publish_dir", str(cfg.publish_dir or "")),
        ("publish_every", int(cfg.publish_every) != 0),
        ("flight_dir", not flight_lane and str(cfg.flight_dir or "")),
    ) if v]
    if offending:
        raise NotImplementedError(
            f"{', '.join(offending)} in {context}: the reference's "
            f"{context} has no publish lane"
            + ("" if flight_lane else " or flight recorder")
            + "; set them on train()")


def _resolve_resume(cfg: Config, ckpt_dir: str):
    """Map config's ``resume`` param to a checkpoint path.  ``latest`` is
    cold-start friendly: an empty or absent checkpoint dir means "first
    run of this job", not an error (reference engine.py:48-65)."""
    want = str(cfg.resume).strip()
    if not want:
        return None
    if want.lower() in ("latest", "auto", "true", "1"):
        if not ckpt_dir:
            raise ValueError("resume=latest needs snapshot_freq>0 or "
                             "checkpoint_dir to locate checkpoints")
        path = resolve_checkpoint(ckpt_dir)
        if path is None:
            log_info(f"resume=latest: no checkpoint in {ckpt_dir} yet; "
                     "starting fresh")
        return path
    return want


def _capture(booster: Booster, train_set: Dataset, cfg: Config,
             callbacks_after: List[Callable],
             history: Dict[str, Dict[str, List[float]]]) -> Checkpoint:
    """Bundle the full boosting state at the current iteration boundary,
    after the iteration's eval callbacks ran (reference engine.py:68)."""
    g = booster._gbdt
    arrays = g.capture_checkpoint_arrays()
    return Checkpoint(
        iteration=int(g.iter_),
        model_text=booster.model_to_string(),
        score=arrays["score"],
        valid_names=arrays["valid_names"],
        valid_scores=arrays["valid_scores"],
        eval_history=copy.deepcopy(history),
        early_stop=[cb.state_dict() for cb in callbacks_after
                    if hasattr(cb, "state_dict")],
        rng_state=rng_checkpoint_state(cfg),
        fingerprint=train_set.fingerprint(),
        params={k: getattr(cfg, k) for k in _CKPT_PARAM_KEYS},
        cegb_used=arrays["cegb_used"],
        prev_iter_leaves=arrays["prev_iter_leaves"],
    )


def _restore(ckpt: Checkpoint, booster: Booster, train_set: Dataset,
             cfg: Config, callbacks_after: List[Callable]) -> int:
    """Continue from a bundle: validate it, restore the boosting state and
    the callbacks' bookkeeping, return the first iteration to run
    (reference engine.py:94-142)."""
    ckpt.validate_config(cfg)
    ckpt.validate_dataset(train_set)
    g = booster._gbdt
    names_now = [name for name, _ in g.valid_sets]
    if list(ckpt.valid_names) != names_now:
        raise CheckpointError(
            f"checkpoint tracked valid sets {list(ckpt.valid_names)} but "
            f"this run registered {names_now}; resume with the same "
            f"valid_sets/valid_names to continue the eval streams")
    g.restore_boosting_state(ckpt.model_text, ckpt.iteration, ckpt.score,
                             ckpt.valid_scores, ckpt.cegb_used,
                             ckpt.prev_iter_leaves)
    stoppers = [cb for cb in callbacks_after if hasattr(cb, "load_state_dict")]
    if ckpt.early_stop and stoppers and \
            len(stoppers) != len(ckpt.early_stop):
        raise CheckpointError(
            f"checkpoint carries {len(ckpt.early_stop)} early-stopping "
            f"states but this run registered {len(stoppers)} early-stopping "
            f"callbacks; resume with the same callbacks to keep the "
            f"continuation bit-identical")
    for cb, state in zip(stoppers, ckpt.early_stop):
        # a knob that steers the stop decision must match the saved run
        for key, label in (("rounds", "stopping_rounds"),
                           ("first_metric_only", "first_metric_only")):
            saved = state.get(key)
            now = getattr(cb, key, None)
            if saved is not None and now is not None and saved != now:
                raise CheckpointError(
                    f"checkpoint early-stopping {label} is {saved} but "
                    f"this run registered {label}={now}; resume with the "
                    f"same early-stopping configuration to keep the "
                    f"continuation bit-identical")
        cb.load_state_dict(state)
    if ckpt.early_stop and not stoppers and any(
            s.get("trackers") for s in ckpt.early_stop):
        log_warning("checkpoint carries early-stopping state but this run "
                    "has no early-stopping callback; patience restarts")
    for cb in callbacks_after:
        er = getattr(cb, "eval_result", None)
        if isinstance(er, dict):
            er.clear()
            er.update(copy.deepcopy(ckpt.eval_history))
    default_registry().counter(
        "resume_total", "training runs continued from a checkpoint").inc()
    log_info(f"resuming training from iteration {ckpt.iteration} "
             f"({len(g.models)} trees restored)")
    return int(ckpt.iteration)


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj: Optional[Callable] = None,
          feval: Optional[Callable] = None,
          init_model=None, callbacks: Optional[List[Callable]] = None,
          resume_from: Optional[Union[str, Checkpoint]] = None,
          device=None, **kwargs) -> Booster:
    """Train a boosted model (reference engine.py:145-400).
    ``init_model`` (a Booster or a model file) continues training: its
    trees stay in the returned model, as the reference's ``init_model``
    keeps them.  ``fobj(preds, train_set) -> (grad, hess)`` replaces the
    objective (it gets the raw scores as host numpy); ``feval(preds,
    dataset) -> (name, value, higher_is_better)`` adds a metric on the
    training set and every valid set.  ``resume_from`` continues a
    checkpointed run (a bundle path, a checkpoint directory, or a loaded
    :class:`Checkpoint`); with the same data, params and seeds the result
    is bit-identical to a run that never stopped."""
    params = dict(params or {})
    params.update(kwargs)
    dev = device_from(params, device)
    cfg = Config(params)
    if any(k in params for k in ("num_iterations", "num_iteration",
                                 "n_iter", "num_boost_round", "num_round",
                                 "num_rounds", "num_trees", "num_tree",
                                 "n_estimators")):
        num_boost_round = cfg.num_iterations
    if getattr(train_set, "is_streamed", False) and \
            str(cfg.tpu_ingest_mode) == "chunked":
        # the out-of-core route (reference engine.py:174-197): a
        # StreamedDataset under tpu_ingest_mode=chunked trains through
        # chunk-accumulated wave histograms (ingest/train.py), device
        # memory bounded by the chunk budget, not by rows; the default
        # "hbm" mode falls through, the binned cache uploading once
        from .ingest.train import train_streamed
        unsupported = [nm for nm, v in (
            ("fobj", fobj), ("feval", feval),
            ("init_model", init_model), ("callbacks", callbacks)) if v]
        if unsupported:
            raise ValueError(
                "tpu_ingest_mode=chunked training does not support "
                + ", ".join(unsupported) +
                " yet; drop them or use tpu_ingest_mode=hbm")
        if isinstance(resume_from, Checkpoint):
            raise ValueError("tpu_ingest_mode=chunked resume takes a "
                             "bundle/directory path, not a loaded "
                             "Checkpoint object")
        return train_streamed(params, train_set, num_boost_round,
                              valid_sets=valid_sets,
                              valid_names=valid_names,
                              resume_from=(str(resume_from)
                                           if resume_from else None),
                              device=dev)
    if fobj is not None:
        params["objective"] = "none"
    booster = Booster(params=params, train_set=train_set, device=dev)
    if init_model is not None:
        init_bst = init_model if isinstance(init_model, Booster) else \
            Booster(model_file=str(init_model), params=params, device=dev)
        booster._gbdt.init_from_model(init_bst._gbdt)
    if valid_sets is not None:
        if not isinstance(valid_sets, (list, tuple)):
            valid_sets = [valid_sets]
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                booster._gbdt.config = booster.config.update(
                    {"is_provide_training_metric": True})
                from .metric import create_metrics
                booster._gbdt.train_metrics = create_metrics(
                    booster._gbdt.config)
                for m in booster._gbdt.train_metrics:
                    m.init(train_set.metadata, train_set.num_data())
                continue
            name = (valid_names[i] if valid_names is not None and
                    i < len(valid_names) else f"valid_{i}")
            booster.add_valid(vs, name)

    callbacks = list(callbacks or [])
    cfg2 = booster.config
    if cfg2.verbosity >= 1 and cfg2.metric_freq > 0:
        callbacks.append(print_evaluation(cfg2.metric_freq))
    if cfg2.early_stopping_round and cfg2.early_stopping_round > 0:
        callbacks.append(early_stopping(cfg2.early_stopping_round,
                                        cfg2.first_metric_only,
                                        verbose=cfg2.verbosity >= 1))
    before = sorted((cb for cb in callbacks
                     if getattr(cb, "before_iteration", False)),
                    key=lambda cb: getattr(cb, "order", 0))
    after = sorted((cb for cb in callbacks
                    if not getattr(cb, "before_iteration", False)),
                   key=lambda cb: getattr(cb, "order", 0))

    # -- fault tolerance (reference engine.py:245-257) ------------------------
    ckpt_dir = str(cfg2.checkpoint_dir or "")
    snap_freq = int(cfg2.snapshot_freq)
    if not ckpt_dir and snap_freq > 0:
        ckpt_dir = f"{cfg2.output_model}.ckpt"
    if ckpt_dir and snap_freq <= 0:
        # an explicit checkpoint_dir without a cadence: ~100 bundles a
        # run (a bundle holds the whole model so far, so flushing every
        # iteration of a long run would make checkpoint cost quadratic)
        snap_freq = max(1, num_boost_round // 100)
    manager = CheckpointManager(ckpt_dir, keep=int(cfg2.checkpoint_keep)) \
        if ckpt_dir else None

    # -- the continuous-learning lane (reference engine.py:258-263) ----------
    publisher = None
    if str(cfg2.publish_dir):
        from .publish.publisher import DeltaPublisher
        publisher = DeltaPublisher(str(cfg2.publish_dir),
                                   every=int(cfg2.publish_every) or 1)

    if resume_from is None and cfg2.resume:
        resume_from = _resolve_resume(cfg2, ckpt_dir)
    ckpt: Optional[Checkpoint] = None
    if isinstance(resume_from, Checkpoint):
        ckpt = resume_from
    elif resume_from:
        ckpt = load_checkpoint(str(resume_from))
    start_iter = 0
    # the engine's own eval history: bundles carry it even when the user
    # registered no record_evaluation callback
    run_history: Dict[str, Dict[str, List[float]]] = {}
    if ckpt is not None:
        if init_model is not None:
            raise CheckpointError(
                "both init_model and resume_from given: a checkpoint "
                "restore replaces the whole model, which would silently "
                "drop the init_model trees; continue from the checkpoint "
                "alone, or start a fresh run from init_model")
        start_iter = _restore(ckpt, booster, train_set, cfg2, after)
        run_history = copy.deepcopy(ckpt.eval_history)

    def _flush(final: bool = False) -> Optional[str]:
        if manager is None:
            return None
        path = manager.save(_capture(booster, train_set, cfg2, after,
                                     run_history))
        if final:
            log_info(f"final checkpoint flushed to {path}")
        return path

    def _flight_dump(reason: str) -> Optional[str]:
        """The flight tape next to the checkpoints, or into an explicit
        ``flight_dir`` (reference engine.py:298-317); called after the
        final checkpoint flush, so the tape's last event and the bundle
        land on the same iteration boundary."""
        return dump_flight(booster._gbdt.flight,
                           str(cfg2.flight_dir) or ckpt_dir, reason)

    # the guard turns a SIGTERM/SIGINT into a drain-and-flush exit; it is
    # installed only while checkpointing is on, so a plain Ctrl-C on an
    # uncheckpointed run stays KeyboardInterrupt
    try:
        with PreemptionGuard(enabled=manager is not None) as guard:
            for it in range(start_iter, num_boost_round):
                faults.check_train_iter(it)   # the chaos layer
                for cb in before:
                    cb(CallbackEnv(booster, params, it, 0, num_boost_round,
                                   None))
                if booster.update(fobj=fobj):
                    break
                if cfg2.snapshot_freq > 0 and \
                        (it + 1) % cfg2.snapshot_freq == 0:
                    # the reference's model-text snapshot
                    # (gbdt.cpp:277-281), written atomically
                    booster.save_model(
                        f"{cfg2.output_model}.snapshot_iter_{it + 1}")
                results = []
                if booster._gbdt.train_metrics or \
                        booster._gbdt.valid_sets or feval:
                    results = booster.eval_train(feval) + \
                        booster.eval_valid(feval)
                booster._gbdt.flight.note_eval(it + 1, results)
                if manager is not None:
                    for data_name, eval_name, value, _ in results:
                        run_history.setdefault(data_name, {}).setdefault(
                            eval_name, []).append(value)
                try:
                    for cb in after:
                        cb(CallbackEnv(booster, params, it, 0,
                                       num_boost_round, results))
                except EarlyStopException as e:
                    booster.best_iteration = e.best_iteration + 1
                    for ds_name, eval_name, score, _ in e.best_score:
                        booster.best_score.setdefault(
                            ds_name, {})[eval_name] = score
                    _flush()
                    break
                # the bundle flushes AFTER the iteration's eval callbacks,
                # so eval history and early-stop bookkeeping restore to
                # the same boundary
                if manager is not None and (it + 1) % snap_freq == 0:
                    _flush()
                if publisher is not None:
                    publisher.maybe_publish(booster._gbdt, it + 1)
                if guard.fired is not None:
                    final_path = _flush(final=True)
                    if publisher is not None:
                        # the journal head lands on the final bundle's
                        # iteration boundary
                        publisher.publish(booster._gbdt)
                    _flight_dump("preempted")
                    raise TrainingPreempted(guard.fired, booster=booster,
                                            checkpoint=final_path)
    except TrainingPreempted:
        raise                      # the tape was dumped above
    except (Exception, KeyboardInterrupt):
        # an uncaught training error (injected faults too): leave the
        # post-mortem tape next to the checkpoints
        _flight_dump("crash")
        raise
    if publisher is not None:
        # completion flush: an early stop or a no-split break leaves
        # off-cadence rounds unpublished; the journal head must equal the
        # final model
        publisher.publish(booster._gbdt)
    if str(cfg2.flight_dir):
        # an explicit flight_dir asks for the tape on success too
        _flight_dump("completed")
    return booster


def dump_flight(flight, out_dir: str, reason: str) -> Optional[str]:
    """Write ``flight`` as ``<out_dir>/flight.jsonl``; None when the
    recorder is off or empty or there is no directory, or the write
    failed (logged: a post-mortem must not mask the error it records)."""
    import os
    if flight is None or not flight.enabled or len(flight) == 0 or \
            not out_dir:
        return None
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = flight.dump(os.path.join(out_dir, "flight.jsonl"),
                           reason=reason)
    except OSError as exc:
        log_warning(f"flight recorder dump failed: {exc}")
        return None
    log_info(f"flight recorder: {len(flight)} events dumped to {path} "
             f"({reason})")
    return path


class CVBooster:
    """Container of per-fold boosters (reference engine.py:400)."""

    def __init__(self) -> None:
        self.boosters: List[Booster] = []
        self.best_iteration = -1

    def append(self, booster: Booster) -> None:
        self.boosters.append(booster)

    def __getattr__(self, name):
        def handler(*args, **kwargs):
            return [getattr(b, name)(*args, **kwargs) for b in self.boosters]
        return handler


class CVAggregator:
    """Per-iteration fold-metric aggregation and aggregated early stopping,
    shared by ``cv``'s fold loop and the batched fast path
    (multitrain/cv.py) so the two cannot fork semantics (reference
    engine.py:417-475).  Early stopping tracks VALIDATION metrics only;
    ``first_metric_only`` restricts it to the first; it stops as soon as
    any tracked metric stalls ``early_stopping_round`` rounds."""

    def __init__(self, cfg: Config, num_boost_round: int) -> None:
        self._es_round = cfg.early_stopping_round
        self._first_only = bool(cfg.first_metric_only)
        self.results: Dict[str, List[float]] = collections.defaultdict(list)
        self.best_iter = num_boost_round
        self.stopped = False
        self._best_signed: Dict[str, float] = {}
        self._best_it: Dict[str, int] = {}

    def update(self, it: int, agg: Dict[str, List[float]],
               hib_map: Dict[str, bool]) -> bool:
        """Fold one iteration's per-fold metric lists in; True = stop."""
        es_keys = [k for k in agg if not k.startswith("train ")]
        if self._first_only and es_keys:
            es_keys = es_keys[:1]
        for key, vals in agg.items():
            self.results[f"{key}-mean"].append(float(np.mean(vals)))
            self.results[f"{key}-stdv"].append(float(np.std(vals)))
            if key not in es_keys:
                continue
            cur = float(np.mean(vals))
            signed = -cur if hib_map.get(key, False) else cur
            if key not in self._best_signed or signed < self._best_signed[key]:
                self._best_signed[key] = signed
                self._best_it[key] = it + 1
        if self._es_round and self._es_round > 0:
            for key in es_keys:
                if it + 1 - self._best_it.get(key, it + 1) >= self._es_round:
                    self.stopped = True
                    self.best_iter = self._best_it[key]
                    break
        return self.stopped

    def finalize(self, cvbooster: CVBooster) -> Dict[str, List[float]]:
        """Truncated results dict; stamps best_iteration when stopped."""
        out = dict(self.results)
        if self.stopped:
            for k in out:
                out[k] = out[k][:self.best_iter]
            cvbooster.best_iteration = self.best_iter
        return out


def _make_n_folds(full_data: Dataset, nfold: int, params: Dict[str, Any],
                  seed: int, stratified: bool, shuffle: bool):
    """(train_idx, test_idx) of each fold (reference engine.py:478-520):
    query-aware for ranking, stratified by label, or shuffled."""
    full_data.construct(Config(params))
    num_data = full_data.num_data()
    rng = np.random.RandomState(seed)
    label = full_data.get_label()
    group = full_data.metadata.group
    if group is not None:
        qb = full_data.metadata.query_boundaries
        nq = len(group)
        q_order = rng.permutation(nq) if shuffle else np.arange(nq)
        q_fold = np.empty(nq, np.int32)
        q_fold[q_order] = np.arange(nq) % nfold
        for k in range(nfold):
            test_idx = np.concatenate([np.arange(qb[q], qb[q + 1])
                                       for q in range(nq) if q_fold[q] == k])
            train_idx = np.concatenate([np.arange(qb[q], qb[q + 1])
                                        for q in range(nq) if q_fold[q] != k])
            yield np.sort(train_idx), np.sort(test_idx)
        return
    if stratified and label is not None:
        order = np.argsort(label, kind="stable")
        folds_assign = np.empty(num_data, np.int32)
        folds_assign[order] = np.arange(num_data) % nfold
        if shuffle:
            perm = rng.permutation(nfold)
            folds_assign = perm[folds_assign]
    else:
        idx = rng.permutation(num_data) if shuffle else np.arange(num_data)
        folds_assign = np.empty(num_data, np.int32)
        folds_assign[idx] = np.arange(num_data) % nfold
    for k in range(nfold):
        yield (np.nonzero(folds_assign != k)[0],
               np.nonzero(folds_assign == k)[0])


def cv(params: Dict[str, Any], train_set: Dataset, num_boost_round: int = 100,
       folds=None, nfold: int = 5, stratified: bool = True,
       shuffle: bool = True, metrics=None, fobj=None, feval=None,
       init_model=None, fpreproc=None, seed: int = 0, callbacks=None,
       eval_train_metric: bool = False, return_cvbooster: bool = False,
       device=None, **kwargs) -> Dict[str, List[float]]:
    """Cross-validation (reference engine.py:523).  With ``tpu_cv_many``
    (default true) the folds train as one batch over the parent
    dataset's bins (multitrain/cv.py); configurations the batch cannot
    take run the per-fold loop, which, as the reference's, calls no
    ``callbacks`` and starts from no ``init_model``; a custom objective
    or metric (``fobj``, ``feval``) takes that loop."""
    params = dict(params or {})
    params.update(kwargs)
    if metrics is not None:
        params["metric"] = metrics
    dev = device_from(params, device)
    cfg = Config(params)
    reject_publishing(cfg, "cv")
    if cfg.objective in ("lambdarank", "rank_xendcg"):
        stratified = False
    train_set.construct(cfg)
    if folds is None:
        folds = list(_make_n_folds(
            train_set, nfold, params, seed,
            stratified and cfg.objective in ("binary", "multiclass",
                                             "multiclassova"), shuffle))
    else:
        folds = list(folds)

    if cfg.tpu_cv_many:
        from .multitrain.batched import MultiTrainError
        from .multitrain.cv import cv_many, cv_reject_reason
        reason = cv_reject_reason(fobj, feval, fpreproc, init_model,
                                  callbacks)
        if reason is None:
            try:
                return cv_many(params, train_set, num_boost_round, folds,
                               cfg, eval_train_metric=eval_train_metric,
                               return_cvbooster=return_cvbooster,
                               device=dev)
            except (MultiTrainError, CheckpointError) as e:
                reason = str(e)
        log_info(f"cv: per-fold loop (batched fold driver unavailable: "
                 f"{reason})")

    cvbooster = CVBooster()
    for train_idx, test_idx in folds:
        tr = train_set.subset(train_idx)
        te = train_set.subset(test_idx)
        if fpreproc is not None:
            tr, te, fold_params = fpreproc(tr, te, copy.deepcopy(params))
        else:
            fold_params = params
        if eval_train_metric:
            fold_params = {**params, "is_provide_training_metric": True}
        bst = Booster(params=fold_params, train_set=tr, device=dev)
        bst.add_valid(te, "valid")
        cvbooster.append(bst)

    aggr = CVAggregator(cfg, num_boost_round)
    for it in range(num_boost_round):
        agg = collections.defaultdict(list)
        hib_map: Dict[str, bool] = {}
        for bst in cvbooster.boosters:
            bst.update(fobj=fobj)
            for ds, name, val, hib in bst.eval_valid(feval):
                agg[f"{ds} {name}"].append(val)
                hib_map[f"{ds} {name}"] = hib
            if eval_train_metric:
                for ds, name, val, hib in bst.eval_train(feval):
                    agg[f"train {name}"].append(val)
        if aggr.update(it, agg, hib_map):
            break
    out = aggr.finalize(cvbooster)
    if return_cvbooster:
        out["cvbooster"] = cvbooster
    return out
