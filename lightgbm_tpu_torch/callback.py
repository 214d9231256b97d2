"""Training callbacks (reference python-package/lightgbm/callback.py:
``print_evaluation``:52, ``record_evaluation``:78, ``reset_parameter``:106,
``early_stopping``:147-242 raising EarlyStopException).

Copy of ``lightgbm_tpu/callback.py`` (numpy only) kept inside the PyTorch port so
the port never imports the JAX package."""

from __future__ import annotations

import collections
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from .utils.log import log_info, log_warning

__all__ = ["EarlyStopException", "CallbackEnv", "print_evaluation",
           "log_evaluation", "record_evaluation", "reset_parameter",
           "early_stopping"]


class EarlyStopException(Exception):
    def __init__(self, best_iteration: int, best_score) -> None:
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


CallbackEnv = collections.namedtuple(
    "CallbackEnv",
    ["model", "params", "iteration", "begin_iteration", "end_iteration",
     "evaluation_result_list"])


def _fmt_eval(res) -> str:
    data_name, eval_name, value, _ = res
    return f"{data_name}'s {eval_name}: {value:g}"


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    def _callback(env: CallbackEnv) -> None:
        if period > 0 and env.evaluation_result_list and \
                (env.iteration + 1) % period == 0:
            result = "\t".join(_fmt_eval(x) for x in env.evaluation_result_list)
            log_info(f"[{env.iteration + 1}]\t{result}")
    _callback.order = 10
    return _callback


log_evaluation = print_evaluation


def record_evaluation(eval_result: Dict[str, Dict[str, List[float]]]) -> Callable:
    if not isinstance(eval_result, dict):
        raise TypeError("eval_result must be a dict")
    eval_result.clear()

    def _callback(env: CallbackEnv) -> None:
        for data_name, eval_name, value, _ in env.evaluation_result_list:
            eval_result.setdefault(data_name, collections.OrderedDict())
            eval_result[data_name].setdefault(eval_name, [])
            eval_result[data_name][eval_name].append(value)
    _callback.order = 20
    # resume support: train(resume_from=...) refills this dict with the
    # checkpointed eval history so the user's record survives preemption
    _callback.eval_result = eval_result
    return _callback


def reset_parameter(**kwargs: Any) -> Callable:
    """Reset parameters on a schedule: value is a list (per iteration) or a
    function iteration -> value (reference callback.py:106)."""

    def _callback(env: CallbackEnv) -> None:
        new_params = {}
        for key, value in kwargs.items():
            if isinstance(value, list):
                if len(value) != env.end_iteration - env.begin_iteration:
                    raise ValueError(f"list length of {key} must match "
                                     "num_boost_round")
                new_params[key] = value[env.iteration - env.begin_iteration]
            elif callable(value):
                new_params[key] = value(env.iteration - env.begin_iteration)
            else:
                raise ValueError("reset_parameter values must be list or callable")
        if new_params:
            env.model.reset_parameter(new_params)
    _callback.before_iteration = True
    _callback.order = 10
    return _callback


def _metric_tag(name: str) -> str:
    """Trailing token of a (possibly composite) metric name."""
    return name.rsplit(" ", 1)[-1]


@dataclass
class _MetricTracker:
    """Best-so-far state of one (dataset, metric) evaluation stream."""
    higher_better: bool
    best_score: float = None
    best_iter: int = 0
    snapshot: Any = None  # full eval list at the best iteration

    def observe(self, score: float, iteration: int, results) -> None:
        if self.snapshot is None or (
                score > self.best_score if self.higher_better
                else score < self.best_score):
            self.best_score = score
            self.best_iter = iteration
            self.snapshot = results


class _EarlyStopper:
    """Stateful early-stopping callback: stop when no validation metric
    improved for ``rounds`` consecutive iterations (the contract of the
    reference's early_stopping callback, callback.py:147).

    One :class:`_MetricTracker` per evaluation stream; training-set
    streams update their tracker (so best_score reports them) but never
    drive the stop decision, and ``first_metric_only`` restricts the
    decision to streams whose metric name matches the first stream's.
    """

    order = 30

    def __init__(self, rounds: int, first_metric_only: bool,
                 verbose: bool) -> None:
        self.rounds = int(rounds)
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.trackers: Optional[List[_MetricTracker]] = None
        self.active = True
        self.first_metric_name = ""

    def _start(self, env: CallbackEnv) -> None:
        results = env.evaluation_result_list
        self.active = bool(results)
        if not self.active:
            if env.params.get("boosting") == "dart":
                log_warning("Early stopping is not available in dart mode")
            else:
                log_warning("For early stopping, at least one dataset and "
                            "eval metric is required for evaluation")
            return
        if self.verbose:
            log_info(f"Training until validation scores don't improve for "
                     f"{self.rounds} rounds")
        # custom fevals may produce composite "prefix metric" names;
        # streams are matched on the trailing token like the reference
        self.first_metric_name = _metric_tag(results[0][1])
        self.trackers = [_MetricTracker(higher_better=hb)
                         for (_, _, _, hb) in results]

    def _stop(self, tracker: _MetricTracker, reached_end: bool) -> None:
        if self.verbose:
            head = ("Did not meet early stopping. Best iteration is:"
                    if reached_end else "Early stopping, best iteration is:")
            body = "\t".join(_fmt_eval(x) for x in tracker.snapshot)
            log_info(f"{head}\n[{tracker.best_iter + 1}]\t{body}")
        raise EarlyStopException(tracker.best_iter, tracker.snapshot)

    # -- checkpoint support --------------------------------------------------
    def state_dict(self) -> dict:
        """JSON-ready best-so-far bookkeeping, captured mid-train by the
        resilience checkpoint so a resumed run keeps counting patience
        from the same best iteration instead of restarting it."""
        return {
            "rounds": self.rounds,
            "first_metric_only": self.first_metric_only,
            "first_metric_name": self.first_metric_name,
            "trackers": None if self.trackers is None else [
                {"higher_better": t.higher_better,
                 "best_score": t.best_score,
                 "best_iter": t.best_iter,
                 "snapshot": None if t.snapshot is None else
                 [list(row) for row in t.snapshot]}
                for t in self.trackers],
        }

    def load_state_dict(self, state: dict) -> None:
        self.first_metric_name = state.get("first_metric_name", "")
        trackers = state.get("trackers")
        if trackers is None:
            self.trackers = None
            return
        self.trackers = []
        self.active = True
        for t in trackers:
            tr = _MetricTracker(higher_better=bool(t["higher_better"]),
                                best_score=t["best_score"],
                                best_iter=int(t["best_iter"]))
            tr.snapshot = None if t["snapshot"] is None else \
                [(r[0], r[1], float(r[2]), bool(r[3]))
                 for r in t["snapshot"]]
            self.trackers.append(tr)
        if not self.trackers:
            self.trackers = None

    def __call__(self, env: CallbackEnv) -> None:
        if self.trackers is None and self.active:
            self._start(env)
        if not self.active:
            return
        results = env.evaluation_result_list
        last_iter = env.iteration == env.end_iteration - 1
        for tracker, (data_name, metric_name, score, _) in zip(
                self.trackers, results):
            tracker.observe(score, env.iteration, results)
            if data_name == "training":
                continue  # training metrics never trigger stopping
            if self.first_metric_only and \
                    _metric_tag(metric_name) != self.first_metric_name:
                continue
            if env.iteration - tracker.best_iter >= self.rounds or \
                    last_iter:
                self._stop(tracker, reached_end=last_iter and
                           env.iteration - tracker.best_iter < self.rounds)


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Early stopping on validation metrics (reference callback.py:147's
    surface; implementation is the tracker-based :class:`_EarlyStopper`)."""
    return _EarlyStopper(stopping_rounds, first_metric_only, verbose)
