"""Multi-model training (``train_many``).

Port of ``lightgbm_tpu/multitrain/__init__.py``: M boosters of one base
configuration train together over ONE binned dataset, their trees grown
in lockstep with each kernel launched once for all of them
(multitrain/batched.py), and every extracted model writes the text a
standalone ``train()`` with the same params writes.

    import lightgbm_tpu_torch as lt
    mb = lt.train_many(params, train_set,
                       variants=[{"lambda_l2": v} for v in grid],
                       num_boost_round=100)
    mb[3].predict(X)           # a full standalone Booster

``engine.cv`` routes its folds through the batch (multitrain/cv.py) when
``tpu_cv_many`` (default true) and the configuration allow it.

``GridSearchCVMany`` (multitrain/sweep.py, imported on first use: it
needs sklearn) runs an sklearn grid search as one batch.

uint16 bins (``max_bin`` > 255) batch as uint8 bins do, through the
model-axis kernels' uint16 forms.  A batch the pool-less (masked) grower
would grow raises :class:`MultiTrainError`, as the reference's does: its
models then train one by one through ``train()``
(``ManyBooster.fallback_indices``, with a logged warning) and ``cv``
runs its per-fold loop.

Every model that falls back to ``train()`` bumps
``multitrain_fallback_total{reason}`` against
``multitrain_models_requested_total`` (the ``multitrain/fallback_rate``
objective), and each batch ``multitrain_batches_total`` and
``multitrain_models_total``, as the reference's.  Not ported yet
(ROADMAP queue 1 item 10): lane sharding across cards
(``tpu_multitrain_shard`` is read and ignored).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..dataset import Dataset
from ..telemetry.metrics import default_registry
from ..telemetry.slo import register_metric_ensurer, slo as _slo
from ..utils.log import log_info, log_warning
from .batched import BatchTrainer, MultiTrainError
from .variants import (HOST_SWEEP, SWEEPABLE, TRACED_SWEEP, group_variants,
                       normalize_variants)

__all__ = ["train_many", "ManyBooster", "MultiTrainError", "TRACED_SWEEP",
           "HOST_SWEEP", "SWEEPABLE", "FALLBACK_COUNTER",
           "REQUESTED_COUNTER"]


# the fallback telemetry (reference multitrain/__init__.py:47-87): one
# count per model that dropped off the batch, labeled with the reason's
# structural prefix (the free text after " (" is cut to keep the series
# few), read against every model requested through train_many

FALLBACK_COUNTER = "multitrain_fallback_total"
REQUESTED_COUNTER = "multitrain_models_requested_total"

_slo("multitrain/fallback_rate", metric=FALLBACK_COUNTER,
     total_metric=REQUESTED_COUNTER, kind="ratio", target=0.95,
     bad_labels={"reason": "*"}, min_events=20,
     note="share of train_many models that fell back to sequential "
          "train()")


@register_metric_ensurer
def _ensure_multitrain_metrics(reg) -> None:
    reg.counter(FALLBACK_COUNTER,
                "train_many models that fell back to sequential train(), "
                "by structural reason", labels=("reason",))
    reg.counter(REQUESTED_COUNTER,
                "models requested through train_many (batched or not)")


def _note_fallback(reason: str, count: int) -> None:
    short = reason.split(" (")[0].strip() or "unknown"
    default_registry().counter(
        FALLBACK_COUNTER,
        "train_many models that fell back to sequential train(), "
        "by structural reason", labels=("reason",)).inc(count, reason=short)


class ManyBooster:
    """Result of :func:`train_many`: list-like per-model standalone
    :class:`~lightgbm_tpu_torch.Booster` handles plus the batch
    bookkeeping (eval histories, which models batched or fell back)."""

    def __init__(self) -> None:
        self.boosters: List = []
        self.variant_params: List[Dict[str, Any]] = []
        self.eval_histories: List[Dict] = []
        self.batched_indices: List[int] = []
        self.fallback_indices: List[int] = []
        self.num_groups = 0

    def __len__(self) -> int:
        return len(self.boosters)

    def __getitem__(self, i):
        return self.boosters[i]

    def __iter__(self):
        return iter(self.boosters)

    @property
    def best_iteration(self) -> List[int]:
        return [b.best_iteration for b in self.boosters]

    def predict(self, X, **kwargs) -> np.ndarray:
        """(M, rows[, ...]) stacked predictions of every model."""
        return np.stack([b.predict(X, **kwargs) for b in self.boosters])


def train_many(params: Dict[str, Any], train_set: Dataset,
               num_boost_round: int = 100,
               variants: Optional[Sequence[Dict[str, Any]]] = None,
               replicas: Optional[int] = None,
               sample_masks=None,
               valid_sets: Optional[List[Dataset]] = None,
               valid_names: Optional[List[str]] = None,
               allow_fallback: bool = True,
               strict: bool = False,
               device=None,
               **kwargs: Any) -> ManyBooster:
    """Train M boosters together (reference multitrain/__init__.py:120).

    Args:
      params: base parameters (every variant inherits them).
      variants: per-model override dicts, or a ``param -> list`` column
        dict.  Sweepable params (:data:`SWEEPABLE`) batch together;
        structurally different variants group into same-structure
        batches; a group that cannot batch falls back to sequential
        ``train()`` calls.
      replicas: instead of ``variants``, M bagging-decorrelated copies of
        the base params (per-model seeds from
        ``utils.random.model_stream_seed``, written into
        ``result.variant_params``).
      sample_masks: optional (M, N) per-model training-row masks over the
        SHARED binned dataset (0 rows are left out as a row subset would
        be).
      valid_sets/valid_names: shared validation Datasets (per-model early
        stopping on per-model scores).
      allow_fallback: False raises :class:`MultiTrainError` instead of
        training unbatchable variants sequentially.
      strict: alias for ``allow_fallback=False``.
      device: where the batch trains (default ``cuda``; ``"cpu"`` runs
        the kernels' plain versions).

    Returns:
      :class:`ManyBooster`; ``result[m]`` writes the model text of
      ``train(result.variant_params[m], train_set, num_boost_round)``.
    """
    params = dict(params or {})
    params.update(kwargs)
    from ..engine import reject_publishing
    reject_publishing(Config(params), "train_many")
    if strict:
        allow_fallback = False
    if sample_masks is not None:
        sample_masks = np.asarray(sample_masks, np.float32)
        num_models = sample_masks.shape[0]
    else:
        num_models = None
    vparams = normalize_variants(params, variants, replicas,
                                 num_models=num_models)
    M = len(vparams)
    if sample_masks is not None and sample_masks.shape[0] != M:
        raise ValueError(f"sample_masks rows ({sample_masks.shape[0]}) != "
                         f"number of variants ({M})")

    result = ManyBooster()
    result.boosters = [None] * M
    result.eval_histories = [None] * M
    result.variant_params = vparams
    groups = group_variants(vparams)
    result.num_groups = len(groups)
    cap = max(1, int(Config(params).tpu_multitrain_batch))
    default_registry().counter(
        REQUESTED_COUNTER,
        "models requested through train_many (batched or not)").inc(M)

    def _fallback(indices: List[int], reason: str) -> None:
        _note_fallback(reason, len(indices))
        if not allow_fallback:
            raise MultiTrainError(reason)
        log_warning(f"train_many: {len(indices)} variant(s) fall back to "
                    f"sequential train(): {reason}")
        from ..callback import record_evaluation
        from ..engine import train as engine_train
        for i in indices:
            if sample_masks is not None:
                raise MultiTrainError(
                    f"sample_masks with a non-batchable variant: {reason}")
            hist: Dict = {}
            bst = engine_train(vparams[i], train_set,
                               num_boost_round=num_boost_round,
                               valid_sets=valid_sets,
                               valid_names=valid_names,
                               callbacks=[record_evaluation(hist)],
                               device=device)
            result.boosters[i] = bst
            result.eval_histories[i] = hist
            result.fallback_indices.append(i)

    for indices in groups:
        for lo in range(0, len(indices), cap):
            chunk = indices[lo:lo + cap]
            try:
                trainer = BatchTrainer(
                    [vparams[i] for i in chunk], train_set,
                    sample_masks=(sample_masks[chunk]
                                  if sample_masks is not None else None),
                    valid_sets=valid_sets, valid_names=valid_names,
                    device=device)
            except MultiTrainError as e:
                _fallback(chunk, str(e))
                continue
            trainer.run(num_boost_round)
            for i, bst, st in zip(chunk, trainer.finalize(),
                                  trainer.states):
                result.boosters[i] = bst
                result.eval_histories[i] = st.history
                result.batched_indices.append(i)
            log_info(f"train_many: batched {len(chunk)} models "
                     f"({trainer._steps} rounds)")
    return result


def __getattr__(name):
    if name == "GridSearchCVMany":   # sklearn is imported when it runs
        from .sweep import GridSearchCVMany
        return GridSearchCVMany
    raise AttributeError(name)
