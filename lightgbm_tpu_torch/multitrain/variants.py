"""Variant normalization and same-structure grouping for ``train_many``.

Port of ``lightgbm_tpu/multitrain/variants.py`` (jax-free; kept as the
port's own copy).  A *variant* is a per-model parameter override dict.
Two classes of parameters can vary inside one batch:

* **traced sweepables** (:data:`TRACED_SWEEP`, the reference's
  ``ops/split.py:85`` ``TRACEABLE_PARAMS``): the split scan's
  regularization and threshold scalars.  In the port every lane builds
  its grower from its own ``SplitParams`` (learner/serial.py
  ``SerialTreeLearner.lane_grower``), so they never reach a kernel.
* **host sweepables** (:data:`HOST_SWEEP`): sampling seeds and fractions
  (the masks they produce are per-lane inputs), ``learning_rate``, and
  early-stopping and metric choices (host bookkeeping).

Everything else is structural.  Variants are grouped by their structural
fingerprint; each group trains as one batch of lanes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..config import Config, resolve_param_aliases
from ..utils.random import model_stream_seed

__all__ = ["TRACED_SWEEP", "HOST_SWEEP", "SWEEPABLE", "normalize_variants",
           "structure_key", "group_variants"]

# the split scan's sweepable scalars (reference ops/split.py:85
# TRACEABLE_PARAMS)
TRACED_SWEEP: Tuple[str, ...] = ("lambda_l1", "lambda_l2",
                                 "min_sum_hessian_in_leaf",
                                 "min_data_in_leaf", "min_gain_to_split")

# sweepable on the host; the GOSS rates and DART drop knobs are listed as
# the reference lists them (GOSS and DART themselves are not ported yet)
HOST_SWEEP: Tuple[str, ...] = (
    "learning_rate", "bagging_seed", "bagging_fraction",
    "pos_bagging_fraction", "neg_bagging_fraction", "feature_fraction",
    "feature_fraction_seed", "seed", "extra_seed",
    "early_stopping_round", "first_metric_only", "metric",
    "top_rate", "other_rate",
    "drop_rate", "max_drop", "skip_drop", "uniform_drop",
    "xgboost_dart_mode", "drop_seed",
)

SWEEPABLE: Tuple[str, ...] = TRACED_SWEEP + HOST_SWEEP

# seeds that replicas=M derives per model, written INTO the variant params
# so ``train(variants[m])`` is model m's standalone counterpart
_REPLICA_SEED_KEYS = ("seed", "bagging_seed", "feature_fraction_seed",
                      "extra_seed")


def normalize_variants(base_params: Dict[str, Any],
                       variants: Optional[Sequence[Dict[str, Any]]],
                       replicas: Optional[int] = None,
                       num_models: Optional[int] = None
                       ) -> List[Dict[str, Any]]:
    """The user's variant spec as canonical per-model FULL param dicts
    (aliases resolved, base params merged).

    ``variants`` may be a list of override dicts or a dict of
    ``param -> list`` columns (all the same length, zipped per model).
    ``replicas=M`` makes M bagging-decorrelated copies of the base params
    through :func:`~lightgbm_tpu_torch.utils.random.model_stream_seed`,
    the derived seeds written into each variant."""
    base = resolve_param_aliases(base_params or {})
    if variants is not None and replicas is not None:
        raise ValueError("pass either variants or replicas, not both")
    if variants is None and replicas is None:
        return [dict(base) for _ in range(int(num_models or 1))]
    if replicas is not None:
        cfg = Config(base)
        out = []
        for m in range(int(replicas)):
            v = dict(base)
            for key in _REPLICA_SEED_KEYS:
                v[key] = model_stream_seed(int(getattr(cfg, key)), m)
            out.append(v)
        return out
    if isinstance(variants, dict):
        cols = {k: list(v) for k, v in variants.items()}
        lens = {len(v) for v in cols.values()}
        if len(lens) != 1:
            raise ValueError(f"variant columns have differing lengths: "
                             f"{ {k: len(v) for k, v in cols.items()} }")
        m = lens.pop()
        variants = [{k: cols[k][i] for k in cols} for i in range(m)]
    return [{**base, **resolve_param_aliases(dict(v))} for v in variants]


def _hashable(v: Any) -> Any:
    if isinstance(v, (list, tuple)):
        return tuple(_hashable(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _hashable(x)) for k, x in v.items()))
    return v


def structure_key(full_params: Dict[str, Any]) -> Tuple:
    """Hashable fingerprint of everything that is NOT sweepable inside a
    batch.  Variants with equal keys train in one batch."""
    skip = set(SWEEPABLE)
    return tuple(sorted((k, _hashable(v)) for k, v in full_params.items()
                        if k not in skip))


def group_variants(variant_params: List[Dict[str, Any]]
                   ) -> List[List[int]]:
    """Variant indices grouped by structural fingerprint, groups in
    first-seen order and variants in order within a group."""
    groups: Dict[Tuple, List[int]] = {}
    order: List[Tuple] = []
    for i, p in enumerate(variant_params):
        key = structure_key(p)
        if key not in groups:
            groups[key] = []
            order.append(key)
        groups[key].append(i)
    return [groups[k] for k in order]
