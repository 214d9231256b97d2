"""Carry trained state from the JAX package into the port.

The JAX package's trees are plain arrays (its ``models/tree.py`` ``Tree``
fields).  :func:`trees_from_reference` turns them, handed over as numpy
arrays, into the port's :class:`~lightgbm_tpu_torch.models.tree.Tree`,
so a model trained by ``lightgbm_tpu`` can be evaluated by the port
without going through model text.  Model text
(``Booster(model_str=...)``) is the other route; both must predict what
the reference predicts.

The port never imports the JAX package: the caller extracts the arrays
(for example ``dataclasses.asdict(tree)`` on each reference tree).
"""

from __future__ import annotations

from typing import Any, List, Mapping, Sequence

import numpy as np

from .models.tree import CAT_MASK, Tree

__all__ = ["trees_from_reference"]

_REQUIRED = {
    "num_leaves": None, "split_feature": np.int32,
    "threshold_bin": np.int32, "nan_bin": np.int32,
    "threshold": np.float64, "decision_type": np.uint8,
    "left_child": np.int32, "right_child": np.int32,
    "split_gain": np.float32, "internal_value": np.float64,
    "internal_weight": np.float64, "internal_count": np.int64,
    "leaf_value": np.float64, "leaf_weight": np.float64,
    "leaf_count": np.int64,
}
# categorical nodes: bitsets over raw category values and the binned
# membership the training-time walks read
_CATEGORICAL = {"cat_boundaries": np.int32, "cat_threshold": np.uint32,
                "cat_member_bins": bool}


def _linear_fields(i: int, fields: Mapping[str, Any]) -> dict:
    """A linear tree's per-leaf models: constants, coefficients and the
    features by real and by inner index (reference tree.h
    leaf_const_ / leaf_coeff_ / leaf_features_)."""
    for k in ("leaf_const", "leaf_coeff", "leaf_features"):
        if fields.get(k) is None:
            raise ValueError(f"reference tree {i} has linear leaves but "
                             f"no {k}")
    real = [[int(f) for f in fs] for fs in fields["leaf_features"]]
    inner = fields.get("leaf_features_inner")
    return {"is_linear": True,
            "leaf_const": np.array(fields["leaf_const"], np.float64,
                                   copy=True),
            "leaf_coeff": [[float(c) for c in cs]
                           for cs in fields["leaf_coeff"]],
            "leaf_features": real,
            "leaf_features_inner": (real if inner is None else
                                    [[int(f) for f in fs] for fs in inner])}


def trees_from_reference(arrays: Sequence[Mapping[str, Any]]) -> List[Tree]:
    """One port ``Tree`` per mapping of reference ``Tree`` fields.

    Categorical nodes carry over with their bitsets (``cat_boundaries``,
    ``cat_threshold``) and, when the reference tree has them, their
    binned memberships (``cat_member_bins``), and linear leaves with
    their constants, coefficients and features (``leaf_const``,
    ``leaf_coeff``, ``leaf_features`` and ``leaf_features_inner``)."""
    out = []
    for i, fields in enumerate(arrays):
        missing = [k for k in _REQUIRED if k not in fields]
        if missing:
            raise ValueError(f"reference tree {i} lacks fields {missing}")
        nl = int(fields["num_leaves"])
        dt = np.asarray(fields["decision_type"], np.uint8)
        kw = {k: (np.array(fields[k], dtype=t, copy=True) if t is not None
                  else nl) for k, t in _REQUIRED.items()}
        if fields.get("is_linear"):
            kw.update(_linear_fields(i, fields))
        if np.any(dt[:max(nl - 1, 0)] & CAT_MASK):
            for k, t in _CATEGORICAL.items():
                if fields.get(k) is not None:
                    kw[k] = np.array(fields[k], dtype=t, copy=True)
            if kw.get("cat_boundaries") is None or \
                    kw.get("cat_threshold") is None:
                raise ValueError(f"reference tree {i} has categorical "
                                 "nodes but no cat_boundaries / "
                                 "cat_threshold")
        out.append(Tree(shrinkage=float(fields.get("shrinkage", 1.0)), **kw))
    return out
