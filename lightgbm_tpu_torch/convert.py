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


def trees_from_reference(arrays: Sequence[Mapping[str, Any]]) -> List[Tree]:
    """One port ``Tree`` per mapping of reference ``Tree`` fields.

    Numeric trees only: a tree with categorical nodes or linear leaves
    raises ``NotImplementedError`` (not ported yet)."""
    out = []
    for i, fields in enumerate(arrays):
        missing = [k for k in _REQUIRED if k not in fields]
        if missing:
            raise ValueError(f"reference tree {i} lacks fields {missing}")
        nl = int(fields["num_leaves"])
        dt = np.asarray(fields["decision_type"], np.uint8)
        if fields.get("is_linear") or np.any(dt[:max(nl - 1, 0)] & CAT_MASK):
            raise NotImplementedError(
                f"reference tree {i} has categorical nodes or linear "
                "leaves, which lightgbm_tpu_torch does not carry yet")
        kw = {k: (np.array(fields[k], dtype=t, copy=True) if t is not None
                  else nl) for k, t in _REQUIRED.items()}
        out.append(Tree(shrinkage=float(fields.get("shrinkage", 1.0)), **kw))
    return out
