"""Shared sequential split-commit selector.

Port of ``lightgbm_tpu/learner/endgame.py``: the TRUE leaf-wise order
(serial_tree_learner.cpp:158-209) commits one split at a time — write the
node records, patch the parent's child pointer at the committed node,
renumber leaves (left child keeps the split leaf's id, right child takes
the next fresh id — Tree::Split).  The wave grower's exact endgame
(learner/wave.py) uses it for every commit.

Leaves are encoded in child slots as ``-(leaf+1)``; at any moment exactly
one node slot holds a given leaf's code (its parent's), so a full-array
compare-and-set replaces parent-index bookkeeping.  Here ``leaf`` and
``node`` are host integers (the endgame commits one split per host step)
and the records are written in place: the grower owns its state.
"""

from __future__ import annotations

import torch

__all__ = ["patch_child_pointers", "write_split_records"]


def patch_child_pointers(left_child: torch.Tensor, right_child: torch.Tensor,
                         leaf: int, node: int):
    """Point the split leaf's parent slot at the newly committed node."""
    enc = -(leaf + 1)
    return (torch.where(left_child == enc, node, left_child),
            torch.where(right_child == enc, node, right_child))


def write_split_records(out: dict, *, node: int, leaf: int, new_id: int,
                        feat, thr, f_nan_bin, dt_bits, gain,
                        internal_value, internal_weight, internal_count,
                        left_child: torch.Tensor,
                        right_child: torch.Tensor) -> dict:
    """Write one committed split's node records into the state dict;
    ``left_child``/``right_child`` arrive pre-patched
    (:func:`patch_child_pointers`) and the node's own slots encode its
    children as leaves ``-(leaf+1)`` / ``-(new_id+1)``.  Writes in place."""
    for name, val in (("split_feature", feat), ("threshold_bin", thr),
                      ("nan_bin", f_nan_bin), ("decision_type", dt_bits),
                      ("split_gain", gain),
                      ("internal_value", internal_value),
                      ("internal_weight", internal_weight),
                      ("internal_count", internal_count)):
        out[name][node] = val
    left_child[node] = -(leaf + 1)
    right_child[node] = -(new_id + 1)
    out["left_child"] = left_child
    out["right_child"] = right_child
    return out
