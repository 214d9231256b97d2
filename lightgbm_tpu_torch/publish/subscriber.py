"""Subscriber-side chain folding: journal/records -> trees / models.

Port of ``lightgbm_tpu/publish/subscriber.py``.  A delta payload is a
*standalone* model text for its round slice (the publisher renders it
with the same serializer as ``save_model``), so parsing reuses the full
``string_to_model`` machinery (tree_sizes truncation detection,
``ModelCorruptError`` offsets, real-index feature mapping) instead of a
second parser.

A fragment's trees are host objects whatever the device, so
:func:`trees_from_fragment` parses on the host; :func:`fold_chain` and
:func:`load_journal` return a model that predicts, on ``device``
(``cuda`` unless the caller asks for the CPU, as every entry point).
"""

from __future__ import annotations

from typing import List, Tuple

from .delta import DeltaChainError, DeltaJournal, DeltaRecord

__all__ = ["trees_from_fragment", "fold_chain", "load_journal"]


def _parse_model_text(text: str, source: str = "<delta payload>",
                      device="cpu"):
    from ..config import Config
    from ..models.model_text import string_to_model
    from ..utils.device import resolve_device
    return string_to_model(text, Config({}), source=source,
                           device=resolve_device(device))


def trees_from_fragment(payload: str, source: str = "<delta payload>"
                        ) -> Tuple[List, int]:
    """Parse one delta payload into ``(trees, num_tree_per_iteration)``.
    The trees carry real (untranslated) feature indices, ready to append
    to a text-loaded booster or re-lower into the dense program."""
    gbdt = _parse_model_text(payload, source=source)
    return list(gbdt.models), max(1, int(gbdt.num_tree_per_iteration))


def fold_chain(base_text: str, records: List[DeltaRecord], device=None):
    """Fold a validated chain into one GBDT on ``device``: load the base,
    append each record's trees in order.  Round bookkeeping (``iter_``)
    tracks the appended trees so ``save_model``/``predict`` see one
    continuous model."""
    gbdt = _parse_model_text(base_text, source="<journal base>",
                             device=device)
    k = max(1, int(gbdt.num_tree_per_iteration))
    for rec in records:
        trees, frag_k = trees_from_fragment(
            rec.payload, source=f"<delta round {rec.round}>")
        if frag_k != k:
            raise DeltaChainError(
                f"delta round {rec.round}: num_tree_per_iteration "
                f"{frag_k} != base {k}")
        expect = (rec.round - rec.base_round) * k
        if len(trees) != expect:
            raise DeltaChainError(
                f"delta round {rec.round}: {len(trees)} trees for "
                f"{rec.round - rec.base_round} rounds (expected {expect})")
        gbdt.models.extend(trees)
    gbdt.iter_ = len(gbdt.models) // k
    return gbdt


def load_journal(directory: str, device=None) -> Tuple[object, int]:
    """Materialize a journal into ``(gbdt, round)`` on ``device``: the
    cold-start / full-reload path for subscribers too far behind to
    replay deltas."""
    journal = DeltaJournal(directory)
    base_text, base_round, records = journal.chain()
    gbdt = fold_chain(base_text, records, device=device)
    rnd = records[-1].round if records else base_round
    return gbdt, rnd
