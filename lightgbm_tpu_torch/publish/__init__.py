"""Continuous-learning lane: per-round model delta publishing.

Port of ``lightgbm_tpu/publish/``.

The trainer appends each published round's new trees to a crash-safe
delta journal (:mod:`.delta`); the serving tier replays the journal to
extend compiled ensembles in place (:mod:`.subscriber`,
``serve/registry.py`` ``apply_delta``).  The fleet supervisor that pushes
deltas to worker processes is ROADMAP queue 1 item 11c."""

from .delta import (DeltaChainError, DeltaJournal, DeltaRecord,
                    fingerprint_text)
from .publisher import DeltaPublisher
from .subscriber import fold_chain, load_journal, trees_from_fragment

__all__ = ["DeltaChainError", "DeltaJournal", "DeltaRecord",
           "fingerprint_text", "DeltaPublisher", "fold_chain",
           "load_journal", "trees_from_fragment"]
