"""Trainer-side delta publisher.

Copy of ``lightgbm_tpu/publish/publisher.py`` kept inside the PyTorch
port (it serializes with the port's ``models/model_text.py``, whose text
is the reference's).

``engine.train`` creates one of these when ``publish_dir`` is set and
calls :meth:`maybe_publish` after each boosting round (plus a forced
publish on the PreemptionGuard drain path and at normal completion), so
the journal head always equals what ``Booster.save_model`` would write
at the same iteration — the fragment and the base are produced by the
same :func:`model_to_string` serializer, byte for byte."""

from __future__ import annotations

from typing import Optional

from ..models.model_text import model_to_string
from ..telemetry.metrics import default_registry
from .delta import DeltaJournal

__all__ = ["DeltaPublisher"]


class DeltaPublisher:
    """Publishes per-round model deltas into a :class:`DeltaJournal`.

    ``every`` is the round cadence; ``compact_after`` (0 = never) folds
    the chain into a fresh BASE once that many deltas pile up, bounding
    replay cost for late subscribers.  A publisher always starts its own
    chain with a BASE at the first published round (a restarted trainer
    re-anchors rather than guessing at a prior chain's fingerprints)."""

    def __init__(self, directory: str, every: int = 1,
                 compact_after: int = 0, registry=None) -> None:
        self.journal = DeltaJournal(directory)
        self.every = max(1, int(every))
        self.compact_after = max(0, int(compact_after))
        self._last_round: Optional[int] = None
        reg = registry if registry is not None else default_registry()
        self._deltas_total = reg.counter(
            "publish_deltas_total",
            "Delta records appended to the publish journal",
            labels=("journal",))
        self._round_gauge = reg.gauge(
            "publish_round",
            "Newest boosting round in the publish journal",
            labels=("journal",))
        self._label = {"journal": self.journal.directory}

    @property
    def last_round(self) -> Optional[int]:
        return self._last_round

    def maybe_publish(self, gbdt, iteration: int) -> bool:
        """Publish when ``iteration`` (1-based completed rounds) lands
        on the cadence; returns True when something was written."""
        if iteration % self.every:
            return False
        return self.publish(gbdt)

    def publish(self, gbdt) -> bool:
        """Publish everything trained since the last publish: a BASE on
        the first call, a chained delta fragment afterwards.  No-op when
        no new full round exists."""
        k = max(1, int(gbdt.num_tree_per_iteration))
        rnd = len(gbdt.models) // k
        if rnd <= 0:
            return False
        if self._last_round is None:
            self.journal.write_base(model_to_string(gbdt), rnd)
        elif rnd > self._last_round:
            self.journal.append_delta(
                model_to_string(gbdt, start_iteration=self._last_round,
                                num_iteration=rnd - self._last_round),
                rnd, num_tree_per_iteration=k)
            self._deltas_total.inc(**self._label)
            if self.compact_after and \
                    self.journal.chain_length() >= self.compact_after:
                self.journal.compact(model_to_string(gbdt), rnd)
        else:
            return False
        self._last_round = rnd
        self._round_gauge.set(float(rnd), **self._label)
        return True
