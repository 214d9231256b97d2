"""Streaming sketch binning: one-pass mergeable per-feature summaries.

Copy of ``lightgbm_tpu/ingest/sketch.py``, its distributed merge over
``distributed.allgather_host``.  The analog of LightGBM's sampled bin finding over streamed
input (reference: src/io/dataset_loader.cpp:902 ``SampleTextDataFromFile``
feeding ``ConstructBinMappersFromTextData`` while ``pipeline_reader.h``
streams the file, PAPER.md layers 0/3): a :class:`BinningSketch` ingests
fixed row chunks, keeps only the deterministically sampled rows' values as
exact mergeable (distinct, count) summaries
(:class:`..binning.ColumnSummary`), and finalizes into the SAME
``BinMapper`` list a one-shot in-core :meth:`Dataset.construct` would
produce on the full matrix — bit-identical, because both paths route
through :func:`..binning.find_bin_from_summary`.

Memory is a function of ``bin_construct_sample_cnt`` (the sample bound)
and the chunk size only — never of the total row count — which is what
lets the ingest subsystem bin 10^8-10^9-row sources without ever holding
them.

The sketch is also the one code path for *distributed* binning:
``serialize()``/``merge_serialized()`` pack the per-feature summaries into
two flat arrays that ride the existing host allgather
(``distributed.allgather_host``), replacing the raw sample-row gather of
the pre-partition path — every rank merges the same rank-ordered
summaries and derives identical mappers (the reference's BinMapper
allgather, dataset_loader.cpp:1040-1130, at summary granularity).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..binning import (BinMapper, ColumnSummary, find_bin_from_summary,
                       merge_column_summaries, summarize_column)
from ..dataset import sample_row_indices

__all__ = ["BinningSketch", "sample_row_indices"]


class BinningSketch:
    """Per-feature mergeable quantile/count sketch over sampled rows."""

    def __init__(self, num_features: int,
                 cat_indices: Optional[Sequence[int]] = None) -> None:
        self.num_features = int(num_features)
        cats = set(int(c) for c in (cat_indices or ()))
        self._is_cat = [j in cats for j in range(self.num_features)]
        self._summaries: List[Optional[ColumnSummary]] = \
            [None] * self.num_features
        self.rows_seen = 0

    # -- accumulation --------------------------------------------------------
    def update(self, rows: np.ndarray) -> None:
        """Fold one block of sampled rows ((m, F) float64) into the
        sketch.  Cost and memory are functions of the block and the
        distinct-value counts only."""
        rows = np.asarray(rows, np.float64)
        if rows.ndim == 1:
            rows = rows.reshape(1, -1)
        if rows.shape[1] != self.num_features:
            raise ValueError(f"sketch expects {self.num_features} features, "
                             f"got {rows.shape[1]}")
        if rows.shape[0] == 0:
            return
        for j in range(self.num_features):
            s = summarize_column(rows[:, j], is_categorical=self._is_cat[j])
            cur = self._summaries[j]
            self._summaries[j] = s if cur is None else \
                merge_column_summaries(cur, s)
        self.rows_seen += rows.shape[0]

    def merge(self, other: "BinningSketch") -> "BinningSketch":
        if other.num_features != self.num_features:
            raise ValueError("cannot merge sketches of different width")
        for j in range(self.num_features):
            o = other._summaries[j]
            if o is None:
                continue
            cur = self._summaries[j]
            self._summaries[j] = o if cur is None else \
                merge_column_summaries(cur, o)
        self.rows_seen += other.rows_seen
        return self

    def summary(self, j: int) -> ColumnSummary:
        s = self._summaries[j]
        if s is None:
            s = summarize_column(np.zeros(0), is_categorical=self._is_cat[j])
        return s

    # -- wire form (distributed binning) -------------------------------------
    # layout per feature: [n_distinct, na_cnt, total_cnt] int64 header in
    # the layout array; distinct values then counts in the flat payload.
    def serialize(self):
        """(payload float64 flat, layout int64 (F, 3)) — fixed-width
        layout rows so rank payloads concatenate through the max-pad
        allgather and split back exactly."""
        payloads = []
        layout = np.zeros((self.num_features, 3), np.int64)
        for j in range(self.num_features):
            s = self.summary(j)
            layout[j] = (len(s.distinct), s.na_cnt, s.total_cnt)
            payloads.append(np.asarray(s.distinct, np.float64))
            payloads.append(np.asarray(s.counts, np.float64))
        flat = np.concatenate(payloads) if payloads else np.zeros(0)
        return flat, layout

    @classmethod
    def deserialize(cls, flat: np.ndarray, layout: np.ndarray,
                    cat_indices: Optional[Sequence[int]] = None
                    ) -> "BinningSketch":
        layout = np.asarray(layout, np.int64)
        sk = cls(layout.shape[0], cat_indices)
        off = 0
        rows = 0
        for j in range(sk.num_features):
            nd, na, tot = (int(v) for v in layout[j])
            d = np.asarray(flat[off:off + nd], np.float64)
            c = np.asarray(flat[off + nd:off + 2 * nd], np.float64) \
                .astype(np.int64)
            off += 2 * nd
            sk._summaries[j] = ColumnSummary(
                distinct=d, counts=c, na_cnt=na, total_cnt=tot,
                is_categorical=sk._is_cat[j])
            rows = max(rows, tot)
        sk.rows_seen = rows
        return sk

    def allgather_merge(self) -> "BinningSketch":
        """Merge this rank's sketch with every other process's (host
        allgather of the serialized summaries, merged in rank order) —
        the distributed-binning collective.  No-op single-process."""
        from .. import distributed as _dist
        if not _dist.is_initialized() or _dist.process_count() == 1:
            return self
        flat, layout = self.serialize()
        # the host allgather carries every dtype bit for bit
        sizes = _dist.allgather_host(np.asarray([len(flat)], np.int64))
        flats = _dist.allgather_host(flat)
        layouts = _dist.allgather_host(layout.reshape(-1)).reshape(
            -1, self.num_features, 3)
        merged: Optional[BinningSketch] = None
        off = 0
        for r in range(len(sizes)):
            part = BinningSketch.deserialize(
                flats[off:off + int(sizes[r])], layouts[r],
                [j for j, c in enumerate(self._is_cat) if c])
            off += int(sizes[r])
            merged = part if merged is None else merged.merge(part)
        assert merged is not None
        self._summaries = merged._summaries
        self.rows_seen = merged.rows_seen
        return self

    # -- finalize ------------------------------------------------------------
    def finalize(self, *, max_bin: int, min_data_in_bin: int = 3,
                 use_missing: bool = True, zero_as_missing: bool = False,
                 forced_bins: Optional[Dict[int, list]] = None,
                 pre_filter_cnt_fn=None) -> List[BinMapper]:
        """All features' BinMappers via the shared
        :func:`find_bin_from_summary` machinery.  ``pre_filter_cnt_fn``
        maps a feature's summarized sample size to the reference's
        NeedFilter threshold (0 disables)."""
        forced_bins = forced_bins or {}
        mappers: List[BinMapper] = []
        for j in range(self.num_features):
            s = self.summary(j)
            filt = int(pre_filter_cnt_fn(s.total_cnt)) \
                if pre_filter_cnt_fn is not None else 0
            mappers.append(find_bin_from_summary(
                s, max_bin, min_data_in_bin,
                use_missing=use_missing, zero_as_missing=zero_as_missing,
                forced_bounds=forced_bins.get(j), pre_filter_cnt=filt))
        return mappers
