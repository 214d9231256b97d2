"""Chunk sources: fixed row-block iterators over out-of-core data.

Copy of ``lightgbm_tpu/ingest/source.py``.  The ingest subsystem's layer 0 (reference src/io/pipeline_reader.h
``PipelineReader`` + parser.cpp streaming, PAPER.md layer 0): a
:class:`ChunkSource` yields the dataset as fixed ``chunk_rows``-sized raw
row blocks — **no source ever materializes the full matrix**, in host RAM
or anywhere else.  Sources are re-iterable: the sketch pass and the
binning pass (and every training pass that re-reads raw data) call
:meth:`chunks` again and receive identical blocks.

``chunk_rows`` must be a multiple of :data:`CHUNK_QUANTUM` (256); every
block except the last is exactly ``chunk_rows`` rows (the chunked
trainer takes the last short block as it is).  ``ArrowSource`` imports
``pyarrow`` when it is built, and only then.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, List, NamedTuple, Optional

import numpy as np

__all__ = ["CHUNK_QUANTUM", "Chunk", "ChunkSource", "ArraySource",
           "NumpyMmapSource", "CSVSource", "ArrowSource", "SyntheticSource",
           "DEFAULT_CHUNK_ROWS"]

CHUNK_QUANTUM = 256
DEFAULT_CHUNK_ROWS = 1 << 20


class Chunk(NamedTuple):
    """One streamed row block."""
    offset: int                      # global row index of the first row
    X: np.ndarray                    # (m, F) raw feature values
    label: Optional[np.ndarray]      # (m,) or None
    weight: Optional[np.ndarray]     # (m,) or None


def _check_chunk_rows(chunk_rows: int) -> int:
    chunk_rows = int(chunk_rows)
    if chunk_rows <= 0 or chunk_rows % CHUNK_QUANTUM:
        raise ValueError(f"chunk_rows must be a positive multiple of "
                         f"{CHUNK_QUANTUM}, got {chunk_rows}")
    return chunk_rows


class ChunkSource:
    """Base protocol: subclasses implement ``num_rows``/``num_features``
    and ``chunks()``.  ``feature_names`` may return None (auto names)."""

    chunk_rows: int = DEFAULT_CHUNK_ROWS

    def num_rows(self) -> int:
        raise NotImplementedError

    def num_features(self) -> int:
        raise NotImplementedError

    def feature_names(self) -> Optional[List[str]]:
        return None

    def chunks(self) -> Iterator[Chunk]:
        raise NotImplementedError

    def num_chunks(self) -> int:
        return -(-self.num_rows() // self.chunk_rows)


class ArraySource(ChunkSource):
    """In-memory adapter (tests / small data): slices views of an
    existing array — still never *copies* the full matrix."""

    def __init__(self, X: np.ndarray, label: Optional[np.ndarray] = None,
                 weight: Optional[np.ndarray] = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
        self.X = np.asarray(X)
        if self.X.ndim == 1:
            self.X = self.X.reshape(-1, 1)
        self.label = None if label is None else \
            np.asarray(label, np.float64).ravel()
        self.weight = None if weight is None else \
            np.asarray(weight, np.float64).ravel()
        self.chunk_rows = _check_chunk_rows(chunk_rows)

    def num_rows(self) -> int:
        return int(self.X.shape[0])

    def num_features(self) -> int:
        return int(self.X.shape[1])

    def chunks(self) -> Iterator[Chunk]:
        n = self.num_rows()
        for lo in range(0, n, self.chunk_rows):
            hi = min(lo + self.chunk_rows, n)
            yield Chunk(lo, self.X[lo:hi],
                        None if self.label is None else self.label[lo:hi],
                        None if self.weight is None else self.weight[lo:hi])


class NumpyMmapSource(ChunkSource):
    """``.npy`` file served through ``np.load(mmap_mode='r')`` — the OS
    page cache is the only resident copy; optional ``.npy`` label/weight
    sidecars ride along."""

    def __init__(self, path: str, label_path: Optional[str] = None,
                 weight_path: Optional[str] = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
        self.path = os.fspath(path)
        self.label_path = label_path
        self.weight_path = weight_path
        self.chunk_rows = _check_chunk_rows(chunk_rows)
        self._X = np.load(self.path, mmap_mode="r")
        if self._X.ndim == 1:
            raise ValueError(f"{path}: expected a 2-D (rows, features) .npy")
        self._label = None if label_path is None else \
            np.load(label_path, mmap_mode="r")
        self._weight = None if weight_path is None else \
            np.load(weight_path, mmap_mode="r")

    def num_rows(self) -> int:
        return int(self._X.shape[0])

    def num_features(self) -> int:
        return int(self._X.shape[1])

    def chunks(self) -> Iterator[Chunk]:
        n = self.num_rows()
        for lo in range(0, n, self.chunk_rows):
            hi = min(lo + self.chunk_rows, n)
            # np.asarray on the mmap slice pages in ONLY this block
            yield Chunk(
                lo, np.asarray(self._X[lo:hi], np.float64),
                None if self._label is None
                else np.asarray(self._label[lo:hi], np.float64).ravel(),
                None if self._weight is None
                else np.asarray(self._weight[lo:hi], np.float64).ravel())


class CSVSource(ChunkSource):
    """Dense CSV/TSV streamed in ``chunk_rows`` blocks (the reference's
    two_round loading, dataset_loader.cpp:902, as a re-iterable source).
    Label handling follows the CLI convention (first column unless
    ``label_column`` says otherwise; ``header=true`` skips a header)."""

    def __init__(self, path: str, params: Optional[Dict[str, Any]] = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
        from ..io_utils import parse_label_column
        self.path = os.fspath(path)
        self.params = dict(params or {})
        self.chunk_rows = _check_chunk_rows(chunk_rows)
        self.header = str(self.params.get("header", "false")).lower() in \
            ("true", "1")
        self.label_col = parse_label_column(self.params)
        # one cheap line pass (O(1) memory): sniff the delimiter and
        # feature count from the first DATA line (comment/blank lines
        # are skipped here exactly like chunks() skips them, so
        # num_rows() and the streamed row count cannot disagree)
        self._names = None
        self._n = 0
        self._skip_physical = 0   # physical lines through the header row
        first_data = None
        header_pending = self.header
        with open(self.path) as fh:
            for lineno, line in enumerate(fh):
                s = line.strip()
                if not s or s.lstrip().startswith("#"):
                    continue
                if header_pending:
                    delim = "\t" if "\t" in s else ","
                    self._names = [c.strip() for c in s.split(delim)]
                    self._skip_physical = lineno + 1
                    header_pending = False
                    continue
                if first_data is None:
                    first_data = s
                self._n += 1
        if first_data is None:
            raise ValueError(f"{path} has no data rows")
        self.delim = "\t" if "\t" in first_data else ","
        self._f = len(first_data.split(self.delim)) - 1

    def num_rows(self) -> int:
        return self._n

    def num_features(self) -> int:
        return self._f

    def feature_names(self) -> Optional[List[str]]:
        if self._names is None:
            return None
        lc = self.label_col
        return self._names[:lc] + self._names[lc + 1:]

    def chunks(self) -> Iterator[Chunk]:
        from ..io_utils import CSV_NA_VALUES
        try:
            import pandas as pd
            reader = pd.read_csv(
                self.path, sep=self.delim, header=None,
                skiprows=self._skip_physical, comment="#",
                chunksize=self.chunk_rows,
                na_values=list(CSV_NA_VALUES))
            off = 0
            for frame in reader:
                try:
                    raw = frame.astype(np.float64).to_numpy()
                except (ValueError, TypeError):
                    raw = frame.apply(pd.to_numeric, errors="coerce") \
                        .to_numpy(np.float64)
                yield self._split(off, raw)
                off += len(raw)
            return
        except ImportError:
            pass
        na = set(CSV_NA_VALUES)

        def tok(t: str) -> float:
            t = t.strip()
            if t in na:
                return np.nan
            try:
                return float(t)
            except ValueError:
                return np.nan   # genfromtxt-ish: junk tokens coerce
        off = 0
        rows: List[List[float]] = []
        with open(self.path) as fh:
            for _ in range(self._skip_physical):
                fh.readline()
            for line in fh:
                s = line.strip()
                if not s or s.startswith("#"):
                    continue
                rows.append([tok(t) for t in s.split(self.delim)])
                if len(rows) == self.chunk_rows:
                    yield self._split(off, np.asarray(rows, np.float64))
                    off += len(rows)
                    rows = []
        if rows:
            yield self._split(off, np.asarray(rows, np.float64))

    def _split(self, off: int, raw: np.ndarray) -> Chunk:
        label = raw[:, self.label_col].copy()
        feats = np.delete(raw, self.label_col, axis=1)
        return Chunk(off, feats, label, None)


class ArrowSource(ChunkSource):
    """Arrow/parquet streamed by record batches (optional ``pyarrow``
    dependency; raises a clear ImportError when absent)."""

    def __init__(self, path: str, label: Optional[str] = None,
                 weight: Optional[str] = None,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS) -> None:
        try:
            import pyarrow.parquet as pq
        except ImportError as exc:  # pragma: no cover - env without arrow
            raise ImportError(
                "ArrowSource requires pyarrow; install it or use "
                "NumpyMmapSource/CSVSource") from exc
        self.path = os.fspath(path)
        self.label_name = label
        self.weight_name = weight
        self.chunk_rows = _check_chunk_rows(chunk_rows)
        self._pf = pq.ParquetFile(self.path)
        names = list(self._pf.schema_arrow.names)
        drop = {n for n in (label, weight) if n}
        self._feat_names = [n for n in names if n not in drop]
        self._n = int(self._pf.metadata.num_rows)

    def num_rows(self) -> int:
        return self._n

    def num_features(self) -> int:
        return len(self._feat_names)

    def feature_names(self) -> Optional[List[str]]:
        return list(self._feat_names)

    def chunks(self) -> Iterator[Chunk]:
        off = 0
        cols = self._feat_names + [n for n in (self.label_name,
                                               self.weight_name) if n]
        for batch in self._pf.iter_batches(batch_size=self.chunk_rows,
                                           columns=cols):
            # native arrow->numpy per column (no Python-object churn)
            def col(name):
                return np.asarray(
                    batch.column(name).to_numpy(zero_copy_only=False),
                    np.float64)
            X = np.stack([col(n) for n in self._feat_names], axis=1)
            lab = col(self.label_name) if self.label_name else None
            wgt = col(self.weight_name) if self.weight_name else None
            yield Chunk(off, X, lab, wgt)
            off += X.shape[0]


class SyntheticSource(ChunkSource):
    """Deterministic synthetic generator — the 10^8-row smoke/bench
    source.  Every chunk is a pure function of (seed, chunk index), so
    re-iteration reproduces identical blocks with zero storage."""

    def __init__(self, rows: int, features: int,
                 chunk_rows: int = DEFAULT_CHUNK_ROWS, seed: int = 0,
                 task: str = "binary") -> None:
        if task not in ("binary", "regression"):
            raise ValueError("task must be binary|regression")
        self._n = int(rows)
        self._f = int(features)
        self.chunk_rows = _check_chunk_rows(chunk_rows)
        self.seed = int(seed)
        self.task = task

    def num_rows(self) -> int:
        return self._n

    def num_features(self) -> int:
        return self._f

    def _gen(self, idx: int, m: int) -> Chunk:
        rng = np.random.RandomState((self.seed * 1_000_003 + idx)
                                    % (2 ** 31 - 1))
        X = rng.rand(m, self._f)
        logit = (X[:, 0] - 0.5) * 4.0 + (X[:, 1 % self._f] - 0.5) * 2.0
        noise = rng.randn(m) * 0.5
        if self.task == "binary":
            label = (logit + noise > 0).astype(np.float64)
        else:
            label = logit + noise
        return Chunk(idx * self.chunk_rows, X, label, None)

    def chunks(self) -> Iterator[Chunk]:
        for idx in range(self.num_chunks()):
            lo = idx * self.chunk_rows
            m = min(self.chunk_rows, self._n - lo)
            yield self._gen(idx, m)
