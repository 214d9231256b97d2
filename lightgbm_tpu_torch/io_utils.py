"""Text data parsers (CSV / TSV / LibSVM with format auto-detection,
reference: src/io/parser.cpp:235 ``Parser::CreateParser`` + parser.hpp
CSVParser/TSVParser/LibSVMParser; label column handling per config
label_column), the ``.weight`` / ``.query`` sidecar reader and crash-safe
file writing.

Copy of ``lightgbm_tpu/io_utils.py`` (numpy only) kept inside the PyTorch
port so the port never imports the JAX package."""

from __future__ import annotations

import itertools
import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

# concurrent writers to the SAME target must not share a temp file, or one
# open('wb') truncates the other mid-write and the rename publishes the
# interleaved bytes this module exists to prevent
_tmp_seq = itertools.count()

# missing-value tokens every CSV path coerces to NaN (genfromtxt-ish
# tolerance) — single-sourced so the in-core loader below and the
# streaming CSVSource (ingest/source.py) cannot drift
CSV_NA_VALUES = ("", "NA", "nan", "NULL", "null", "?", "N/A", "na")


def parse_label_column(params: Dict[str, Any]) -> int:
    """The reference CLI ``label_column`` convention: column 0 unless
    ``label_column``/``label`` names ``column_<i>`` or a bare index —
    shared by :func:`load_data_file` and the streaming CSVSource."""
    lc = str(params.get("label_column", "") or params.get("label", ""))
    if lc.startswith("column_") or lc.isdigit():
        return int(lc.replace("column_", "") or 0)
    return 0


def atomic_write_bytes(path: str, data: Optional[bytes] = None,
                       writer: Optional[Callable] = None) -> None:
    """Write a file so a crash at ANY point leaves either the old content
    or the new — never a truncated hybrid: write to a same-directory temp
    file, flush + fsync it, ``os.replace`` onto the target (atomic on
    POSIX), then fsync the directory so the rename itself is durable.

    Pass raw ``data`` bytes, or a ``writer(fh)`` callback for producers
    that stream into a file object (``np.savez``)."""
    path = os.fspath(path)
    d = os.path.dirname(os.path.abspath(path))
    tmp = os.path.join(
        d, f".{os.path.basename(path)}.tmp.{os.getpid()}"
           f".{threading.get_ident()}.{next(_tmp_seq)}")
    try:
        with open(tmp, "wb") as fh:
            if writer is not None:
                writer(fh)
            else:
                fh.write(data or b"")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # some filesystems refuse directory fsync; rename landed
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str) -> None:
    """Crash-safe text-file write (see :func:`atomic_write_bytes`)."""
    atomic_write_bytes(path, text.encode("utf-8"))


def _detect_format(line: str) -> str:
    """LibSVM iff a post-label token looks like ``<int>:<number>`` (a
    headered CSV whose second column name contains ':' must NOT be
    misrouted); otherwise by delimiter."""
    tokens = line.split()
    for tok in tokens[1:3]:
        head, _, tail = tok.partition(":")
        if _ and head.isdigit():
            try:
                float(tail)
                return "libsvm"
            except ValueError:
                pass
    if "\t" in line:
        return "tsv"
    if "," in line:
        return "csv"
    return "tsv"


def load_sidecar(path: str, kind: str) -> Optional[np.ndarray]:
    """Load a ``<data>.weight`` / ``<data>.query`` sidecar file if present
    (reference dataset_loader.cpp Metadata::Init weight/query file
    convention: one value per line)."""
    import os
    side = f"{path}.{kind}"
    if not os.path.exists(side):
        return None
    return np.loadtxt(side, dtype=np.float64).ravel()


def load_data_file(path: str, params: Optional[Dict[str, Any]] = None
                   ) -> Tuple[np.ndarray, List[str], Optional[np.ndarray]]:
    """Load a CSV/TSV/LibSVM file -> (features, names, label).

    Follows the reference CLI convention: first column is the label unless
    ``label_column`` says otherwise; ``header=true`` skips/uses a header row.
    """
    params = params or {}
    header = str(params.get("header", "false")).lower() in ("true", "1")
    label_col = parse_label_column(params)

    with open(path) as fh:
        first = fh.readline()
        if not first.strip():
            raise ValueError(f"{path} is empty")
    fmt = _detect_format(first.strip())

    two_round = False  # honor reference aliases (config.h two_round)
    for key in ("two_round", "two_round_loading", "use_two_round_loading"):
        if str(params.get(key, "false")).lower() in ("true", "1"):
            two_round = True

    if fmt == "libsvm":
        if two_round:
            from .utils.log import log_warning
            log_warning("two_round chunked loading applies to dense "
                        "CSV/TSV only; the LibSVM parser loads in one "
                        "pass")
        return _load_libsvm(path)

    delim = "," if fmt == "csv" else "\t"
    skip = 1 if header else 0
    raw = _load_dense(path, delim, skip, two_round)
    if raw.ndim == 1:
        raw = raw.reshape(-1, 1)
    names: List[str] = []
    if header:
        with open(path) as fh:
            names = [c.strip() for c in fh.readline().strip().split(delim)]
    label = raw[:, label_col].copy()
    feats = np.delete(raw, label_col, axis=1)
    if names:
        names = names[:label_col] + names[label_col + 1:]
    else:
        names = [f"Column_{i}" for i in range(feats.shape[1])]
    return feats, names, label


def _load_dense(path: str, delim: str, skip: int,
                two_round: bool) -> np.ndarray:
    """Dense CSV/TSV -> float64 matrix.

    Default: one-shot C-parser read.  ``two_round=true`` (reference
    config.h two_round + dataset_loader.cpp:902's two-pass low-memory
    loading) streams the file in bounded chunks into a preallocated
    array instead of materializing parser intermediates for the whole
    file — for datasets close to memory size.
    """
    try:
        import pandas as pd
    except ImportError:           # minimal environments: numpy fallback
        return np.genfromtxt(path, delimiter=delim, skip_header=skip,
                             dtype=np.float64)
    # match genfromtxt's tolerance: '#' comments stripped, missing markers
    # and ANY unparseable token coerced to NaN rather than raising (the
    # slow coerce path only runs when the fast typed parse fails)
    kw = dict(sep=delim, header=None, skiprows=skip, comment="#",
              na_values=list(CSV_NA_VALUES))

    def _to_f64(df):
        """Clean numeric columns are already float64 after type inference
        (no copy cost); mixed/object columns go through per-column coerce
        so junk tokens become NaN like genfromtxt."""
        try:
            return df.astype(np.float64).to_numpy()
        except (ValueError, TypeError):
            return df.apply(pd.to_numeric, errors="coerce").to_numpy(
                np.float64)

    if not two_round:
        return _to_f64(pd.read_csv(path, **kw))
    # pass 1: count only parseable data rows (comment/blank lines would
    # otherwise inflate the preallocation this low-memory mode exists to
    # bound)
    with open(path) as fh:
        for _ in range(skip):
            fh.readline()
        n = sum(1 for line in fh
                if line.strip() and not line.lstrip().startswith("#"))
    out: Optional[np.ndarray] = None
    r = 0
    for chunk in pd.read_csv(path, chunksize=1 << 18, **kw):
        a = _to_f64(chunk)
        if out is None:
            out = np.empty((n, a.shape[1]), np.float64)
        out[r:r + len(a)] = a
        r += len(a)
    if out is None:
        raise ValueError(f"{path} has no data rows")
    if r < n:
        # release the slack instead of keeping a view over the larger
        # buffer alive
        return np.ascontiguousarray(out[:r])
    return out[:r]


def _load_libsvm(path: str) -> Tuple[np.ndarray, List[str], np.ndarray]:
    labels: List[float] = []
    rows: List[Dict[int, float]] = []
    max_idx = -1
    with open(path) as fh:
        for line in fh:
            parts = line.strip().split()
            if not parts:
                continue
            labels.append(float(parts[0]))
            row = {}
            for tok in parts[1:]:
                if ":" not in tok:
                    continue
                idx, val = tok.split(":", 1)
                j = int(idx)
                row[j] = float(val)
                max_idx = max(max_idx, j)
            rows.append(row)
    n, f = len(rows), max_idx + 1
    out = np.zeros((n, f), np.float64)
    for i, row in enumerate(rows):
        for j, v in row.items():
            out[i, j] = v
    names = [f"Column_{i}" for i in range(f)]
    return out, names, np.asarray(labels)
