"""StreamedDataset: out-of-core ingestion into a Dataset-compatible object.

Port of ``lightgbm_tpu/ingest/stream.py``.  A :class:`StreamedDataset`
wraps a :class:`..ingest.source.ChunkSource` and constructs in two
streaming passes, never materializing the raw matrix:

1. **sketch pass** — the deterministic bin-construct row sample
   (``dataset.sample_row_indices``, the draw the in-core
   ``Dataset.construct`` makes) is folded chunk by chunk into a
   :class:`..ingest.sketch.BinningSketch`; labels and weights accumulate
   into per-row host arrays.  Finalizing the sketch yields the BinMappers
   of an in-core construct of the same matrix (both run through
   ``binning.find_bin_from_summary``).
2. **bin + spill pass** — every chunk is quantized with
   ``binning.bin_matrix`` and appended to an on-disk binned cache (1 B a
   value at ``max_bin`` <= 256), so later training passes stream binned
   codes from the OS page cache instead of re-parsing raw input.

Host working set: the sketch (bounded by ``bin_construct_sample_cnt``),
one raw chunk, and O(bytes-per-row) label / score state.  The full
Dataset API (fingerprint, ``device_bins``, ``engine.train``) works on top
of the cache: with ``tpu_ingest_mode=hbm`` (the default) training uploads
the binned matrix to the device once and every in-core path runs
unchanged; with ``tpu_ingest_mode=chunked`` ``engine.train`` hands the
dataset to ``ingest/train.py``, whose grower accumulates histograms chunk
by chunk within the ``ingest/chunk_pipeline`` budget declared below.

Pre-partitioned multi-process streaming (the reference's
``pre_partition`` route) comes with distributed training (ROADMAP queue 1
item 10).
"""

from __future__ import annotations

import os
import tempfile
import zlib
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np

from ..analysis.contracts import memory_budget
from ..binning import bin_matrix
from ..config import Config
from ..dataset import Dataset, sample_row_indices
from ..ops.histogram_cuda import LEAF_CHANNELS, Q_LEAF_CHANNELS
from ..telemetry.metrics import default_registry
from ..telemetry.trace import span
from ..utils.log import log_info
from .sketch import BinningSketch
from .source import DEFAULT_CHUNK_ROWS, ChunkSource, _check_chunk_rows

__all__ = ["StreamedDataset", "ingest_chunk_hbm_bytes"]


# ---------------------------------------------------------------------------
# The chunked pipeline's device-memory budget.  The whole point of the
# mode: the curve is a function of (chunk_rows, features, bins, leaves,
# wave_size, quantized, classes) ONLY; there is deliberately NO total-rows
# term (tests/test_torch_ingest.py asserts it is flat in ctx["rows"]).
# Terms, for the port's buffers (ingest/grower.py):
# * the two-slot device ring: row-major bin codes (F B/row), f32
#   gradient, hessian and bag mask (12), the row_leaf upload (1 B/row up
#   to 256 leaves, else 4);
# * one chunk's working set on the compute stream: the feature-major bins
#   (F), the int32 row_leaf in and out (8), the int8 channels (1), the
#   row_leaf download (1 or 4), the weight lanes (8 int8 quantized; 24
#   int64 fixed point exact) and their f32/f64 temporaries (16
#   quantized; 40 exact);
# * the per-chunk gradient pass: the chunk's scores, labels, weights and
#   gradient temporaries, ~12 f32 per row and class;
# * histograms: the kernel's (K, F, B, 3) output (K = 42 int32 or 25
#   int64), the wave accumulator (W channels of the same type), the
#   (L, F, B, 3) pool (int32 or f32), and the children's scan over 2W
#   leaves (~12 f32 layers of (2W, F, B, 3)).
# ---------------------------------------------------------------------------

def ingest_chunk_hbm_bytes(ctx):
    c = int(ctx.get("chunk_rows", DEFAULT_CHUNK_ROWS))
    f = int(ctx["features"])
    b = int(ctx["bins"])
    q = bool(ctx.get("quantized"))
    leaves = int(ctx.get("leaves", 2))
    classes = int(ctx.get("classes", 1))
    k = Q_LEAF_CHANNELS if q else LEAF_CHANNELS
    wave = max(1, min(int(ctx.get("wave_size", 0)) or k, k, leaves - 1))
    rl = 1 if leaves <= 256 else 4
    ring = 2 * c * (f + 12 + rl)
    work = c * (f + 9 + rl + (8 + 16 if q else 24 + 40))
    grads = c * 4 * 12 * classes
    item = 4 if q else 8
    fb3 = f * b * 3
    hist = (k * item + wave * item + leaves * 4 + 12 * 2 * wave * 4) * fb3
    return ring + work + grads + hist + (1 << 20)


memory_budget(
    "ingest/chunk_pipeline", ("ingest",), ingest_chunk_hbm_bytes,
    note="two-slot device chunk ring + one chunk's working set + the "
         "wave histogram working set; flat in total rows by construction")


class StreamedDataset(Dataset):
    """Dataset built from a :class:`ChunkSource` without ever holding the
    raw matrix.  ``spill_dir`` hosts the binned on-disk cache (a temp dir
    by default); ``chunk_rows`` is fixed by the source."""

    def __init__(self, source: ChunkSource,
                 params: Optional[Dict[str, Any]] = None,
                 categorical_feature: Any = "auto",
                 spill_dir: Optional[str] = None,
                 free_raw_data: bool = True) -> None:
        super().__init__(None, params=params,
                         categorical_feature=categorical_feature,
                         free_raw_data=free_raw_data)
        self.source = source
        # the chunk quantum (source.py): every chunk but the last is
        # exactly chunk_rows rows
        self.chunk_rows = _check_chunk_rows(source.chunk_rows)
        self.spill_dir = spill_dir
        self._own_spill = spill_dir is None
        self._spill_path: Optional[str] = None
        self._spill_fd: Optional[int] = None
        self.is_streamed = True

    # -- construction (two streaming passes) --------------------------------
    def construct(self, config: Optional[Config] = None) -> "StreamedDataset":
        if self.constructed:
            return self
        cfg = config or Config(self.params)
        ref = self.reference
        if ref is not None and not ref.constructed:
            ref.construct(cfg)
        if cfg.linear_tree:
            raise ValueError("linear_tree needs raw feature values resident "
                             "in memory; StreamedDataset does not keep them")
        reg = default_registry()
        rows_ctr = reg.counter("ingest_rows_total",
                               "rows streamed through ingest")
        chunks_ctr = reg.counter("ingest_chunks_total",
                                 "chunks streamed through ingest")
        spill_ctr = reg.counter("ingest_spill_bytes_total",
                                "binned bytes spilled to the disk cache")
        src = self.source
        n = src.num_rows()
        f = src.num_features()
        self.num_total_features = f
        names = src.feature_names()
        self.feature_names_ = list(names) if names else \
            [f"Column_{i}" for i in range(f)]
        self.efb = None
        self.raw_used = None
        cat_indices = self._resolve_categoricals(self.feature_names_)
        forced_bins = self._load_forced_bins(cfg)

        # ---- pass 1: sketch + metadata ------------------------------------
        sample_idx = sample_row_indices(n, int(cfg.bin_construct_sample_cnt),
                                        cfg.data_random_seed)
        sketch = BinningSketch(f, cat_indices)
        label = None
        weight = None
        with span("ingest/sketch_pass"):
            for chunk in src.chunks():
                m = chunk.X.shape[0]
                lo = np.searchsorted(sample_idx, chunk.offset)
                hi = np.searchsorted(sample_idx, chunk.offset + m)
                if ref is None and hi > lo:
                    local = sample_idx[lo:hi] - chunk.offset
                    sketch.update(np.asarray(chunk.X, np.float64)[local])
                if chunk.label is not None:
                    if label is None:
                        label = np.empty(n, np.float64)
                    label[chunk.offset:chunk.offset + m] = chunk.label
                if chunk.weight is not None:
                    if weight is None:
                        weight = np.ones(n, np.float64)
                    weight[chunk.offset:chunk.offset + m] = chunk.weight
                rows_ctr.inc(m)
                chunks_ctr.inc()
        # one process: the merge is a no-op (sketch.py)
        sketch.allgather_merge()

        def _filt(sample_total: int) -> int:
            if not cfg.feature_pre_filter:
                return 0
            return max(1, int(cfg.min_data_in_leaf * sample_total /
                              max(1, n)))

        if ref is not None:
            # align bins with the reference dataset (dataset.h:304, the
            # in-core reference path): a streamed valid set bins against
            # the TRAIN mappers so tree thresholds transfer
            if getattr(ref, "efb", None) is not None:
                raise ValueError(
                    "StreamedDataset cannot bin against an EFB-bundled "
                    "reference (the streamed binning pass has no bundle "
                    "step); construct the reference with "
                    "enable_bundle=false")
            self.bin_mappers = ref.bin_mappers
            self.used_feature_map = ref.used_feature_map
            self.num_bins_per_feature = ref.num_bins_per_feature
            self.efb = ref.efb
        else:
            self.bin_mappers = sketch.finalize(
                max_bin=cfg.max_bin, min_data_in_bin=cfg.min_data_in_bin,
                use_missing=cfg.use_missing,
                zero_as_missing=cfg.zero_as_missing,
                forced_bins=forced_bins, pre_filter_cnt_fn=_filt)
            self._finalize_used_features(f)   # shared trivial-filter policy
        used_arr = self.used_feature_map
        mappers = [self.bin_mappers[j] for j in used_arr]
        used = [int(j) for j in used_arr]

        # ---- pass 2: bin + spill ------------------------------------------
        max_bins = max(m_.num_bin for m_ in mappers)
        dtype = np.uint8 if max_bins <= 256 else np.uint16
        if self.spill_dir is None:
            self.spill_dir = tempfile.mkdtemp(prefix="lgbm_tpu_ingest_")
        os.makedirs(self.spill_dir, exist_ok=True)
        self._spill_path = os.path.join(self.spill_dir, "binned.dat")
        # sequential buffered FILE writes, not memmap stores: dirty pages
        # of a writable mapping stay in this process's RSS until unmapped,
        # which would make the working set O(rows).  Sources stream in
        # offset order.
        with span("ingest/bin_spill"), open(self._spill_path, "wb") as fh:
            expect = 0
            for chunk in src.chunks():
                if chunk.offset != expect:
                    raise ValueError(
                        f"chunk source must stream rows in order (got "
                        f"offset {chunk.offset}, expected {expect})")
                binned = bin_matrix(
                    np.asarray(chunk.X, np.float64)[:, used_arr], mappers)
                fh.write(np.ascontiguousarray(
                    binned.astype(dtype, copy=False)).tobytes())
                spill_ctr.inc(int(binned.size) * binned.dtype.itemsize)
                expect += chunk.X.shape[0]
        # the Dataset-API view: a read-only memmap (no page is resident
        # until touched; the hbm route reads it once on upload)
        self.X_binned = np.memmap(self._spill_path, dtype=dtype, mode="r",
                                  shape=(n, len(used)))
        self._label_arg = label if self._label_arg is None else \
            self._label_arg
        self._weight_arg = weight if self._weight_arg is None else \
            self._weight_arg
        self._set_metadata(n)
        self.constructed = True
        log_info(f"StreamedDataset: {n} rows x {len(used)} features binned "
                 f"in {src.num_chunks()} chunks of {self.chunk_rows} "
                 f"(spill: {self._spill_path}, "
                 f"{os.path.getsize(self._spill_path) >> 20} MB)")
        return self

    # -- chunk access for the chunked trainer --------------------------------
    def num_chunks(self) -> int:
        self._check_constructed()
        return -(-int(self.X_binned.shape[0]) // self.chunk_rows)

    def chunk_bounds(self, i: int) -> Tuple[int, int]:
        lo = i * self.chunk_rows
        return lo, min(lo + self.chunk_rows, int(self.X_binned.shape[0]))

    def _fd(self) -> int:
        if self._spill_fd is None:
            self._spill_fd = os.open(self._spill_path, os.O_RDONLY)
        return self._spill_fd

    def read_chunk_into(self, i: int, out: np.ndarray) -> None:
        """Read chunk ``i``'s (m, F) binned codes straight into ``out`` (a
        C-contiguous (m, F) view, e.g. of a pinned upload buffer) with
        positioned reads on a kept fd: no page of the cache stays mapped,
        and no intermediate copy is made."""
        self._check_constructed()
        lo, hi = self.chunk_bounds(i)
        f = self.X_binned.shape[1]
        if out.shape != (hi - lo, f) or out.dtype != self.X_binned.dtype \
                or not out.flags.c_contiguous:
            raise ValueError(f"chunk {i} reads into a C-contiguous "
                             f"({hi - lo}, {f}) {self.X_binned.dtype} array")
        view = memoryview(out).cast("B")
        off = lo * f * self.X_binned.dtype.itemsize
        got = 0
        while got < len(view):
            k = os.preadv(self._fd(), [view[got:]], off + got)
            if k <= 0:
                raise IOError(f"short read from spill cache "
                              f"{self._spill_path}")
            got += k

    def binned_chunk(self, i: int) -> np.ndarray:
        """(m, F) binned codes of chunk ``i``, read with positioned reads
        (NOT through the memmap: a mapping's touched pages pile up in RSS
        for the run's lifetime)."""
        lo, hi = self.chunk_bounds(i)
        out = np.empty((hi - lo, self.X_binned.shape[1]), self.X_binned.dtype)
        self.read_chunk_into(i, out)
        return out

    # -- spill lifecycle -----------------------------------------------------
    def close(self) -> None:
        """Release the spill cache.  Self-created temp spill dirs are
        deleted (a CV sweep constructing many StreamedDatasets must not
        accumulate orphaned binned caches); caller-provided ``spill_dir``s
        are left in place for reuse."""
        if self._spill_fd is not None:
            try:
                os.close(self._spill_fd)
            except OSError:
                pass
            self._spill_fd = None
        self.X_binned = None
        self._device_cache = {}
        if self._own_spill and self.spill_dir is not None:
            import shutil
            shutil.rmtree(self.spill_dir, ignore_errors=True)
            self.spill_dir = None
        self.constructed = False

    def __del__(self):  # best effort; close() is the reliable path
        try:
            if getattr(self, "_own_spill", False) and \
                    getattr(self, "spill_dir", None):
                self.close()
        except Exception:
            pass

    def binned_chunks(self) -> Iterator[Tuple[int, np.ndarray]]:
        for i in range(self.num_chunks()):
            yield self.chunk_bounds(i)[0], self.binned_chunk(i)

    # -- fingerprint: stream the crc instead of materializing ----------------
    def fingerprint(self) -> Dict[str, Any]:
        self._check_constructed()
        fp = self._device_cache.get("_fingerprint")
        if fp is not None:
            return fp
        # incremental crc over row blocks == one-shot crc over the full
        # buffer (zlib.crc32 chains), so this equals the in-core
        # fingerprint of the same binned matrix
        crc = 0
        for _, block in self.binned_chunks():
            crc = zlib.crc32(np.ascontiguousarray(block).tobytes(), crc)
        fp = self._fingerprint_with_crc(crc)
        self._device_cache["_fingerprint"] = fp
        return fp
