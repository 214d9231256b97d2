"""Out-of-core ingestion: streaming sketch binning and chunked
host-to-device training (port of ``lightgbm_tpu/ingest/``).

Layers:

* :mod:`.source` — ``ChunkSource`` row-block iterators (mmap ``.npy``,
  CSV/TSV, optional Arrow/parquet, deterministic synthetic);
* :mod:`.sketch` — one-pass mergeable per-feature summaries producing
  the BinMappers of an in-core construct;
* :mod:`.stream` — ``StreamedDataset``: two streaming passes into an
  on-disk binned cache, the full Dataset API on top;
* :mod:`.grower` / :mod:`.train` — chunk-accumulated wave training whose
  device memory has no term in total rows (``tpu_ingest_mode=chunked``),
  over the leaf-histogram and row-update kernels of ``csrc/``.
"""

from .source import (ArraySource, ArrowSource, Chunk, ChunkSource,
                     CSVSource, DEFAULT_CHUNK_ROWS, NumpyMmapSource,
                     SyntheticSource)
from .sketch import BinningSketch, sample_row_indices
from .stream import StreamedDataset
from .grower import ChunkedWaveGrower, StreamedEnvelopeError
from .train import train_streamed

__all__ = [
    "ArraySource", "ArrowSource", "Chunk", "ChunkSource", "CSVSource",
    "DEFAULT_CHUNK_ROWS", "NumpyMmapSource", "SyntheticSource",
    "BinningSketch", "sample_row_indices", "StreamedDataset",
    "ChunkedWaveGrower", "StreamedEnvelopeError", "train_streamed",
]
