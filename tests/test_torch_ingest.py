"""Out-of-core ingestion of the port held against the JAX package:
sources, the streaming sketch, StreamedDataset and the ``hbm`` route.

The same seeded data goes through ``lightgbm_tpu.ingest`` and
``lightgbm_tpu_torch.ingest`` (the CPU, no kernel):

* the sources stream the rows the reference's stream;
* a sketch's merged summaries and its wire form equal the reference's,
  and finalize to the reference's mappers;
* a StreamedDataset's bin mappers, binned matrix and fingerprint equal
  the reference's StreamedDataset and the port's in-core Dataset,
  across chunk boundaries at 2048 and 2049 rows; the spill is on disk;
* the ``hbm`` route (``tpu_ingest_mode=hbm``, the default) trains the
  port's in-core text; quantized, the reference's text too, exact its
  tree structure;
* the ``ingest/chunk_pipeline`` budget is flat in rows.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu.ingest as ringest
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.binning import (find_bin, find_bin_from_summary,
                                        merge_column_summaries,
                                        summarize_column)
from lightgbm_tpu_torch.ingest import (ArraySource, BinningSketch, CSVSource,
                                       NumpyMmapSource, StreamedDataset,
                                       SyntheticSource, sample_row_indices)

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)


def _data(n=3001, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    if f > 2:
        X[:, 2] = np.where(rng.rand(n) < 0.3, 0.0, X[:, 2])
    if f > 3:
        X[:, 3] = np.where(rng.rand(n) < 0.1, np.nan, X[:, 3])
    if f > 4:
        X[:, 4] = rng.randint(0, 9, n)
    y = (X[:, 0] + np.nan_to_num(X[:, 1]) * 0.5 +
         rng.randn(n) * 0.5 > 0).astype(np.float64)
    return X, y


def _mappers_equal(a, b):
    assert len(a) == len(b)
    for j, (ma, mb) in enumerate(zip(a, b)):
        assert ma.num_bin == mb.num_bin, j
        assert ma.is_categorical == mb.is_categorical, j
        assert ma.missing_type.value == mb.missing_type.value, j
        assert ma.default_bin == mb.default_bin, j
        assert ma.most_freq_bin == mb.most_freq_bin, j
        assert ma.forced_trivial == mb.forced_trivial, j
        if ma.bin_upper_bound is not None or mb.bin_upper_bound is not None:
            assert np.array_equal(ma.bin_upper_bound, mb.bin_upper_bound), j
        assert ma.cat_to_bin == mb.cat_to_bin, j


# ---------------------------------------------------------------------------
# summaries / sketch
# ---------------------------------------------------------------------------

def test_summary_merge_matches_one_shot():
    rng = np.random.RandomState(1)
    vals = np.concatenate([rng.randn(500), np.zeros(100),
                           np.full(30, np.nan), rng.randn(200) * 1e-3])
    rng.shuffle(vals)
    one = find_bin(vals, max_bin=63)
    parts = [summarize_column(vals[i::7]) for i in range(7)]
    merged = parts[0]
    for p in parts[1:]:
        merged = merge_column_summaries(merged, p)
    _mappers_equal([one], [find_bin_from_summary(merged, 63)])


def test_summary_merge_categorical():
    rng = np.random.RandomState(2)
    vals = rng.randint(0, 40, 2000).astype(np.float64)
    one = find_bin(vals, max_bin=16, is_categorical=True)
    a = summarize_column(vals[:777], is_categorical=True)
    b = summarize_column(vals[777:], is_categorical=True)
    _mappers_equal([one], [find_bin_from_summary(
        merge_column_summaries(a, b), 16)])


def test_sketch_merge_and_wire_form_match_reference():
    X, _ = _data()
    sk = BinningSketch(X.shape[1], cat_indices=[4])
    rk = ringest.BinningSketch(X.shape[1], cat_indices=[4])
    for part in (X[:1000], X[1000:2200], X[2200:]):
        sk.update(part)
        rk.update(part)
    # a second sketch merged in, as the distributed merge folds ranks
    sk.merge(BinningSketch(X.shape[1], [4]))
    flat, layout = sk.serialize()
    rflat, rlayout = rk.serialize()
    assert np.array_equal(flat, rflat) and np.array_equal(layout, rlayout)
    sk2 = BinningSketch.deserialize(rflat, rlayout, cat_indices=[4])
    for j in range(X.shape[1]):
        a, b = sk.summary(j), sk2.summary(j)
        assert np.array_equal(a.distinct, b.distinct)
        assert np.array_equal(a.counts, b.counts)
        assert (a.na_cnt, a.total_cnt) == (b.na_cnt, b.total_cnt)
    kw = dict(max_bin=63, min_data_in_bin=3)
    _mappers_equal(sk.finalize(**kw), rk.finalize(**kw))
    # one process: the distributed merge is a no-op
    assert sk.allgather_merge() is sk


def test_sample_row_indices_is_the_reference_draw():
    n, cnt, seed = 5000, 1200, 17
    got = sample_row_indices(n, cnt, seed)
    assert np.array_equal(got, ringest.sample_row_indices(n, cnt, seed))
    rng = np.random.RandomState(seed)
    assert np.array_equal(got, np.sort(rng.choice(n, size=cnt,
                                                  replace=False)))
    # one copy in the port: the sketch's is the dataset's
    from lightgbm_tpu_torch import dataset
    assert sample_row_indices is dataset.sample_row_indices


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------

def test_chunk_rows_quantum_validated():
    with pytest.raises(ValueError, match="multiple"):
        ArraySource(np.zeros((10, 2)), chunk_rows=100)


def test_numpy_mmap_source(tmp_path):
    X, y = _data(1500, 4, seed=3)
    np.save(tmp_path / "x.npy", X)
    np.save(tmp_path / "y.npy", y)
    src = NumpyMmapSource(str(tmp_path / "x.npy"), str(tmp_path / "y.npy"),
                          chunk_rows=512)
    ref = ringest.NumpyMmapSource(str(tmp_path / "x.npy"),
                                  str(tmp_path / "y.npy"), chunk_rows=512)
    assert src.num_rows() == 1500 and src.num_features() == 4
    for a, b in zip(src.chunks(), ref.chunks()):
        assert a.offset == b.offset
        assert np.array_equal(np.nan_to_num(a.X), np.nan_to_num(b.X))
        assert np.array_equal(a.label, b.label)
    got = np.concatenate([c.X for c in src.chunks()])
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(X))


def test_csv_source(tmp_path):
    rng = np.random.RandomState(4)
    X = rng.randn(700, 3)
    y = (X[:, 0] > 0).astype(np.float64)
    path = tmp_path / "d.csv"
    with open(path, "w") as fh:
        for i in range(700):
            fh.write(",".join(f"{v:.9g}" for v in [y[i]] + list(X[i])) + "\n")
    src = CSVSource(str(path), chunk_rows=256)
    assert src.num_rows() == 700 and src.num_features() == 3
    got = np.concatenate([c.X for c in src.chunks()])
    lab = np.concatenate([c.label for c in src.chunks()])
    assert np.allclose(got, X, atol=1e-7)
    assert np.array_equal(lab, y)
    ref = np.concatenate([c.X for c in ringest.CSVSource(
        str(path), chunk_rows=256).chunks()])
    assert np.array_equal(got, ref)


def test_csv_source_comments_and_header(tmp_path):
    rng = np.random.RandomState(8)
    X = rng.randn(300, 2)
    y = (X[:, 0] > 0).astype(np.float64)
    path = tmp_path / "c.csv"
    with open(path, "w") as fh:
        fh.write("# a comment before the header\n")
        fh.write("target,a,b\n")
        fh.write("# and one after\n")
        for i in range(300):
            fh.write(f"{y[i]:g},{X[i,0]:.9g},{X[i,1]:.9g}\n")
    src = CSVSource(str(path), params={"header": "true"}, chunk_rows=256)
    assert src.num_rows() == 300 and src.num_features() == 2
    assert src.feature_names() == ["a", "b"]
    got = np.concatenate([c.X for c in src.chunks()])
    assert np.allclose(got, X, atol=1e-7)
    sd = StreamedDataset(src, params={"verbosity": -1}).construct()
    assert sd.num_data() == 300
    assert sd.feature_names == ["a", "b"]


def test_arrow_source(tmp_path):
    pa = pytest.importorskip("pyarrow")
    pq = pytest.importorskip("pyarrow.parquet")
    from lightgbm_tpu_torch.ingest import ArrowSource
    rng = np.random.RandomState(6)
    X = rng.randn(900, 3)
    y = (X[:, 0] > 0).astype(np.float64)
    tbl = pa.table({"f0": X[:, 0], "f1": X[:, 1], "f2": X[:, 2],
                    "target": y})
    path = str(tmp_path / "d.parquet")
    pq.write_table(tbl, path, row_group_size=256)
    src = ArrowSource(path, label="target", chunk_rows=256)
    assert src.feature_names() == ["f0", "f1", "f2"]
    got = np.concatenate([c.X for c in src.chunks()])
    assert np.allclose(got, X)
    params = {"verbosity": -1, "enable_bundle": False}
    sd = StreamedDataset(src, params=params).construct()
    ds = lt.Dataset(X.copy(), label=y.copy(), params=params).construct()
    assert np.array_equal(np.asarray(ds.X_binned), np.asarray(sd.X_binned))


def test_arrow_source_import_is_lazy():
    """``pyarrow`` is imported when an ArrowSource is built, never when
    the package is: the module imports without it."""
    import sys
    from lightgbm_tpu_torch.ingest import source
    assert "pyarrow" not in source.__dict__
    if "pyarrow" not in sys.modules:
        try:
            import pyarrow  # noqa: F401
        except ImportError:
            with pytest.raises(ImportError, match="pyarrow"):
                source.ArrowSource("missing.parquet")


def test_synthetic_source_matches_reference():
    src = SyntheticSource(2000, 5, chunk_rows=512, seed=9)
    a = [c.X.copy() for c in src.chunks()]
    b = [c.X.copy() for c in src.chunks()]
    r = [c.X for c in ringest.SyntheticSource(2000, 5, chunk_rows=512,
                                              seed=9).chunks()]
    for xa, xb, xr in zip(a, b, r):
        assert np.array_equal(xa, xb) and np.array_equal(xa, xr)
    assert sum(len(x) for x in a) == 2000


# ---------------------------------------------------------------------------
# StreamedDataset: construct identity with the reference and in-core
# ---------------------------------------------------------------------------

def test_streamed_dataset_matches_reference_and_incore():
    X, y = _data()
    params = {"verbosity": -1, "enable_bundle": False,
              "bin_construct_sample_cnt": 1200}
    ds = lt.Dataset(X.copy(), label=y.copy(), params=params,
                    categorical_feature=[4]).construct()
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=params,
                         categorical_feature=[4]).construct()
    rsd = ringest.StreamedDataset(ringest.ArraySource(X, y, chunk_rows=512),
                                  params=params,
                                  categorical_feature=[4]).construct()
    _mappers_equal(ds.bin_mappers, sd.bin_mappers)
    _mappers_equal(rsd.bin_mappers, sd.bin_mappers)
    assert np.array_equal(ds.used_feature_map, sd.used_feature_map)
    assert np.array_equal(np.asarray(ds.X_binned), np.asarray(sd.X_binned))
    assert np.array_equal(np.asarray(rsd.X_binned), np.asarray(sd.X_binned))
    assert ds.fingerprint() == sd.fingerprint() == rsd.fingerprint()
    assert np.array_equal(ds.metadata.label, sd.metadata.label)
    # chunk reads straight into a buffer are the cache's rows
    out = np.empty((512, sd.X_binned.shape[1]), np.uint8)
    sd.read_chunk_into(1, out)
    assert np.array_equal(out, np.asarray(ds.X_binned)[512:1024])


@pytest.mark.parametrize("n", [2048, 2049])
def test_streamed_dataset_chunk_boundaries(n):
    X, y = _data(n, 5, seed=11)
    params = {"verbosity": -1, "enable_bundle": False}
    ds = lt.Dataset(X.copy(), label=y.copy(), params=params).construct()
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512),
                         params=params).construct()
    assert sd.num_chunks() == -(-n // 512)
    assert sd.chunk_bounds(sd.num_chunks() - 1)[1] == n
    assert np.array_equal(np.asarray(ds.X_binned), np.asarray(sd.X_binned))
    assert np.array_equal(
        np.concatenate([b for _, b in sd.binned_chunks()]),
        np.asarray(ds.X_binned))
    assert ds.fingerprint() == sd.fingerprint()


def test_streamed_dataset_spill_is_on_disk(tmp_path):
    X, y = _data(2048, 4, seed=5)
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512),
                         params={"verbosity": -1},
                         spill_dir=str(tmp_path)).construct()
    assert isinstance(sd.X_binned, np.memmap)
    assert os.path.getsize(os.path.join(str(tmp_path), "binned.dat")) == \
        sd.X_binned.shape[0] * sd.X_binned.shape[1]
    # caller-provided spill dirs survive close() (reusable caches)...
    sd.close()
    assert os.path.exists(os.path.join(str(tmp_path), "binned.dat"))
    # ...self-created temp spills are deleted
    sd2 = StreamedDataset(ArraySource(X, y, chunk_rows=512),
                          params={"verbosity": -1}).construct()
    own = sd2.spill_dir
    assert own and os.path.exists(own)
    sd2.close()
    assert not os.path.exists(own)


# ---------------------------------------------------------------------------
# engine.train (hbm route): the reference's text
# ---------------------------------------------------------------------------

_BASE = {"objective": "binary", "verbosity": -1, "num_leaves": 13,
         "learning_rate": 0.2, "max_bin": 63, "min_data_in_leaf": 5,
         "enable_bundle": False, "seed": 3, "tpu_histogram_impl": "pallas",
         "tree_grow_mode": "wave", "stochastic_rounding": False}


def _structure(text):
    keep = ("Tree=", "num_leaves=", "split_feature=", "threshold=",
            "left_child=", "right_child=", "leaf_count=")
    return [ln for ln in text.splitlines() if ln.startswith(keep)]


@pytest.mark.parametrize("name,extra", [
    ("partition", {"tree_grow_mode": "partition"}),
    ("wave", {"tpu_wave_size": 4}),
    ("quantized", {"use_quantized_grad": True}),
])
def test_hbm_route_matches_reference(name, extra):
    """The streamed binned cache trains the in-core text of the port; the
    quantized text is the reference's too, exact training its structure
    (the rule of tests/test_torch_slice.py)."""
    X, y = _data(3001, 6, seed=7)
    X = np.nan_to_num(X)
    p = dict(_BASE)
    p.update(extra)
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=512), params=p)
    got = lt.train(p, sd, 5, device="cpu").model_to_string()
    assert got == lt.train(p, lt.Dataset(X.copy(), label=y.copy()), 5,
                           device="cpu").model_to_string(), name
    rsd = ringest.StreamedDataset(ringest.ArraySource(X, y, chunk_rows=512),
                                  params=p)
    ref = lgb.train(p, rsd, 5).model_to_string()
    if p.get("use_quantized_grad"):
        assert got == ref, name
    else:
        assert _structure(got) == _structure(ref), name


# ---------------------------------------------------------------------------
# memory budget: no rows term
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quantized", [True, False])
def test_ingest_memory_budget_flat_in_rows(quantized):
    from lightgbm_tpu_torch.analysis.contracts import (memory_budget_for,
                                                       resolve_limit)
    b = memory_budget_for("ingest")
    assert b is not None and b.name == "ingest/chunk_pipeline"
    assert b.declared_in == "lightgbm_tpu_torch.ingest.stream"
    ctx = {"features": 28, "bins": 255, "wave_size": 0, "leaves": 255,
           "chunk_rows": 1 << 20, "quantized": quantized}
    small = resolve_limit(b.hbm_per_device, dict(ctx, rows=10 ** 3))
    huge = resolve_limit(b.hbm_per_device, dict(ctx, rows=10 ** 12))
    assert small == huge, "ingest budget must not depend on total rows"
    # but it scales with the chunk size
    bigger = resolve_limit(b.hbm_per_device,
                           dict(ctx, chunk_rows=1 << 24, rows=10 ** 3))
    assert bigger > small
