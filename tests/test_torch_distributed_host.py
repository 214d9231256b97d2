"""The port's host allgather behind pre-partitioned ingest
(``lightgbm_tpu_torch.distributed.allgather_host``) and the
mergeable-sketch merge that rides it, on the simulated two-rank wire of
tests/test_distributed_host.py.

The world is SIMULATED: ``torch.distributed.all_gather`` is replaced by
a fake that answers each call from the full set of per-rank operands, in
the form allgather_host sends them (a length probe, then every rank's
rows as raw bytes max-padded), so the padding, trim and rank-order logic
runs as in a real 2-process gloo run, in one process.  The five cases of
the reference's file, as cases of one parametrised test: float64 bits
(NaN payloads, -0.0, a denormal) come back bit for bit; ranks with no
rows vanish; the concatenation is rank-major with unequal lengths; one
process passes its array through; and two half-data sketches merged over
the wire finalize into the mappers of one sketch over all rows.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch import distributed as dist
from lightgbm_tpu_torch.ingest.sketch import BinningSketch


def _wire_form(a):
    """A rank's operand as allgather_host puts it on the wire: its rows
    as raw bytes."""
    a = np.asarray(a)
    a = a.reshape(1) if a.ndim == 0 else a
    width = a.dtype.itemsize * int(np.prod(a.shape[1:], dtype=np.int64))
    return np.ascontiguousarray(a).view(np.uint8).reshape(a.shape[0], width)


def _gather_as_rank(rank_inputs, monkeypatch, rank=0):
    """Rank ``rank``'s allgather_host against the simulated world."""
    rows = [_wire_form(a) for a in rank_inputs]
    calls = {"n": 0}

    def fake_all_gather(outs, t):
        i, calls["n"] = calls["n"], calls["n"] + 1
        if i == 0:           # the length probe
            for o, r in zip(outs, rows):
                o.copy_(torch.tensor([r.shape[0]], dtype=torch.int64))
            return
        m = max(r.shape[0] for r in rows)
        for o, r in zip(outs, rows):
            buf = np.zeros((m, r.shape[1]), np.uint8)
            buf[:r.shape[0]] = r
            o.copy_(torch.from_numpy(buf))

    monkeypatch.setattr(dist, "process_count", lambda: len(rank_inputs))
    monkeypatch.setattr(torch.distributed, "all_gather", fake_all_gather)
    return dist.allgather_host(np.asarray(rank_inputs[rank]))


def _float64_bits(monkeypatch):
    a0 = np.array([np.pi, -0.0, 5e-324, 1.0 + 2 ** -52], np.float64)
    a1 = np.array([np.nan, -np.inf, 1e308], np.float64)
    got = _gather_as_rank([a0, a1], monkeypatch)
    want = np.concatenate([a0, a1])
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def _empty_ranks(monkeypatch):
    a0 = np.arange(6, dtype=np.int32)
    a1 = np.zeros((0,), np.int32)
    np.testing.assert_array_equal(_gather_as_rank([a0, a1], monkeypatch), a0)
    np.testing.assert_array_equal(_gather_as_rank([a1, a0], monkeypatch), a0)
    assert _gather_as_rank([a1, a1.copy()], monkeypatch).shape == (0,)


def _rank_order(monkeypatch):
    a0 = np.full((3, 2), 7, np.int32)
    a1 = np.full((5, 2), 9, np.int32)
    np.testing.assert_array_equal(_gather_as_rank([a0, a1], monkeypatch),
                                  np.concatenate([a0, a1]))
    np.testing.assert_array_equal(
        _gather_as_rank([a0, a1], monkeypatch, rank=1),
        np.concatenate([a0, a1]))


def _single_process(monkeypatch):
    a = np.array([1.5, np.nan, -0.0], np.float64)
    got = dist.allgather_host(a)
    np.testing.assert_array_equal(np.asarray(got).view(np.uint64),
                                  a.view(np.uint64))


def _sketch_merge(monkeypatch):
    rng = np.random.RandomState(0)
    rows = rng.randn(400, 5)
    rows[rng.rand(400) < 0.1, 2] = np.nan
    rows[:, 4] = rng.randint(0, 6, 400)          # categorical-ish
    sketches = []
    for part in (rows[:200], rows[200:]):
        sk = BinningSketch(5, cat_indices=[4])
        sk.update(part)
        sketches.append(sk)
    payloads = [sk.serialize() for sk in sketches]
    calls = {"n": 0}

    def fake_allgather(arr):
        # allgather_merge's fixed call sequence: sizes, flats, layouts
        i, calls["n"] = calls["n"], calls["n"] + 1
        if i % 3 == 0:
            return np.asarray([len(p[0]) for p in payloads], np.int64)
        if i % 3 == 1:
            return np.concatenate([p[0] for p in payloads])
        return np.concatenate([p[1].reshape(-1) for p in payloads])

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "allgather_host", fake_allgather)
    merged = sketches[0].allgather_merge()
    assert merged.rows_seen == 400
    full = BinningSketch(5, cat_indices=[4])
    full.update(rows)
    kw = dict(max_bin=63, min_data_in_bin=3)
    for j, (g, w) in enumerate(zip(merged.finalize(**kw),
                                   full.finalize(**kw))):
        assert g.num_bin == w.num_bin, j
        assert g.is_categorical == w.is_categorical, j
        np.testing.assert_array_equal(
            np.asarray(g.bin_upper_bound, np.float64),
            np.asarray(w.bin_upper_bound, np.float64), err_msg=f"f{j}")


@pytest.mark.parametrize("case", [_float64_bits, _empty_ranks, _rank_order,
                                  _single_process, _sketch_merge],
                         ids=lambda f: f.__name__.strip("_"))
def test_allgather_host_and_sketch_merge(case, monkeypatch):
    case(monkeypatch)
