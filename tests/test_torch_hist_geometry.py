"""The launch geometry of the leaf-channel histogram kernels
(csrc/hist_leaves.cu) and the q8 kernel's packed (g, h) accumulator.

The kernel runs only on the card; what decides its blocks is the plain
Python of ``ops/histogram_cuda.py`` ``leaf_geometry``, checked here on the
CPU (``_blocks`` repeats the kernel's index arithmetic): every
(channel, feature, row) cell is covered by exactly one block, each block's
shared memory fits one block's limit and the block fits an SM's shared
memory and threads (registers are checked on the card: ``chip_smoke.py``
prints ``ptxas``'s count from the build), so the grid sized for one
resident round is one round.
"""

import numpy as np
import pytest
import torch

from lightgbm_tpu_torch.ops import histogram_cuda as hc

F = 28
SMS = 132          # H100 SXM
SM_THREADS = 2048  # resident threads an H100 SM holds
SM_SMEM = 233_472  # an H100 SM's shared memory, 1 KB of it per block kept
SMEM_RESERVED = 1024
ROWS = [17, 4096, 1_000_003, 10_502_144, 1 << 24]
PACKED_ROWS = [4096, 10_502_144, 1 << 24]   # packed: 4096-row multiples

CASES = ([(k, b, False, n) for k in (hc.LEAF_CHANNELS, hc.Q_LEAF_CHANNELS)
          for b in (1, 5, 16, 17, 255, 256) for n in ROWS] +
         [(k, b, True, n) for k in (hc.LEAF_CHANNELS, hc.Q_LEAF_CHANNELS)
          for b in (1, 5, 16) for n in PACKED_ROWS])


def _blocks(geo, f, n, k):
    """(channels, features, rows) ranges of every block, as
    hist_leaves_kernel computes them from its block index."""
    for y in range(geo.chunks):
        r0 = y * geo.chunk_rows
        for x in range(geo.c_groups * geo.f_groups):
            c0 = (x % geo.c_groups) * geo.cg
            f0 = (x // geo.c_groups) * geo.fg
            yield ((c0, min(k, c0 + geo.cg)), (f0, min(f, f0 + geo.fg)),
                   (r0, min(n, r0 + geo.chunk_rows)))


def _pack_gh(g, h):
    """The q8 kernel's 64-bit accumulator of int8 (g, h): (g << 32) + h,
    in int64 arithmetic that wraps as the kernel's does."""
    return (g.to(torch.int64) << 32) + h.to(torch.int64)


def _unpack_gh(acc):
    """The kernel's flush: the low word, signed, is sum h; the rest,
    shifted down, sum g."""
    lo = acc & 0xFFFFFFFF
    hs = torch.where(lo >= 1 << 31, lo - (1 << 32), lo)
    return (acc - hs) >> 32, hs


def _geo(k, b, packed, n):
    return hc.leaf_geometry(SMS, F, n, b, k, k == hc.Q_LEAF_CHANNELS, packed)


@pytest.mark.parametrize("k,num_bins,packed,n", CASES)
def test_leaf_blocks_cover_every_cell_once(k, num_bins, packed, n):
    geo = _geo(k, num_bins, packed, n)
    assert geo.chunk_rows % hc.LEAF_ROW_STEP == 0    # warp steps align
    assert geo.chunk_rows <= (hc.Q8_MAX_BLOCK_ROWS
                              if k == hc.Q_LEAF_CHANNELS
                              else hc.LEAF_MAX_BLOCK_ROWS)
    cover = np.zeros((k, F), np.int64)
    spans = {}
    for (c0, c1), (f0, f1), (r0, r1) in _blocks(geo, F, n, k):
        assert c0 < c1 and f0 < f1 and r0 < r1   # no empty block
        assert (c1 - c0) <= geo.cg and (f1 - f0) <= geo.fg
        cover[c0:c1, f0:f1] += r1 - r0
        spans.setdefault((c0, f0), []).append((r0, r1))
    assert (cover == n).all()
    for rows in spans.values():       # each group's chunks tile [0, n)
        rows.sort()
        assert rows[0][0] == 0 and rows[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))


@pytest.mark.parametrize("k,num_bins,packed,n", CASES)
def test_leaf_geometry_fits_the_sm(k, num_bins, packed, n):
    geo = _geo(k, num_bins, packed, n)
    acc = 12 if k == hc.Q_LEAF_CHANNELS else 20
    assert geo.smem == (geo.cg * geo.fg * num_bins * acc +
                        hc.LEAF_THREADS * hc.LEAF_QUEUE_BYTES)
    assert geo.smem <= hc.BLOCK_SMEM
    assert geo.smem + SMEM_RESERVED <= SM_SMEM
    assert hc.LEAF_THREADS <= SM_THREADS and geo.cg < 128   # queue entry bits
    blocks = geo.c_groups * geo.f_groups * geo.chunks
    assert blocks <= SMS                       # one resident round
    assert geo.c_groups == -(-k // geo.cg)
    assert geo.f_groups == -(-F // geo.fg)


@pytest.mark.parametrize("k", [hc.LEAF_CHANNELS, hc.Q_LEAF_CHANNELS])
@pytest.mark.parametrize("num_bins", [1, 15, 16, 255, 256])
def test_leaf_geometry_picks_the_fewest_block_columns(k, num_bins):
    """Every candidate group fits one block, each channel count once with
    the most features that fit; the geometry takes the fewest block
    columns, and of those the most channels per block."""
    q8 = k == hc.Q_LEAF_CHANNELS
    groups = hc.leaf_groups(F, num_bins, k, q8)
    budget = hc.BLOCK_SMEM - hc.LEAF_THREADS * hc.LEAF_QUEUE_BYTES
    pair = num_bins * (12 if q8 else 20)
    assert len({cg for cg, _ in groups}) == len(groups)
    for cg, fg in groups:
        assert cg * fg * pair <= budget
        more = -(-F // (-(-F // fg) - 1)) if fg < F else None
        assert more is None or cg * more * pair > budget
    geo = hc.leaf_geometry(SMS, F, 10_502_144, num_bins, k, q8, False)
    assert (geo.cg, geo.fg) in groups
    cols = {g: -(-k // g[0]) * -(-F // g[1]) for g in groups}
    fewest = min(cols.values())
    assert cols[(geo.cg, geo.fg)] == fewest
    assert geo.cg == max(cg for (cg, fg), c in cols.items() if c == fewest)


def test_leaf_geometry_at_the_main_shapes():
    """The groups the wave grower's launches get at F=28 (uint8 at
    B=256, packed at the B=15 of max_bin=15): the fastest of every group
    in one replayed wave iteration on the H100 (PERF.md section 6)."""
    picks = [(hc.leaf_geometry(SMS, F, 10_502_144, b, k, q8, b < 16)[:2])
             for b in (256, 15) for k, q8 in ((hc.LEAF_CHANNELS, False),
                                              (hc.Q_LEAF_CHANNELS, True))]
    assert picks == [(13, 3), (21, 3), (25, 28), (42, 28)]


@pytest.mark.parametrize("q8", [True, False])
def test_leaf_geometry_caps_rows_per_block(q8):
    cap = hc.Q8_MAX_BLOCK_ROWS if q8 else hc.LEAF_MAX_BLOCK_ROWS
    n = 3 * cap + 5
    geo = hc.leaf_geometry(4, F, n, 256, hc.Q_LEAF_CHANNELS if q8 else
                           hc.LEAF_CHANNELS, q8, False)
    assert geo.chunk_rows <= cap
    assert geo.chunks * geo.chunk_rows >= n


def _wrapped(v: int) -> torch.Tensor:
    """A Python integer as the kernel's uint64 register, read as int64."""
    v %= 1 << 64
    return torch.tensor([v - (1 << 64) if v >= 1 << 63 else v],
                        dtype=torch.int64)


@pytest.mark.parametrize("g,h", [(-127, 127), (-128, -128), (127, 127),
                                 (-128, 127), (127, -128), (0, -1), (-1, 0)])
def test_q8_packed_gh_has_no_carry_at_the_row_cap(g, h):
    """Every row of a block (the most the wrapper admits) in one bin with
    the same (g, h): the packed sum still splits into sum g and sum h."""
    rows = hc.Q8_MAX_BLOCK_ROWS
    one = _pack_gh(torch.tensor([g]), torch.tensor([h]))
    assert int(one) == (g << 32) + h
    gs, hs = _unpack_gh(_wrapped(rows * int(one)))
    assert int(gs) == rows * g and int(hs) == rows * h


def test_q8_packed_gh_cap_is_tight():
    """One row past the cap at h = -128 leaves the signed low word."""
    rows = hc.Q8_MAX_BLOCK_ROWS + 1
    gs, hs = _unpack_gh(_wrapped(rows * ((-127 << 32) - 128)))
    assert int(hs) != rows * -128


def test_q8_packed_gh_prefix_sums():
    rng = np.random.RandomState(0)
    g = torch.from_numpy(rng.randint(-128, 128, 1 << 16).astype(np.int8))
    h = torch.from_numpy(rng.randint(-128, 128, 1 << 16).astype(np.int8))
    acc = torch.cumsum(_pack_gh(g, h), 0)
    gs, hs = _unpack_gh(acc)
    assert torch.equal(gs, torch.cumsum(g.to(torch.int64), 0))
    assert torch.equal(hs, torch.cumsum(h.to(torch.int64), 0))
