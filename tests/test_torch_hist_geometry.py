"""The launch geometry of the leaf-channel histogram kernels
(csrc/hist_leaves.cu) and the q8 kernel's packed (g, h) accumulator, and
of the single-leaf histogram (csrc/hist_single.cu, ``single_geometry``,
and its model-axis work items, ``lane_single_items``).

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

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

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


def _lane_blocks(geo, f, n, k, lanes):
    """(lane, channels, features, rows) of every block of the model-axis
    launch in dispatch order, as hist_leaves_kernel computes them from
    its block index (x the block column, y the lane, z the row chunk)."""
    for z in range(geo.chunks):
        r0 = z * geo.chunk_rows
        for y in range(lanes):
            for x in range(geo.c_groups * geo.f_groups):
                c0 = (x % geo.c_groups) * geo.cg
                f0 = (x // geo.c_groups) * geo.fg
                yield (y, (c0, min(k, c0 + geo.cg)), (f0, min(f, f0 + geo.fg)),
                       (r0, min(n, r0 + geo.chunk_rows)))


LANE_CASES = ([(k, b, False, n) for k in (hc.LEAF_CHANNELS,
                                          hc.Q_LEAF_CHANNELS)
               for b in (16, 256) for n in (17, 1_000_003, 10_502_144)] +
              [(k, 16, True, n) for k in (hc.LEAF_CHANNELS,
                                          hc.Q_LEAF_CHANNELS)
               for n in (4096, 10_502_144)])


@pytest.mark.parametrize("lanes", [1, 3, 4, 8])
@pytest.mark.parametrize("k,num_bins,packed,n", LANE_CASES)
def test_lane_leaf_items_cover_every_cell_once(k, num_bins, packed, n,
                                               lanes):
    """The model-axis leaf launch: every (lane, channel group, feature
    group, row) in exactly one block, no q8 block past 2^24 rows (its
    int32 sums), each row chunk's blocks of every lane dispatched
    together, and whole resident rounds of 132 SMs costing no more rows
    a slot than L single launches (:func:`leaf_geometry`'s grid, one
    round each at these shapes)."""
    q8 = k == hc.Q_LEAF_CHANNELS
    geo = hc.lane_leaf_geometry(SMS, F, n, num_bins, k, q8, packed, lanes)
    one = hc.leaf_geometry(SMS, F, n, num_bins, k, q8, packed)
    assert (geo.cg, geo.fg, geo.smem) == (one.cg, one.fg, one.smem)
    assert geo.chunk_rows % hc.LEAF_ROW_STEP == 0
    assert geo.chunk_rows <= (hc.Q8_MAX_BLOCK_ROWS if q8
                              else hc.LEAF_MAX_BLOCK_ROWS)
    assert geo.chunks <= 65_535        # grid z
    cover = np.zeros((lanes, k, F), np.int64)
    spans = {}
    order = []
    for y, (c0, c1), (f0, f1), (r0, r1) in _lane_blocks(geo, F, n, k,
                                                         lanes):
        assert c0 < c1 and f0 < f1 and r0 < r1   # no empty block
        cover[y, c0:c1, f0:f1] += r1 - r0
        spans.setdefault((y, c0, f0), []).append((r0, r1))
        order.append(r0)
    assert (cover == n).all()
    for rows in spans.values():       # each group's chunks tile [0, n)
        rows.sort()
        assert rows[0][0] == 0 and rows[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert order == sorted(order)     # chunk by chunk over the lanes
    items = geo.c_groups * geo.f_groups * lanes * geo.chunks
    singles = one.c_groups * one.f_groups * one.chunks
    assert (-(-items // SMS) * geo.chunk_rows <=
            lanes * -(-singles // SMS) * one.chunk_rows + hc.LEAF_ROW_STEP *
            -(-items // SMS))


def test_lane_leaf_items_at_the_main_shape():
    """Phase 12a's L=4 and 8 at F=28, N=10,502,144, B=256: the lanes fill
    5 and 11 rounds of 132 blocks where L single launches take 4 and 8
    rounds of 120 (LEAF_LANE_CHUNKS = 2)."""
    for q8, k in ((True, hc.Q_LEAF_CHANNELS), (False, hc.LEAF_CHANNELS)):
        got = [hc.lane_leaf_geometry(SMS, F, 10_502_144, 256, k, q8, False,
                                     lanes).chunks for lanes in (1, 4, 8)]
        assert got == [6, 8, 9]


@pytest.mark.parametrize("lanes", [1, 3, 4, 8])
@pytest.mark.parametrize("k,num_bins,packed,n", LANE_CASES)
def test_lane_leaf_chunks_fill_the_rounds_floor(k, num_bins, packed, n,
                                                lanes):
    """The lanes' row chunks give at least ``LEAF_LANE_ROUNDS`` rounds of
    132 resident blocks wherever ``LEAF_LANE_CHUNKS`` times the single
    form's chunks (and the 16-row steps) allow them, and otherwise the
    rule without the floor."""
    q8 = k == hc.Q_LEAF_CHANNELS
    geo = hc.lane_leaf_geometry(SMS, F, n, num_bins, k, q8, packed, lanes)
    one = hc.leaf_geometry(SMS, F, n, num_bins, k, q8, packed)
    units = one.c_groups * one.f_groups
    steps = -(-n // hc.LEAF_ROW_STEP)
    hi = min(steps, hc.LEAF_LANE_CHUNKS * one.chunks)
    need = -(-hc.LEAF_LANE_ROUNDS * SMS // (units * lanes))
    lo = -(-n // (hc.Q8_MAX_BLOCK_ROWS if q8 else hc.LEAF_MAX_BLOCK_ROWS))
    c = hc._lane_chunks(units, lanes, SMS, lo, hi, hc.LEAF_LANE_ROUNDS)
    assert geo.chunk_rows == -(-steps // c) * hc.LEAF_ROW_STEP
    if need <= hi:
        assert c >= need
    else:
        assert c == hc._lane_chunks(units, lanes, SMS, lo, hi)


def test_lane_leaf_chunks_at_the_main_shape_packed():
    """Phase 12a's packed shape (2 block columns at B=16): 66, 66 and 33
    chunks a lane at L = 1, 4 and 8, 2 and 4 rounds of 132 blocks."""
    for q8, k in ((True, hc.Q_LEAF_CHANNELS), (False, hc.LEAF_CHANNELS)):
        got = [hc.lane_leaf_geometry(SMS, F, 10_502_144, 16, k, q8, True,
                                     lanes).chunks for lanes in (1, 4, 8)]
        assert got == [66, 66, 33]


LIVE_MIXES = ("even", "empty lane", "one channel", "none kept")


def _live_mix(lanes, n, k, mix, seed):
    rng = np.random.RandomState(seed)
    ch = rng.randint(-1, 42, (lanes, n))
    if mix == "empty lane":
        ch[lanes // 2] = -1
    elif mix == "one channel":
        ch[:] = np.where(rng.rand(lanes, n) < 0.5, 7 % k, -1)
    elif mix == "none kept":
        ch[:] = -1
    return ch.astype(np.int8)


@pytest.mark.parametrize("mix", LIVE_MIXES)
@pytest.mark.parametrize("lanes,n", [(1, 1), (3, 1001), (4, 4096),
                                     (8, 65_537)])
@pytest.mark.parametrize("k", [hc.LEAF_CHANNELS, hc.Q_LEAF_CHANNELS])
def test_leaf_live_lanes_plain_matches_numpy(k, lanes, n, mix):
    """The live-channel flags (the plain version, which the CPU wrapper
    runs): 1 exactly where a lane holds a row in channel c < K; rows
    outside [0, K) (-1, or a q8 channel past the exact form's 25) mark
    nothing."""
    ch = _live_mix(lanes, n, k, mix, 7 + lanes)
    want = np.zeros((lanes, k), np.int32)
    for y in range(lanes):
        for c in ch[y]:
            if 0 <= c < k:
                want[y, c] = 1
    got = hc.leaf_live_lanes([torch.from_numpy(c) for c in ch],
                             num_channels=k)
    assert got.dtype == torch.int32 and got.shape == (lanes, k)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, hc.leaf_live_lanes_plain(
        torch.from_numpy(ch), num_channels=k))


@pytest.mark.parametrize("mix", LIVE_MIXES)
@pytest.mark.parametrize("lanes", [1, 3, 4, 8])
@pytest.mark.parametrize("k,num_bins,packed", [
    (hc.LEAF_CHANNELS, 256, False), (hc.Q_LEAF_CHANNELS, 256, False),
    (hc.LEAF_CHANNELS, 16, True), (hc.Q_LEAF_CHANNELS, 16, True)])
def test_lane_leaf_blocks_skip_what_has_no_row(k, num_bins, packed, lanes,
                                               mix):
    """The model-axis launch with its live-channel flags: a block works
    only if its lane holds a row in one of its channels (the kernel's
    ``block_live``), so an empty lane's blocks all leave at once, and
    every kept (lane, channel, feature, row) is in exactly one working
    block."""
    n = 50_003
    q8 = k == hc.Q_LEAF_CHANNELS
    ch = _live_mix(lanes, n, k, mix, 11 * lanes + k)
    live = hc.leaf_live_lanes([torch.from_numpy(c) for c in ch],
                              num_channels=k).numpy()
    geo = hc.lane_leaf_geometry(SMS, F, n, num_bins, k, q8, packed, lanes)
    kept = np.zeros((lanes, k, F), np.int64)
    for y in range(lanes):
        c = ch[y][(ch[y] >= 0) & (ch[y] < k)].astype(np.int64)
        kept[y] = np.bincount(c, minlength=k)[:, None]
    cover = np.zeros((lanes, k, F), np.int64)
    working = np.zeros(lanes, np.int64)
    for y, (c0, c1), (f0, f1), (r0, r1) in _lane_blocks(geo, F, n, k,
                                                         lanes):
        if not live[y, c0:c1].any():
            continue
        working[y] += 1
        for c in range(c0, c1):
            rows = ch[y, r0:r1]
            cover[y, c, f0:f1] += int((rows == c).sum())
    assert (cover == kept).all()
    for y in range(lanes):
        if not kept[y].any():
            assert working[y] == 0


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


# -- the single-leaf histogram (csrc/hist_single.cu) --------------------------

SINGLE_ROWS = [1, 17, 2283, 4096, 34_330, 100_003, 250_107, 1_000_003,
               10_502_144]
SINGLE_CASES = ([(f, b, layout, n) for f in (1, 6, 7, 28, 29)
                 for b in (2, 17, 256) for layout in ("rows", "features")
                 for n in SINGLE_ROWS] +
                [(f, b, "packed", n) for f in (1, 28) for b in (5, 16)
                 for n in PACKED_ROWS])


def _single_blocks(geo, f, n):
    """(features, rows) ranges of every block, as hist_single_rows and
    hist_single_feats compute them from their block index."""
    for y in range(geo.f_groups):
        f0 = y * geo.fg
        for x in range(geo.chunks):
            r0 = x * geo.chunk_rows
            yield (f0, min(f, f0 + geo.fg)), (r0, min(n, r0 + geo.chunk_rows))


@pytest.mark.parametrize("f,num_bins,layout,n", SINGLE_CASES)
def test_single_blocks_cover_every_cell_once(f, num_bins, layout, n):
    geo = hc.single_geometry(SMS, f, n, num_bins, layout)
    assert geo.chunk_rows % hc.SINGLE_ROW_STEP == 0   # 4-row loads align
    cover = np.zeros(f, np.int64)
    rows = {}
    for (f0, f1), (r0, r1) in _single_blocks(geo, f, n):
        assert f0 < f1 and r0 < r1                    # no empty block
        cover[f0:f1] += r1 - r0
        rows.setdefault(f0, []).append((r0, r1))
    assert (cover == n).all()
    for spans in rows.values():                       # chunks tile [0, n)
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


@pytest.mark.parametrize("f,num_bins,layout,n", SINGLE_CASES)
def test_single_geometry_fits_the_sm(f, num_bins, layout, n):
    geo = hc.single_geometry(SMS, f, n, num_bins, layout)
    assert geo.smem == geo.fg * (num_bins | 1) * hc.SINGLE_BIN_BYTES
    assert geo.smem <= hc.BLOCK_SMEM
    assert geo.threads in (256, hc.LEAF_THREADS)
    per_sm = hc.LEAF_THREADS // geo.threads        # 64 registers a thread
    assert per_sm * (geo.smem + SMEM_RESERVED) <= SM_SMEM
    assert geo.f_groups * geo.chunks <= per_sm * SMS   # one resident round
    if layout == "rows" and geo.f_groups > 1 and geo.fg > 4:
        assert geo.fg % 4 == 0        # every group's run starts on a word


@pytest.mark.parametrize("f", [1, 6, 28, 29])
@pytest.mark.parametrize("n", [4096, 13_022, 34_330, 100_003, 250_107,
                               1_000_003, 10_502_144])
def test_single_grid_fills_the_sms(f, n):
    """From a 4,096-row child to the 10.5M-row root, the grid gives 90% of
    the SMs a block, or every (feature, SINGLE_MIN_ROWS rows) cell its
    own block when the segment has fewer."""
    geo = hc.single_geometry(SMS, f, n, 256, "rows")
    cells = f * -(-n // hc.SINGLE_MIN_ROWS)
    assert geo.f_groups * geo.chunks >= min(0.9 * SMS, cells)


def test_single_geometry_at_the_main_shapes():
    """The partitioned root takes every feature in one block per SM; the
    renewal column runs four small blocks to an SM."""
    root = hc.single_geometry(SMS, F, 10_502_144, 256, "rows")
    assert (root.fg, root.f_groups, root.chunks, root.threads) == \
        (F, 1, SMS, hc.LEAF_THREADS)
    assert root.smem == 143_920
    renew = hc.single_geometry(SMS, 1, 10_502_144, 256, "features")
    assert (renew.threads, renew.chunks) == (256, 4 * SMS)


def test_single_counts_fit_32_bits():
    """A block's count is a uint32 sum of 0/1 rows: no block takes more
    than SINGLE_MAX_BLOCK_ROWS rows, which a uint32 holds."""
    assert hc.SINGLE_MAX_BLOCK_ROWS <= (1 << 32) - 1
    n = 3 * hc.SINGLE_MAX_BLOCK_ROWS + 5
    geo = hc.single_geometry(4, 1, n, 256, "features")
    assert geo.chunk_rows <= hc.SINGLE_MAX_BLOCK_ROWS
    assert geo.chunks * geo.chunk_rows >= n


# -- the uint16 single-leaf form's thread-block clusters -----------------------

CLUSTER_BINS = [256, 1024, 4096, 11_621, 11_622, 16_384, 65_535]
CLUSTER_ROWS = [1, 17, 4096, 50_003, 1_000_003, 10_502_144]


def _cluster_blocks(geo, f, n, num_bins):
    """Every block of a ``hist_single_u16`` launch as the kernel places it
    from its grid index (x, y) and its rank in its cluster (x % cluster):
    (cluster, rows, features read, features kept, (t, bins kept)): its
    tile keeps the bins t, t + tiles, t + 2 tiles, ... below B."""
    fgc = geo.cluster // geo.tiles * geo.fg
    for y in range(geo.f_groups):
        g0 = y * fgc
        for x in range(geo.chunks):
            rank = x % geo.cluster
            f0 = g0 + rank // geo.tiles * geo.fg
            t = rank % geo.tiles
            r0 = x * geo.chunk_rows
            yield ((x // geo.cluster, y),
                   (min(n, r0), min(n, r0 + geo.chunk_rows)),
                   (g0, min(f, g0 + fgc)),
                   (f0, max(f0, min(f, f0 + geo.fg))),
                   (t, -(-(num_bins - t) // geo.tiles)))


@pytest.mark.parametrize("n", CLUSTER_ROWS)
@pytest.mark.parametrize("layout", ["rows", "features"])
@pytest.mark.parametrize("num_bins", CLUSTER_BINS)
def test_single_clusters_cover_every_cell_once(num_bins, layout, n):
    """Each cluster keeps every (feature, bin) of its features in exactly
    one block's shared memory, within a block's room; each feature group's
    clusters walk every row exactly once; a cluster holds at most 16
    blocks, its blocks consecutive chunks, and at most 2^31 rows (its
    blocks' uint32 counts); blocks keep SINGLE_MIN_ROWS rows unless the
    segment is shorter than the cluster's share; past 256 bins the shape
    is the same for every segment."""
    geo = hc.single_geometry(SMS, F, n, num_bins, layout)
    if num_bins > 256:   # the shape is the segment's own only in its chunks
        shape = hc.single_shape(SMS, F, num_bins, layout)
        assert geo._replace(chunks=0, chunk_rows=0) == shape._replace(
            chunks=0)
        assert geo.chunks <= shape.chunks or n > hc.SINGLE_MAX_BLOCK_ROWS
    bt, tiles = geo.bt, geo.tiles
    least = hc.single_bin_tile(num_bins)[1]
    assert tiles == least or least > 1 and tiles > least
    assert bt == -(-num_bins // tiles)
    assert 1 <= geo.cluster <= hc.SINGLE_MAX_CLUSTER
    assert geo.cluster % geo.tiles == 0 and geo.chunks % geo.cluster == 0
    assert geo.peers == (hc.single_peers(geo.cluster) if geo.cluster > 1
                         else 0) and 0 <= geo.peers < geo.cluster
    assert geo.smem == geo.fg * (geo.bt | 1) * hc.SINGLE_BIN_BYTES
    per_sm = hc.LEAF_THREADS // geo.threads
    assert geo.smem <= hc.BLOCK_SMEM
    assert per_sm * (geo.smem + SMEM_RESERVED) <= SM_SMEM
    assert geo.chunk_rows % hc.SINGLE_ROW_STEP == 0
    assert geo.cluster * geo.chunk_rows <= hc.SINGLE_MAX_BLOCK_ROWS
    assert geo.f_groups <= 65_535
    if num_bins <= 256:
        assert geo.cluster == 1      # the uint8 forms' geometry
    if geo.chunks > geo.cluster:
        assert geo.chunk_rows >= hc.SINGLE_MIN_ROWS
    kept = {}
    walked = {}
    for cl, (r0, r1), (g0, g1), (f0, f1), (t, nbt) in _cluster_blocks(
            geo, F, n, num_bins):
        assert g0 < g1 and 0 < nbt <= geo.bt   # the tile fits the block
        assert f0 == f1 or g0 <= f0 < f1 <= g1   # none past F
        assert f1 - f0 <= geo.fg
        cover = kept.setdefault(cl, np.zeros((F, tiles), np.int64))
        cover[f0:f1, t] += 1
        assert (cover[:g0] == 0).all() and (cover[g1:] == 0).all()
        walked.setdefault(cl[1], []).append((r0, r1))
    for (_, y), cover in kept.items():
        g0 = y * (geo.cluster // geo.tiles * geo.fg)
        g1 = min(F, g0 + geo.cluster // geo.tiles * geo.fg)
        assert (cover[g0:g1] == 1).all()
    assert len(walked) == geo.f_groups
    for spans in walked.values():
        spans.sort()
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))


def _cluster_walk(bins, w, num_bins, geo):
    """``hist_single_u16``'s decomposition in plain PyTorch: every block
    of ``geo`` walks its rows for its cluster's features; each code goes
    to the block of its cluster that keeps the code's feature and bin
    (rank (k / fg) x tiles + v % tiles, entry (k % fg, v / tiles)): into
    that block's histogram when it is the walking block or one of the
    ``peers`` ranks after it, else straight into the (F, B, 3) int64
    sums; then each block flushes its tile (bins entry x tiles + t) into
    the sums."""
    f = bins.shape[0]
    wide = bins.to(torch.int64)
    hists = {}
    out = torch.zeros((f, num_bins, 3), dtype=torch.int64)
    blocks = list(_cluster_blocks(geo, f, bins.shape[1], num_bins))
    for x, (cl, (r0, r1), (g0, g1), _, _) in enumerate(blocks):
        me = x % geo.cluster
        for k in range(g1 - g0):
            v = wide[g0 + k, r0:r1]
            keep = v < num_bins
            v, wk = v[keep], w.w[:, r0:r1][:, keep].T
            rank = k // geo.fg * geo.tiles + v % geo.tiles
            for r in rank.unique().tolist():
                mine = rank == r
                if (r - me) % geo.cluster > geo.peers:   # through L2
                    out[g0 + k].index_add_(0, v[mine], wk[mine])
                    continue
                h = hists.setdefault((cl, r), torch.zeros(
                    (geo.fg, geo.bt, 3), dtype=torch.int64))
                h[k % geo.fg].index_add_(0, v[mine] // geo.tiles, wk[mine])
    for x, (cl, _, _, (f0, f1), (t, nbt)) in enumerate(blocks):
        h = hists.get((cl, x % geo.cluster))
        if h is not None:
            out[f0:f1, t::geo.tiles] += h[:f1 - f0, :nbt]
    return out


@pytest.mark.parametrize("layout", ["rows", "features"])
@pytest.mark.parametrize("num_bins", [1024, 4096, 11_622, 16_384, 65_535])
def test_single_cluster_walk_matches_plain(num_bins, layout):
    """Walking the blocks of ``single_geometry``'s pick over a segment,
    and of the pick with its remote adds all through L2 and all through
    DSM, with clusters of one feature and with the fewest bin tiles,
    gives ``hist_single_plain`` bit for bit: the clusters drop and
    double no add."""
    from lightgbm_tpu_torch.ops import histogram as th
    rng = np.random.RandomState(num_bins % 101)
    f, n = 9, 20_011
    bins = torch.from_numpy(rng.randint(0, num_bins, (f, n)).astype(
        np.uint16))
    bins[:, :50] = num_bins - 1
    w = th.pack_weights(torch.randn(n), torch.rand(n),
                        (torch.rand(n) < 0.8).float())
    want = hc.hist_single_plain(bins, w, num_bins=num_bins)
    pick = hc.single_geometry(SMS, f, n, num_bins, layout)
    t = pick.tiles
    least = hc.single_bin_tile(num_bins)[1]
    bt = -(-num_bins // least)
    # one feature a cluster (the fallback past one tile), the fewest
    # tiles, two clusters along the rows
    shapes = [pick._replace(cluster=t, f_groups=f, peers=t // 2),
              pick._replace(bt=bt, tiles=least, cluster=least,
                            peers=least // 2, f_groups=f,
                            smem=(bt | 1) * hc.SINGLE_BIN_BYTES)]
    walks = [pick] + [pick._replace(peers=k) for k in
                      (0, pick.cluster - 1)] + [
        hc.single_chunks(g._replace(chunks=2 * g.cluster), n)
        for g in shapes]
    for g in walks:
        assert torch.equal(_cluster_walk(bins, w, num_bins, g), want), g


def test_single_resident_clusters_off_the_card():
    """Off the card the clusters resident at once are the H100's measured
    ones for the two sizes the geometry takes (a cluster's blocks share a
    GPC): never more blocks than the SMs hold, fewer clusters of 16 than
    of 8; one block a cluster fills every SM; other sizes none."""
    for bt, per_sm in ((10_923, 1), (2048, 4)):
        assert hc._single_per_sm((bt | 1) * hc.SINGLE_BIN_BYTES) == per_sm
        assert hc.single_resident(SMS, 1, 1, bt, "rows") == per_sm * SMS
        got = [hc.single_resident(SMS, cs, 1, bt, "rows") for cs in (8, 16)]
        assert got == [hc.H100_RESIDENT_CLUSTERS[cs][per_sm > 1]
                       for cs in (8, 16)]
        assert 0 < got[1] < got[0] and got[0] * 8 <= per_sm * SMS
        assert hc.single_resident(SMS, 6, 1, bt, "rows") == 0


@pytest.mark.parametrize("layout", ["rows", "features"])
def test_single_shape_skips_clusters_that_fit_no_card(layout, monkeypatch):
    """Clusters of 16 blocks the card cannot hold (none resident) are
    passed over for clusters of 8, not raised on; only when no cluster
    fits does the geometry raise."""
    nb = 65_535
    pick = hc.single_shape(SMS, F, nb, layout)
    assert (pick.tiles, pick.cluster, pick.f_groups) == (8, 16, F // 2)
    for table in ({8: (15, 62), 16: (0, 0)}, {8: (0, 0), 16: (0, 0)}):
        monkeypatch.setattr(hc, "H100_RESIDENT_CLUSTERS", table)
        monkeypatch.setattr(hc, "_RESIDENT", {})
        hc.single_shape.cache_clear()
        hc.single_geometry.cache_clear()
        try:
            if table[8][0]:
                got = hc.single_geometry(SMS, F, 1_000_003, nb, layout)
                assert (got.tiles, got.cluster, got.f_groups) == (8, 8, F)
                assert got.peers == hc.single_peers(8)
            else:
                with pytest.raises(RuntimeError, match="no cluster"):
                    hc.single_geometry(SMS, F, 1_000_003, nb, layout)
        finally:
            hc.single_shape.cache_clear()
            hc.single_geometry.cache_clear()


# -- the model-axis uint16 forms (hist_single_lanes_u16, the leaf lanes) ------

LANE_SEGMENTS = [
    # chip_smoke.py phase 12f's partitioned segments: N, N/2, 50,003, N/5
    [10_502_144, 5_251_072, 50_003, 2_100_428],
    [4096, 0, 17, 1_000_003, 7, 250_107, 34_330],
    [3 << 30, 1 << 20]]


def _block_spans(geo, a, b):
    """The row spans of one work item's cluster blocks, as
    csrc/hist_single.cu ``span_of`` cuts them: one share (16-row steps)
    for every block, the last blocks' shorter or empty."""
    cs = geo.cluster
    share = -(-(-(-(b - a) // cs)) // hc.SINGLE_ROW_STEP) * hc.SINGLE_ROW_STEP
    return share, [(min(b, a + r * share), min(b, a + (r + 1) * share))
                   for r in range(cs)]


def _item_walk(bins, w, num_bins, geo, clusters):
    """``hist_single_lanes``' decomposition of one lane in plain PyTorch:
    each work item ``(group, first row, end row)`` of ``clusters`` is one
    cluster of ``geo``, its rows cut over its blocks (``_block_spans``).
    Each block walks its rows for its cluster's features; each code goes
    to the block that keeps its feature and bin (rank (k / fg) x tiles + v
    % tiles, entry (k % fg) x S + v / tiles): into that block's histogram
    when it is the walking block (at one tile always) or one of the
    ``peers`` ranks after it, else straight into the (F, B, 3) int64 sums
    (L2); then each block flushes its tile (bins entry x tiles + t).  The
    adds into a histogram go as the kernel's ``put`` sends them: with no
    peers the walking block's own as 32-bit halves; with peers every one,
    the walking block's own too, as a 64-bit DSM reduction, so that no
    entry takes both.  Returns the sums and the (halves, DSM, L2) add
    counts."""
    from lightgbm_tpu_torch.ops import histogram as th
    f = bins.shape[0]
    codes = th.widen_bins(bins).to(torch.int64)
    out = torch.zeros((f, num_bins, 3), dtype=torch.int64)
    cs, tiles, fg = geo.cluster, geo.tiles, geo.fg
    fgc = cs // tiles * fg
    S = geo.bt | 1
    sent = [0, 0, 0]
    for y, a, b in clusters:
        g0 = y * fgc
        ng = min(fgc, f - g0)
        _, spans = _block_spans(geo, a, b)
        hists = torch.zeros((cs, fg * S, 3), dtype=torch.int64)
        for rank, (r0, r1) in enumerate(spans):
            wk = w[:, r0:r1].T
            live = (wk != 0).any(dim=1)
            for k in range(ng):
                v = codes[g0 + k, r0:r1]
                keep = live & (v < num_bins)
                v, wv = v[keep], wk[keep]
                owner = k // fg * tiles + v % tiles
                d = (owner - rank) % cs
                mine = d <= geo.peers
                hists.index_put_((owner[mine], (k % fg) * S +
                                  v[mine] // tiles), wv[mine],
                                 accumulate=True)
                out[g0 + k].index_add_(0, v[~mine], wv[~mine])
                sent[0 if geo.peers == 0 else 1] += int(mine.sum())
                sent[2] += int((~mine).sum())
        for rank in range(cs):
            f0 = g0 + rank // tiles * fg
            nf = max(0, min(fg, f - f0))
            b0 = rank % tiles
            nbt = -(-(num_bins - b0) // tiles)
            h = hists[rank].view(fg, S, 3)
            out[f0:f0 + nf, b0::tiles] += h[:nf, :nbt]
    return out, tuple(sent)


@pytest.mark.parametrize("rows", LANE_SEGMENTS, ids=["phase12f", "seven",
                                                     "past-2^31"])
@pytest.mark.parametrize("layout", ["rows", "features"])
@pytest.mark.parametrize("num_bins", [257, 1024, 16_384, 65_535])
def test_lane_single_u16_geometry(num_bins, layout, rows):
    """``lane_single_items`` over uint16 codes: ``single_shape``'s launch,
    and work items that cover every (lane, row, feature group) exactly
    once, one lane an item (so no cluster holds two lanes' blocks), at
    most ``SINGLE_MAX_BLOCK_ROWS`` rows an item (the cluster's uint32
    counts), every block's span starting 16-row aligned, and no item for
    an empty lane; past one tile each lane's clusters are those of its
    single launch."""
    geo, items = hc.lane_single_items(SMS, F, rows, num_bins, layout, True)
    shape = hc.single_shape(SMS, F, num_bins, layout)
    assert geo._replace(chunks=0, chunk_rows=0) == shape._replace(
        chunks=0, chunk_rows=0)
    _check_items(geo, items, rows)
    if geo.tiles > 1:   # each lane's clusters its single launch's
        for lane, r in enumerate(rows):
            mine = sorted((a, b) for z, y, a, b in items
                          if z == lane and y == 0)
            if r:
                one = hc.single_geometry(SMS, F, r, num_bins, layout)
                assert len(mine) == one.chunks // one.cluster
                assert mine[0][1] - mine[0][0] == min(
                    r, one.chunk_rows * one.cluster)


def _check_items(geo, items, rows):
    cs = geo.cluster
    assert geo.chunks == len(items) * cs
    cover = {}
    for lane, y, a, b in items:
        assert 0 <= lane < len(rows) and 0 <= y < geo.f_groups
        assert 0 <= a < b <= rows[lane]
        assert b - a <= hc.SINGLE_MAX_BLOCK_ROWS
        assert a % (cs * hc.SINGLE_ROW_STEP) == 0
        share, spans = _block_spans(geo, a, b)
        assert share % hc.SINGLE_ROW_STEP == 0
        assert spans[0][0] == a and spans[-1][1] == b
        cover.setdefault((lane, y), []).append((a, b))
    for lane, r in enumerate(rows):
        for y in range(geo.f_groups):
            spans = sorted(cover.get((lane, y), []))
            if r == 0:
                assert not spans
                continue
            assert spans[0][0] == 0 and spans[-1][1] == r
            assert all(x[1] == z[0] for x, z in zip(spans, spans[1:]))


@pytest.mark.parametrize("rows", LANE_SEGMENTS + [[0, 5, 0]],
                         ids=["phase12f", "seven", "past-2^31", "tiny"])
@pytest.mark.parametrize("num_bins,layout", [
    (256, "rows"), (256, "features"), (16, "packed"), (255, "rows")])
def test_lane_single_items_cover_every_row_once(num_bins, layout, rows):
    """``lane_single_items`` for the uint8 (and packed) lanes form: the
    feature groups of ``single_geometry`` over all the lanes' rows, blocks
    of one tile, and items that cover every (lane, row, feature group)
    exactly once; when every lane's groups take at most half the
    resident blocks, every item fits one round of them."""
    geo, items = hc.lane_single_items(SMS, F, rows, num_bins, layout)
    one = hc.single_geometry(SMS, F, max(1, sum(rows)), num_bins, layout)
    assert (geo.fg, geo.f_groups, geo.threads, geo.cluster) == (
        one.fg, one.f_groups, one.threads, 1)
    _check_items(geo, items, rows)
    slots = SMS * (hc.LEAF_THREADS // geo.threads)
    live = sum(1 for r in rows if r)
    if 2 * live * geo.f_groups <= slots and \
            geo.chunk_rows > hc.SINGLE_MIN_ROWS:
        assert len(items) <= slots


@pytest.mark.parametrize("layout", ["rows", "features"])
@pytest.mark.parametrize("num_bins", [1024, 65_535])
def test_lane_single_u16_walk_matches_plain(num_bins, layout):
    """Walking each lane's work items (``_item_walk``: its clusters'
    blocks and their routing) over that lane's segment gives its
    ``hist_single_plain`` bit for bit; an empty lane has no item and a
    lane shorter than one block's share walks one."""
    from lightgbm_tpu_torch.ops import histogram as th
    rng = np.random.RandomState(num_bins % 103)
    f, rows = 9, [20_011, 6_007, 0, 17]
    geo, items = hc.lane_single_items(SMS, f, rows, num_bins, layout, True)
    for lane, n in enumerate(rows):
        bins = torch.from_numpy(rng.randint(0, num_bins, (f, n)).astype(
            np.uint16))
        w = th.pack_weights(torch.randn(n), torch.rand(n),
                            (torch.rand(n) < 0.8).float())
        mine = [(y, a, b) for z, y, a, b in items if z == lane]
        assert bool(mine) == (n > 0)
        got, _ = _item_walk(bins, w.w, num_bins, geo, mine)
        assert torch.equal(got, hc.hist_single_plain(bins, w,
                                                     num_bins=num_bins))


@pytest.mark.parametrize("mix", ["even", "skewed"])
@pytest.mark.parametrize("num_bins", [16_384, 65_535])
def test_lane_routing_walk_matches_plain(num_bins, mix):
    """Past one bin tile the lanes' clusters send each remote add to its
    owner through DSM (the ``peers`` ranks after the walking block) or
    straight into the sums through L2: over the lanes' work items, with
    the geometry's peers, with none and with every other rank, on an even
    and a 90%-skewed mix with codes at or past B, every lane is bitwise
    ``hist_single_lanes_plain`` (an empty lane's zeros too), and each
    routing sends its adds the ways it says: 32-bit halves only with no
    DSM peers, so that no entry takes both widths."""
    from lightgbm_tpu_torch.ops import histogram as th
    rng = np.random.RandomState(num_bins % 97 + (mix == "skewed"))
    f, rows = 5, [12_000, 0, 3_001]
    geo, items = hc.lane_single_items(SMS, f, rows, num_bins, "rows", True)
    bins, ws = [], []
    for n in rows:
        b = rng.randint(0, num_bins, (f, n))
        if mix == "skewed":
            b = np.where(rng.rand(f, n) < 0.9, (np.arange(f) * 7919 %
                                                num_bins)[:, None], b)
        b[:, :5] = 65_535   # at or past B: no add
        bins.append(torch.from_numpy(b.astype(np.uint16)))
        ws.append(th.pack_weights(torch.randn(n), torch.rand(n),
                                  (torch.rand(n) < 0.8).float()).w)
    want = hc.hist_single_lanes_plain(bins, ws, num_bins=num_bins)
    for peers in (geo.peers, 0, geo.cluster - 1):
        g = geo._replace(peers=peers)
        for lane in range(len(rows)):
            mine = [(y, a, b) for z, y, a, b in items if z == lane]
            got, (halves, dsm, l2) = _item_walk(bins[lane], ws[lane],
                                                num_bins, g, mine)
            assert torch.equal(got, want[lane])
            if rows[lane]:
                assert (halves > 0) == (peers == 0)
                assert (dsm > 0) == (peers > 0)
                assert (l2 > 0) == (peers < g.cluster - 1)


def _lane_counts(mix, n, k, seed):
    """Rows per channel: half the rows over every channel, 90% of them in
    channel 3 with every fourth channel empty, or none at all."""
    if mix == "none":
        return torch.zeros(k, dtype=torch.int64)
    if mix == "even":
        return torch.full((k,), n // 2 // k, dtype=torch.int64)
    rng = np.random.RandomState(seed)
    c = np.zeros(k, np.int64)
    c[3] = n // 2 * 9 // 10
    np.add.at(c, rng.choice([i for i in range(k) if i % 4 != 1 and i != 3],
                            n // 2 - c[3]), 1)
    return torch.from_numpy(c)


@pytest.mark.parametrize("lanes", [1, 4, 7])
@pytest.mark.parametrize("q8", [True, False])
def test_lane_list_plan_lists_every_slot_once(q8, lanes):
    """The leaf lanes' plan: each lane's histogram launch takes the single
    form's geometry over its own plan, and each lane's table lists each
    of its (channel, slot) pairs once, so the lanes' launches walk every
    (lane, channel) slot once; q8 slots stay under 2^24 rows; the lanes'
    partition shares the single form's row blocks out over the lanes."""
    k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
    n = 10_502_144
    one = hc.list_geometry(SMS, F, n, 1024, k, q8)
    part = hc._part_blocks(SMS, n, lanes)
    assert part == -(-one.part_blocks // lanes)
    assert lanes * part <= one.part_blocks + lanes
    seen, want = {}, set()
    for lane in range(lanes):
        counts = _lane_counts(("even", "skewed", "none")[lane % 3], n, k,
                              lane)
        slots, table = hc.list_slots(counts, one.slots)
        assert table.numel() == one.slots + k
        want |= {(lane, c, j) for c in range(k)
                 for j in range(int(slots[c]))}
        for e in table.tolist():
            if e >= 0:
                key = (lane, e & 255, e >> 8)
                seen[key] = seen.get(key, 0) + 1
                c, j = e & 255, e >> 8
                rows = (int(counts[c]) * (j + 1) // int(slots[c]) -
                        int(counts[c]) * j // int(slots[c]))
                assert not q8 or rows <= hc.Q8_MAX_BLOCK_ROWS
    assert set(seen) == want and set(seen.values()) <= {1}


@pytest.mark.parametrize("q8", [True, False])
def test_partition_tile_fits_shared_memory(q8):
    """A scatter block of the channel partition: its tile's staged records
    and places, the warps' channel counters, the small tables and the
    tile's channels (and q8 weight bytes) fit one block's 232,448 bytes,
    and ``LIST_PART_SM_BLOCKS`` such blocks fit an SM; each loader thread
    takes one 16-row group of the tile."""
    smem = hc.part_smem(q8)
    tile = hc.part_tile_rows(q8)
    assert smem == tile * ((8 if q8 else 32) + 4 + (4 if q8 else 1)) + \
        hc.PART_THREADS // 32 * hc.LIST_MAX_CHANNELS * 4 + \
        7 * (hc.LIST_MAX_CHANNELS + 8) * 4
    assert smem <= hc.BLOCK_SMEM == 232_448
    assert hc.LIST_PART_SM_BLOCKS * (smem + SMEM_RESERVED) <= SM_SMEM
    assert hc.LIST_PART_SM_BLOCKS * hc.PART_THREADS <= SM_THREADS
    assert tile % (32 * hc.PART_THREADS // 32) == 0
    assert tile // hc.PART_ROW_STEP <= hc.PART_THREADS


@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("k,slots,blocks", [(42, 126, 264), (25, 25, 66),
                                            (1, 3, 1), (64, 192, 7)])
def test_partition_plan_layout(k, slots, blocks, lanes):
    """One lane's plan is ``plan_ints`` int32 entries: offsets (k + 1),
    slots (k), the slot table (slots + k), then the row blocks' counts (k
    x blocks); ``_row_lists`` views each lane's first three parts of a
    (lanes, plan_ints) buffer, and nothing of the counts."""
    size = hc.plan_ints(k, slots, blocks)
    assert size == 3 * k + 1 + slots + k * blocks
    assert blocks * k * 4 <= hc.BLOCK_SMEM     # the kernel's P limit
    plan = torch.arange(lanes * size, dtype=torch.int32).view(lanes, size)
    rec = torch.zeros((lanes, 5), dtype=torch.int64)
    for z, rl in enumerate(hc._row_lists(rec, plan, k, slots)):
        base = z * size
        assert torch.equal(rl.offsets, base + torch.arange(k + 1,
                                                           dtype=torch.int32))
        assert torch.equal(rl.slots, base + k + 1 + torch.arange(
            k, dtype=torch.int32))
        assert torch.equal(rl.table, base + 2 * k + 1 + torch.arange(
            slots + k, dtype=torch.int32))
        assert int(rl.table[-1]) + k * blocks == base + size - 1


@pytest.mark.parametrize("n", [1, 15, 16, 17, 1000, 10_502_144])
@pytest.mark.parametrize("blocks", [1, 7, 264])
def test_partition_block_rows_cover_the_rows(n, blocks):
    """The partition's row blocks: runs of ``part_block_rows`` rows, a
    multiple of 16 (each 16-row group one aligned 16-byte load), cover
    the n rows, the last nonempty block ending at n."""
    br = hc.part_block_rows(n, blocks)
    assert br % hc.PART_ROW_STEP == 0 and br >= -(-n // blocks)
    assert br * blocks >= n and br - hc.PART_ROW_STEP < -(-n // blocks)
