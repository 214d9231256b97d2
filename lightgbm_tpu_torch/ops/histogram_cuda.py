"""Hand-written CUDA kernels of the growers, their wrappers and their
plain PyTorch versions — the counterpart of
``lightgbm_tpu/ops/histogram_pallas.py``.

Five entry points, their kernels in four sources (csrc/hist_single.cu,
csrc/hist_leaves.cu, csrc/hist_leaves_u16.cu, csrc/row_update.cu), the
three histograms each in two forms (uint8 bins, and nibble-packed bins
with ``bins_packed=True``):

* :func:`build_histogram` — ``build_histogram_pallas``
  (histogram_pallas.py:471): one leaf's (F, B, 3) f32 histogram; the
  partitioned grower and quantized leaf renewal call its fixed-point form
  :func:`hist_single` with the tree's packed weights;
* :func:`build_histogram_leaves_q8` — ``build_histogram_pallas_leaves_q8``
  (histogram_pallas.py:1030): 42 leaf channels of int32 (g_q, h_q, count);
* :func:`build_histogram_leaves` — ``build_histogram_pallas_leaves``
  (histogram_pallas.py:852): 25 leaf channels of f32 (g*mask, h*mask,
  count);
* :func:`wave_row_update` — ``wave_row_update_pallas``
  (histogram_pallas.py:1280); with ``decode=`` (:class:`SplitDecode`) its
  categorical / EFB form, which also decides categorical splits by
  membership and decodes bundled columns (the reference's XLA fallback,
  learner/wave.py:1341-1420);
* :func:`wave_trial_channels` — ``wave_trial_channels_pallas``
  (histogram_pallas.py:1314).

The two row-update entry points take the reference's gathered ``(W, N)``
winning columns, or, with ``feats=``, the grower's whole bin matrix (uint8
or, with ``bins_packed``, nibble-packed) read in place; the grower passes
the latter.

Dispatch is by the device of the tensors: a CPU tensor takes the plain
version (``*_plain``), a CUDA tensor launches the kernel on
``torch.cuda.current_stream()`` or raises.  There is no fallback from one
to the other.  Each kernel launch adds one to its entry in
:data:`LAUNCHES`; the plain versions never do.

The reference's ``pipeline`` (dma / blockspec) and ``interpret`` knobs are
accepted and ignored by the leaf-channel and row-update wrappers, and not
taken by the single-leaf ones: both TPU variants collapse into one kernel
here.

Packed bins (``bins_packed=True``): ``bins_t`` is the ``(F, N/2)`` byte
matrix of ``ops/histogram.py`` ``pack_bins4`` (row 2j in the low nibble of
byte j, row 2j+1 in the high one), ``num_bins <= 16``, and N, the row
count of the weights and channels, a non-zero multiple of the 4096-row
block, as the reference's ``_check_rows`` demands.  A packed CUDA tensor
launches the packed kernel (its own :data:`LAUNCHES` key, ``*_packed4``);
the plain versions unpack and run the uint8 scatter.

The exact-mode histograms sum the 64-bit fixed-point weights of
``ops/histogram.py`` ``pack_weights``; integer sums make each kernel
equal its plain version bit for bit.

uint16 bins (``max_bin`` > 255, up to 65,536 bins): every single-model
entry point takes a ``torch.uint16`` bin matrix (never packed) and, on the
card, launches the kernel's uint16 form (its own :data:`LAUNCHES` key,
``*_u16``), chosen by the bins' dtype.  The histogram geometries then
split the bins into tiles that fit a block's shared memory (``bt``,
``tiles``; one tile of B below that).  The two leaf-channel forms run
``csrc/hist_leaves_u16.cu``: the channel partition (:func:`leaf_partition`,
its own :data:`LAUNCHES` key), then a histogram over its row list
(:func:`list_geometry`).  The plain versions widen the codes to int32
(``ops/histogram.py`` ``widen_bins``) where they compare or index.  The
model-axis (``*_lanes``) forms take uint16 bins the same way (their
``*_lanes_u16`` keys): the leaf forms run the lanes' channel partitions
in one launch (:func:`leaf_partition_lanes`), then the histograms over
their row lists (one launch of every lane's clusters,
:func:`list_lane_order`), and ``hist_single_lanes`` runs the single
form's clusters over work items that cut every lane's
segment into rows of one length (:func:`lane_single_items`).

The exact leaf form's f32 values past one bin tile leave the kernel
whole (owner mode, :class:`ListGeometry`): each (channel, feature group)
is one cluster's, which writes its final sums scaled, so no int64
histogram reaches device memory.  At one tile its int64 sums are scaled
back in one pass (:func:`fx_scale_lanes` for the lanes form, as the
uint8 lanes form's are).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from ..dataset import ROW_BLOCK, pad_rows
from . import histogram as _plain
from .histogram import (MAX_BINS_U16, PACK4_MAX_BINS, FxWeights,
                        fx_to_f32, pack_weights, scatter_histogram,
                        take_rows, unpack_bins4, widen_bins)
from .histogram import build_histogram_leaves as _scatter_leaves

__all__ = ["LEAF_CHANNELS", "Q_LEAF_CHANNELS", "LAUNCHES", "build_histogram",
           "hist_single", "hist_single_plain", "build_histogram_leaves",
           "build_histogram_leaves_q8", "wave_row_update",
           "wave_trial_channels", "build_histogram_leaves_plain",
           "build_histogram_leaves_q8_plain", "wave_row_update_plain",
           "wave_trial_channels_plain", "reset_launches", "LeafGeometry",
           "SplitDecode", "split_decode", "MEMBER_WORDS",
           "leaf_groups", "leaf_geometry", "SingleGeometry",
           "single_geometry", "trial_tab", "MAX_LANES",
           "lane_leaf_geometry", "lane_single_items",
           "build_histogram_leaves_q8_lanes",
           "build_histogram_leaves_q8_lanes_plain",
           "build_histogram_leaves_lanes", "build_histogram_leaves_lanes_plain",
           "hist_single_lanes", "hist_single_lanes_plain",
           "wave_row_update_lanes", "wave_row_update_lanes_plain",
           "wave_trial_channels_lanes", "wave_trial_channels_lanes_plain",
           "leaf_bin_tile", "single_bin_tile", "single_shape", "single_peers",
           "ListGeometry",
           "list_geometry", "list_features", "list_slots", "RowList",
           "leaf_partition", "leaf_partition_plain", "leaf_partition_lanes",
           "leaf_partition_lanes_plain", "list_owner", "list_lane_order",
           "fx_scale_lanes", "leaf_live_lanes", "leaf_live_lanes_plain"]

# Leaf channels per pass.  These are the reference's TPU lane budgets
# (25 x 5 and 42 x 3 of 128 MXU lanes).  They set the default wave sizes,
# which decide which splits commit together, so the port keeps them.
LEAF_CHANNELS = 25
Q_LEAF_CHANNELS = 42

# launches of each CUDA kernel form since the last reset_launches()
LAUNCHES = {"hist_single": 0, "hist_single_packed4": 0, "hist_leaves_q8": 0,
            "hist_leaves_q8_packed4": 0, "hist_leaves": 0,
            "hist_leaves_packed4": 0, "wave_row_update": 0,
            "wave_row_update_ext": 0, "wave_trial_channels": 0,
            # the model-axis forms: one launch for every lane of a group
            "hist_single_lanes": 0, "hist_single_lanes_packed4": 0,
            "hist_leaves_q8_lanes": 0,
            "hist_leaves_q8_lanes_packed4": 0, "hist_leaves_lanes": 0,
            "hist_leaves_lanes_packed4": 0, "wave_row_update_lanes": 0,
            "wave_row_update_ext_lanes": 0, "wave_trial_channels_lanes": 0,
            # the uint8 and packed leaf lanes forms' live channels
            "leaf_live_lanes": 0,
            # the uint16 forms (max_bin > 255)
            "hist_single_u16": 0, "hist_leaves_q8_u16": 0,
            "hist_leaves_u16": 0, "wave_row_update_u16": 0,
            "wave_row_update_ext_u16": 0, "wave_trial_channels_u16": 0,
            # the channel partition of the uint16 leaf histograms
            "leaf_partition": 0,
            # the model-axis uint16 forms and their lanes' partition
            "hist_single_lanes_u16": 0, "hist_leaves_q8_lanes_u16": 0,
            "hist_leaves_lanes_u16": 0, "wave_row_update_lanes_u16": 0,
            "wave_row_update_ext_lanes_u16": 0,
            "wave_trial_channels_lanes_u16": 0, "leaf_partition_lanes": 0,
            # the exact lanes forms' f32 scale-back (hist_leaves_u16.cu's
            # kernel): uint16 at one bin tile, uint8 and packed
            "fx_scale_lanes_u16": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# -- argument checks --------------------------------------------------------

def _check_device(kernel: str, dev: torch.device) -> None:
    """A wrapper runs its plain version on the CPU and its kernel on the
    current CUDA device; any other device is refused."""
    if dev.type == "cpu":
        return
    if dev.type != "cuda" or dev.index != torch.cuda.current_device():
        raise ValueError(f"{kernel}: tensors on {dev}; the kernel runs on "
                         f"the current CUDA device or the plain version "
                         f"on the CPU")


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _stream() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _raise_on(rc: int, kernel: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {rc}")


_SIGS_SET = set()


def _fn(lib_name: str, fn_name: str, argtypes):
    """``fn_name`` of ``csrc/<lib_name>.cu``, its C signature set once."""
    from .cuda_lib import library
    fn = getattr(library(lib_name), fn_name)
    if fn_name not in _SIGS_SET:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _SIGS_SET.add(fn_name)
    return fn


_LL, _VP, _CI = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int


def _p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# -- histograms ---------------------------------------------------------------

def _check_packed(kernel: str, n: int, num_bins: int) -> None:
    """The packed layout's limits (reference histogram_pallas.py:124-130
    ``_check_rows`` and :502-505)."""
    if num_bins > PACK4_MAX_BINS:
        raise ValueError(f"bins_packed requires num_bins <= "
                         f"{PACK4_MAX_BINS}, got {num_bins}")
    if num_bins < 1:
        raise ValueError(f"{kernel}: num_bins must be at least 1, got "
                         f"{num_bins}")
    if n % ROW_BLOCK != 0 or n == 0:
        raise ValueError(
            f"{kernel} requires the row count to be a non-zero multiple of "
            f"row_block={ROW_BLOCK}, got N={n}; pad inputs to pad_rows(N) "
            f"== {pad_rows(max(n, 1))} first (masked/padded rows carry "
            "weight 0 and contribute nothing)")


def _bin_dtype(kernel, bins_t, packed=False) -> torch.dtype:
    """The bins' code type: uint8, or uint16 (never packed)."""
    if bins_t.dtype == torch.uint16 and not packed:
        return torch.uint16
    if bins_t.dtype != torch.uint8:
        raise TypeError(f"{kernel}: bins must be torch.uint8" +
                        ("" if packed else " or torch.uint16") +
                        f", got {bins_t.dtype}")
    return torch.uint8


def _check_num_bins(kernel, num_bins, wide: bool) -> None:
    top = MAX_BINS_U16 if wide else 256
    if not 1 <= num_bins <= top:
        raise ValueError(f"{kernel}: num_bins must be in [1, {top}] for "
                         f"{'uint16' if wide else 'uint8'} bins, got "
                         f"{num_bins}")


def _check_hist_args(kernel, bins_t, w, w_dtype, w_rows, ch, num_bins,
                     packed=False):
    if bins_t.dim() != 2:
        raise ValueError(f"{kernel}: bins must be (F, N)" +
                         (" packed as (F, N/2)" if packed else ""))
    f, nb = bins_t.shape
    n = 2 * nb if packed else nb
    if packed:
        _check_packed(kernel, n, num_bins)
    dev = bins_t.device
    dt = _bin_dtype(kernel, bins_t, packed)
    _check("bins", bins_t, dt, (f, nb), dev)
    _check("weights", w, w_dtype, (w_rows, n), dev)
    _check("ch", ch, torch.int8, (n,), dev)
    _check_device(kernel, dev)
    _check_num_bins(kernel, num_bins, dt == torch.uint16)
    return f, n


# -- leaf-channel geometry (csrc/hist_leaves.cu) -------------------------------
#
# One block of 1024 threads per SM (64 registers a thread fill the SM's
# 65,536); of an H100 SM's 228 KB of shared memory, such a block may use
# 227 KB.
LEAF_THREADS = 1024
BLOCK_SMEM = 232_448
LEAF_QUEUE_BYTES = 20     # a warp's row queue per thread (kQueue * 4 / 32)
LEAF_ROW_STEP = 16        # chunks start 16-row aligned (4-byte ch loads)
LEAF_MAX_BLOCK_ROWS = 1 << 25   # queue entries hold a 25-bit row
Q8_MAX_BLOCK_ROWS = 1 << 24     # |a q8 block's int32 sums| <= 128 * 2^24


class LeafGeometry(NamedTuple):
    """The launch of one leaf-channel histogram: ``cg`` channels x ``fg``
    features per block, ``c_groups * f_groups`` block columns (channel
    groups fastest) times ``chunks`` row chunks of ``chunk_rows`` rows,
    ``smem`` shared bytes per block."""
    cg: int
    fg: int
    c_groups: int
    f_groups: int
    chunks: int
    chunk_rows: int
    smem: int


def _pair_bytes(num_bins: int, q8: bool) -> int:
    """Shared bytes of one (channel, feature): per bin a packed (g, h) and
    a count (q8), or g, h and a count (fx)."""
    return num_bins * (12 if q8 else 20)


def leaf_groups(f: int, num_bins: int, k: int, q8: bool) -> list:
    """The (channels, features) groups one block can hold: for each count
    of channel groups, its channels and as many features as fit the
    block's shared memory, spread evenly over the feature groups."""
    pair = _pair_bytes(num_bins, q8)
    budget = BLOCK_SMEM - LEAF_THREADS * LEAF_QUEUE_BYTES
    groups = []
    for c_groups in range(1, k + 1):
        cg = -(-k // c_groups)
        if cg * pair > budget or (groups and groups[-1][0] == cg):
            continue
        fg = -(-f // -(-f // min(f, budget // (cg * pair))))
        groups.append((cg, fg))
    return groups


def leaf_geometry(sms: int, f: int, n: int, num_bins: int, k: int, q8: bool,
                  packed: bool) -> LeafGeometry:
    """Geometry of ``hist_leaves_{q8,fx}[_p4]`` (uint8 or packed bins) on a
    card with ``sms`` SMs: of :func:`leaf_groups`, the one with the fewest
    block columns (each reads every row's channel byte and queues its own
    rows), then the most channels per block (its rows lie densest, so
    their bin and weight gathers share the most sectors); row chunks
    sized so that the whole grid is one resident round of one block per
    SM, of at most ``LEAF_MAX_BLOCK_ROWS`` rows (``Q8_MAX_BLOCK_ROWS`` for
    q8)."""
    cg, fg = min(leaf_groups(f, num_bins, k, q8),
                 key=lambda g: (-(-k // g[0]) * -(-f // g[1]), -g[0]))
    combos = -(-k // cg) * -(-f // fg)
    steps = max(1, -(-n // LEAF_ROW_STEP))
    chunks = max(1, min(steps, sms // combos),
                 -(-n // (Q8_MAX_BLOCK_ROWS if q8 else LEAF_MAX_BLOCK_ROWS)))
    chunk_rows = -(-steps // chunks) * LEAF_ROW_STEP
    return LeafGeometry(cg, fg, -(-k // cg), -(-f // fg),
                        max(1, -(-n // chunk_rows)), chunk_rows,
                        cg * fg * _pair_bytes(num_bins, q8) +
                        LEAF_THREADS * LEAF_QUEUE_BYTES)


# -- the uint16 leaf histograms' geometry (csrc/hist_leaves_u16.cu) ------------
#
# The channel partition lists the rows of each channel; a histogram block
# then walks one channel's share of that list (one slot) for fg features
# and one tile of bt bins, with no row queue beside its histogram.
LIST_PART_MIN_ROWS = 16_384   # fewest rows a partition block takes
LIST_PART_SM_BLOCKS = 2       # partition blocks per SM, at most
PART_THREADS = 512            # a partition block's threads (16 warps)
PART_ROW_STEP = 16            # its blocks' runs: 16-row (16-byte) groups
LIST_FILL = 0.9               # least share of the last resident round filled
LIST_MAX_CHANNELS = 64        # the partition's shared tables
LIST_BIN_BATCH = 8            # bin loads of one listed row issued together


class ListGeometry(NamedTuple):
    """The launch of one uint16 leaf histogram: ``fg`` features of one
    channel x ``bt`` bins per block; ``f_groups * tiles`` block columns
    (tiles fastest; the ``tiles`` blocks of a feature group form one
    thread-block cluster) for each of ``slots + k`` ranked slots (the
    list's chunks, shared out over the channels by their rows; at most
    ``slots + k`` taken), ``blocks`` in all, ``smem`` shared bytes per
    block; the partition in ``part_blocks`` row blocks.  ``slots`` 0 is
    owner mode: each channel with rows takes one slot (:func:`list_slots`
    at S = 0), and the clusters of rank c walk all of channel c's rows,
    so each (channel, feature group) has one cluster, which writes its
    final f32 sums."""
    fg: int
    f_groups: int
    bt: int
    tiles: int
    slots: int
    blocks: int
    smem: int
    part_blocks: int

    @property
    def owner(self) -> bool:
        return self.slots == 0


def leaf_bin_tile(num_bins: int, q8: bool) -> tuple:
    """(bins per tile, tiles): B in one tile when one (channel, feature)
    pair of B bins fits a block, else the fewest even tiles that do
    (past 11,622 fx / 19,370 q8 bins; at most 6 fx / 4 q8 tiles, within
    a thread-block cluster's 8 blocks)."""
    most = BLOCK_SMEM // _pair_bytes(1, q8)
    tiles = -(-num_bins // most)
    return -(-num_bins // tiles), tiles


def list_features(f: int, bt: int, q8: bool) -> list:
    """The features per block the uint16 leaf histograms can take at
    ``bt`` bins a tile: for each count of feature groups, its features
    spread evenly, from the most that fit a block down to one."""
    most = max(1, min(f, BLOCK_SMEM // _pair_bytes(bt, q8)))
    out = []
    for groups in range(-(-f // most), f + 1):
        fg = -(-f // groups)
        if not out or out[-1] != fg:
            out.append(fg)
    return out


def list_slots_least(n: int, q8: bool) -> int:
    """Fewest slots that keep every q8 block under ``Q8_MAX_BLOCK_ROWS``
    listed rows: a slot holds at most ceil(2 x total / slots) rows
    (:func:`list_slots`)."""
    return max(1, -(-2 * n // Q8_MAX_BLOCK_ROWS)) if q8 else 1


def list_owner(num_bins: int, q8: bool, f32_out: bool) -> bool:
    """Whether :func:`list_geometry` takes owner mode: the fx form's f32
    values past one bin tile."""
    return f32_out and not q8 and leaf_bin_tile(num_bins, q8)[1] > 1


def list_geometry(sms: int, f: int, n: int, num_bins: int, k: int,
                  q8: bool, f32_out: bool = False) -> ListGeometry:
    """Geometry of ``hist_leaves_{fx,q8}_u16`` on a card with ``sms`` SMs
    over ``n`` rows (and of their model-axis forms' histogram launches).
    A block keeps one channel: the list puts a block's rows in one
    channel, so a wider channel group would only flush more.
    Of :func:`list_features`, it takes the split whose listed rows wait
    the fewest times for their bins (each feature group reads a row's
    record and loads its bins ``LIST_BIN_BATCH`` at a time, one wait a
    batch), then the fewest feature groups (the fewest record reads).  The
    slots are ``k`` x m for the least m whose grid of columns x slots
    blocks fills at least ``sms`` blocks and ``LIST_FILL`` of its last
    resident round (an even mix then gives every channel m slots), and
    at least :func:`list_slots_least`.  PERF.md section 6 has the sweep
    behind both rules (``scripts/torch_u16_leaf_sweep.py``).

    ``f32_out`` (the fx form's f32 values, not its raw int64 sums): past
    one bin tile, owner mode (``slots`` 0), so that no int64 histogram
    reaches device memory; at one tile the slots balance the rows and the
    int64 output is small."""
    bt, tiles = leaf_bin_tile(num_bins, q8)
    fg = min(list_features(f, bt, q8),
             key=lambda g: (-(-f // g) * -(-g // LIST_BIN_BATCH), -g))
    f_groups = -(-f // fg)
    columns = f_groups * tiles
    slots = 0
    if not list_owner(num_bins, q8, f32_out):
        least = list_slots_least(n, q8)
        m = max(1, -(-least // k))
        while True:
            g = columns * k * m
            if g >= sms and g >= LIST_FILL * sms * -(-g // sms):
                break
            m += 1
        slots = k * m
    return ListGeometry(fg, f_groups, bt, tiles, slots,
                        columns * (slots + k), fg * _pair_bytes(bt, q8),
                        _part_blocks(sms, n))


def _part_blocks(sms: int, n: int, lanes: int = 1) -> int:
    """Row blocks of the channel partition over ``n`` rows, per lane: the
    lanes share ``LIST_PART_SM_BLOCKS`` blocks an SM."""
    return max(1, min(-(-LIST_PART_SM_BLOCKS * sms // lanes),
                      -(-n // LIST_PART_MIN_ROWS)))


def part_block_rows(n: int, part_blocks: int) -> int:
    """Rows of each partition block: ceil(n / part_blocks), rounded up to
    ``PART_ROW_STEP`` (csrc/hist_leaves_u16.cu ``part_block_rows``)."""
    per_block = -(-n // part_blocks)
    return -(-per_block // PART_ROW_STEP) * PART_ROW_STEP


def part_tile_rows(q8: bool) -> int:
    """Rows of one tile of the partition's scatter: 8 a thread for q8
    records (8 bytes), 4 for fx (32 bytes)."""
    return PART_THREADS * (8 if q8 else 4)


def part_smem(q8: bool) -> int:
    """Shared bytes of one scatter block (``PartTile::kSmem``): a tile's
    staged records and their places, the warps' channel counters, seven
    small tables of ``LIST_MAX_CHANNELS`` + 8 ints, the tile's channels
    and (q8) its three weight bytes a row."""
    rows = part_tile_rows(q8)
    return (rows * ((8 if q8 else 32) + 4) +
            PART_THREADS // 32 * LIST_MAX_CHANNELS * 4 +
            7 * (LIST_MAX_CHANNELS + 8) * 4 + rows * (4 if q8 else 1))


def plan_ints(k: int, slots: int, part_blocks: int) -> int:
    """int32 entries of one lane's partition plan (csrc/hist_leaves_u16.cu
    ``plan_ints``): offsets (k + 1), slots (k), the slot table (slots +
    k), then each row block's count of each channel (k x part_blocks)."""
    return 3 * k + 1 + slots + k * part_blocks


_SMS = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _launch_hist(fn_name, bins_t, w, ch, out, f, n, num_bins, k, packed):
    q8 = fn_name.startswith("hist_leaves_q8")
    if bins_t.dtype == torch.uint16:
        _launch_list_hist(fn_name + "_u16", bins_t, w, ch, out, f, n,
                          num_bins, k, q8)
        return
    fn_name = fn_name + ("_p4" if packed else "")
    geo = leaf_geometry(_sm_count(bins_t.device), f, n, num_bins, k, q8,
                        packed)
    fn = _fn("hist_leaves", fn_name,
             [_VP] * 4 + [_CI, _LL, _CI, _CI, _CI, _CI, _CI, _LL, _CI, _VP])
    _raise_on(fn(_p(bins_t), _p(w), _p(ch), _p(out), f, n, num_bins, k,
                 geo.cg, geo.fg, geo.chunks, geo.chunk_rows,
                 int(ch.data_ptr() % 4 == 0), _stream()), fn_name)


# -- the channel partition (csrc/hist_leaves_u16.cu) ---------------------------

class RowList(NamedTuple):
    """The rows with 0 <= ch < K listed by channel, ascending within one,
    as ``records`` (int64; the first ``offsets[K]`` are the list): the
    exact form's (M, 4) [g, h, id | n << 32, 0], the quantized form's (M,)
    id | g << 32 | h << 40 | n << 48 (the int8 weights' bytes), its
    three weights beside each id; ``offsets`` (K + 1,) int32; and the
    list's chunks: ``slots`` (K,) int32 chunks of each channel and
    ``table`` (S + K,) int32, entry r = (j << 8) | c for the slot of rank
    r (slot j of channel c), -1 past the last (:func:`list_slots`)."""
    records: torch.Tensor
    offsets: torch.Tensor
    slots: torch.Tensor
    table: torch.Tensor

    def ids(self) -> torch.Tensor:
        """The listed rows' ids, (offsets[K],) int64."""
        m = int(self.offsets[-1])
        r = self.records[:m]
        return (r[:, 2] if r.dim() == 2 else r) & 0xFFFFFFFF

    def weights(self) -> torch.Tensor:
        """The listed rows' (g, h, count), (3, offsets[K]) int64."""
        m = int(self.offsets[-1])
        r = self.records[:m]
        if r.dim() == 2:
            return torch.stack([r[:, 0], r[:, 1], r[:, 2] >> 32])
        return torch.stack([((r >> s) & 0xFF).to(torch.uint8).view(
            torch.int8).long() for s in (32, 40, 48)])


def _records(ids: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The partition's records of rows ``ids`` (int64) with weights ``w``
    (>= 3, N), int64 (exact) or int8 (quantized)."""
    w3 = w[:3, ids].long()
    if w.dtype == torch.int8:
        return (ids | ((w3[0] & 0xFF) << 32) | ((w3[1] & 0xFF) << 40) |
                ((w3[2] & 0xFF) << 48))
    return torch.stack([w3[0], w3[1], ids | (w3[2] << 32),
                        torch.zeros_like(ids)], dim=1)


def list_slots(counts: torch.Tensor, num_slots: int) -> tuple:
    """(slots, table) of ``num_slots`` chunk slots shared out over channels
    of ``counts`` listed rows: channel c takes s_c = max(1, round(n_c x S
    / total)) (half up; 0 if empty), at most S + K in all; the slots are
    ranked by the start of their share of the channel, (j / s_c, c), so
    that blocks run together walk the same stretch of rows.  The plain
    version of the plan the partition's scatter writes
    (csrc/hist_leaves_u16.cu ``write_plan``)."""
    n = counts.to(torch.int64).cpu()
    k = n.numel()
    total = int(n.sum())
    s = (torch.clamp((2 * n * num_slots + total) // max(2 * total, 1),
                     min=1) * (n > 0)).to(torch.int64)
    table = torch.full((num_slots + k,), -1, dtype=torch.int32)
    c = torch.repeat_interleave(torch.arange(k), s)
    j = torch.arange(c.numel()) - torch.repeat_interleave(
        torch.cumsum(s, 0) - s, s)
    if c.numel():
        sc, sd = s[c][:, None], s[None, :]
        q = j[:, None] * sd
        other = (torch.arange(k)[None, :] != c[:, None]) & (sd > 0)
        tie = (torch.arange(k)[None, :] < c[:, None]) & (q % sc == 0)
        rank = j + ((-(-q // sc) + tie) * other).sum(dim=1)
        table[rank] = ((j << 8) | c).to(torch.int32)
    return s.to(torch.int32), table


def leaf_partition_plain(ch: torch.Tensor, w: torch.Tensor, *,
                         num_channels: int, slots: int) -> RowList:
    """Plain version of :func:`leaf_partition`: a stable argsort of the
    kept rows' channels, offsets from their ``bincount``."""
    k = num_channels
    rows = torch.nonzero((ch >= 0) & (ch < k)).squeeze(1)
    c = ch[rows].long()
    ids = rows[torch.argsort(c, stable=True)]
    counts = torch.bincount(c, minlength=k)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
    s, table = list_slots(counts, slots)
    return RowList(_records(ids, w), offsets.to(torch.int32),
                   s.to(ch.device), table.to(ch.device))


def leaf_partition(ch: torch.Tensor, w: torch.Tensor, *, num_channels: int,
                   slots: int, part_blocks: int = None) -> RowList:
    """The rows of each leaf channel as one list of records
    (:class:`RowList`): ch (N,) int8, rows outside [0, K) unlisted; w
    (>= 3, N) int64 (exact) or int8 (quantized) weights, its first three
    rows copied into the records.  On the card the records have room for
    N rows, the first ``offsets[K]`` listed; ``part_blocks`` row blocks
    (default :func:`list_geometry`'s count)."""
    _check_partition("leaf_partition", ch, w, num_channels, slots)
    if ch.device.type == "cpu":
        return leaf_partition_plain(ch, w, num_channels=num_channels,
                                    slots=slots)
    rec, plan = _partition_buffers([ch], [w], num_channels, slots,
                                   part_blocks, False)
    return _row_lists(rec, plan, num_channels, slots)[0]


def _check_partition(kernel, ch, w, k, slots) -> None:
    if ch.dtype != torch.int8 or ch.dim() != 1:
        raise TypeError(f"{kernel}: ch must be (N,) int8")
    n = ch.shape[0]
    if (w.dtype not in (torch.int64, torch.int8) or w.dim() != 2 or
            w.shape[0] < 3 or w.shape[1] != n):
        raise ValueError(f"{kernel}: weights must be (>= 3, {n}) "
                         f"int64 or int8, got {tuple(w.shape)} {w.dtype}")
    if not 1 <= k <= LIST_MAX_CHANNELS or slots < 0:
        raise ValueError(f"{kernel}: {k} channels (at most "
                         f"{LIST_MAX_CHANNELS}) and {slots} slots")
    if w.device != ch.device:
        raise ValueError(f"weights are on {w.device}, expected {ch.device}")
    if not (ch.is_contiguous() and w.is_contiguous()):
        raise ValueError(f"{kernel}: ch and weights must be contiguous")
    _check_device(kernel, ch.device)
    if n >= 1 << 31:
        raise ValueError(f"{kernel}: {n} rows; a record's id is 32 bits")


def _partition_buffers(chs, ws, k, slots, part_blocks, lanes_form):
    """Launch the channel partition of each lane's ``chs[l]``, ``ws[l]``:
    one lane's ``leaf_partition``, or with ``lanes_form`` the lanes'
    ``leaf_partition_lanes`` (the lane as grid y; ``part_blocks`` row
    blocks a lane, by default :func:`_part_blocks`' share of the lanes).
    Returns the (L, N, 4)
    or (L, N) int64 records and the (L, plan) int32 plans, each lane's
    laid out as :class:`RowList` reads it."""
    lanes, n, w0 = len(chs), chs[0].shape[0], ws[0]
    dev = chs[0].device
    if part_blocks is None:
        part_blocks = _part_blocks(_sm_count(dev), n, lanes)
    rec = torch.empty((lanes, n, 4) if w0.dtype == torch.int64
                      else (lanes, n), dtype=torch.int64, device=dev)
    plan = torch.empty((lanes, plan_ints(k, slots, part_blocks)),
                       dtype=torch.int32, device=dev)
    if not n:
        plan.zero_()
        plan[:, 2 * k + 1:3 * k + 1 + slots] = -1
    elif lanes_form:
        table = _lane_table([[c.data_ptr() for c in chs],
                             [w.data_ptr() for w in ws]], dev)
        fn = _fn("hist_leaves_u16", "leaf_partition_lanes",
                 [_VP, _CI, _LL, _CI, _CI, _CI, _VP, _VP, _CI, _VP])
        _raise_on(fn(_p(table), w0.element_size(), n, k, part_blocks, slots,
                     _p(rec), _p(plan), lanes, _stream()),
                  "leaf_partition_lanes")
        LAUNCHES["leaf_partition_lanes"] += 1
    else:
        fn = _fn("hist_leaves_u16", "leaf_partition",
                 [_VP, _VP, _CI, _LL, _CI, _CI, _CI, _VP, _VP, _VP])
        _raise_on(fn(_p(chs[0]), _p(w0), w0.element_size(), n, k,
                     part_blocks, slots, _p(rec), _p(plan), _stream()),
                  "leaf_partition")
        LAUNCHES["leaf_partition"] += 1
    return rec, plan


def _row_lists(rec, plan, k, slots) -> list:
    """Each lane's :class:`RowList`: views of the partition's buffers."""
    return [RowList(r, p[:k + 1], p[k + 1:2 * k + 1],
                    p[2 * k + 1:3 * k + 1 + slots])
            for r, p in zip(rec, plan)]


def leaf_partition_lanes_plain(ch, w, *, num_channels: int,
                               slots: int) -> list:
    """Plain version of :func:`leaf_partition_lanes`: each lane's
    :func:`leaf_partition_plain`."""
    return [leaf_partition_plain(c, w_, num_channels=num_channels,
                                 slots=slots)
            for c, w_ in zip(_seq(ch), _seq(w))]


def leaf_partition_lanes(ch, w, *, num_channels: int, slots: int,
                         part_blocks: int = None) -> list:
    """:func:`leaf_partition` of L lanes in one launch of each of its
    two kernels (the lane as grid y): ``ch`` and ``w`` hold each lane's
    (N,) int8 channels and (>= 3, N) weights, of one dtype.  Returns each
    lane's :class:`RowList`, record for record its single partition's;
    ``part_blocks`` row blocks a lane."""
    ch, w = _seq(ch), _seq(w)
    _lane_count("leaf_partition_lanes", ch, w)
    for c, w_ in zip(ch, w):
        _check_partition("leaf_partition_lanes", c, w_, num_channels, slots)
    if len({(c.shape[0], c.device, w_.dtype) for c, w_ in zip(ch, w)}) != 1:
        raise ValueError("leaf_partition_lanes: every lane needs the same "
                         "row count, device and weight dtype")
    if ch[0].device.type == "cpu":
        return leaf_partition_lanes_plain(ch, w, num_channels=num_channels,
                                          slots=slots)
    rec, plan = _partition_buffers(ch, w, num_channels, slots, part_blocks,
                                   True)
    return _row_lists(rec, plan, num_channels, slots)


def _launch_list_hist(fn_name, bins_t, w, ch, out, f, n, num_bins, k, q8,
                      scale=None):
    """The channel partition, then the histogram over its records, both
    on the current stream and from one :func:`list_geometry`; ``scale``
    (the fx form's (3,) float64 scale) writes ``out`` as f32 in owner
    mode."""
    geo = list_geometry(_sm_count(bins_t.device), f, n, num_bins, k, q8,
                        f32_out=scale is not None)
    rec, plan = _partition_buffers([ch], [w], k, geo.slots,
                                   geo.part_blocks, False)
    if q8:
        fn = _fn("hist_leaves_u16", fn_name,
                 [_VP] * 4 + [_CI, _LL, _CI, _CI, _CI, _CI, _CI, _VP])
        _raise_on(fn(_p(bins_t), _p(rec), _p(plan), _p(out), f, n, num_bins,
                     k, geo.fg, geo.bt, geo.slots, _stream()), fn_name)
        return
    fn = _fn("hist_leaves_u16", fn_name,
             [_VP] * 5 + [_CI, _LL, _CI, _CI, _CI, _CI, _CI, _VP])
    _raise_on(fn(_p(bins_t), _p(rec), _p(plan), _p(out),
                 _VP(None) if scale is None else _p(scale), f, n, num_bins,
                 k, geo.fg, geo.bt, geo.slots, _stream()), fn_name)


# the lanes' histogram launches (csrc/hist_leaves_u16.cu hist_lanes): a
# launch a lane, or one launch of every lane's clusters, lane-major (a
# channel's feature groups together) or feature-major (a feature group's
# lanes and channels together)
LIST_LAUNCH_PER_LANE, LIST_LANE_MAJOR, LIST_FEATURE_MAJOR = 0, 1, 2


def list_lane_order(geo: ListGeometry) -> int:
    """How the lanes forms launch their histograms: one launch,
    feature-major, in every mode.  On an H100 at L=4 over 10.5M rows it
    was the fastest of the three or within 1% of it for both forms on
    every mix measured but the exact form's 90% skew over channels, where
    lane-major was 2-5% faster; lane-major was the slowest on the even
    mix at B=1024 (q8 6.31 ms against 3.87 feature-major and 4.06 a
    launch a lane; PERF.md section 6, the sweep
    ``scripts/torch_u16_lanes_sweep.py``)."""
    return LIST_FEATURE_MAJOR


def _launch_list_hist_lanes(fn_name, bins_t, ws, chs, out, f, n, num_bins,
                            k, q8, scales=None):
    """The lanes' channel partitions in one launch, then the lanes'
    histograms over their row lists (:func:`list_geometry`), launched as
    :func:`list_lane_order` says; ``scales`` (the fx form's (L, 3)
    float64 scales) writes ``out`` as f32 in owner mode."""
    lanes = len(ws)
    sms = _sm_count(bins_t.device)
    geo = list_geometry(sms, f, n, num_bins, k, q8,
                        f32_out=scales is not None)
    part_blocks = _part_blocks(sms, n, lanes)
    rec, plan = _partition_buffers(chs, ws, k, geo.slots, part_blocks, True)
    head = [_p(bins_t), _p(rec), _p(plan), _p(out)]
    if not q8:
        head.append(_VP(None) if scales is None else _p(scales))
    fn = _fn("hist_leaves_u16", fn_name,
             [_VP] * len(head) + [_CI, _CI, _LL] + [_CI] * 7 + [_VP])
    _raise_on(fn(*head, lanes, f, n, num_bins, k, geo.fg, geo.bt,
                 geo.slots, part_blocks, list_lane_order(geo), _stream()),
              fn_name)


def _unpacked(bins_t, bins_packed: bool):
    return unpack_bins4(bins_t) if bins_packed else widen_bins(bins_t)


def build_histogram_leaves_q8_plain(bins_t, wch, ch, *, num_bins: int,
                                    bins_packed: bool = False):
    """Plain version: int64 ``index_add_`` cast to int32 (packed bins are
    unpacked first)."""
    return _scatter_leaves(_unpacked(bins_t, bins_packed), wch, ch,
                           num_channels=Q_LEAF_CHANNELS, num_bins=num_bins,
                           acc_dtype=torch.int64).to(torch.int32)


def build_histogram_leaves_q8(bins_t: torch.Tensor, wch: torch.Tensor,
                              ch: torch.Tensor, *, num_bins: int,
                              interpret=None, pipeline=None,
                              bins_packed: bool = False) -> torch.Tensor:
    """(42, F, B, 3) int32 histograms of 42 leaf channels in one pass.

    bins_t (F, N) uint8, or (F, N/2) packed with ``bins_packed``; wch
    (8, N) int8 [g_q, h_q, count, 0...] from ops/quantize.py
    ``quantize_wch``; ch (N,) int8 channel, -1 = row in no batched leaf.
    Exact integer sums, as the reference."""
    f, n = _check_hist_args("build_histogram_leaves_q8", bins_t, wch,
                            torch.int8, 8, ch, num_bins, bins_packed)
    if bins_t.device.type == "cpu":
        return build_histogram_leaves_q8_plain(bins_t, wch, ch,
                                               num_bins=num_bins,
                                               bins_packed=bins_packed)
    out = torch.zeros((Q_LEAF_CHANNELS, f, num_bins, 3), dtype=torch.int32,
                      device=bins_t.device)
    _launch_hist("hist_leaves_q8", bins_t, wch, ch, out, f, n, num_bins,
                 Q_LEAF_CHANNELS, bins_packed)
    LAUNCHES["hist_leaves_q8_packed4" if bins_packed else
             "hist_leaves_q8_u16" if bins_t.dtype == torch.uint16
             else "hist_leaves_q8"] += 1
    return out


def build_histogram_leaves_plain(bins_t, w: FxWeights, ch, *,
                                 num_bins: int, bins_packed: bool = False,
                                 raw: bool = False):
    """Plain version: int64 ``index_add_`` of the fixed-point weights,
    scaled back to f32 (``raw``: the int64 sums) — the same integers as
    the kernel (packed bins are unpacked first)."""
    h = _scatter_leaves(_unpacked(bins_t, bins_packed), w.w, ch,
                        num_channels=LEAF_CHANNELS, num_bins=num_bins,
                        acc_dtype=torch.int64)
    return h if raw else fx_to_f32(h, w.inv_scale)


def build_histogram_leaves(bins_t: torch.Tensor, w: FxWeights,
                           ch: torch.Tensor, *, num_bins: int,
                           interpret=None, pipeline=None,
                           bins_packed: bool = False,
                           raw: bool = False) -> torch.Tensor:
    """(25, F, B, 3) f32 histograms of 25 leaf channels in one pass.

    bins_t (F, N) uint8, or (F, N/2) packed with ``bins_packed``; ``w``
    from :func:`pack_weights`; ch (N,) int8 channel, -1 = row in no
    batched leaf.  ``raw`` returns the kernel's int64 fixed-point sums
    instead, which passes over row chunks weighted with one tree's
    exponents add exactly (ingest/grower.py).  Over uint16 bins past one
    bin tile the f32 values come straight from the kernel (owner mode,
    :class:`ListGeometry`)."""
    f, n = _check_hist_args("build_histogram_leaves", bins_t, w.w,
                            torch.int64, 3, ch, num_bins, bins_packed)
    if bins_t.device.type == "cpu":
        return build_histogram_leaves_plain(bins_t, w, ch, num_bins=num_bins,
                                            bins_packed=bins_packed, raw=raw)
    if bins_t.dtype == torch.uint16 and list_owner(num_bins, False, not raw):
        # owner mode: the kernel writes the f32 values whole
        scale = _scales("build_histogram_leaves", w.inv_scale, (3,),
                        bins_t.device)
        out = torch.empty((LEAF_CHANNELS, f, num_bins, 3),
                          dtype=torch.float32, device=bins_t.device)
        _launch_list_hist("hist_leaves_fx_u16", bins_t, w.w, ch, out, f, n,
                          num_bins, LEAF_CHANNELS, False, scale)
        LAUNCHES["hist_leaves_u16"] += 1
        return out
    out = torch.zeros((LEAF_CHANNELS, f, num_bins, 3), dtype=torch.int64,
                      device=bins_t.device)
    _launch_hist("hist_leaves_fx", bins_t, w.w, ch, out, f, n, num_bins,
                 LEAF_CHANNELS, bins_packed)
    LAUNCHES["hist_leaves_packed4" if bins_packed else
             "hist_leaves_u16" if bins_t.dtype == torch.uint16
             else "hist_leaves"] += 1
    return out if raw else fx_to_f32(out, w.inv_scale)


# -- single-leaf histogram -------------------------------------------------------

def _check_single_args(kernel, bins_t, w, num_bins):
    if bins_t.dim() != 2:
        raise ValueError(f"{kernel}: bins must be (F, N)")
    f, n = bins_t.shape
    dev = bins_t.device
    dt = _bin_dtype(kernel, bins_t)
    if w.dtype != torch.int64:
        raise TypeError(f"weights must be torch.int64, got {w.dtype}")
    if tuple(w.shape) != (3, n):
        raise ValueError(f"weights must have shape (3, {n}), got "
                         f"{tuple(w.shape)}")
    if w.device != dev:
        raise ValueError(f"weights are on {w.device}, expected {dev}")
    if n > 1 and w.stride(1) != 1:
        raise ValueError("each weight row must be contiguous")
    if min(bins_t.stride()) < 0 or w.stride(0) < 0:
        raise ValueError(f"{kernel}: negative strides are not taken")
    _check_device(kernel, dev)
    _check_num_bins(kernel, num_bins, dt == torch.uint16)
    return f, n


def hist_single_plain(bins_t, w: FxWeights, *, num_bins: int,
                      bins_packed: bool = False):
    """Plain version: int64 ``index_add_`` of the fixed-point weights
    (packed bins are unpacked first)."""
    return scatter_histogram(_unpacked(bins_t, bins_packed), w.w,
                             num_bins=num_bins, acc_dtype=torch.int64)


def _check_single_packed(bins_t, w, num_bins):
    """The packed form takes the autotune probe's layout: contiguous
    (F, N/2) bytes and contiguous (3, N) weights on one device."""
    if bins_t.dim() != 2:
        raise ValueError("hist_single: packed bins must be (F, N/2)")
    f, nb = bins_t.shape
    dev = bins_t.device
    _check_packed("hist_single", 2 * nb, num_bins)
    _check("bins", bins_t, torch.uint8, (f, nb), dev)
    _check("weights", w, torch.int64, (3, 2 * nb), dev)
    _check_device("hist_single", dev)
    return f, nb


# -- single-leaf geometry (csrc/hist_single.cu) --------------------------------
#
# Per feature a block keeps (B | 1) bins of int64 g, int64 h and a uint32
# count.  A block of 1024 threads (64 registers each) fills an SM; a block
# whose histogram fits a quarter of the SM's shared memory runs at 256
# threads, four to an SM.
SINGLE_BIN_BYTES = 20
SINGLE_ROW_STEP = 16          # chunks start 16-row aligned (4-row loads)
SINGLE_MIN_ROWS = 512         # fewest rows a block takes before features split
SINGLE_MAX_BLOCK_ROWS = 1 << 31   # the per-block uint32 count of 0/1 rows
SM_SMEM = 233_472             # an H100 SM's shared memory
SINGLE_MAX_CLUSTER = 16       # H100's largest (non-portable) cluster
SINGLE_ROUNDS = 4             # resident rounds a uint16 launch may take
# rounds of lanes' items that leave the resident blocks room, uint8 and
# uint16 codes (one tile): the fewest of 1, 2 and 4 that ran fastest on
# the card (scripts/torch_single_lanes_sweep.py, PERF.md section 6)
SINGLE_LANE_ROUNDS = {False: 1, True: 4}
SINGLE_ITEM_ROUNDS = 8        # rounds of lanes' items when they crowd slots
# Clusters of 8 and 16 blocks (the uint16 form's past one bin tile)
# resident at once on an H100 SXM (132 SMs), for blocks of one per SM
# (1024 threads) and of four (256 threads): cudaOccupancyMaxActiveClusters
# as scripts/torch_u16_leaf_sweep.py prints it, what single_resident
# answers off the card (the CPU tests).
H100_RESIDENT_CLUSTERS = {8: (15, 62), 16: (7, 28)}


class SingleGeometry(NamedTuple):
    """The launch of one single-leaf histogram: ``fg`` features per block;
    ``cluster`` blocks a thread-block cluster (a multiple of ``tiles``, 1
    for the uint8 forms), which holds ``cluster / tiles * fg`` features
    of ``f_groups`` groups, each feature in ``tiles`` bin tiles of ``bt``
    bins (one tile of B unless one feature's B bins overflow a block);
    ``chunks`` row blocks (a multiple of ``cluster``; a cluster's blocks
    take consecutive chunks) of ``chunk_rows`` rows each, blocks of
    ``threads``, ``smem`` shared bytes per block; a block adds into the
    histograms of the ``peers`` ranks after its own through DSM and
    sends its other remote adds to the output through L2."""
    fg: int
    f_groups: int
    chunks: int
    chunk_rows: int
    threads: int
    smem: int
    bt: int
    tiles: int
    cluster: int = 1
    peers: int = 0


def single_bin_tile(num_bins: int) -> tuple:
    """(bins per tile, tiles): B in one tile when one feature's (B | 1)
    entries fit a block, else the fewest even tiles that do (uint16 bins
    past 11,621 bins)."""
    tiles = 1
    while ((-(-num_bins // tiles)) | 1) * SINGLE_BIN_BYTES > BLOCK_SMEM:
        tiles += 1
    return -(-num_bins // tiles), tiles


def _single_per_sm(smem: int) -> int:
    """Blocks of ``smem`` shared bytes an SM runs: 4 at 256 threads when
    their histograms fit a quarter of its shared memory, else 1."""
    return 4 if 4 * (smem + 1024) <= SM_SMEM else 1


_RESIDENT = {}


def single_resident(sms: int, cluster: int, fg: int, bt: int,
                    layout: str) -> int:
    """Clusters of ``cluster`` uint16-form blocks (fg features x bt bins)
    resident at once on a card of ``sms`` SMs, 0 when none fits: every
    SM's blocks for one block a cluster; else cudaOccupancyMaxActiveClusters
    on the current card when it has ``sms`` SMs (queried once per shape),
    and off the card :data:`H100_RESIDENT_CLUSTERS` (a cluster's blocks
    share a GPC) scaled to ``sms``, 0 for the sizes it does not list."""
    per_sm = _single_per_sm(fg * (bt | 1) * SINGLE_BIN_BYTES)
    if cluster == 1:
        return sms * per_sm
    key = (sms, cluster, fg, bt, layout)
    if key not in _RESIDENT:
        if torch.cuda.is_available() and _sm_count(
                torch.device("cuda")) == sms:
            fn = _fn("hist_single", "hist_single_u16_clusters",
                     [_CI] * 6)
            got = fn(bt, fg, bt, cluster, LEAF_THREADS // per_sm,
                     0 if layout == "rows" else 2)
        else:
            got = H100_RESIDENT_CLUSTERS.get(cluster, (0, 0))[
                per_sm > 1] * sms // 132
        _RESIDENT[key] = max(0, got)
    return _RESIDENT[key]


def _single_u8(sms: int, f: int, n: int, num_bins: int,
               layout: str) -> list:
    """The launches of one block a cluster and one tile (every B up to
    256): for each count of feature groups (features spread evenly, in
    fours for ``rows``), row chunks of at least ``SINGLE_MIN_ROWS`` rows,
    as many as fit one resident round; the cost of the busiest SM, one
    unit per (row, feature) for the adds and one per row for its
    weights, each group re-reading them."""
    per_feature = (num_bins | 1) * SINGLE_BIN_BYTES
    fg_max = max(1, min(f, BLOCK_SMEM // per_feature))
    steps = max(1, -(-n // SINGLE_ROW_STEP))
    most_chunks = max(1, -(-n // SINGLE_MIN_ROWS))
    out = []
    for g in range(1, f + 1):
        fg = -(-f // g)
        if layout == "rows" and 4 < fg < f:
            fg = -(-fg // 4) * 4
        fg = min(fg, fg_max)
        groups = -(-f // fg)
        per_sm = _single_per_sm(fg * per_feature)
        slots = sms * per_sm
        chunks = max(1, min(most_chunks, slots // groups),
                     -(-n // SINGLE_MAX_BLOCK_ROWS))
        chunk_rows = -(-steps // chunks) * SINGLE_ROW_STEP
        chunks = max(1, -(-n // chunk_rows))
        rounds = -(-groups * chunks // slots)
        cost = (fg + 1) * chunk_rows * per_sm * rounds
        out.append((cost, SingleGeometry(
            fg, groups, chunks, chunk_rows, LEAF_THREADS // per_sm,
            fg * per_feature, num_bins, 1)))
    return out


@functools.lru_cache(maxsize=256)
def single_shape(sms: int, f: int, num_bins: int,
                 layout: str) -> SingleGeometry:
    """The uint16 form's launch past 256 bins, the same for every
    segment: its :func:`single_fill` chunks for a long one, no chunk
    rows.  One tile (B <= 11,621): one block a cluster, the features
    spread evenly over the groups with the least (features a block + 1)
    x groups, a row's adds and weight reads (for ``rows`` one feature,
    all of them or an even count a block: runs that read as 4-byte
    words).  Past one tile: 8 tiles a feature (8 x 11,621 bins hold
    every uint16 code), one feature a block, and clusters of 16 blocks
    that hold two features, so a row's weights are read once per two
    features; clusters of 8 (one feature) when the card holds no cluster
    of 16; a block adds into the tiles of the :func:`single_peers` ranks
    after its own through DSM.  The masked grower's launches over every
    row, most of them weightless, read the weights more than they add,
    and took 26-32% less kernel time a tree at 16,383 and 65,535 bins
    with two features a cluster (PERF.md section 6).  Raises when no
    cluster fits the card."""
    least = single_bin_tile(num_bins)[1]
    if least == 1:
        per_feature = (num_bins | 1) * SINGLE_BIN_BYTES
        fg_max = max(1, min(f, BLOCK_SMEM // per_feature))
        best = None
        for g in range(-(-f // fg_max), f + 1):
            fg = -(-f // g)
            if layout == "rows" and fg % 2 and 1 < fg < f:
                fg += 1
            if fg > fg_max:
                continue
            groups = -(-f // fg)
            if best is None or (fg + 1) * groups < (best + 1) * -(-f // best):
                best = fg
        per_sm = _single_per_sm(best * per_feature)
        return single_fill(sms, SingleGeometry(
            best, -(-f // best), 0, 0, LEAF_THREADS // per_sm,
            best * per_feature, num_bins, 1), layout)
    tiles = max(least, SINGLE_MAX_CLUSTER // 2)
    bt = -(-num_bins // tiles)
    smem = (bt | 1) * SINGLE_BIN_BYTES
    for fgc in (min(f, SINGLE_MAX_CLUSTER // tiles), 1):
        cs = tiles * fgc
        if single_resident(sms, cs, 1, bt, layout):
            return single_fill(sms, SingleGeometry(
                1, -(-f // fgc), 0, 0, LEAF_THREADS // _single_per_sm(smem),
                smem, bt, tiles, cs, single_peers(cs)), layout)
    raise RuntimeError(f"hist_single_u16: no cluster of {tiles} blocks of "
                       f"{bt} bins fits the card")


def single_peers(cluster: int) -> int:
    """The peers a block of a ``cluster``-block cluster reaches through
    DSM (the rest of its remote adds go through L2): half the blocks, the
    share the sweep found best (PERF.md section 6)."""
    return cluster // 2


def single_fill(sms: int, geo: SingleGeometry,
                layout: str) -> SingleGeometry:
    """``geo`` with ``chunks`` set for a long segment: the clusters
    along the rows (x the cluster's blocks) that keep the most of the
    resident clusters busy over up to ``SINGLE_ROUNDS`` rounds, ties to
    fewer rounds."""
    resident = single_resident(sms, geo.cluster, geo.fg, geo.bt, layout)
    best = None
    for k in range(1, SINGLE_ROUNDS + 1):
        c = max(1, k * resident // geo.f_groups)
        clusters = c * geo.f_groups
        busy = clusters / (-(-clusters // resident) * resident)
        if best is None or busy > best[0]:
            best = (busy, c)
    return geo._replace(chunks=best[1] * geo.cluster)


def single_chunks(geo: SingleGeometry, n: int) -> SingleGeometry:
    """``geo`` (a :func:`single_fill` shape) with its row chunks for a
    segment of ``n`` rows: its clusters along the rows, fewer when a
    block would take under ``SINGLE_MIN_ROWS`` rows (one when the segment
    is shorter than a cluster's share), more when a cluster would take
    over ``SINGLE_MAX_BLOCK_ROWS``."""
    cs = geo.cluster
    c = max(1, min(geo.chunks // cs, n // (cs * SINGLE_MIN_ROWS)),
            -(-n // (SINGLE_MAX_BLOCK_ROWS - cs * SINGLE_ROW_STEP)))
    rows = -(-(-(-n // c)) // (cs * SINGLE_ROW_STEP)) * SINGLE_ROW_STEP
    c = -(-n // (cs * rows))
    return geo._replace(chunks=c * cs, chunk_rows=rows)


@functools.lru_cache(maxsize=4096)
def single_geometry(sms: int, f: int, n: int, num_bins: int,
                    layout: str) -> SingleGeometry:
    """Geometry of ``hist_single[_u16|_p4]`` on a card with ``sms`` SMs
    for a segment of ``n`` rows; ``layout`` is ``rows`` (row-major runs,
    read as words when a group's features come in fours, or in pairs for
    uint16 codes), ``features`` or ``packed``.  Up to 256 bins, of
    :func:`_single_u8`'s launches the cheapest, ties to the first
    listed: long segments take all features in one block per SM and
    short ones split the features until the grid fills the SMs.  Past
    256 bins (the uint16 form) :func:`single_shape`, the same for every
    segment, with :func:`single_chunks`' row chunks for this one (O(1)
    a launch)."""
    if num_bins <= 256 or layout == "packed":
        return min(_single_u8(sms, f, n, num_bins, layout),
                   key=lambda c: c[0])[1]
    return single_chunks(single_shape(sms, f, num_bins, layout), n)


def hist_single(bins_t: torch.Tensor, w: FxWeights, *, num_bins: int,
                bins_packed: bool = False) -> torch.Tensor:
    """(F, B, 3) int64 fixed-point histogram of one leaf.

    bins_t: (F, n) uint8 view with any strides (the partitioned grower
    passes ``P[s:e, :F].T`` of its row-major packed rows); ``w``: the
    tree's :func:`pack_weights` restricted to the same rows
    (``w.w[:, s:e]``), rows of the leaf carrying their weights and all
    other rows zeros; the count row 0/1.  With ``bins_packed``: contiguous
    (F, N/2) packed bytes and contiguous (3, N) weights.  Scale back with
    :func:`fx_to_f32`."""
    if bins_packed:
        f, nb = _check_single_packed(bins_t, w.w, num_bins)
        n = 2 * nb
    else:
        f, n = _check_single_args("hist_single", bins_t, w.w, num_bins)
    if bins_t.device.type == "cpu":
        return hist_single_plain(bins_t, w, num_bins=num_bins,
                                 bins_packed=bins_packed)
    out = torch.zeros((f, num_bins, 3), dtype=torch.int64,
                      device=bins_t.device)
    if f == 0 or n == 0:
        return out
    sf, sn = bins_t.stride()
    layout = ("packed" if bins_packed else
              "features" if sn == 1 else "rows")
    geo = single_geometry(_sm_count(bins_t.device), f, n, num_bins, layout)
    ptr = bins_t.data_ptr()
    if bins_packed:
        fn = _fn("hist_single", "hist_single_p4",
                 [_VP] * 3 + [_CI, _LL, _CI, _CI, _CI, _LL, _CI, _CI, _VP])
        _raise_on(fn(_p(bins_t), _p(w.w), _p(out), f, nb, num_bins, geo.fg,
                     geo.chunks, geo.chunk_rows, geo.threads,
                     int(ptr % 2 == 0 and nb % 2 == 0), _stream()),
                  "hist_single_p4")
        LAUNCHES["hist_single_packed4"] += 1
        return out
    if bins_t.dtype == torch.uint16:
        # 4 rows a 64-bit load (FEATS, from the first aligned row); words
        # of 2 features (ROWS), every run of a cluster's features 4-byte
        # aligned
        if layout == "features":
            kind = 3 if sf % 4 == 0 else 2
        else:
            fgc = geo.cluster // geo.tiles * geo.fg
            kind = int(sf == 1 and ptr % 4 == 0 and sn % 2 == 0 and
                       (fgc % 2 == 0 or geo.f_groups == 1))
        fn = _fn("hist_single", "hist_single_u16",
                 [_VP, _LL, _LL, _VP, _LL, _VP, _CI, _LL, _CI, _CI, _CI, _CI,
                  _CI, _CI, _LL, _CI, _CI, _VP])
        _raise_on(fn(_p(bins_t), sf, sn, _p(w.w), w.w.stride(0), _p(out), f,
                     n, num_bins, geo.fg, geo.bt, geo.cluster, geo.peers,
                     geo.chunks, geo.chunk_rows, geo.threads, kind,
                     _stream()), "hist_single_u16")
        LAUNCHES["hist_single_u16"] += 1
        return out
    if layout == "features":   # 4 rows a 32-bit load, from an aligned row
        kind = 3 if sf % 4 == 0 else 2
    else:
        kind = int(sf == 1 and ptr % 4 == 0 and sn % 4 == 0 and
                   (geo.fg % 4 == 0 or geo.f_groups == 1))
    fn = _fn("hist_single", "hist_single",
             [_VP, _LL, _LL, _VP, _LL, _VP, _CI, _LL, _CI, _CI, _CI, _LL,
              _CI, _CI, _VP])
    _raise_on(fn(_p(bins_t), sf, sn, _p(w.w), w.w.stride(0), _p(out), f, n,
                 num_bins, geo.fg, geo.chunks, geo.chunk_rows, geo.threads,
                 kind, _stream()), "hist_single")
    LAUNCHES["hist_single"] += 1
    return out


def build_histogram(bins_t: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, mask: torch.Tensor, *,
                    num_bins: int, bins_packed: bool = False
                    ) -> torch.Tensor:
    """(F, B, 3) f32 histogram of one leaf over masked rows: (sum g*mask,
    sum h*mask, count of rows with mask > 0).

    bins_t (F, N) uint8, any strides; grad, hess, mask (N,) f32; N need
    not be a multiple of a row block.  With ``bins_packed``: contiguous
    (F, N/2) packed bytes, N a multiple of the 4096-row block.  The
    weights are packed to fixed point for this call (one scale per
    channel over these rows).  CPU tensors take the plain version,
    ``ops/histogram.py`` ``build_histogram``."""
    if bins_t.device.type == "cpu":
        return _plain.build_histogram(_unpacked(bins_t, bins_packed), grad,
                                      hess, mask, num_bins=num_bins)
    w = pack_weights(grad, hess, mask)
    return fx_to_f32(hist_single(bins_t, w, num_bins=num_bins,
                                 bins_packed=bins_packed), w.inv_scale)


# -- row update ---------------------------------------------------------------

def _check_row_args(kernel, cols_w, rl, tab, feats, bins_packed,
                    decode=None):
    if cols_w.dim() != 2:
        raise ValueError(f"{kernel}: cols_w must be (W, N) or, with feats, "
                         "the (F, N) bin matrix" +
                         (" packed as (F, N/2)" if bins_packed else ""))
    if tab.dim() != 2 or rl.dim() != 1:
        raise ValueError(f"{kernel}: tab must be (8, W) and rl (N,)")
    wn, n, f = tab.shape[1], rl.shape[0], cols_w.shape[0]
    dev = cols_w.device
    if bins_packed and n % 2:
        raise ValueError(f"{kernel}: packed bins need an even row count, "
                         f"got {n}")
    _check("cols_w", cols_w, _bin_dtype(kernel, cols_w, bins_packed),
           (f, n // 2 if bins_packed else n), dev)
    _check("rl", rl, torch.int32, (n,), dev)
    _check("tab", tab, torch.int32, (8, wn), dev)
    if feats is None:
        if f != wn:
            raise ValueError(f"{kernel}: without feats, cols_w must hold "
                             f"one column per split ({wn}), got {f}")
    else:
        _check("feats", feats, torch.int32, (wn,), dev)
    if decode is not None:
        if bins_packed:
            raise ValueError(f"{kernel}: the categorical / EFB form reads "
                             "unpacked bins")
        _check("decode.dec", decode.dec, torch.int32, (5, wn), dev)
        _check("decode.member", decode.member, torch.int32,
               (wn, MEMBER_WORDS), dev)
    _check_device(kernel, dev)
    if wn > 128:
        raise ValueError(f"{kernel}: at most 128 splits per pass, got {wn}")
    if f == 0 and wn > 0:
        raise ValueError(f"{kernel}: the bin matrix has no feature")
    return wn, n


# bitset words of a split's categorical membership: 256 bins
MEMBER_WORDS = 8


class SplitDecode(NamedTuple):
    """Per-split inputs of the row update's categorical / EFB form.

    ``dec`` (5, W) int32 rows [is_categorical, f_offset, f_nbins,
    f_default, f_single]: how split j turns its column byte v into its
    feature's bin b (``efb.make_bundle_decode``: b = v when f_single,
    else u = v - f_offset, b = u + (u >= f_default) for 0 <= u <
    f_nbins - 1 and f_default otherwise), and whether it then goes left by
    membership instead of the threshold.  ``member`` (W, 8) int32: bit b
    of word b // 32 set when bin b goes left (the bits of each int32 as
    uint32)."""
    dec: torch.Tensor
    member: torch.Tensor


def split_decode(is_cat: torch.Tensor, member: torch.Tensor,
                 f_offset: torch.Tensor, f_nbins: torch.Tensor,
                 f_default: torch.Tensor, f_single: torch.Tensor
                 ) -> SplitDecode:
    """A :class:`SplitDecode` from per-split (W,) flags and decode
    parameters and the (W, B) bool membership, B <= 256."""
    i32 = torch.int32
    w, b = member.shape
    if b > 32 * MEMBER_WORDS:
        raise ValueError(f"membership over {b} bins; at most "
                         f"{32 * MEMBER_WORDS}")
    m = torch.nn.functional.pad(member.to(torch.int64),
                                (0, 32 * MEMBER_WORDS - b))
    weights = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=member.device),
        torch.arange(32, dtype=torch.int64, device=member.device))
    words = (m.reshape(w, MEMBER_WORDS, 32) * weights).sum(dim=-1)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    dec = torch.stack([is_cat.to(i32), f_offset.to(i32), f_nbins.to(i32),
                       f_default.to(i32), f_single.to(i32)]).contiguous()
    return SplitDecode(dec, words.to(i32).contiguous())


def _split_columns(cols_w, feats, bins_packed):
    """The (W, N) unpacked columns the splits read: the plain versions'
    gather (a feature outside [0, F) clamped into it, as the kernel does;
    an inactive split's column is never used)."""
    if feats is not None:
        idx = feats.long().clamp(0, cols_w.shape[0] - 1)
        cols_w = take_rows(cols_w, idx)
    return _unpacked(cols_w, bins_packed)


def _decide(col, j, tab, decode):
    """Split j's decision over its (N,) int32 column: 1 = left.  With
    ``decode``, the column is decoded to its feature's bins first and a
    categorical split reads its membership bit."""
    thr, nanb, dlft = tab[0, j], tab[1, j], tab[2, j]
    if decode is not None:
        is_cat, off, nb, dft, single = (decode.dec[i, j] for i in range(5))
        u = col - off
        mapped = torch.where((u >= 0) & (u < nb - 1),
                             u + (u >= dft).to(torch.int32), dft)
        col = torch.where(single > 0, col, mapped)
        word = decode.member[j].to(torch.int64).index_select(
            0, (col >> 5).long().clamp(0, MEMBER_WORDS - 1))
        bit = ((word >> (col & 31).to(torch.int64)) & 1).to(torch.int32)
    go_left = torch.where(col == nanb, dlft, (col <= thr).to(torch.int32))
    if decode is not None:
        go_left = torch.where(is_cat > 0, bit, go_left)
    return go_left


def _row_loop(cols, rl, tab, decode=None):
    rl = rl.clone()
    ch = torch.full_like(rl, -1)
    cols = cols.to(torch.int32)
    for j in range(cols.shape[0]):
        small, selj, newid, act = (tab[i, j] for i in range(3, 7))
        go_left = _decide(cols[j], j, tab, decode)
        upd = (rl == selj) & (act > 0)
        ch = torch.where(upd & (go_left == small), j, ch)
        rl = torch.where(upd & (go_left == 0), newid, rl)
    return rl, ch.to(torch.int8)


def wave_row_update_plain(cols_w, rl, tab, *, feats=None,
                          bins_packed: bool = False,
                          decode: SplitDecode = None):
    """Plain version: gather (and unpack) the split columns, then a Python
    loop over the W splits of ``torch.where``, in the order and with the
    overwrites of histogram_pallas.py:1097-1113; with ``decode``, each
    split's column decoded and categorical splits decided by
    membership."""
    return _row_loop(_split_columns(cols_w, feats, bins_packed), rl, tab,
                     decode)


def _launch_rows(kernel, cols_w, rl, tab, feats, bins_packed, rl_out, ch,
                 decode=None):
    """Launch ``kernel`` (its ``_u16`` form for uint16 bins, which takes
    no packed flag); returns the form's :data:`LAUNCHES` key."""
    wn, n = tab.shape[1], rl.shape[0]
    vec = int(rl.data_ptr() % 16 == 0 and ch.data_ptr() % 4 == 0 and
              (rl_out is None or rl_out.data_ptr() % 16 == 0))
    ext = [] if decode is None else [_p(decode.dec), _p(decode.member)]
    wide = cols_w.dtype == torch.uint16
    packed = [] if wide else [int(bins_packed)]
    kernel = kernel + ("_u16" if wide else "")
    fn = _fn("row_update", kernel,
             [_VP, _LL, _CI] + [_VP] * (4 if rl_out is None else 5) +
             [_VP] * len(ext) + [_CI, _LL] + [_CI] * len(packed) +
             [_CI, _VP])
    outs = [_p(ch)] if rl_out is None else [_p(rl_out), _p(ch)]
    _raise_on(fn(_p(cols_w), cols_w.stride(0), cols_w.shape[0],
                 _p(feats) if feats is not None else None, _p(rl), _p(tab),
                 *outs, *ext, wn, n, *packed, vec, _stream()),
              kernel)
    return kernel


def wave_row_update(cols_w: torch.Tensor, rl: torch.Tensor,
                    tab: torch.Tensor, *, feats: torch.Tensor = None,
                    bins_packed: bool = False, decode: SplitDecode = None,
                    interpret=None, pipeline=None):
    """Apply a wave's W splits to every row in one pass.

    rl (N,) int32 row->leaf; tab (8, W) int32 rows [threshold_bin,
    nan_bin (-1 = none), default_left, left_is_smaller, split_leaf,
    new_right_id, active, 0].  ``cols_w`` is the (W, N) uint8 winning
    columns (the reference's signature), or, with ``feats`` ((W,) int32,
    the column of each split), the grower's (F, N) bin matrix read in
    place; with ``bins_packed`` either is nibble-packed, (.., N/2).  An
    active split's column must lie in [0, F); an inactive split's
    column is never read.  ``decode`` (:class:`SplitDecode`, uint8 bins
    only) selects the categorical / EFB form: each split's byte is
    decoded to its feature's bin and a categorical split goes left by
    membership.  Returns (rl_new (N,) int32, ch (N,) int8 smaller-child
    channel)."""
    wn, n = _check_row_args("wave_row_update", cols_w, rl, tab, feats,
                            bins_packed, decode)
    if cols_w.device.type == "cpu":
        return wave_row_update_plain(cols_w, rl, tab, feats=feats,
                                     bins_packed=bins_packed, decode=decode)
    rl_out = torch.empty_like(rl)
    ch = torch.empty((n,), dtype=torch.int8, device=rl.device)
    kernel = "wave_row_update" if decode is None else "wave_row_update_ext"
    LAUNCHES[_launch_rows(kernel, cols_w, rl, tab, feats, bins_packed,
                          rl_out, ch, decode)] += 1
    return rl_out, ch


def trial_tab(sel_leaves, thr, nan_bin, default_left, left_smaller,
              active):
    """The (8, W) row-update table of a trial pass: new_right_id =
    split_leaf, so row->leaf never changes."""
    i32 = torch.int32
    return torch.stack([thr.to(i32), nan_bin.to(i32), default_left.to(i32),
                        left_smaller.to(i32), sel_leaves.to(i32),
                        sel_leaves.to(i32), active.to(i32),
                        torch.zeros_like(thr, dtype=i32)]).contiguous()


def wave_trial_channels_plain(cols_w, rl, sel_leaves, thr, nan_bin,
                              default_left, left_smaller, active, *,
                              feats=None, bins_packed: bool = False):
    """Plain version: the row update with new_right_id = split_leaf."""
    tab = trial_tab(sel_leaves, thr, nan_bin, default_left, left_smaller,
                     active)
    return wave_row_update_plain(cols_w, rl, tab, feats=feats,
                                 bins_packed=bins_packed)[1]


def wave_trial_channels(cols_w: torch.Tensor, rl: torch.Tensor,
                        sel_leaves: torch.Tensor, thr: torch.Tensor,
                        nan_bin: torch.Tensor, default_left: torch.Tensor,
                        left_smaller: torch.Tensor, active: torch.Tensor,
                        *, feats: torch.Tensor = None,
                        bins_packed: bool = False, interpret=None,
                        pipeline=None) -> torch.Tensor:
    """TRIAL leaf channels of W *candidate* splits: the slot whose SMALLER
    side each row would take, or -1; ``rl`` is not changed (the exact
    endgame's batched pass, learner/wave.py).  ``cols_w``, ``feats`` and
    ``bins_packed`` as in :func:`wave_row_update`."""
    tab = trial_tab(sel_leaves, thr, nan_bin, default_left, left_smaller,
                     active)
    wn, n = _check_row_args("wave_trial_channels", cols_w, rl, tab, feats,
                            bins_packed)
    if cols_w.device.type == "cpu":
        return wave_row_update_plain(cols_w, rl, tab, feats=feats,
                                     bins_packed=bins_packed)[1]
    ch = torch.empty((n,), dtype=torch.int8, device=rl.device)
    LAUNCHES[_launch_rows("wave_trial_channels", cols_w, rl, tab, feats,
                          bins_packed, None, ch)] += 1
    return ch


# -- the model-axis (lane) forms ----------------------------------------------
#
# The reference batches its entry points under ``jax.vmap``: pallas_call's
# batching rule makes the batch axis a leading grid dimension
# (histogram_pallas.py:45-48), which is how multitrain/batched.py runs M
# models' kernels in one launch.  The forms below take L lanes' inputs,
# each lane's own tensors (a sequence, or one stacked (L, ...) tensor),
# over ONE shared bin matrix, and launch once for all of them; the lane is
# the kernel's leading grid dimension, so each lane's output is bitwise
# the single launch's on that lane.  The kernels find each lane's inputs
# through a small device table of pointers (no stacking copy).  Each plain
# version is one ``index_add_`` with the lane folded into the channel
# index (histograms) or the single plain version per lane (row update).

# the grid's y / z limit, the most lanes one launch can take; a batch is
# capped far below it, at ``tpu_multitrain_batch`` lanes (default 256),
# by multitrain/__init__.py ``train_many``
MAX_LANES = 65_535


def _seq(x) -> list:
    """A sequence of per-lane tensors from a sequence or a stacked (L, ...)
    tensor."""
    return list(x.unbind(0)) if isinstance(x, torch.Tensor) else list(x)


def _lane_count(kernel: str, *seqs) -> int:
    lanes = {len(q) for q in seqs if q is not None}
    if len(lanes) != 1:
        raise ValueError(f"{kernel}: every per-lane input needs one entry "
                         f"per lane, got {sorted(lanes)}")
    lanes = lanes.pop()
    if not 1 <= lanes <= MAX_LANES:
        raise ValueError(f"{kernel}: 1 to {MAX_LANES} lanes, got {lanes}")
    return lanes


def _lane_table(rows, dev) -> torch.Tensor:
    """The kernels' (len(rows), L) int64 table of per-lane pointers and
    sizes, on the device: copied from pinned host memory without waiting
    (a copy from pageable memory would hold the host until the stream
    reaches it)."""
    return torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)


def build_histogram_leaves_q8_lanes_plain(bins_t, wch, ch, *, num_bins: int,
                                          bins_packed: bool = False):
    """Plain version: one int64 ``index_add_`` over lanes x channels, cast
    to int32."""
    return _plain.build_histogram_leaves_lanes(
        _unpacked(bins_t, bins_packed), _seq(wch), _seq(ch),
        num_channels=Q_LEAF_CHANNELS, num_bins=num_bins,
        acc_dtype=torch.int64).to(torch.int32)


# a lanes launch may cut each lane's rows into up to this many times the
# single form's row chunks, to fill whole resident rounds
LEAF_LANE_CHUNKS = 2
# and into enough chunks for at least this many rounds of the resident
# blocks where that cap allows: a lane whose blocks leave at once (no row
# in their channels) or run long (its rows crowded on a few bins) then
# leaves fewer of the other lanes' blocks to a round of their own
LEAF_LANE_ROUNDS = 4


def _lane_chunks(units: int, lanes: int, slots: int, lo: int, hi: int,
                 rounds: int = 0) -> int:
    """Row chunks per lane for a grid of ``units`` block columns x
    ``lanes`` x chunks over ``slots`` resident blocks: the count in [lo,
    hi], at least ``rounds`` rounds of blocks if hi allows them, whose
    rounds cost least per chunk of rows (ceil(units x lanes x c / slots)
    / c), the fewest on a tie (each chunk flushes its histogram once)."""
    lo = max(1, lo)
    hi = max(lo, hi)
    need = -(-rounds * slots // (units * lanes))
    if need <= hi:
        lo = max(lo, need)
    best = None
    for c in range(lo, hi + 1):
        cost = -(-units * lanes * c // slots) / c
        if best is None or cost < best[0] - 1e-12:
            best = (cost, c)
    return best[1]


def lane_leaf_geometry(sms: int, f: int, n: int, num_bins: int, k: int,
                       q8: bool, packed: bool, lanes: int) -> LeafGeometry:
    """Geometry of the model-axis leaf kernels: the single form's groups
    (:func:`leaf_geometry`), and one grid of (block column, lane, row
    chunk) work items over all lanes, the blocks of one chunk of every
    lane dispatched together (they share its bin bytes in L2).  Every
    lane takes the same row chunks: the count, from the fewest the row
    cap allows to ``LEAF_LANE_CHUNKS`` times the single form's and at
    least ``LEAF_LANE_ROUNDS`` rounds where that allows, whose items fill
    whole resident rounds best (at one lane the single form's grid; at
    four lanes of 20 block columns on 132 SMs 8 chunks, 640 items in 5
    rounds, where 4 single launches take 4 rounds of 120; packed, 2
    columns, 66 chunks in 4 rounds).  Which lanes keep rows the host
    does not know without waiting for the card: the kernel's blocks of a
    lane with no row in their channels leave at once
    (:func:`leaf_live_lanes`)."""
    geo = leaf_geometry(sms, f, n, num_bins, k, q8, packed)
    combos = geo.c_groups * geo.f_groups
    steps = max(1, -(-n // LEAF_ROW_STEP))
    lo = -(-n // (Q8_MAX_BLOCK_ROWS if q8 else LEAF_MAX_BLOCK_ROWS))
    c = _lane_chunks(combos, lanes, sms, lo,
                     min(steps, LEAF_LANE_CHUNKS * geo.chunks),
                     LEAF_LANE_ROUNDS)
    chunk_rows = -(-steps // c) * LEAF_ROW_STEP
    return geo._replace(chunks=max(1, -(-n // chunk_rows)),
                        chunk_rows=chunk_rows)


def lane_single_items(sms: int, f: int, rows, num_bins: int, layout: str,
                      wide: bool = False) -> tuple:
    """Geometry of ``hist_single_lanes`` over lanes of ``rows`` rows each:
    the single form's launch shape (uint16 codes past 256 bins
    :func:`single_shape`'s, else :func:`single_geometry`'s feature groups
    and block size for all the lanes' rows as one segment) and the work
    items, (lane, feature group, first row, end row), one block a cluster
    each.  At one tile the lanes' rows are cut into items of one length q,
    a lane's last one shorter, so that they fill the resident blocks
    (``slots``) together: when every lane's groups take at most half of
    ``SINGLE_LANE_ROUNDS`` rounds of the slots, the q that fits every item
    in those rounds; else the q of ``SINGLE_ITEM_ROUNDS`` rounds of the
    lanes' rows, so that the longest item is a small share of a slot's
    work however the block scheduler packs the shorter ones; at least
    ``SINGLE_MIN_ROWS`` rows a block, starts 16-row aligned.  The items
    run lane by lane, piece by piece, the feature groups of one piece
    together (their rows shared in L2).  Past one tile each lane's
    clusters are its single launch's (:func:`single_chunks`, at most
    ``SINGLE_MAX_BLOCK_ROWS`` rows a cluster, its blocks' uint32 counts):
    more, shorter items cost more flushes of the feature's tiles than
    their balance gained on the card.  A short lane takes a slot only for
    the rows it has and an empty one none.  Returns (the geometry, its
    ``chunks`` the items' blocks and ``chunk_rows`` the longest item; the
    items)."""
    total = sum(rows)
    if wide and num_bins > 256:
        geo = single_shape(sms, f, num_bins, layout)
    else:
        geo = single_geometry(sms, f, max(1, total), num_bins, layout)
    cs, groups = geo.cluster, geo.f_groups
    if cs > 1:
        # past one tile: each lane's clusters its single launch's
        # (single_chunks), with no surplus cluster
        items = []
        for lane, r in enumerate(rows):
            if r > 0:
                step = single_chunks(geo, r).chunk_rows * cs
                items.extend((lane, y, a, min(r, a + step))
                             for y in range(groups)
                             for a in range(0, r, step))
        return (geo._replace(chunks=len(items) * cs,
                             chunk_rows=max(b - a for _, _, a, b in items)
                             if items else 0), tuple(items))
    slots = max(1, single_resident(sms, cs, geo.fg, geo.bt, layout))
    unit = cs * SINGLE_ROW_STEP
    live = sum(1 for r in rows if r > 0)
    k = SINGLE_LANE_ROUNDS[wide]
    if 2 * live * groups <= k * slots:
        q = -(-total * groups // (k * slots - live * groups))
    else:
        q = -(-total * groups // (SINGLE_ITEM_ROUNDS * slots))
    q = min((SINGLE_MAX_BLOCK_ROWS - unit) // unit * unit,
            max(cs * SINGLE_MIN_ROWS, -(-q // unit) * unit))
    items = []
    for lane, r in enumerate(rows):
        if r > 0:   # the lane's rows in equal pieces of at most q
            pieces = -(-r // q)
            step = -(-(-(-r // pieces)) // unit) * unit
            items.extend((lane, y, a, min(r, a + step))
                         for a in range(0, r, step) for y in range(groups))
    return geo._replace(chunks=len(items) * cs, chunk_rows=q), tuple(items)


def _launch_hist_lanes(fn_name, bins_t, ws, chs, out, f, n, num_bins, k,
                       packed):
    q8 = fn_name.startswith("hist_leaves_q8")
    if bins_t.dtype == torch.uint16:
        _launch_list_hist_lanes(fn_name + "_u16", bins_t, ws, chs, out, f, n,
                                num_bins, k, q8)
        return
    lanes = len(ws)
    geo = lane_leaf_geometry(_sm_count(bins_t.device), f, n, num_bins, k,
                             q8, packed, lanes)
    table = _lane_table([[w.data_ptr() for w in ws],
                         [c.data_ptr() for c in chs]], bins_t.device)
    vec = int(all(c.data_ptr() % 4 == 0 for c in chs))
    live = _live_lanes(table, chs, k)
    fn = _fn("hist_leaves", fn_name,
             [_VP] * 4 + [_CI, _CI, _LL, _CI, _CI, _CI, _CI, _CI, _LL, _CI,
                          _CI, _VP])
    _raise_on(fn(_p(bins_t), _p(table), _p(live), _p(out), lanes, f, n,
                 num_bins, k, geo.cg, geo.fg, geo.chunks, geo.chunk_rows,
                 vec, int(packed), _stream()), fn_name)


def leaf_live_lanes_plain(ch, *, num_channels: int) -> torch.Tensor:
    """Plain version: (L, K) int32, 1 where lane l's channels hold channel
    c for some row."""
    return torch.stack([torch.bincount(
        c[(c >= 0) & (c < num_channels)].long(), minlength=num_channels) > 0
        for c in _seq(ch)]).to(torch.int32)


def leaf_live_lanes(ch, *, num_channels: int) -> torch.Tensor:
    """(L, K) int32 live-channel flags of L lanes' (N,) int8 channels: 1
    where a row of lane l is in channel c < K.  The uint8 and packed leaf
    lanes forms launch it before their histogram, whose blocks of a lane
    with no row in their channels then leave at once."""
    ch = _seq(ch)
    lanes = _lane_count("leaf_live_lanes", ch)
    n = ch[0].shape[0]
    for c in ch:
        _check("leaf_live_lanes: ch", c, torch.int8, (n,), ch[0].device)
    _check_device("leaf_live_lanes", ch[0].device)
    if not 1 <= num_channels < 128:
        raise ValueError(f"leaf_live_lanes: 1 to 127 channels, got "
                         f"{num_channels}")
    if ch[0].device.type == "cpu":
        return leaf_live_lanes_plain(ch, num_channels=num_channels)
    table = _lane_table([[0] * lanes, [c.data_ptr() for c in ch]],
                        ch[0].device)
    return _live_lanes(table, ch, num_channels)


def _live_lanes(table, chs, k) -> torch.Tensor:
    """:func:`leaf_live_lanes` of the lanes in ``table`` (its second row
    the channel pointers), on the card."""
    live = torch.zeros((len(chs), k), dtype=torch.int32,
                       device=chs[0].device)
    fn = _fn("hist_leaves", "leaf_lanes_live",
             [_VP, _VP, _CI, _LL, _CI, _VP])
    _raise_on(fn(_p(table), _p(live), len(chs), chs[0].shape[0], k,
                 _stream()), "leaf_lanes_live")
    LAUNCHES["leaf_live_lanes"] += 1
    return live


def build_histogram_leaves_q8_lanes(bins_t: torch.Tensor, wch, ch, *,
                                    num_bins: int,
                                    bins_packed: bool = False
                                    ) -> torch.Tensor:
    """(L, 42, F, B, 3) int32: :func:`build_histogram_leaves_q8` of L lanes
    in one launch (uint16 bins: the lanes' channel partition in one
    launch, then one histogram launch of every lane's clusters).
    ``bins_t`` is shared; ``wch`` and ``ch`` hold each lane's (8, N) int8
    weights and (N,) int8 channels."""
    wch, ch = _seq(wch), _seq(ch)
    lanes = _lane_count("build_histogram_leaves_q8_lanes", wch, ch)
    f = n = None
    for w_, c_ in zip(wch, ch):
        f, n = _check_hist_args("build_histogram_leaves_q8_lanes", bins_t,
                                w_, torch.int8, 8, c_, num_bins, bins_packed)
    if bins_t.device.type == "cpu":
        return build_histogram_leaves_q8_lanes_plain(
            bins_t, wch, ch, num_bins=num_bins, bins_packed=bins_packed)
    out = torch.zeros((lanes, Q_LEAF_CHANNELS, f, num_bins, 3),
                      dtype=torch.int32, device=bins_t.device)
    _launch_hist_lanes("hist_leaves_q8_lanes", bins_t, wch, ch, out, f, n,
                       num_bins, Q_LEAF_CHANNELS, bins_packed)
    LAUNCHES["hist_leaves_q8_lanes_packed4" if bins_packed else
             "hist_leaves_q8_lanes_u16" if bins_t.dtype == torch.uint16
             else "hist_leaves_q8_lanes"] += 1
    return out


def _lane_scales(ws) -> torch.Tensor:
    return torch.stack([w.inv_scale for w in ws])


def build_histogram_leaves_lanes_plain(bins_t, ws, ch, *, num_bins: int,
                                       bins_packed: bool = False):
    """Plain version: one int64 ``index_add_`` over lanes x channels of the
    fixed-point weights, each lane scaled back with its own scale."""
    ws = list(ws)
    h = _plain.build_histogram_leaves_lanes(
        _unpacked(bins_t, bins_packed), [w.w for w in ws], _seq(ch),
        num_channels=LEAF_CHANNELS, num_bins=num_bins, acc_dtype=torch.int64)
    return fx_to_f32(h, _lane_scales(ws))


def build_histogram_leaves_lanes(bins_t: torch.Tensor, ws, ch, *,
                                 num_bins: int, bins_packed: bool = False
                                 ) -> torch.Tensor:
    """(L, 25, F, B, 3) f32: :func:`build_histogram_leaves` of L lanes in
    one launch (uint16 bins: the lanes' channel partition in one launch,
    then the lanes' histograms, :func:`_fx_lanes_u16`).  ``ws`` holds each
    lane's :class:`FxWeights` (its tree's own scale), ``ch`` each lane's
    (N,) int8 channels."""
    ws, ch = list(ws), _seq(ch)
    lanes = _lane_count("build_histogram_leaves_lanes", ws, ch)
    f = n = None
    for w_, c_ in zip(ws, ch):
        f, n = _check_hist_args("build_histogram_leaves_lanes", bins_t,
                                w_.w, torch.int64, 3, c_, num_bins,
                                bins_packed)
    if bins_t.device.type == "cpu":
        return build_histogram_leaves_lanes_plain(
            bins_t, ws, ch, num_bins=num_bins, bins_packed=bins_packed)
    if bins_t.dtype == torch.uint16:
        out = _fx_lanes_u16(bins_t, ws, ch, f, n, num_bins)
        LAUNCHES["hist_leaves_lanes_u16"] += 1
        return out
    sums = torch.zeros((lanes, LEAF_CHANNELS, f, num_bins, 3),
                       dtype=torch.int64, device=bins_t.device)
    _launch_hist_lanes("hist_leaves_fx_lanes", bins_t, [w.w for w in ws], ch,
                       sums, f, n, num_bins, LEAF_CHANNELS, bins_packed)
    LAUNCHES["hist_leaves_lanes_packed4" if bins_packed else
             "hist_leaves_lanes"] += 1
    return fx_scale_lanes(sums, _lane_scales(ws))


def _fx_lanes_u16(bins_t, ws, chs, f, n, num_bins) -> torch.Tensor:
    """The exact lanes form over uint16 bins: past one bin tile in owner
    mode (each lane's f32 values written whole by its clusters, with no
    int64 histogram); at one tile in slot mode, the lanes' int64 sums
    then :func:`fx_scale_lanes`."""
    dev = bins_t.device
    scales = _scales("build_histogram_leaves_lanes", _lane_scales(ws),
                     (len(ws), 3), dev)
    shape = (len(ws), LEAF_CHANNELS, f, num_bins, 3)
    w3 = [w.w for w in ws]
    if list_owner(num_bins, False, True):
        out = torch.empty(shape, dtype=torch.float32, device=dev)
        _launch_list_hist_lanes("hist_leaves_fx_lanes_u16", bins_t, w3, chs,
                                out, f, n, num_bins, LEAF_CHANNELS, False,
                                scales)
        return out
    sums = torch.zeros(shape, dtype=torch.int64, device=dev)
    _launch_list_hist_lanes("hist_leaves_fx_lanes_u16", bins_t, w3, chs,
                            sums, f, n, num_bins, LEAF_CHANNELS, False)
    return fx_scale_lanes(sums, scales)


def _scales(kernel, scale, shape, dev) -> torch.Tensor:
    """A kernel's float64 fixed-point scales, checked."""
    if scale.dtype != torch.float64 or tuple(scale.shape) != shape:
        raise ValueError(f"{kernel}: scales must be {shape} float64, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if scale.device != dev:
        raise ValueError(f"{kernel}: scales are on {scale.device}, "
                         f"expected {dev}")
    return scale.contiguous()


def fx_scale_lanes(h: torch.Tensor, inv_scale: torch.Tensor
                   ) -> torch.Tensor:
    """(L, ..., 3) f32 values of L lanes' int64 fixed-point sums ``h``
    (contiguous), lane l scaled by ``inv_scale[l]`` ((L, 3) float64): one
    pass, (float)((double)sum x scale), bitwise :func:`fx_to_f32` (its
    plain version, which takes three: to float64, the multiply, to
    float32).  Its launches count under ``fx_scale_lanes_u16``, after the
    file that holds its kernel."""
    if (h.dtype != torch.int64 or h.dim() < 2 or h.shape[-1] != 3 or
            not h.is_contiguous()):
        raise ValueError(f"fx_scale_lanes: sums must be contiguous (L, ..., "
                         f"3) int64, got {tuple(h.shape)} {h.dtype}")
    _check_device("fx_scale_lanes", h.device)
    scale = _scales("fx_scale_lanes", inv_scale, (h.shape[0], 3), h.device)
    if h.device.type == "cpu":
        return fx_to_f32(h, scale)
    out = torch.empty(h.shape, dtype=torch.float32, device=h.device)
    triples = h[0].numel() // 3
    if triples:
        fn = _fn("hist_leaves_u16", "fx_scale_lanes",
                 [_VP, _VP, _VP, _LL, _CI, _VP])
        _raise_on(fn(_p(h), _p(scale), _p(out), triples, h.shape[0],
                     _stream()), "fx_scale_lanes")
        LAUNCHES["fx_scale_lanes_u16"] += 1
    return out


def _weights_of(w) -> torch.Tensor:
    return w.w if isinstance(w, FxWeights) else w


def hist_single_lanes_plain(bins, ws, *, num_bins: int,
                            bins_packed: bool = False):
    """Plain version: one int64 ``index_add_`` with the lane as the channel
    index (packed bins are unpacked first)."""
    return _plain.scatter_histogram_lanes(
        [_unpacked(b, bins_packed) for b in _seq(bins)],
        [_weights_of(w) for w in ws], num_bins=num_bins,
        acc_dtype=torch.int64)


def hist_single_lanes(bins, ws, *, num_bins: int,
                      bins_packed: bool = False) -> torch.Tensor:
    """(L, F, B, 3) int64: :func:`hist_single` of L lanes in one launch.
    ``bins[l]`` is lane l's (F, n_l) uint8 or uint16 view (a segment of
    its own row-major rows, or a feature-major matrix; every lane's view
    with the same dtype and strides), ``ws[l]`` its :class:`FxWeights` or
    (3, n_l) int64 weights over the same rows.  With ``bins_packed`` (the
    reference's ``vmap`` of ``build_histogram_pallas(bins_packed=True)``):
    each lane's contiguous (F, N/2) nibble-packed bytes, all of one width,
    and its contiguous (3, N) weights.  Scale back per lane with
    :func:`fx_to_f32`."""
    bins, ws = _seq(bins), [_weights_of(w) for w in ws]
    lanes = _lane_count("hist_single_lanes", bins, ws)
    strides = {(b.stride(), b.dtype) for b in bins}
    if len(strides) != 1 or len({b.shape for b in bins} if bins_packed
                                else {b.shape[0] for b in bins}) != 1:
        raise ValueError("hist_single_lanes: every lane's bins need the same "
                         "feature count, dtype and strides"
                         + (" and width" if bins_packed else ""))
    f = n = None
    rows = []
    for b, w in zip(bins, ws):
        if bins_packed:
            f, nb = _check_single_packed(b, w, num_bins)
            n = 2 * nb
        else:
            f, n = _check_single_args("hist_single_lanes", b, w, num_bins)
        rows.append(n)
    if bins[0].device.type == "cpu":
        return hist_single_lanes_plain(bins, ws, num_bins=num_bins,
                                       bins_packed=bins_packed)
    dev = bins[0].device
    out = torch.zeros((lanes, f, num_bins, 3), dtype=torch.int64, device=dev)
    if f == 0 or max(rows) == 0:
        return out
    sf, sn = bins[0].stride()
    layout = ("packed" if bins_packed else
              "features" if sn == 1 else "rows")
    wide = bins[0].dtype == torch.uint16
    geo, items = lane_single_items(_sm_count(dev), f, rows, num_bins,
                                   layout, wide)
    table = _lane_table([b.data_ptr() for b in bins] +
                        [w.data_ptr() for w in ws] + rows +
                        [w.stride(0) for w in ws] +
                        [x for it in items for x in it], dev)
    if wide:
        # as hist_single's uint16 form, the alignment of each lane's bins
        # pointer taken in the kernel (FEATS: from each span's first
        # aligned row)
        if layout == "features":
            kind = 3 if sf % 4 == 0 else 2
        else:
            fgc = geo.cluster // geo.tiles * geo.fg
            kind = int(sf == 1 and sn % 2 == 0 and
                       (fgc % 2 == 0 or geo.f_groups == 1))
        fn = _fn("hist_single", "hist_single_lanes_u16",
                 [_VP, _CI, _LL, _LL, _VP] + [_CI] * 9 + [_VP])
        _raise_on(fn(_p(table), len(items), sf, sn, _p(out), lanes, f,
                     num_bins, geo.fg, geo.bt, geo.cluster, geo.peers,
                     geo.threads, kind, _stream()), "hist_single_lanes_u16")
        LAUNCHES["hist_single_lanes_u16"] += 1
        return out
    if layout == "packed":
        kind = 5 if sf % 4 == 0 else 4
    elif layout == "features":
        kind = 3 if sf % 4 == 0 else 2
    else:
        kind = int(sf == 1 and sn % 4 == 0 and
                   (geo.fg % 4 == 0 or geo.f_groups == 1))
    fn = _fn("hist_single", "hist_single_lanes",
             [_VP, _CI, _LL, _LL, _VP] + [_CI] * 6 + [_VP])
    _raise_on(fn(_p(table), len(items), sf, sn, _p(out), lanes, f, num_bins,
                 geo.fg, geo.threads, kind, _stream()), "hist_single_lanes")
    LAUNCHES["hist_single_lanes_packed4" if bins_packed
             else "hist_single_lanes"] += 1
    return out


def _check_row_lanes(kernel, cols_w, rl, tab, feats, bins_packed, decode):
    lanes = _lane_count(kernel, rl, tab, feats,
                        None if decode is None else decode)
    wn = n = None
    for l_ in range(lanes):
        wn, n = _check_row_args(kernel, cols_w, rl[l_], tab[l_], feats[l_],
                                bins_packed,
                                None if decode is None else decode[l_])
    if len({t.shape[1] for t in tab}) != 1:
        raise ValueError(f"{kernel}: every lane needs the same W")
    return lanes, wn, n


def wave_row_update_lanes_plain(cols_w, rl, tab, *, feats,
                                bins_packed: bool = False, decode=None):
    """Plain version: the single plain version on each lane, stacked."""
    outs = [wave_row_update_plain(
        cols_w, r, t, feats=f, bins_packed=bins_packed,
        decode=None if decode is None else decode[i])
        for i, (r, t, f) in enumerate(zip(_seq(rl), _seq(tab), _seq(feats)))]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def _launch_rows_lanes(kernel, cols_w, rl, tab, feats, bins_packed, rl_out,
                       ch, decode=None):
    """Launch ``kernel`` (its ``_u16`` form for uint16 bins); returns the
    form's :data:`LAUNCHES` key."""
    lanes, wn, n = len(rl), tab[0].shape[1], rl[0].shape[0]
    kernel = kernel + ("_u16" if cols_w.dtype == torch.uint16 else "")
    rows = [[f.data_ptr() for f in feats], [r.data_ptr() for r in rl],
            [t.data_ptr() for t in tab]]
    if decode is not None:
        rows += [[d.dec.data_ptr() for d in decode],
                 [d.member.data_ptr() for d in decode]]
    vec = int(n % 4 == 0 and all(r.data_ptr() % 16 == 0 for r in rl) and
              ch.data_ptr() % 16 == 0 and
              (rl_out is None or rl_out.data_ptr() % 16 == 0))
    table = _lane_table(rows, cols_w.device)
    outs = [_p(ch)] if rl_out is None else [_p(rl_out), _p(ch)]
    fn = _fn("row_update", kernel,
             [_VP, _LL, _CI] + [_VP] * (1 + len(outs)) +
             [_CI, _CI, _LL, _CI, _CI, _VP])
    _raise_on(fn(_p(cols_w), cols_w.stride(0), cols_w.shape[0], _p(table),
                 *outs, lanes, wn, n, int(bins_packed), vec, _stream()),
              kernel)
    return kernel


def wave_row_update_lanes(cols_w: torch.Tensor, rl, tab, *, feats,
                          bins_packed: bool = False, decode=None):
    """:func:`wave_row_update` of L lanes in one launch, over the shared
    (F, N) bin matrix ``cols_w`` (uint8, nibble-packed with
    ``bins_packed``, or uint16: the ``_u16`` forms) read in place.
    ``rl``, ``tab`` and ``feats`` hold each lane's (N,) int32 row->leaf,
    (8, W) int32 table and (W,) int32 split columns; ``decode`` each
    lane's :class:`SplitDecode` (the categorical / EFB form).  Returns
    (rl_new (L, N) int32, ch (L, N) int8)."""
    rl, tab, feats = _seq(rl), _seq(tab), _seq(feats)
    decode = None if decode is None else list(decode)
    lanes, wn, n = _check_row_lanes("wave_row_update_lanes", cols_w, rl,
                                    tab, feats, bins_packed, decode)
    if cols_w.device.type == "cpu":
        return wave_row_update_lanes_plain(cols_w, rl, tab, feats=feats,
                                           bins_packed=bins_packed,
                                           decode=decode)
    rl_out = torch.empty((lanes, n), dtype=torch.int32, device=cols_w.device)
    ch = torch.empty((lanes, n), dtype=torch.int8, device=cols_w.device)
    kernel = ("wave_row_update_lanes" if decode is None
              else "wave_row_update_ext_lanes")
    LAUNCHES[_launch_rows_lanes(kernel, cols_w, rl, tab, feats, bins_packed,
                                rl_out, ch, decode)] += 1
    return rl_out, ch


def wave_trial_channels_lanes_plain(cols_w, rl, tab, *, feats,
                                    bins_packed: bool = False):
    """Plain version: the single plain version on each lane, stacked."""
    return wave_row_update_lanes_plain(cols_w, rl, tab, feats=feats,
                                       bins_packed=bins_packed)[1]


def wave_trial_channels_lanes(cols_w: torch.Tensor, rl, tab, *, feats,
                              bins_packed: bool = False) -> torch.Tensor:
    """:func:`wave_trial_channels` of L lanes in one launch: ``tab`` holds
    each lane's (8, W) :func:`trial_tab`, ``rl`` and ``feats`` as in
    :func:`wave_row_update_lanes`.  Returns ch (L, N) int8."""
    rl, tab, feats = _seq(rl), _seq(tab), _seq(feats)
    lanes, wn, n = _check_row_lanes("wave_trial_channels_lanes", cols_w, rl,
                                    tab, feats, bins_packed, None)
    if cols_w.device.type == "cpu":
        return wave_trial_channels_lanes_plain(cols_w, rl, tab, feats=feats,
                                               bins_packed=bins_packed)
    ch = torch.empty((lanes, n), dtype=torch.int8, device=cols_w.device)
    LAUNCHES[_launch_rows_lanes("wave_trial_channels_lanes", cols_w, rl, tab,
                                feats, bins_packed, None, ch)] += 1
    return ch
