"""Hand-written CUDA kernels of the growers, their wrappers and their
plain PyTorch versions — the counterpart of
``lightgbm_tpu/ops/histogram_pallas.py``.

Five entry points, four kernels (csrc/hist_single.cu, csrc/hist_leaves.cu,
csrc/row_update.cu), the three histograms each in two forms (uint8 bins,
and nibble-packed bins with ``bins_packed=True``):

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
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..dataset import ROW_BLOCK, pad_rows
from . import histogram as _plain
from .histogram import (PACK4_MAX_BINS, FxWeights, fx_to_f32, pack_weights,
                        scatter_histogram, unpack_bins4)
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
           "lane_leaf_geometry", "lane_single_geometry",
           "build_histogram_leaves_q8_lanes",
           "build_histogram_leaves_q8_lanes_plain",
           "build_histogram_leaves_lanes", "build_histogram_leaves_lanes_plain",
           "hist_single_lanes", "hist_single_lanes_plain",
           "wave_row_update_lanes", "wave_row_update_lanes_plain",
           "wave_trial_channels_lanes", "wave_trial_channels_lanes_plain"]

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
            "wave_row_update_ext_lanes": 0, "wave_trial_channels_lanes": 0}


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
    _check("bins", bins_t, torch.uint8, (f, nb), dev)
    _check("weights", w, w_dtype, (w_rows, n), dev)
    _check("ch", ch, torch.int8, (n,), dev)
    _check_device(kernel, dev)
    if not 1 <= num_bins <= 256:
        raise ValueError(f"{kernel}: num_bins must be in [1, 256], got "
                         f"{num_bins}")
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
Q8_MAX_BLOCK_ROWS = 1 << 24     # q8 sums (g << 32) + h in 64 bits


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
    """Geometry of ``hist_leaves_{q8,fx}[_p4]`` on a card with ``sms`` SMs:
    of :func:`leaf_groups`, the one with the fewest block columns (each
    reads every row's channel byte and queues its own rows), then the
    most channels per block (its rows lie densest, so their bin and
    weight gathers share the most sectors); row chunks sized so that the
    whole grid is one resident round of one block per SM, of at most
    ``LEAF_MAX_BLOCK_ROWS`` rows (``Q8_MAX_BLOCK_ROWS`` for q8)."""
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


_SMS = {}


def _sm_count(dev: torch.device) -> int:
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def _launch_hist(fn_name, bins_t, w, ch, out, f, n, num_bins, k, packed):
    fn_name = fn_name + ("_p4" if packed else "")
    geo = leaf_geometry(_sm_count(bins_t.device), f, n, num_bins, k,
                        fn_name.startswith("hist_leaves_q8"), packed)
    fn = _fn("hist_leaves", fn_name,
             [_VP] * 4 + [_CI, _LL, _CI, _CI, _CI, _CI, _CI, _LL, _CI, _VP])
    _raise_on(fn(_p(bins_t), _p(w), _p(ch), _p(out), f, n, num_bins, k,
                 geo.cg, geo.fg, geo.chunks, geo.chunk_rows,
                 int(ch.data_ptr() % 4 == 0), _stream()), fn_name)


def _unpacked(bins_t, bins_packed: bool):
    return unpack_bins4(bins_t) if bins_packed else bins_t


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
    LAUNCHES["hist_leaves_q8_packed4" if bins_packed
             else "hist_leaves_q8"] += 1
    return out


def build_histogram_leaves_plain(bins_t, w: FxWeights, ch, *,
                                 num_bins: int, bins_packed: bool = False):
    """Plain version: int64 ``index_add_`` of the fixed-point weights,
    scaled back to f32 — the same integers as the kernel (packed bins are
    unpacked first)."""
    h = _scatter_leaves(_unpacked(bins_t, bins_packed), w.w, ch,
                        num_channels=LEAF_CHANNELS, num_bins=num_bins,
                        acc_dtype=torch.int64)
    return fx_to_f32(h, w.inv_scale)


def build_histogram_leaves(bins_t: torch.Tensor, w: FxWeights,
                           ch: torch.Tensor, *, num_bins: int,
                           interpret=None, pipeline=None,
                           bins_packed: bool = False) -> torch.Tensor:
    """(25, F, B, 3) f32 histograms of 25 leaf channels in one pass.

    bins_t (F, N) uint8, or (F, N/2) packed with ``bins_packed``; ``w``
    from :func:`pack_weights`; ch (N,) int8 channel, -1 = row in no
    batched leaf."""
    f, n = _check_hist_args("build_histogram_leaves", bins_t, w.w,
                            torch.int64, 3, ch, num_bins, bins_packed)
    if bins_t.device.type == "cpu":
        return build_histogram_leaves_plain(bins_t, w, ch, num_bins=num_bins,
                                            bins_packed=bins_packed)
    out = torch.zeros((LEAF_CHANNELS, f, num_bins, 3), dtype=torch.int64,
                      device=bins_t.device)
    _launch_hist("hist_leaves_fx", bins_t, w.w, ch, out, f, n, num_bins,
                 LEAF_CHANNELS, bins_packed)
    LAUNCHES["hist_leaves_packed4" if bins_packed else "hist_leaves"] += 1
    return fx_to_f32(out, w.inv_scale)


# -- single-leaf histogram -------------------------------------------------------

def _check_single_args(kernel, bins_t, w, num_bins):
    if bins_t.dim() != 2:
        raise ValueError(f"{kernel}: bins must be (F, N)")
    f, n = bins_t.shape
    dev = bins_t.device
    if bins_t.dtype != torch.uint8:
        raise TypeError(f"bins must be torch.uint8, got {bins_t.dtype}")
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
    if not 1 <= num_bins <= 256:
        raise ValueError(f"{kernel}: num_bins must be in [1, 256], got "
                         f"{num_bins}")
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


class SingleGeometry(NamedTuple):
    """The launch of one single-leaf histogram: ``fg`` features per block
    in ``f_groups`` groups times ``chunks`` row chunks of ``chunk_rows``
    rows, blocks of ``threads``, ``smem`` shared bytes per block."""
    fg: int
    f_groups: int
    chunks: int
    chunk_rows: int
    threads: int
    smem: int


def single_geometry(sms: int, f: int, n: int, num_bins: int,
                    layout: str) -> SingleGeometry:
    """Geometry of ``hist_single[_p4]`` on a card with ``sms`` SMs for a
    segment of ``n`` rows; ``layout`` is ``rows`` (row-major runs, read
    as words when a group's features come in fours), ``features`` or
    ``packed``.

    For each count of feature groups (features spread evenly, in fours
    for ``rows``; a block whose histogram fits a quarter of an SM runs at
    256 threads, four to an SM): row chunks of at least
    ``SINGLE_MIN_ROWS`` rows, as many as fit one resident round.  Of
    those, the launch whose busiest SM has the least work, counted as
    one unit per (row, feature) for the adds and one per row for its
    weights, each block column re-reading them; ties go to fewer
    groups.  Long segments so take all features in one block per SM;
    short ones split the features until the grid fills the SMs."""
    per_feature = (num_bins | 1) * SINGLE_BIN_BYTES
    fg_max = max(1, min(f, BLOCK_SMEM // per_feature))
    steps = max(1, -(-n // SINGLE_ROW_STEP))
    most_chunks = max(1, -(-n // SINGLE_MIN_ROWS))
    best = None
    for g in range(1, f + 1):
        fg = -(-f // g)
        if layout == "rows" and 4 < fg < f:
            fg = -(-fg // 4) * 4
        fg = min(fg, fg_max)
        groups = -(-f // fg)
        per_sm = 4 if 4 * (fg * per_feature + 1024) <= SM_SMEM else 1
        slots = sms * per_sm
        chunks = max(1, min(most_chunks, slots // groups),
                     -(-n // SINGLE_MAX_BLOCK_ROWS))
        chunk_rows = -(-steps // chunks) * SINGLE_ROW_STEP
        chunks = max(1, -(-n // chunk_rows))
        rounds = -(-groups * chunks // slots)
        cost = (fg + 1) * chunk_rows * per_sm * rounds
        geo = SingleGeometry(fg, groups, chunks, chunk_rows,
                             LEAF_THREADS // per_sm, fg * per_feature)
        if best is None or cost < best[0]:
            best = (cost, geo)
    return best[1]


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
    if layout == "features":
        kind = 3 if ptr % 4 == 0 and sf % 4 == 0 else 2
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
    _check("cols_w", cols_w, torch.uint8,
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
                             "uint8 bins")
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
        cols_w = cols_w.index_select(0, idx)
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
    wn, n = tab.shape[1], rl.shape[0]
    vec = int(rl.data_ptr() % 16 == 0 and ch.data_ptr() % 4 == 0 and
              (rl_out is None or rl_out.data_ptr() % 16 == 0))
    ext = [] if decode is None else [_p(decode.dec), _p(decode.member)]
    fn = _fn("row_update", kernel,
             [_VP, _LL, _CI] + [_VP] * (4 if rl_out is None else 5) +
             [_VP] * len(ext) + [_CI, _LL, _CI, _CI, _VP])
    outs = [_p(ch)] if rl_out is None else [_p(rl_out), _p(ch)]
    _raise_on(fn(_p(cols_w), cols_w.stride(0), cols_w.shape[0],
                 _p(feats) if feats is not None else None, _p(rl), _p(tab),
                 *outs, *ext, wn, n, int(bins_packed), vec, _stream()),
              kernel)


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
    _launch_rows(kernel, cols_w, rl, tab, feats, bins_packed, rl_out, ch,
                 decode)
    LAUNCHES[kernel] += 1
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
    _launch_rows("wave_trial_channels", cols_w, rl, tab, feats, bins_packed,
                 None, ch)
    LAUNCHES["wave_trial_channels"] += 1
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


def _lane_chunks(units: int, lanes: int, slots: int, lo: int, hi: int) -> int:
    """Row chunks per lane for a grid of ``units`` block columns x chunks x
    ``lanes`` over ``slots`` resident blocks: the count in [lo, hi] whose
    rounds of blocks cost least per chunk of rows (ceil(units x lanes x
    c / slots) / c), the fewest on a tie (each chunk flushes its
    histogram once)."""
    best = None
    for c in range(max(1, lo), max(lo, hi) + 1):
        cost = -(-units * lanes * c // slots) / c
        if best is None or cost < best[0] - 1e-12:
            best = (cost, c)
    return best[1]


def lane_leaf_geometry(sms: int, f: int, n: int, num_bins: int, k: int,
                       q8: bool, packed: bool, lanes: int) -> LeafGeometry:
    """Geometry of the model-axis leaf kernels: the single form's groups
    (:func:`leaf_geometry`), and per lane the row chunks whose grid of
    block columns x chunks x lanes fills whole resident rounds best, from
    the fewest the row cap allows to the single form's count (the single
    form's chunks times L lanes would queue L rounds; a quarter of them
    per lane can leave SMs idle)."""
    geo = leaf_geometry(sms, f, n, num_bins, k, q8, packed)
    combos = geo.c_groups * geo.f_groups
    steps = max(1, -(-n // LEAF_ROW_STEP))
    lo = -(-n // (Q8_MAX_BLOCK_ROWS if q8 else LEAF_MAX_BLOCK_ROWS))
    c = _lane_chunks(combos, lanes, sms, lo, geo.chunks)
    chunk_rows = -(-steps // c) * LEAF_ROW_STEP
    return geo._replace(chunks=max(1, -(-n // chunk_rows)),
                        chunk_rows=chunk_rows)


def lane_single_geometry(sms: int, f: int, rows, num_bins: int,
                         layout: str) -> SingleGeometry:
    """Geometry of ``hist_single_lanes`` over lanes of ``rows`` rows each:
    :func:`single_geometry`'s feature groups and block size for all the
    lanes' rows as one segment, and one chunk length for every lane,
    short enough that the lanes' blocks (each lane's rows rounded up to
    whole chunks) fit one resident round.  The grid's chunk count is the
    longest lane's; a shorter lane's surplus blocks walk no rows."""
    total = max(1, sum(rows))
    geo = single_geometry(sms, f, total, num_bins, layout)
    per_sm = LEAF_THREADS // geo.threads
    fit = max(1, sms * per_sm // geo.f_groups - len(rows))
    chunk_rows = -(-total // fit)
    chunk_rows = max(SINGLE_MIN_ROWS,
                     -(-chunk_rows // SINGLE_ROW_STEP) * SINGLE_ROW_STEP)
    chunk_rows = min(chunk_rows, SINGLE_MAX_BLOCK_ROWS)
    return geo._replace(chunks=max(1, -(-max(rows) // chunk_rows)),
                        chunk_rows=chunk_rows)


def _launch_hist_lanes(fn_name, bins_t, ws, chs, out, f, n, num_bins, k,
                       packed):
    lanes = len(ws)
    geo = lane_leaf_geometry(_sm_count(bins_t.device), f, n, num_bins, k,
                             fn_name.startswith("hist_leaves_q8"), packed,
                             lanes)
    table = _lane_table([[w.data_ptr() for w in ws],
                         [c.data_ptr() for c in chs]], bins_t.device)
    vec = int(all(c.data_ptr() % 4 == 0 for c in chs))
    fn = _fn("hist_leaves", fn_name,
             [_VP] * 3 + [_CI, _CI, _LL, _CI, _CI, _CI, _CI, _CI, _LL, _CI,
                          _CI, _VP])
    _raise_on(fn(_p(bins_t), _p(table), _p(out), lanes, f, n, num_bins, k,
                 geo.cg, geo.fg, geo.chunks, geo.chunk_rows, vec,
                 int(packed), _stream()), fn_name)


def build_histogram_leaves_q8_lanes(bins_t: torch.Tensor, wch, ch, *,
                                    num_bins: int,
                                    bins_packed: bool = False
                                    ) -> torch.Tensor:
    """(L, 42, F, B, 3) int32: :func:`build_histogram_leaves_q8` of L lanes
    in one launch.  ``bins_t`` is shared; ``wch`` and ``ch`` hold each
    lane's (8, N) int8 weights and (N,) int8 channels."""
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
    LAUNCHES["hist_leaves_q8_lanes_packed4" if bins_packed
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
    one launch.  ``ws`` holds each lane's :class:`FxWeights` (its tree's
    own scale), ``ch`` each lane's (N,) int8 channels."""
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
    out = torch.zeros((lanes, LEAF_CHANNELS, f, num_bins, 3),
                      dtype=torch.int64, device=bins_t.device)
    _launch_hist_lanes("hist_leaves_fx_lanes", bins_t, [w.w for w in ws], ch,
                       out, f, n, num_bins, LEAF_CHANNELS, bins_packed)
    LAUNCHES["hist_leaves_lanes_packed4" if bins_packed
             else "hist_leaves_lanes"] += 1
    return fx_to_f32(out, _lane_scales(ws))


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
    ``bins[l]`` is lane l's (F, n_l) uint8 view (a segment of its own
    row-major rows, or a feature-major matrix; every lane's view with the
    same strides), ``ws[l]`` its :class:`FxWeights` or (3, n_l) int64
    weights over the same rows.  With ``bins_packed`` (the reference's
    ``vmap`` of ``build_histogram_pallas(bins_packed=True)``): each lane's
    contiguous (F, N/2) nibble-packed bytes, all of one width, and its
    contiguous (3, N) weights.  Scale back per lane with
    :func:`fx_to_f32`."""
    bins, ws = _seq(bins), [_weights_of(w) for w in ws]
    lanes = _lane_count("hist_single_lanes", bins, ws)
    strides = {b.stride() for b in bins}
    if len(strides) != 1 or len({b.shape for b in bins} if bins_packed
                                else {b.shape[0] for b in bins}) != 1:
        raise ValueError("hist_single_lanes: every lane's bins need the same "
                         "feature count and strides"
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
    geo = lane_single_geometry(_sm_count(dev), f, rows, num_bins, layout)
    if layout == "packed":
        kind = 5 if sf % 4 == 0 else 4
    elif layout == "features":
        kind = 3 if sf % 4 == 0 else 2
    else:
        kind = int(sf == 1 and sn % 4 == 0 and
                   (geo.fg % 4 == 0 or geo.f_groups == 1))
    table = _lane_table([[b.data_ptr() for b in bins],
                         [w.data_ptr() for w in ws], rows,
                         [w.stride(0) for w in ws]], dev)
    fn = _fn("hist_single", "hist_single_lanes",
             [_VP, _LL, _LL, _VP, _CI, _CI, _CI, _CI, _CI, _LL, _CI, _CI,
              _VP])
    _raise_on(fn(_p(table), sf, sn, _p(out), lanes, f, num_bins, geo.fg,
                 geo.chunks, geo.chunk_rows, geo.threads, kind, _stream()),
              "hist_single_lanes")
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
    lanes, wn, n = len(rl), tab[0].shape[1], rl[0].shape[0]
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


def wave_row_update_lanes(cols_w: torch.Tensor, rl, tab, *, feats,
                          bins_packed: bool = False, decode=None):
    """:func:`wave_row_update` of L lanes in one launch, over the shared
    (F, N) bin matrix ``cols_w`` (nibble-packed with ``bins_packed``) read
    in place.  ``rl``, ``tab`` and ``feats`` hold each lane's (N,) int32
    row->leaf, (8, W) int32 table and (W,) int32 split columns; ``decode``
    each lane's :class:`SplitDecode` (the categorical / EFB form).
    Returns (rl_new (L, N) int32, ch (L, N) int8)."""
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
    _launch_rows_lanes(kernel, cols_w, rl, tab, feats, bins_packed, rl_out,
                       ch, decode)
    LAUNCHES[kernel] += 1
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
    _launch_rows_lanes("wave_trial_channels_lanes", cols_w, rl, tab, feats,
                       bins_packed, None, ch)
    LAUNCHES["wave_trial_channels_lanes"] += 1
    return ch
