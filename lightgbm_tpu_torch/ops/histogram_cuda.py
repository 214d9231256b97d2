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
  (histogram_pallas.py:1280);
* :func:`wave_trial_channels` — ``wave_trial_channels_pallas``
  (histogram_pallas.py:1314).

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
           "leaf_groups", "leaf_geometry"]

# Leaf channels per pass.  These are the reference's TPU lane budgets
# (25 x 5 and 42 x 3 of 128 MXU lanes).  They set the default wave sizes,
# which decide which splits commit together, so the port keeps them.
LEAF_CHANNELS = 25
Q_LEAF_CHANNELS = 42

# launches of each CUDA kernel form since the last reset_launches()
LAUNCHES = {"hist_single": 0, "hist_single_packed4": 0, "hist_leaves_q8": 0,
            "hist_leaves_q8_packed4": 0, "hist_leaves": 0,
            "hist_leaves_packed4": 0, "wave_row_update": 0,
            "wave_trial_channels": 0}

_ROW_THREADS = 256
_SINGLE_THREADS = 512
_SINGLE_SMEM = 200 * 1024   # shared bytes for one block's feature group
_SINGLE_MIN_CHUNK = 4096    # fewest rows per block (see csrc/hist_single.cu)


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


def _fn(lib_name: str, fn_name: str, nptr: int, nint: int, with_stream=True):
    from .cuda_lib import library
    fn = getattr(library(lib_name), fn_name)
    if fn_name not in _SIGS_SET:
        fn.argtypes = ([ctypes.c_void_p] * nptr + [ctypes.c_int] * nint +
                       ([ctypes.c_void_p] if with_stream else []))
        fn.restype = ctypes.c_int
        _SIGS_SET.add(fn_name)
    return fn


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
    from .cuda_lib import library
    fn = getattr(library("hist_leaves"), fn_name)
    if fn_name not in _SIGS_SET:
        ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 4 + [ci, ll, ci, ci, ci, ci, ci, ll, ci, vp]
        fn.restype = ci
        _SIGS_SET.add(fn_name)
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


def _single_geometry(dev: torch.device, f: int, n: int, num_bins: int):
    """(features per block, rows per block): as many features as fit the
    shared budget, and row chunks that give every SM its resident blocks
    once."""
    fg = max(1, min(f, _SINGLE_SMEM // (num_bins * 24)))
    per_sm = max(1, min(2048 // _SINGLE_THREADS,
                        (220 * 1024) // (fg * num_bins * 24)))
    groups = -(-f // fg)
    blocks = max(1, _sm_count(dev) * per_sm // groups)
    return fg, max(_SINGLE_MIN_CHUNK, -(-n // blocks))


def hist_single(bins_t: torch.Tensor, w: FxWeights, *, num_bins: int,
                bins_packed: bool = False) -> torch.Tensor:
    """(F, B, 3) int64 fixed-point histogram of one leaf.

    bins_t: (F, n) uint8 view with any strides (the partitioned grower
    passes ``P[s:e, :F].T`` of its row-major packed rows); ``w``: the
    tree's :func:`pack_weights` restricted to the same rows
    (``w.w[:, s:e]``), rows of the leaf carrying their weights and all
    other rows zeros.  With ``bins_packed``: contiguous (F, N/2) packed
    bytes and contiguous (3, N) weights.  Scale back with
    :func:`fx_to_f32`."""
    if bins_packed:
        f, nb = _check_single_packed(bins_t, w.w, num_bins)
    else:
        f, n = _check_single_args("hist_single", bins_t, w.w, num_bins)
    if bins_t.device.type == "cpu":
        return hist_single_plain(bins_t, w, num_bins=num_bins,
                                 bins_packed=bins_packed)
    out = torch.zeros((f, num_bins, 3), dtype=torch.int64,
                      device=bins_t.device)
    if bins_packed:
        _launch_single_packed(bins_t, w.w, out, f, nb, num_bins)
        LAUNCHES["hist_single_packed4"] += 1
        return out
    if f == 0 or n == 0:
        return out
    from .cuda_lib import library
    fn = library("hist_single").hist_single
    if "hist_single" not in _SIGS_SET:
        ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ll, ll, vp, ll, vp] + [ci] * 6 + [vp]
        fn.restype = ci
        _SIGS_SET.add("hist_single")
    fg, chunk = _single_geometry(bins_t.device, f, n, num_bins)
    sf, sn = bins_t.stride()
    _raise_on(fn(_p(bins_t), sf, sn, _p(w.w), w.w.stride(0), _p(out), f, n,
                 num_bins, fg, chunk, _SINGLE_THREADS, _stream()),
              "hist_single")
    LAUNCHES["hist_single"] += 1
    return out


def _launch_single_packed(bins_t, w, out, f, nb, num_bins):
    from .cuda_lib import library
    fn = library("hist_single").hist_single_p4
    if "hist_single_p4" not in _SIGS_SET:
        ll, vp, ci = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, ci, ll] + [ci] * 4 + [vp]
        fn.restype = ci
        _SIGS_SET.add("hist_single_p4")
    fg, chunk = _single_geometry(bins_t.device, f, 2 * nb, num_bins)
    _raise_on(fn(_p(bins_t), _p(w), _p(out), f, nb, num_bins, fg,
                 -(-chunk // 2), _SINGLE_THREADS, _stream()),
              "hist_single_p4")


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

def _check_row_args(kernel, cols_w, rl, tab):
    if cols_w.dim() != 2:
        raise ValueError(f"{kernel}: cols_w must be (W, N)")
    wn, n = cols_w.shape
    dev = cols_w.device
    _check("cols_w", cols_w, torch.uint8, (wn, n), dev)
    _check("rl", rl, torch.int32, (n,), dev)
    _check("tab", tab, torch.int32, (8, wn), dev)
    _check_device(kernel, dev)
    if wn > 128:
        raise ValueError(f"{kernel}: at most 128 splits per pass, got {wn}")
    return wn, n


def wave_row_update_plain(cols_w, rl, tab):
    """Plain version: a Python loop over the W splits of ``torch.where``,
    in the order and with the overwrites of histogram_pallas.py:1097-1113."""
    rl = rl.clone()
    ch = torch.full_like(rl, -1)
    cols = cols_w.to(torch.int32)
    for j in range(cols_w.shape[0]):
        thr, nanb, dlft, small, selj, newid, act = (tab[i, j]
                                                     for i in range(7))
        col = cols[j]
        go_left = torch.where(col == nanb, dlft, (col <= thr).to(torch.int32))
        upd = (rl == selj) & (act > 0)
        ch = torch.where(upd & (go_left == small), j, ch)
        rl = torch.where(upd & (go_left == 0), newid, rl)
    return rl, ch.to(torch.int8)


def wave_row_update(cols_w: torch.Tensor, rl: torch.Tensor,
                    tab: torch.Tensor, *, interpret=None, pipeline=None):
    """Apply a wave's W numeric splits to every row in one pass.

    cols_w (W, N) uint8 winning feature columns; rl (N,) int32 row->leaf;
    tab (8, W) int32 rows [threshold_bin, nan_bin (-1 = none),
    default_left, left_is_smaller, split_leaf, new_right_id, active, 0].
    Returns (rl_new (N,) int32, ch (N,) int8 smaller-child channel)."""
    wn, n = _check_row_args("wave_row_update", cols_w, rl, tab)
    if cols_w.device.type == "cpu":
        return wave_row_update_plain(cols_w, rl, tab)
    rl_out = torch.empty_like(rl)
    ch = torch.empty((n,), dtype=torch.int8, device=rl.device)
    fn = _fn("row_update", "wave_row_update", 5, 3)
    _raise_on(fn(_p(cols_w), _p(rl), _p(tab), _p(rl_out), _p(ch), wn, n,
                 _ROW_THREADS, _stream()), "wave_row_update")
    LAUNCHES["wave_row_update"] += 1
    return rl_out, ch


def _trial_tab(sel_leaves, thr, nan_bin, default_left, left_smaller,
               active):
    i32 = torch.int32
    return torch.stack([thr.to(i32), nan_bin.to(i32), default_left.to(i32),
                        left_smaller.to(i32), sel_leaves.to(i32),
                        sel_leaves.to(i32), active.to(i32),
                        torch.zeros_like(thr, dtype=i32)]).contiguous()


def wave_trial_channels_plain(cols_w, rl, sel_leaves, thr, nan_bin,
                              default_left, left_smaller, active):
    """Plain version: the row update with new_right_id = split_leaf."""
    tab = _trial_tab(sel_leaves, thr, nan_bin, default_left, left_smaller,
                     active)
    return wave_row_update_plain(cols_w, rl, tab)[1]


def wave_trial_channels(cols_w: torch.Tensor, rl: torch.Tensor,
                        sel_leaves: torch.Tensor, thr: torch.Tensor,
                        nan_bin: torch.Tensor, default_left: torch.Tensor,
                        left_smaller: torch.Tensor, active: torch.Tensor,
                        *, interpret=None, pipeline=None) -> torch.Tensor:
    """TRIAL leaf channels of W *candidate* splits: the slot whose SMALLER
    side each row would take, or -1; ``rl`` is not changed (the exact
    endgame's batched pass, learner/wave.py)."""
    tab = _trial_tab(sel_leaves, thr, nan_bin, default_left, left_smaller,
                     active)
    wn, n = _check_row_args("wave_trial_channels", cols_w, rl, tab)
    if cols_w.device.type == "cpu":
        return wave_row_update_plain(cols_w, rl, tab)[1]
    ch = torch.empty((n,), dtype=torch.int8, device=rl.device)
    fn = _fn("row_update", "wave_trial_channels", 4, 3)
    _raise_on(fn(_p(cols_w), _p(rl), _p(tab), _p(ch), wn, n, _ROW_THREADS,
                 _stream()), "wave_trial_channels")
    LAUNCHES["wave_trial_channels"] += 1
    return ch
