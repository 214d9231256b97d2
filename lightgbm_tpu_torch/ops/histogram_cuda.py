"""Hand-written CUDA kernels of the wave grower, their wrappers and their
plain PyTorch versions — the counterpart of
``lightgbm_tpu/ops/histogram_pallas.py``.

Four entry points, three kernels (csrc/hist_leaves.cu, csrc/row_update.cu):

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
accepted and ignored: both TPU variants collapse into one kernel here.
Nibble-packed 4-bit bins (``pack_bins4``) are not ported yet.

Exact-mode weights.  The reference carries g*mask and h*mask as bf16
hi+lo pairs into an f32 MXU contraction.  The port carries them as 64-bit
fixed point with one power-of-two scale per channel per tree
(:func:`pack_weights`) and sums integers, which makes the histogram
independent of summation order: the kernel and its plain version agree
bit for bit and every run grows the same tree.  The scale leaves 2^61 of
headroom for N x max|w|, so each weight keeps about 2^-37 of max|w| of
absolute precision at 2^24 rows.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .histogram import build_histogram_leaves as _scatter_leaves

__all__ = ["LEAF_CHANNELS", "Q_LEAF_CHANNELS", "LAUNCHES", "FxWeights",
           "pack_weights", "build_histogram_leaves",
           "build_histogram_leaves_q8", "wave_row_update",
           "wave_trial_channels", "build_histogram_leaves_plain",
           "build_histogram_leaves_q8_plain", "wave_row_update_plain",
           "wave_trial_channels_plain", "reset_launches"]

# Leaf channels per pass.  These are the reference's TPU lane budgets
# (25 x 5 and 42 x 3 of 128 MXU lanes).  They set the default wave sizes,
# which decide which splits commit together, so the port keeps them.
LEAF_CHANNELS = 25
Q_LEAF_CHANNELS = 42

# launches of each CUDA kernel since the last reset_launches()
LAUNCHES = {"hist_leaves_q8": 0, "hist_leaves": 0, "wave_row_update": 0,
            "wave_trial_channels": 0}

_HIST_THREADS = 512
_HIST_CHUNK = 1 << 18     # rows per block (see csrc/hist_leaves.cu)
_ROW_THREADS = 256
_FX_HEADROOM_BITS = 61


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class FxWeights(NamedTuple):
    """Per-tree exact-mode weights: ``w`` (3, N) int64 fixed point
    [g*mask, h*mask, count] and ``inv_scale`` (3,) float64 turning integer
    sums back into values."""
    w: torch.Tensor
    inv_scale: torch.Tensor


def _fx_exponent(amax: float, n: int) -> int:
    if amax <= 0.0 or not math.isfinite(amax):
        return 0
    return (_FX_HEADROOM_BITS - math.ceil(math.log2(max(n, 1))) -
            math.ceil(math.log2(amax)))


def pack_weights(grad: torch.Tensor, hess: torch.Tensor,
                 mask: torch.Tensor) -> FxWeights:
    """Exact-mode weights for one tree (the counterpart of
    ``pack_weights8``, histogram_pallas.py:539): g*mask and h*mask in
    64-bit fixed point, the count channel as strict 0/1 membership (the
    reference counts rows, not weights)."""
    n = grad.shape[0]
    gm = (grad * mask).double()
    hm = (hess * mask).double()
    rows, inv = [], []
    for v in (gm, hm):
        e = _fx_exponent(float(v.abs().max()) if n else 0.0, n)
        rows.append(torch.round(v * (2.0 ** e)).to(torch.int64))
        inv.append(2.0 ** -e)
    rows.append((mask > 0).to(torch.int64))
    inv.append(1.0)
    return FxWeights(torch.stack(rows),
                     torch.tensor(inv, dtype=torch.float64,
                                  device=grad.device))


def _fx_to_f32(h: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    return (h.double() * inv_scale).float()


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

def _check_hist_args(kernel, bins_t, w, w_dtype, w_rows, ch, num_bins):
    if bins_t.dim() != 2:
        raise ValueError(f"{kernel}: bins must be (F, N)")
    f, n = bins_t.shape
    dev = bins_t.device
    _check("bins", bins_t, torch.uint8, (f, n), dev)
    _check("weights", w, w_dtype, (w_rows, n), dev)
    _check("ch", ch, torch.int8, (n,), dev)
    _check_device(kernel, dev)
    if not 1 <= num_bins <= 256:
        raise ValueError(f"{kernel}: num_bins must be in [1, 256], got "
                         f"{num_bins}")
    return f, n


def _launch_hist(fn_name, bins_t, w, ch, out, f, n, num_bins, k):
    fn = _fn("hist_leaves", fn_name, 4, 6)
    chunk = min(_HIST_CHUNK, max(n, 1))
    _raise_on(fn(_p(bins_t), _p(w), _p(ch), _p(out), f, n, num_bins, k,
                 chunk, _HIST_THREADS, _stream()), fn_name)


def build_histogram_leaves_q8_plain(bins_t, wch, ch, *, num_bins: int):
    """Plain version: int64 ``index_add_`` cast to int32."""
    return _scatter_leaves(bins_t, wch, ch, num_channels=Q_LEAF_CHANNELS,
                           num_bins=num_bins,
                           acc_dtype=torch.int64).to(torch.int32)


def build_histogram_leaves_q8(bins_t: torch.Tensor, wch: torch.Tensor,
                              ch: torch.Tensor, *, num_bins: int,
                              interpret=None, pipeline=None
                              ) -> torch.Tensor:
    """(42, F, B, 3) int32 histograms of 42 leaf channels in one pass.

    bins_t (F, N) uint8; wch (8, N) int8 [g_q, h_q, count, 0...] from
    ops/quantize.py ``quantize_wch``; ch (N,) int8 channel, -1 = row in no
    batched leaf.  Exact integer sums, as the reference."""
    f, n = _check_hist_args("build_histogram_leaves_q8", bins_t, wch,
                            torch.int8, 8, ch, num_bins)
    if bins_t.device.type == "cpu":
        return build_histogram_leaves_q8_plain(bins_t, wch, ch,
                                               num_bins=num_bins)
    out = torch.zeros((Q_LEAF_CHANNELS, f, num_bins, 3), dtype=torch.int32,
                      device=bins_t.device)
    _launch_hist("hist_leaves_q8", bins_t, wch, ch, out, f, n, num_bins,
                 Q_LEAF_CHANNELS)
    LAUNCHES["hist_leaves_q8"] += 1
    return out


def build_histogram_leaves_plain(bins_t, w: FxWeights, ch, *,
                                 num_bins: int):
    """Plain version: int64 ``index_add_`` of the fixed-point weights,
    scaled back to f32 — the same integers as the kernel."""
    h = _scatter_leaves(bins_t, w.w, ch, num_channels=LEAF_CHANNELS,
                        num_bins=num_bins, acc_dtype=torch.int64)
    return _fx_to_f32(h, w.inv_scale)


def build_histogram_leaves(bins_t: torch.Tensor, w: FxWeights,
                           ch: torch.Tensor, *, num_bins: int,
                           interpret=None, pipeline=None) -> torch.Tensor:
    """(25, F, B, 3) f32 histograms of 25 leaf channels in one pass.

    bins_t (F, N) uint8; ``w`` from :func:`pack_weights`; ch (N,) int8
    channel, -1 = row in no batched leaf."""
    f, n = _check_hist_args("build_histogram_leaves", bins_t, w.w,
                            torch.int64, 3, ch, num_bins)
    if bins_t.device.type == "cpu":
        return build_histogram_leaves_plain(bins_t, w, ch, num_bins=num_bins)
    out = torch.zeros((LEAF_CHANNELS, f, num_bins, 3), dtype=torch.int64,
                      device=bins_t.device)
    _launch_hist("hist_leaves_fx", bins_t, w.w, ch, out, f, n, num_bins,
                 LEAF_CHANNELS)
    LAUNCHES["hist_leaves"] += 1
    return _fx_to_f32(out, w.inv_scale)


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
