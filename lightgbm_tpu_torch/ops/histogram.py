"""Plain PyTorch histograms: the portable counterparts of the CUDA kernels.

Port of ``lightgbm_tpu/ops/histogram.py``: the single-leaf
``build_histogram`` (:134, under the contract of
``build_histogram_pallas``, histogram_pallas.py:471-494), the leaf-channel
form (``build_histogram_leaves``, the ``segment`` scatter-add) and
``histogram_subtract`` (reference serial_tree_learner.cpp:311-320), and
the nibble-packed bin layout of ``histogram_pallas.py`` (``PACK4_MAX_BINS``,
``pack_bins4``, ``unpack_bins4``, :81 and :143-161).  These
are the plain versions the kernel wrappers in ops/histogram_cuda.py take
for CPU tensors, and what ``chip_smoke.py`` holds each kernel against on
the card.

Layout: bins arrive FEATURE-MAJOR ``(F, N)`` (the kernels' layout; any
strides) and histograms are ``(F, B, 3)`` or ``(K, F, B, 3)`` with
channels (sum_grad, sum_hess, count).

Exact-mode weights.  The reference carries g*mask and h*mask as bf16
hi+lo pairs into an f32 MXU contraction.  The port carries them as 64-bit
fixed point with one power-of-two scale per channel per tree
(:func:`pack_weights`) and sums integers, which makes the histogram
independent of summation order: a kernel and its plain version agree bit
for bit and every run grows the same tree.  The scale leaves 2^61 of
headroom for N x max|w|, so each weight keeps about 2^-37 of max|w| of
absolute precision at 2^24 rows.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["FxWeights", "pack_weights", "fx_to_f32", "build_histogram",
           "scatter_histogram", "build_histogram_leaves",
           "build_histogram_leaves_lanes", "scatter_histogram_lanes",
           "histogram_subtract", "PACK4_MAX_BINS", "pack_bins4",
           "unpack_bins4", "MAX_BINS_U16", "widen_bins", "take_rows"]

_FX_HEADROOM_BITS = 61

# 4-bit bin packing (reference src/io/dense_bin.hpp 4-bit dense bins): two
# bin codes per byte, applicable when every feature fits a nibble
PACK4_MAX_BINS = 16

# uint16 bin codes (max_bin > 255; reference binning.py bin_matrix): the
# most bins a feature may have
MAX_BINS_U16 = 1 << 16


def widen_bins(bins: torch.Tensor) -> torch.Tensor:
    """uint16 bin codes as int32 (PyTorch's CPU and CUDA comparison,
    gather and scatter ops do not take uint16: the codes go through an
    int16 view, whose copy every device has); any other dtype is returned
    as it is."""
    if bins.dtype == torch.uint16:
        return bins.view(torch.int16).to(torch.int32) & 0xFFFF
    return bins


def take_rows(t: torch.Tensor, idx: torch.Tensor, dim: int = 0
              ) -> torch.Tensor:
    """``t.index_select(dim, idx)`` for any bin dtype (uint16 through an
    int16 view: the same bits, an op every device has)."""
    if t.dtype == torch.uint16:
        return t.view(torch.int16).index_select(dim, idx).view(torch.uint16)
    return t.index_select(dim, idx)


def pack_bins4(bins_t: torch.Tensor) -> torch.Tensor:
    """(F, N) uint8 bin codes (all < 16) -> (F, N/2) nibble-packed bytes.

    Row 2j lives in the LOW nibble of byte j, row 2j+1 in the HIGH nibble
    (the reference's 4-bit dense_bin layout along the row axis).  N must be
    even; the padded row blocks always are."""
    if bins_t.shape[-1] % 2:
        raise ValueError(f"pack_bins4 needs an even row count, got "
                         f"{bins_t.shape[-1]}")
    lo = bins_t[..., 0::2]
    hi = bins_t[..., 1::2]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_bins4(packed: torch.Tensor) -> torch.Tensor:
    """(..., N/2) packed bytes -> (..., N) interleaved bin codes."""
    lo = packed & 0xF
    hi = packed >> 4
    return torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], packed.shape[-1] * 2)


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


def fx_to_f32(h: torch.Tensor, inv_scale: torch.Tensor) -> torch.Tensor:
    """int64 fixed-point sums (..., 3) -> f32 values; ``inv_scale`` (3,),
    or (L, 3) for the (L, ..., 3) sums of L lanes, each lane scaled by
    its own tree's scale."""
    if inv_scale.dim() == 2:
        inv_scale = inv_scale.reshape(inv_scale.shape[0],
                                      *([1] * (h.dim() - 2)), 3)
    return (h.double() * inv_scale).float()


def scatter_histogram(bins_t: torch.Tensor, w3: torch.Tensor, *,
                      num_bins: int, acc_dtype: torch.dtype) -> torch.Tensor:
    """(F, B, 3) scatter-add of every row's three weights (the first three
    rows of ``w3``) into its bin, one ``index_add_`` per feature.  Bin
    codes at or above ``num_bins`` are ignored, as the kernels ignore
    them.  ``bins_t`` may be any strided (F, N) view."""
    f, _ = bins_t.shape
    out = torch.zeros((f, num_bins, 3), dtype=acc_dtype,
                      device=bins_t.device)
    active = w3[:3].any(dim=0)
    if not bool(active.all()):
        # rows whose three weights are zero add nothing: leave them out
        # (a masked leaf's pass carries mostly such rows)
        rows = active.nonzero().squeeze(1)
        bins_t, w3 = bins_t[:, rows], w3[:, rows]
    w = w3[:3].to(acc_dtype).t()                                # (N, 3)
    for j in range(f):
        b = bins_t[j].long()
        ok = b < num_bins
        if bool(ok.all()):
            out[j].index_add_(0, b, w)
        else:
            out[j].index_add_(0, b[ok], w[ok])
    return out


def build_histogram(bins_t: torch.Tensor, grad: torch.Tensor,
                    hess: torch.Tensor, mask: torch.Tensor, *,
                    num_bins: int) -> torch.Tensor:
    """(F, B, 3) f32 histogram of one leaf: (sum g*mask, sum h*mask,
    count of rows with mask > 0).

    An int64 ``index_add_`` over the fixed-point weights of
    :func:`pack_weights`, scaled back to f32: the same integers the CUDA
    kernel sums, so the two agree bit for bit."""
    w = pack_weights(grad, hess, mask)
    return fx_to_f32(scatter_histogram(bins_t, w.w, num_bins=num_bins,
                                       acc_dtype=torch.int64), w.inv_scale)


def build_histogram_leaves(bins_t: torch.Tensor, w3: torch.Tensor,
                           ch: torch.Tensor, *, num_channels: int,
                           num_bins: int,
                           acc_dtype: torch.dtype) -> torch.Tensor:
    """(K, F, B, 3) scatter-add of per-row weights into leaf channels.

    ``w3`` holds the three per-row weight channels as its first three rows;
    rows whose channel ``ch`` lies outside [0, K) contribute nothing.
    Bin codes at or above ``num_bins`` are ignored, as the kernels ignore
    them.  Accumulates in ``acc_dtype`` with ``index_add_`` over a
    flattened (channel, feature, bin) index."""
    k = num_channels
    rows = torch.nonzero((ch >= 0) & (ch < k)).squeeze(1)
    return _scatter_channels(bins_t[:, rows], ch[rows].long(), w3[:3, rows],
                             num_channels=k, num_bins=num_bins,
                             acc_dtype=acc_dtype)


def _scatter_channels(b: torch.Tensor, c: torch.Tensor, w3: torch.Tensor, *,
                      num_channels: int, num_bins: int,
                      acc_dtype: torch.dtype) -> torch.Tensor:
    """(K, F, B, 3) from M rows: ``b`` (F, M) bins, ``c`` (M,) channels in
    [0, K), ``w3`` (3, M) weights; one ``index_add_`` over a flattened
    (channel, feature, bin) index, bins at or above ``num_bins``
    ignored."""
    k = num_channels
    f = b.shape[0]
    out = torch.zeros((k * f * num_bins, 3), dtype=acc_dtype,
                      device=b.device)
    if c.numel() == 0:
        return out.reshape(k, f, num_bins, 3)
    b = b.long()
    fidx = torch.arange(f, device=b.device).unsqueeze(1)
    idx = (c.unsqueeze(0) * f + fidx) * num_bins + b           # (F, M)
    w = w3.to(acc_dtype).t()                                   # (M, 3)
    upd = w.unsqueeze(0).expand(f, -1, -1).reshape(-1, 3)
    ok = (b < num_bins).reshape(-1)
    if not bool(ok.all()):
        idx, upd = idx.reshape(-1)[ok], upd[ok]
    out.index_add_(0, idx.reshape(-1), upd)
    return out.reshape(k, f, num_bins, 3)


def build_histogram_leaves_lanes(bins_t: torch.Tensor, w3s, chs, *,
                                 num_channels: int, num_bins: int,
                                 acc_dtype: torch.dtype) -> torch.Tensor:
    """(L, K, F, B, 3): :func:`build_histogram_leaves` of L lanes over the
    shared ``bins_t``, lane l with its own weights ``w3s[l]`` and channels
    ``chs[l]``; one ``index_add_`` with the lane folded into the channel
    index (lane * K + channel)."""
    k = num_channels
    bs, cs, ws = [], [], []
    for lane, (w3, ch) in enumerate(zip(w3s, chs)):
        rows = torch.nonzero((ch >= 0) & (ch < k)).squeeze(1)
        bs.append(bins_t[:, rows])
        cs.append(ch[rows].long() + lane * k)
        ws.append(w3[:3, rows])
    lanes = len(cs)
    h = _scatter_channels(torch.cat(bs, dim=1), torch.cat(cs),
                          torch.cat(ws, dim=1), num_channels=lanes * k,
                          num_bins=num_bins, acc_dtype=acc_dtype)
    return h.reshape(lanes, k, *h.shape[1:])


def scatter_histogram_lanes(bins, w3s, *, num_bins: int,
                            acc_dtype: torch.dtype) -> torch.Tensor:
    """(L, F, B, 3): :func:`scatter_histogram` of L lanes, lane l's rows
    the (F, n_l) view ``bins[l]`` with weights ``w3s[l]`` (3, n_l); one
    ``index_add_`` with the lane as the channel index."""
    bs, cs, ws = [], [], []
    for lane, (b, w3) in enumerate(zip(bins, w3s)):
        rows = w3[:3].any(dim=0).nonzero().squeeze(1)
        bs.append(b[:, rows])
        cs.append(torch.full((rows.numel(),), lane, dtype=torch.long,
                             device=b.device))
        ws.append(w3[:3, rows])
    return _scatter_channels(torch.cat(bs, dim=1), torch.cat(cs),
                             torch.cat(ws, dim=1), num_channels=len(cs),
                             num_bins=num_bins, acc_dtype=acc_dtype)


def histogram_subtract(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """The histogram subtraction trick: sibling = parent - child
    (reference serial_tree_learner.cpp:311-320)."""
    return parent - child
