"""Plain PyTorch histograms: the portable counterparts of the CUDA kernels.

Port of ``lightgbm_tpu/ops/histogram.py``'s leaf-channel form
(``build_histogram_leaves``, the ``segment`` scatter-add) and
``histogram_subtract`` (reference serial_tree_learner.cpp:311-320).  These
are the plain versions the kernel wrappers in ops/histogram_cuda.py fall
back to for CPU tensors, and what ``chip_smoke.py`` holds each kernel
against on the card.

Layout: bins arrive FEATURE-MAJOR ``(F, N)`` (the kernels' layout) and
histograms are ``(K, F, B, 3)`` with channels (sum_grad, sum_hess, count).
"""

from __future__ import annotations

import torch

__all__ = ["build_histogram_leaves", "histogram_subtract"]


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
    f, n = bins_t.shape
    rows = torch.nonzero((ch >= 0) & (ch < k)).squeeze(1)
    out = torch.zeros((k * f * num_bins, 3), dtype=acc_dtype,
                      device=bins_t.device)
    if rows.numel() == 0:
        return out.reshape(k, f, num_bins, 3)
    c = ch[rows].long()
    b = bins_t[:, rows].long()                                 # (F, M)
    fidx = torch.arange(f, device=bins_t.device).unsqueeze(1)
    idx = (c.unsqueeze(0) * f + fidx) * num_bins + b           # (F, M)
    w = w3[:3, rows].to(acc_dtype).t()                         # (M, 3)
    upd = w.unsqueeze(0).expand(f, -1, -1).reshape(-1, 3)
    ok = (b < num_bins).reshape(-1)
    if not bool(ok.all()):
        idx, upd = idx.reshape(-1)[ok], upd[ok]
    out.index_add_(0, idx.reshape(-1), upd)
    return out.reshape(k, f, num_bins, 3)


def histogram_subtract(parent: torch.Tensor,
                       child: torch.Tensor) -> torch.Tensor:
    """The histogram subtraction trick: sibling = parent - child
    (reference serial_tree_learner.cpp:311-320)."""
    return parent - child
