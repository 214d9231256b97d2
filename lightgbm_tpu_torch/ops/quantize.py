"""Gradient quantization for int8 histogram training.

Port of ``lightgbm_tpu/ops/quantize.py`` (reference:
src/treelearner/gradient_discretizer.cpp DiscretizeGradients): per-tree
linear scales map gradients to signed and hessians to unsigned integer
levels, histograms accumulate exact int32 sums
(ops/histogram_cuda.py ``build_histogram_leaves_q8``), and split gains are
computed on the dequantized sums.

Stochastic rounding (the default) draws its uniforms from the port's
threefry stream (utils/random.py), which is ``jax.random``'s bit for bit,
so the port rounds every row as the reference does.
"""

from __future__ import annotations

import torch

from ..utils.random import fold_in, uniform

__all__ = ["quant_levels", "quantize_wch", "quant_scales",
           "dequant_scales"]


def quant_levels(num_grad_quant_bins: int) -> tuple:
    """(gq_max, hq_max) integer level bounds for a quant-bin count.

    Gradients are symmetric in [-gq_max, gq_max]; hessians (non-negative)
    in [0, hq_max].  Both clamp to the int8 payload range."""
    qb = max(2, int(num_grad_quant_bins))
    return max(1, min(qb // 2, 127)), max(1, min(qb, 127))


def quant_scales(gmax: torch.Tensor, hmax: torch.Tensor, gq_max: int,
                 hq_max: int):
    """Per-tree scales ``max(gmax, 1e-30) / gq_max`` and the same for the
    hessians, as the reference's jitted grower computes them: XLA rewrites
    a division by a constant into a multiply by its f32 reciprocal (an ulp
    away from the quotient at 127 levels), so the port multiplies too, on
    every device."""
    def scale(m, q):
        inv = torch.full((), 1.0, dtype=torch.float32, device=m.device) / q
        return torch.clamp(m, min=1e-30) * inv
    return scale(gmax, gq_max), scale(hmax, hq_max)


def quantize_wch(grad: torch.Tensor, hess: torch.Tensor,
                 bag_mask: torch.Tensor, g_scale: torch.Tensor,
                 h_scale: torch.Tensor, key: torch.Tensor = None, *,
                 gq_max: int, hq_max: int,
                 stochastic: bool = False, own=None) -> torch.Tensor:
    """(8, N) int8 FEATURE-MAJOR weight rows [g_q, h_q, count, 0, ...].

    ``g_scale``/``h_scale`` are the per-tree dequantization scales
    (0-d f32 tensors, g ~= g_q * g_scale).  Stochastic rounding
    ``floor(x + u)`` draws u from ``uniform(fold_in(key, 0), (N,))`` for
    the gradients and ``fold_in(key, 1)`` for the hessians (``key`` the
    tree's threefry key, utils/random.py); ``stochastic=False`` rounds half
    up.  Both are the reference's branches bit for bit.  ``own`` = (rows,
    n_pad) draws as a run over only the rows ``rows`` (padded to n_pad)
    would, each row's draw at its own position (rows outside it have zero
    weight and round to 0 with any draw)."""
    if stochastic and key is None:
        raise ValueError("stochastic rounding draws from a threefry key: "
                         "pass the tree's quant_key")
    n = grad.shape[0]
    gm = (grad * bag_mask) / g_scale
    hm = (hess * bag_mask) / h_scale
    if stochastic:
        m = n if own is None else own[1]
        ug = uniform(fold_in(key, 0), (m,), grad.device)
        uh = uniform(fold_in(key, 1), (m,), grad.device)
        if own is not None:
            rows = own[0]
            ug = torch.zeros_like(gm).index_copy_(0, rows, ug[:len(rows)])
            uh = torch.zeros_like(hm).index_copy_(0, rows, uh[:len(rows)])
    else:
        ug = uh = 0.5
    g_q = torch.clamp(torch.floor(gm + ug), -gq_max, gq_max).to(torch.int8)
    h_q = torch.clamp(torch.floor(hm + uh), 0, hq_max).to(torch.int8)
    out = torch.zeros((8, grad.shape[0]), dtype=torch.int8,
                      device=grad.device)
    out[0] = g_q
    out[1] = h_q
    out[2] = (bag_mask > 0).to(torch.int8)
    return out


def dequant_scales(g_scale: torch.Tensor, h_scale: torch.Tensor
                   ) -> torch.Tensor:
    """(3,) f32 multiplier turning int32 channel sums into f32 sums."""
    return torch.stack([g_scale, h_scale,
                        torch.ones_like(g_scale)]).float()
