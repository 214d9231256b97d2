"""Gradient quantization for int8 histogram training.

Port of ``lightgbm_tpu/ops/quantize.py`` (reference:
src/treelearner/gradient_discretizer.cpp DiscretizeGradients): per-tree
linear scales map gradients to signed and hessians to unsigned integer
levels, histograms accumulate exact int32 sums
(ops/histogram_cuda.py ``build_histogram_leaves_q8``), and split gains are
computed on the dequantized sums.

Only deterministic rounding (``stochastic=False``, round-half-up) is
ported.  Stochastic rounding draws from ``jax.random`` in the reference;
until the port has a bit-exact threefry (ROADMAP queue 1, item 2) it
raises rather than drawing different bits.
"""

from __future__ import annotations

import torch

__all__ = ["quant_levels", "quantize_wch", "dequant_scales"]


def quant_levels(num_grad_quant_bins: int) -> tuple:
    """(gq_max, hq_max) integer level bounds for a quant-bin count.

    Gradients are symmetric in [-gq_max, gq_max]; hessians (non-negative)
    in [0, hq_max].  Both clamp to the int8 payload range."""
    qb = max(2, int(num_grad_quant_bins))
    return max(1, min(qb // 2, 127)), max(1, min(qb, 127))


def quantize_wch(grad: torch.Tensor, hess: torch.Tensor,
                 bag_mask: torch.Tensor, g_scale: torch.Tensor,
                 h_scale: torch.Tensor, *, gq_max: int, hq_max: int,
                 stochastic: bool = False) -> torch.Tensor:
    """(8, N) int8 FEATURE-MAJOR weight rows [g_q, h_q, count, 0, ...].

    ``g_scale``/``h_scale`` are the per-tree dequantization scales
    (0-d f32 tensors, g ~= g_q * g_scale).  Round-half-up:
    ``floor(x + 0.5)``, the reference's ``stochastic=False`` branch, bit
    for bit."""
    if stochastic:
        raise NotImplementedError(
            "stochastic_rounding=true needs the reference's jax.random "
            "threefry stream, which lightgbm_tpu_torch does not reproduce "
            "yet (ROADMAP queue 1, item 2); set stochastic_rounding=false")
    gm = (grad * bag_mask) / g_scale
    hm = (hess * bag_mask) / h_scale
    g_q = torch.clamp(torch.floor(gm + 0.5), -gq_max, gq_max).to(torch.int8)
    h_q = torch.clamp(torch.floor(hm + 0.5), 0, hq_max).to(torch.int8)
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
