"""Serial (single-device) tree learner: the wave grower's host wrapper.

Port of ``lightgbm_tpu/learner/serial.py`` for the branch the main path
takes: ``GrownTree``, ``resolve_hist_impl``, ``split_params_from_config``
and the wave branch of ``SerialTreeLearner`` (reference serial.py:750-831).
The partitioned and masked growers, the parallel strategies and the
autotuner are later slices (ROADMAP queue 1, items 7 and 12).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.split import SplitParams

__all__ = ["SerialTreeLearner", "GrownTree", "resolve_hist_impl",
           "split_params_from_config"]


class GrownTree(NamedTuple):
    """Result of growing one tree (tensors on the training device)."""
    split_feature: torch.Tensor     # (L-1,) int32 (inner feature indices)
    threshold_bin: torch.Tensor     # (L-1,) int32
    nan_bin: torch.Tensor           # (L-1,) int32
    decision_type: torch.Tensor     # (L-1,) int32
    left_child: torch.Tensor        # (L-1,) int32
    right_child: torch.Tensor       # (L-1,) int32
    split_gain: torch.Tensor        # (L-1,) float32
    internal_value: torch.Tensor    # (L-1,) float32
    internal_weight: torch.Tensor   # (L-1,) float32
    internal_count: torch.Tensor    # (L-1,) float32
    leaf_value: torch.Tensor        # (L,) float32
    leaf_weight: torch.Tensor       # (L,) float32
    leaf_count: torch.Tensor        # (L,) float32
    num_leaves: int                 # leaves actually grown
    row_leaf: torch.Tensor          # (N,) int32 final leaf of every row
    hist_passes: int                # full-data histogram passes


def resolve_hist_impl(config: Config, device: torch.device) -> str:
    """Pick the histogram implementation: ``auto`` (and the reference's
    ``pallas``) resolve to the hand-written CUDA kernels on a ``cuda``
    device and to their plain PyTorch versions on the CPU.  The wrappers
    dispatch on the tensors' device, so the name only records what ran."""
    impl = str(config.tpu_histogram_impl)
    if impl not in ("auto", "pallas"):
        raise NotImplementedError(
            f"tpu_histogram_impl={impl!r} selects an XLA formulation of the "
            "reference; lightgbm_tpu_torch has the CUDA kernels and their "
            "plain versions only (ROADMAP queue 1, item 7: autotune)")
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def split_params_from_config(config: Config,
                             is_cat: Optional[np.ndarray] = None
                             ) -> SplitParams:
    mc = config.monotone_constraints or []
    use_cegb = bool(config.cegb_penalty_split > 0.0 or
                    config.cegb_penalty_feature_coupled or
                    config.cegb_penalty_feature_lazy)
    return SplitParams(
        lambda_l1=float(config.lambda_l1),
        lambda_l2=float(config.lambda_l2),
        min_data_in_leaf=int(config.min_data_in_leaf),
        min_sum_hessian_in_leaf=float(config.min_sum_hessian_in_leaf),
        min_gain_to_split=float(config.min_gain_to_split),
        max_delta_step=float(config.max_delta_step),
        cat_l2=float(config.cat_l2),
        cat_smooth=float(config.cat_smooth),
        path_smooth=float(config.path_smooth),
        use_monotone=any(int(v) != 0 for v in mc),
        monotone_penalty=float(config.monotone_penalty),
        max_cat_to_onehot=int(config.max_cat_to_onehot),
        max_cat_threshold=int(config.max_cat_threshold),
        min_data_per_group=int(config.min_data_per_group),
        use_cegb=use_cegb,
        cegb_tradeoff=float(config.cegb_tradeoff),
        cegb_penalty_split=float(config.cegb_penalty_split),
        feature_fraction_bynode=float(config.feature_fraction_bynode),
        extra_trees=bool(config.extra_trees),
        any_cat=bool(is_cat is not None and np.any(np.asarray(is_cat))))


def _check_wave_config(config: Config) -> None:
    """Raise for configurations the port's wave grower does not carry."""
    unported = [
        ("tree_grow_mode=partition (the partitioned grower)",
         str(config.tree_grow_mode) == "partition"),
        ("forcedsplits_filename", bool(config.forcedsplits_filename)),
        ("interaction_constraints", bool(config.interaction_constraints)),
        ("feature_contri", bool(config.feature_contri)),
        ("quant_train_renew_leaf", bool(config.use_quantized_grad) and
         bool(config.quant_train_renew_leaf)),
        ("stochastic_rounding=true", bool(config.use_quantized_grad) and
         bool(config.stochastic_rounding)),
    ]
    for what, on in unported:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to lightgbm_tpu_torch yet "
                "(ROADMAP queue 1)")


class SerialTreeLearner:
    """Host-side wrapper owning the wave grower and the dataset's static
    feature descriptors (reference tree_learner.h:27 ``TreeLearner``)."""

    def __init__(self, config: Config, num_features: int, max_bins: int,
                 num_bins: np.ndarray, has_nan: np.ndarray,
                 device: torch.device):
        if int(config.num_leaves) <= 2:
            raise NotImplementedError(
                "num_leaves <= 2 takes the partitioned grower in the "
                "reference, which is not ported yet (ROADMAP queue 1, "
                "item 7)")
        _check_wave_config(config)
        self.config = config
        self.device = torch.device(device)
        self.max_bins = int(max_bins)
        self.num_features = num_features
        self.num_bins = torch.as_tensor(num_bins, dtype=torch.int32,
                                        device=self.device)
        self.has_nan = torch.as_tensor(has_nan, dtype=torch.bool,
                                       device=self.device)
        self.split_params = split_params_from_config(config)
        self.hist_impl = resolve_hist_impl(config, self.device)
        self.grow_mode = "wave"
        self.quantized = bool(config.use_quantized_grad)
        # 4-bit packed bins are a layout only; the port keeps uint8 bins
        self.pack4 = False
        from ..ops.quantize import quant_levels
        gq_max, hq_max = quant_levels(int(config.num_grad_quant_bins))
        from .wave import make_wave_grow_fn
        self._grow = make_wave_grow_fn(
            num_leaves=int(config.num_leaves), num_features=num_features,
            max_bins=self.max_bins, max_depth=int(config.max_depth),
            split_params=self.split_params,
            wave_size=int(config.tpu_wave_size), quantized=self.quantized,
            gq_max=gq_max, hq_max=hq_max,
            stochastic=bool(config.stochastic_rounding),
            spec_ramp=bool(config.tpu_speculative_ramp),
            spec_tol=float(config.tpu_spec_tolerance),
            exact_endgame=bool(config.tpu_exact_endgame),
            renew_leaf=bool(config.quant_train_renew_leaf))

    def train(self, X_T: torch.Tensor, grad: torch.Tensor,
              hess: torch.Tensor, sample_mask: torch.Tensor,
              feature_mask: Optional[torch.Tensor] = None) -> GrownTree:
        """Grow one tree.  ``X_T`` is the dataset's padded feature-major
        bin matrix (dataset.py ``device_bins``); the per-row vectors carry
        the N real rows and are zero-padded here (padded rows are out of
        the bag and contribute nothing)."""
        n = grad.shape[0]
        pad = X_T.shape[1] - n
        if feature_mask is None:
            feature_mask = torch.ones((self.num_features,), dtype=torch.bool,
                                      device=self.device)
        if pad:
            grad = torch.nn.functional.pad(grad, (0, pad))
            hess = torch.nn.functional.pad(hess, (0, pad))
            sample_mask = torch.nn.functional.pad(sample_mask, (0, pad))
        grown = self._grow(X_T, grad, hess, sample_mask, self.num_bins,
                           self.has_nan, feature_mask)
        if pad:
            grown = grown._replace(row_leaf=grown.row_leaf[:n])
        return grown
