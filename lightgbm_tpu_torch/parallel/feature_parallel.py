"""Feature-parallel tree learner: the features split over the ranks.

Port of ``lightgbm_tpu/parallel/feature_parallel.py`` (reference LightGBM
``FeatureParallelTreeLearner``, feature_parallel_tree_learner.cpp:
features partitioned per machine :40-56, each machine's best split over
its own features, the global best by ``SyncUpGlobalBestSplit``,
parallel_tree_learner.h:191-214, then every machine splits the same
way).

Every rank holds every row and one contiguous block of ``ceil(F / W)``
features (the feature axis padded with 1-bin features, which never
split) on its device.  The learner grows the masked sequential grower
over that block: each split histograms the block's features only, the
per-rank bests are joined by pmax of the gain and pmin of the global
feature (the lowest-feature tie rule, split_info.hpp:280) with the
winner's payload read from its owner, and the winning feature's bin
column, which only its owner holds, goes out from the owner with one
(N,) psum for the partition update.  Every rank sums all rows, so its
histograms are the serial learner's for its features, and the tree is
the serial masked grower's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..dataset import pad_rows
from ..ops.histogram import widen_bins
from ..learner.serial import (CommStrategy, SerialTreeLearner,
                              resolve_monotone_method,
                              split_params_from_config)
from ..utils.log import log_warning
from . import mesh as M
from .data_parallel import DataParallelStrategy, block_exchange, block_scan
from .data_parallel import unpack_candidate

__all__ = ["FeatureParallelTreeLearner", "FeatureParallelStrategy"]


class FeatureParallelStrategy(CommStrategy):
    """Block-local scans joined across ranks, and the owner's column
    broadcast (reference :63-150)."""

    _block = DataParallelStrategy._block
    local_meta = DataParallelStrategy.local_meta

    def __init__(self, mesh: M.Workers, num_features: int):
        self.mesh = mesh
        self.f_local = -(-num_features // mesh.world)
        self.f_pad = self.f_local * mesh.world - num_features

    def leaf_candidates(self, hist, leaf_sum, feature_mask, params,
                        rand_bins=None, bound=None, depth=None,
                        parent_out=None):
        g, f_glob, payload = block_scan(self, hist, leaf_sum, feature_mask,
                                        params, bound, depth, parent_out)
        gmax, f_win, win = block_exchange(
            g, f_glob, payload, self.f_local,
            site="feature_parallel/winner_bcast",
            gain_site="feature_parallel/best_gain",
            feat_site="feature_parallel/best_feature")
        return unpack_candidate(gmax, f_win, win)

    pair_candidates = DataParallelStrategy.pair_candidates

    def get_column(self, X_T, feat):
        """The winning feature's (N,) int32 bin codes: its owner's column,
        broadcast as one psum of zeros elsewhere, as uint8 codes (uint16
        ones widened first: NCCL sums no 16-bit integers)."""
        owner, j = divmod(int(feat), self.f_local)
        col = X_T[j] if X_T.dtype == torch.uint8 else \
            widen_bins(X_T[j]).to(torch.int32)
        if owner != self.mesh.rank:
            col = torch.zeros_like(col)
        return M.psum(col, "feature_parallel/column_bcast").to(torch.int32)


class FeatureParallelTreeLearner(SerialTreeLearner):
    """Host-side feature-parallel learner (reference :152-218): the
    masked grower over this rank's block of features."""

    name = "feature"

    def __init__(self, config: Config, num_features: int, max_bins: int,
                 num_bins: np.ndarray, has_nan: np.ndarray,
                 device: torch.device, is_cat: Optional[np.ndarray] = None,
                 monotone: Optional[np.ndarray] = None):
        if config.use_quantized_grad:
            log_warning("use_quantized_grad is only applied by the wave "
                        "grower (serial / tree_learner=data); training "
                        "with exact gradients")
        self.mesh = M.get_mesh(int(config.num_devices))
        self.ndev = self.mesh.world
        resolve_monotone_method(
            config, split_params_from_config(config, num_bins,
                                             is_cat).use_monotone,
            wave=False)
        self.supports_extras = False
        super().__init__(config, num_features, max_bins, num_bins, has_nan,
                         device, is_cat=is_cat, monotone=monotone,
                         strategy=FeatureParallelStrategy(self.mesh,
                                                          num_features),
                         grow_mode="masked")

    def local_bins(self, train_set, device) -> torch.Tensor:
        """This rank's FEATURE-MAJOR (ceil(F / W), N_pad) block of the bin
        matrix: every row, its own features (trailing pads all zero)."""
        fl = self._strategy.f_local
        lo = self.mesh.rank * fl
        X = train_set.X_binned[:, lo:lo + fl]
        n = X.shape[0]
        xt = np.zeros((fl, pad_rows(n)), X.dtype)
        xt[:X.shape[1], :n] = X.T
        return torch.from_numpy(xt).to(device)
