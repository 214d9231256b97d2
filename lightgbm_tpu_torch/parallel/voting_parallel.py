"""Voting-parallel tree learner (PV-Tree): data-parallel with top-k voting.

Port of ``lightgbm_tpu/parallel/voting_parallel.py`` (reference LightGBM
``VotingParallelTreeLearner``, voting_parallel_tree_learner.cpp: local
top-k vote, the allgather of the votes :322, ``GlobalVoting`` picking the
global top-2k features :151, the full scan only on the merged features;
local min_data / min_hessian scaled by 1/num_machines :62-63; Meng et
al., "A Communication-Efficient Parallel Algorithm for Decision Tree",
NIPS 2016).

Rows are sharded as in the data-parallel learner (its row layout,
``RowShardedLearner``), but a scan does not merge the whole (F, B, 3)
histogram: each rank votes its top-k features, the votes ride one
all_gather of k feature ids per rank, and only the winning 2k features'
histogram slices are summed, 2k·B instead of F·B per leaf.  The wave
grower carries the voted merge for a batch of leaves (learner/wave.py,
:class:`WaveVotingStrategy`); the masked sequential grower votes per
leaf (:class:`VotingStrategy`) and cannot train quantized.

:func:`modeled_pass_bytes` and :func:`voting_favored` are the
``tree_learner=auto`` rule (reference :197-253), with the reference's
``devices_per_host`` read as ranks per node.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..learner.serial import (CommStrategy, hist_pool_fits,
                              resolve_monotone_method,
                              split_params_from_config)
from ..ops.histogram import fx_to_f32
from ..ops.split import NEG_INF, best_split_per_feature, local_best_candidates
from . import mesh as M
from .data_parallel import RowShardedLearner, WaveDPStrategy

__all__ = ["VotingParallelTreeLearner", "VotingStrategy",
           "WaveVotingStrategy", "QuantizedGradUnsupportedError",
           "modeled_pass_bytes", "voting_favored", "AUTO_VOTING_MIN_WORLD"]

class QuantizedGradUnsupportedError(ValueError):
    """use_quantized_grad requested on a grower that cannot honor it.

    The WAVE voting learner trains quantized for real (int32 voted
    slices sum exactly); only the masked sequential fallback cannot, and
    silently downgrading to exact gradients there would make two
    'identical' configs train different models."""


def modeled_pass_bytes(num_features: int, bins: int, top_k: int,
                       world: int, *, wave: int = 0, itemsize: int = 4,
                       devices_per_host: int = 8) -> dict:
    """Modeled per-pass histogram-merge bytes for the data-parallel
    reduce-scatter path against the voting path at world size ``world``,
    split per node vs across nodes on a node-major rank order with
    ``devices_per_host`` ranks per node (copy of the reference's model,
    so the rule picks the learner the reference picks).

    Reduce-scatter moves the whole (W, F, B, 3) batch once around the
    ring; voting moves the O(k) vote ids plus the (W, 2k, B, 3) selected
    slices, allreduced (2x a reduce-scatter's volume for the slices)."""
    from ..learner.wave import WAVE_SIZE
    w = int(wave) or WAVE_SIZE
    hosts_ = max(1, int(world) // max(1, int(devices_per_host)))
    dcn = (hosts_ - 1) / hosts_ if hosts_ > 1 else 0.0
    two_k = min(2 * int(top_k), int(num_features))
    ch = 3 * int(itemsize) * int(bins) * w
    full = int(num_features) * ch
    voted = two_k * ch
    vote_ids = 4 * w * int(top_k) * int(world)
    rs_total = full
    vote_total = 2 * voted + vote_ids
    return {
        "world": int(world),
        "hosts": hosts_,
        "reduce_scatter": {
            "total": rs_total,
            "cross_host": int(rs_total * dcn),
            "per_host": int(rs_total * (1.0 - dcn)),
        },
        "voting": {
            "total": vote_total,
            "cross_host": int(vote_total * dcn),
            "per_host": int(vote_total * (1.0 - dcn)),
        },
        "voted_full_ratio": voted / full,
    }


#: world size at or above which ``tree_learner=auto`` considers voting
AUTO_VOTING_MIN_WORLD = 4


def voting_favored(num_features: int, bins: int, top_k: int,
                   world: int, **kw) -> bool:
    """The ``tree_learner=auto`` flip rule: voting wins when its modeled
    CROSS-NODE bytes per pass undercut the reduce-scatter path's (PV-Tree
    saves inter-node traffic; within one node the scatter path's exact
    merge is better)."""
    if int(world) < AUTO_VOTING_MIN_WORLD:
        return False
    m = modeled_pass_bytes(num_features, bins, top_k, world, **kw)
    if m["hosts"] > 1:
        return m["voting"]["cross_host"] < m["reduce_scatter"]["cross_host"]
    return m["voting"]["total"] < m["reduce_scatter"]["total"]


class WaveVotingStrategy(WaveDPStrategy):
    """The wave grower's voted merge (reference :272-336): the pool stays
    rank-local and each candidate scan votes, all_gathers O(k) feature
    ids and sums only the voted top-2k feature slices.  Voting-gated
    shapes (categorical features, EFB, lazy CEGB, forced splits) fall
    back to ``reduce_hist``'s full-batch psum."""

    hist_voting = True
    _prefix = "voting_parallel/wave"

    def __init__(self, mesh: M.Workers, rows: int, top_k: int = 20,
                 local_params=None):
        super().__init__(mesh, rows, hist_scatter=False)
        self.top_k = int(top_k)
        self.local_params = local_params

    def vote_allgather(self, top_ids):
        """(k_leaves, top_k) local winner ids -> (world, k_leaves,
        top_k)."""
        return M.all_gather(top_ids, f"{self._prefix}/vote_allgather")

    def reduce_hist_voted(self, sel):
        """The merge of the voted (k_leaves, 2k, B, 3) slices, integer
        sums (int32 quantized, int64 fixed point exact)."""
        return M.psum(sel, f"{self._prefix}/voted_hist_psum")


class VotingStrategy(CommStrategy):
    """The masked grower's per-leaf vote (reference :338-418): local gains
    under the 1/num_machines-relaxed constraints, the top-k ids
    all_gathered, the global top-2k features' int64 slices summed and
    scanned with the full parameters."""

    rows_sharded = True
    scan_merges = True

    def __init__(self, mesh: M.Workers, top_k: int, num_features: int,
                 local_params, rows: int):
        self.mesh = mesh
        self.top_k = int(top_k)
        self.num_features = int(num_features)
        self.local_params = local_params
        self.rows = rows
        self.fx_inv = None

    def fx_rows(self, n: int) -> int:
        from ..dataset import pad_rows
        return pad_rows(self.rows)

    def reduce_sum(self, v):
        return M.psum(v, "voting_parallel/leaf_sum")

    def reduce_max(self, v):
        return M.pmax(v, "voting_parallel/fx_scale")

    def leaf_candidates(self, hist, leaf_sum, feature_mask, params,
                        rand_bins=None, bound=None, depth=None,
                        parent_out=None):
        F = self.num_features
        dev = hist.device
        mono = self.monotone_full

        def one(t):
            return None if t is None else t.unsqueeze(0)
        # 1. local gains, relaxed constraints (:62-63)
        local = best_split_per_feature(
            fx_to_f32(hist, self.fx_inv).unsqueeze(0),
            (leaf_sum / self.mesh.world).unsqueeze(0), self.num_bins_full,
            self.has_nan_full, self.local_params, is_cat=self.is_cat_full,
            monotone=mono, bound=one(bound), depth=one(depth),
            parent_out=one(parent_out))
        gain = torch.where(feature_mask, local.gain[0],
                           torch.full((), NEG_INF, device=dev))
        k = min(self.top_k, F)
        top = torch.sort(gain, descending=True, stable=True)[1][:k]
        # 2. the vote allgather (:322) and GlobalVoting (:151); ties go
        #    to the lower feature through a small index epsilon
        all_ids = M.all_gather(top.to(torch.int32),
                               "voting_parallel/vote_allgather")
        votes = torch.zeros((F,), dtype=torch.float32, device=dev)
        votes.scatter_add_(0, all_ids.reshape(-1).long(),
                           torch.ones(all_ids.numel(), device=dev))
        anti = -torch.arange(F, dtype=torch.float32, device=dev) * 1e-6
        sel = torch.sort(votes + anti, descending=True,
                         stable=True)[1][:min(2 * k, F)]
        # 3. merge only the selected features' slices
        merged = fx_to_f32(M.psum(hist.index_select(0, sel),
                                  "voting_parallel/voted_hist_psum"),
                           self.fx_inv)
        sel_h = sel.tolist()
        cats = tuple(i for i, j in enumerate(sel_h) if j in params.cat_idx)
        sp = params._replace(cat_idx=cats, any_cat=bool(cats)) \
            if params.any_cat else params
        g, f, b, dl, ls, rs, member = (o[0] for o in local_best_candidates(
            merged.unsqueeze(0), leaf_sum.unsqueeze(0),
            self.num_bins_full[sel], self.has_nan_full[sel],
            feature_mask[sel].unsqueeze(0), sp,
            is_cat=self.is_cat_full[sel] if sp.any_cat else None,
            monotone=None if mono is None else mono[sel], bound=one(bound),
            depth=one(depth), parent_out=one(parent_out)))
        return (g, sel[f.long()].to(torch.int32), b, dl, ls, rs, member)

    def pair_candidates(self, hist_l, hist_r, lsum, rsum, feature_mask,
                        params, rand_bins=None, bounds=None, depth=None,
                        parent_outs=None):
        """Two sequential votes (their collectives are not batched)."""
        out = []
        for i, (h, s) in enumerate(((hist_l, lsum), (hist_r, rsum))):
            out.append(self.leaf_candidates(
                h, s, feature_mask, params,
                bound=None if bounds is None else bounds[i], depth=depth,
                parent_out=None if parent_outs is None else parent_outs[i]))
        return out[0], out[1]


class VotingParallelTreeLearner(RowShardedLearner):
    """Two growers, as the reference's (:420-594): the WAVE grower with
    the voted merge (quantized gradients, the exact endgame and the
    speculative ramp included) and the masked sequential grower with a
    vote per leaf, which cannot train quantized: that combination raises
    :class:`QuantizedGradUnsupportedError`."""

    name = "voting"
    _gather_site = "voting_parallel/row_leaf_gather"

    def __init__(self, config: Config, num_features: int, max_bins: int,
                 num_bins: np.ndarray, has_nan: np.ndarray,
                 device: torch.device, is_cat: Optional[np.ndarray] = None,
                 monotone: Optional[np.ndarray] = None, *, num_data: int,
                 block: Optional[int] = None):
        mesh = M.get_mesh(int(config.num_devices))
        self.top_k = max(1, min(int(config.top_k), num_features))
        sp = split_params_from_config(config, num_bins, is_cat)
        local_sp = sp._replace(
            min_data_in_leaf=max(1, sp.min_data_in_leaf // mesh.world),
            min_sum_hessian_in_leaf=sp.min_sum_hessian_in_leaf / mesh.world)
        mode = str(config.tree_grow_mode)
        wave_able = (int(config.num_leaves) > 2 and
                     hist_pool_fits(config, num_features, int(max_bins)))
        self.wave = wave_able and (mode == "wave" or
                                   (mode == "auto" and max_bins <= 256))
        if not self.wave and config.use_quantized_grad and wave_able \
                and mode != "partition":
            # quantized voting is a wave-grower feature: ride it rather
            # than refuse when the config merely defaulted off it
            self.wave = True
        if self.wave:
            strategy = WaveVotingStrategy(mesh, num_data, top_k=self.top_k,
                                          local_params=local_sp)
        else:
            if config.use_quantized_grad:
                raise QuantizedGradUnsupportedError(
                    "use_quantized_grad with tree_learner=voting requires "
                    "the wave grower (tree_grow_mode=wave, or auto on TPU); "
                    "the masked voting grower trains exact gradients only "
                    "— drop use_quantized_grad or enable the wave grower")
            resolve_monotone_method(config, sp.use_monotone, wave=False)
            strategy = VotingStrategy(mesh, self.top_k, num_features,
                                      local_sp, num_data)
        self.supports_extras = self.wave
        super().__init__(config, num_features, max_bins, num_bins, has_nan,
                         device, is_cat=is_cat, monotone=monotone,
                         strategy=strategy,
                         grow_mode="wave" if self.wave else "masked")
        self._init_rows(mesh, num_data, block)
