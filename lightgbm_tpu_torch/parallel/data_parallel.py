"""Data-parallel tree learner: rows sharded over the ranks.

Port of ``lightgbm_tpu/parallel/data_parallel.py`` (reference LightGBM
``DataParallelTreeLearner``, data_parallel_tree_learner.cpp: rows
partitioned across machines, local histograms reduce-scattered so each
machine scans one feature block :155-173, the best split agreed by an
allreduce-max :244).

Layout.  Rank r of W holds the contiguous block of global rows
``[r * block, (r + 1) * block)``: ``block`` is the reference's shard,
the row count padded to W x 4096 and divided by W (reference :488-520),
or, under ``pre_partition``, the ranks' common padded shard length
(dataset.py).  Only that block of the binned matrix goes to the rank's
device (:meth:`local_bins`).  Everything else is the same on every rank:
each rank holds the (N,) scores, labels and gradients of every row and
computes them identically, so metrics, early stopping and the score
update see all rows as the reference's global arrays do.  The learner
cuts its block of the gradients, grows the tree over it, and gathers the
ranks' ``row_leaf`` blocks once per tree (one all_gather) into the (N,)
vector the score update reads.

Two growers, as the reference's: the wave grower under
:class:`WaveDPStrategy` (one histogram merge per wave, the psum or the
feature-sliced reduce-scatter, ``tpu_dp_hist_scatter``), and the masked
sequential grower under :class:`DataParallelStrategy` (each leaf's local
histogram reduce-scattered over feature blocks, the per-block winners
joined by pmax / pmin and the winner's payload).  Exact histograms merge
as int64 fixed-point sums on one global scale, so the data-parallel tree
is the serial learner's bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..dataset import ROW_BLOCK, pad_rows
from ..learner.serial import (CommStrategy, GrownTree, SerialTreeLearner,
                              hist_pool_fits, resolve_monotone_method,
                              split_params_from_config)
from ..ops.histogram import fx_to_f32
from ..ops.split import local_best_candidates
from ..utils.log import log_warning
from ..utils.random import fold_in
from . import mesh as M

__all__ = ["DataParallelTreeLearner", "DataParallelStrategy",
           "WaveDPStrategy", "RowShardedLearner", "BIG_FEAT"]

BIG_FEAT = 2 ** 30


def block_exchange(g, f_glob, payload, f_block: int, *, site: str,
                   gain_site: str, feat_site: str):
    """Join per-rank best candidates of k leaves over feature blocks of
    ``f_block`` features, rank r owning block r (the SplitInfo
    allreduce-max, data_parallel_tree_learner.cpp:244): pmax of the
    gain, pmin of the global feature among the ranks that reach it (the
    full scan's lowest-feature tie rule), then the owner's (k, P) payload
    read from one all_gather, bit for bit (the reference psums it with
    zeros elsewhere, which loses the sign of a zero).  Returns (gain,
    feature, payload)."""
    gmax = M.pmax(g, gain_site)
    f_win = M.pmin(torch.where(g >= gmax, f_glob,
                               torch.full_like(f_glob, BIG_FEAT)), feat_site)
    allp = M.all_gather(payload, site)                     # (W, k, P)
    win = allp[(f_win // f_block).long(),
               torch.arange(g.shape[0], device=g.device)]
    return gmax, f_win, win


def block_scan(strat, blk, leaf_sum, feature_mask, params, bound, depth,
               parent_out):
    """One leaf's best split over this rank's feature block ``blk``
    (f_local, B, 3) f32 (the masked growers' sliced scan): the block's
    descriptors sliced to match, the categorical subset search's feature
    list moved into the block.  Returns (1,)-shaped gain and global
    feature, and the (1, 8 + B) payload: bin, default_left, left and
    right sums, categorical LEFT bins (bin codes < 2^24 are exact in
    f32)."""
    s = strat.mesh.rank * strat.f_local
    if params.any_cat:
        cats = tuple(j - s for j in params.cat_idx
                     if s <= j < s + strat.f_local)
        params = params._replace(cat_idx=cats, any_cat=bool(cats))

    def one(t):
        return None if t is None else t.unsqueeze(0)
    nb, hn, ic, fm = strat.local_meta(feature_mask)
    g, f, b, dl, ls, rs, member = local_best_candidates(
        blk.unsqueeze(0), leaf_sum.unsqueeze(0), nb, hn, fm.unsqueeze(0),
        params, is_cat=ic if params.any_cat else None,
        monotone=strat._block(strat.monotone_full, 0), bound=one(bound),
        depth=one(depth), parent_out=one(parent_out))
    payload = torch.cat([b.to(torch.float32).unsqueeze(-1),
                         dl.to(torch.float32).unsqueeze(-1), ls, rs,
                         member.to(torch.float32)], -1)
    return g, (f + s).to(torch.int32), payload


def unpack_candidate(gmax, f_win, win):
    """The scalar candidate tuple of one leaf from :func:`block_exchange`'s
    (1,)-shaped results."""
    w = win[0]
    return (gmax[0], f_win[0], w[0].to(torch.int32), w[1] > 0, w[2:5],
            w[5:8], w[8:] > 0)


class DataParallelStrategy(CommStrategy):
    """The masked grower's strategy (reference :120-196): local
    histograms, reduce-scattered per candidate scan over feature blocks
    (the int64 sums, then f32), each rank scanning its block, the winners
    joined by :func:`block_exchange`."""

    rows_sharded = True
    scan_merges = True

    def __init__(self, mesh: M.Workers, num_features: int, rows: int):
        self.mesh = mesh
        self.f_local = -(-num_features // mesh.world)
        self.f_pad = self.f_local * mesh.world - num_features
        self.rows = rows
        self.fx_inv = None

    def fx_rows(self, n: int) -> int:
        return pad_rows(self.rows)

    def reduce_sum(self, v):
        return M.psum(v, "data_parallel/masked/leaf_sum")

    def reduce_max(self, v):
        return M.pmax(v, "data_parallel/masked/fx_scale")

    def _block(self, a, fill):
        if a is None:
            return None
        if self.f_pad:
            a = torch.cat([a, torch.full(a.shape[:-1] + (self.f_pad,), fill,
                                         dtype=a.dtype, device=a.device)],
                          -1)
        s = self.mesh.rank * self.f_local
        return a[..., s:s + self.f_local]

    def local_meta(self, feature_mask):
        """This rank's block of the per-feature descriptors (padded
        features: 1 bin, never split)."""
        return (self._block(self.num_bins_full, 1),
                self._block(self.has_nan_full, False),
                self._block(self.is_cat_full, False),
                self._block(feature_mask, False))

    def leaf_candidates(self, hist, leaf_sum, feature_mask, params,
                        rand_bins=None, bound=None, depth=None,
                        parent_out=None):
        h = hist
        if self.f_pad:
            h = torch.nn.functional.pad(h, (0, 0, 0, 0, 0, self.f_pad))
        blk = fx_to_f32(M.psum_scatter(
            h, "data_parallel/masked/hist_reduce_scatter", dim=0),
            self.fx_inv)
        g, f_glob, payload = block_scan(self, blk, leaf_sum, feature_mask,
                                        params, bound, depth, parent_out)
        gmax, f_win, win = block_exchange(
            g, f_glob, payload, self.f_local,
            site="data_parallel/masked/winner_bcast",
            gain_site="data_parallel/masked/best_gain",
            feat_site="data_parallel/masked/best_feature")
        return unpack_candidate(gmax, f_win, win)

    def pair_candidates(self, hist_l, hist_r, lsum, rsum, feature_mask,
                        params, rand_bins=None, bounds=None, depth=None,
                        parent_outs=None):
        """Two sequential scans (their collectives are not batched)."""
        out = []
        for i, (h, s) in enumerate(((hist_l, lsum), (hist_r, rsum))):
            out.append(self.leaf_candidates(
                h, s, feature_mask, params,
                bound=None if bounds is None else bounds[i], depth=depth,
                parent_out=None if parent_outs is None else parent_outs[i]))
        return out[0], out[1]


class WaveDPStrategy(CommStrategy):
    """The wave grower's row-sharded strategy (reference :199-290): ONE
    histogram merge per wave, the full-batch psum or, under
    ``hist_scatter``, the feature-sliced reduce-scatter with the O(W·k)
    winner exchange (learner/wave.py).  ``spec_ok``: the speculative
    ramp's provisional passes merge like committed waves."""

    rows_sharded = True
    spec_ok = True
    _prefix = "data_parallel/wave"

    def __init__(self, mesh: M.Workers, rows: int,
                 hist_scatter: bool = False):
        self.mesh = mesh
        self.rank = mesh.rank
        self.nshards = mesh.world
        self.hist_scatter = bool(hist_scatter)
        self.rows = rows

    def fx_rows(self, n: int) -> int:
        return pad_rows(self.rows)

    def reduce_sum(self, v):
        return M.psum(v, f"{self._prefix}/scalar_sum")

    def reduce_max(self, v):
        """Global quantization scales (and exact-mode fixed-point
        exponents): every rank sees the same maxima."""
        return M.pmax(v, f"{self._prefix}/quant_scale")

    def shard_key(self, key):
        """The rank's stochastic-rounding stream (reference
        ``jax.random.fold_in(key, axis_index)``)."""
        return key if key is None else fold_in(key, self.rank)

    def reduce_hist(self, hist):
        return M.psum(hist, f"{self._prefix}/hist_psum")

    def reduce_hist_scatter(self, hist):
        return M.psum_scatter(hist, f"{self._prefix}/hist_reduce_scatter",
                              dim=1)

    def exchange_gather(self, v):
        """The winner exchange's one collective (learner/wave.py): every
        rank's O(k) candidate rows."""
        return M.all_gather(v, f"{self._prefix}/winner_exchange")


class RowShardedLearner(SerialTreeLearner):
    """The row layout of the data- and voting-parallel learners (module
    docstring): this rank's block of the bin matrix on its device, the
    block of every per-row vector cut on the way in and the ranks'
    ``row_leaf`` blocks gathered on the way out."""

    _gather_site = "data_parallel/row_leaf_gather"

    def _init_rows(self, mesh: M.Workers, num_data: int,
                   block: Optional[int] = None) -> None:
        self.mesh = mesh
        self.ndev = mesh.world
        self.num_data = int(num_data)
        q = mesh.world * ROW_BLOCK
        self.block = (int(block) if block is not None else
                      -(-self.num_data // q) * q // mesh.world)
        # the wave strategy's view of this rank's rows (the speculative
        # ramp takes the one-process subsample's rows in its block)
        self._strategy.row_offset = mesh.rank * self.block
        self._strategy.row_block = self.block

    def local_bins(self, train_set, device) -> torch.Tensor:
        """This rank's FEATURE-MAJOR (F, pad_rows(block)) block of the bin
        matrix on ``device`` (the rows of a ``pre_partition`` shard as
        they are)."""
        X = train_set.X_binned
        if not getattr(train_set, "distributed_rows", False):
            lo = self.mesh.rank * self.block
            X = X[lo:lo + self.block]
        xt = np.zeros((X.shape[1], pad_rows(self.block)), X.dtype)
        xt[:, :X.shape[0]] = X.T
        return torch.from_numpy(xt).to(device)

    def train(self, X_T, grad, hess, sample_mask, feature_mask=None,
              node_key=None, quant_key=None, cegb_penalty=None) -> GrownTree:
        """Grow one tree from the GLOBAL (N,) per-row vectors; the
        returned ``row_leaf`` is the global (N,) one."""
        lo = min(self.mesh.rank * self.block, self.num_data)
        hi = min(lo + self.block, self.num_data)
        grown = super().train(X_T, grad[lo:hi], hess[lo:hi],
                              sample_mask[lo:hi], feature_mask=feature_mask,
                              node_key=node_key, quant_key=quant_key,
                              cegb_penalty=cegb_penalty)
        rl = torch.nn.functional.pad(grown.row_leaf, (0, self.block -
                                                      (hi - lo)))
        rows = M.all_gather(rl, self._gather_site).reshape(-1)
        return grown._replace(row_leaf=rows[:self.num_data])


class DataParallelTreeLearner(RowShardedLearner):
    """Host-side data-parallel learner (reference :290-561): the wave
    grower when it can serve the config (``tree_grow_mode`` wave, or auto
    at uint8 bins), else the masked sequential grower, with the
    reference's warnings for what the masked grower drops."""

    name = "data"

    def __init__(self, config: Config, num_features: int, max_bins: int,
                 num_bins: np.ndarray, has_nan: np.ndarray,
                 device: torch.device, is_cat: Optional[np.ndarray] = None,
                 efb=None, monotone: Optional[np.ndarray] = None,
                 forced_splits: tuple = (), interaction_groups: tuple = (),
                 feature_contri: tuple = (), cegb_lazy: tuple = (), *,
                 num_data: int, block: Optional[int] = None):
        mesh = M.get_mesh(int(config.num_devices))
        mode = str(config.tree_grow_mode)
        wave_able = (int(config.num_leaves) > 2 and
                     hist_pool_fits(config, num_features, int(max_bins)))
        self.wave = wave_able and (mode == "wave" or
                                   (mode == "auto" and max_bins <= 256))
        if self.wave:
            strategy = WaveDPStrategy(
                mesh, num_data, hist_scatter=bool(config.tpu_dp_hist_scatter))
            grow_mode = "wave"
        else:
            _masked_warnings(config, forced_splits, interaction_groups,
                             cegb_lazy, num_bins, is_cat)
            strategy = DataParallelStrategy(mesh, num_features, num_data)
            grow_mode = "masked"
            forced_splits = interaction_groups = cegb_lazy = ()
            feature_contri = ()
        self.supports_extras = self.wave
        super().__init__(config, num_features, max_bins, num_bins, has_nan,
                         device, is_cat=is_cat, efb=efb, monotone=monotone,
                         forced_splits=forced_splits,
                         interaction_groups=interaction_groups,
                         feature_contri=feature_contri, cegb_lazy=cegb_lazy,
                         strategy=strategy, grow_mode=grow_mode)
        self._init_rows(mesh, num_data, block)


def _masked_warnings(config: Config, forced_splits, interaction_groups,
                     cegb_lazy, num_bins, is_cat) -> None:
    """What the masked data-parallel grower does not apply (reference
    :330-362)."""
    if config.use_quantized_grad:
        log_warning("use_quantized_grad requires the wave grower; the "
                    "masked data-parallel grower trains with exact "
                    "gradients")
    if forced_splits:
        log_warning("forcedsplits_filename is applied by the DP-wave "
                    "grower only; the masked data-parallel grower "
                    "ignores it")
    resolve_monotone_method(
        config, split_params_from_config(config, num_bins,
                                         is_cat).use_monotone, wave=False)
    if interaction_groups or cegb_lazy or config.extra_trees or \
            config.feature_fraction_bynode < 1.0 or \
            config.cegb_penalty_split > 0 or \
            config.cegb_penalty_feature_coupled:
        log_warning("extra_trees / bynode sampling / cegb / interaction"
                    " constraints under tree_learner=data require the "
                    "wave grower (tree_grow_mode=wave, or auto on TPU);"
                    " the masked DP grower ignores them")
