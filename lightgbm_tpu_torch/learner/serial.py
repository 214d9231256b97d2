"""Serial (single-device) tree learner: the growers' host wrapper.

Port of ``lightgbm_tpu/learner/serial.py``: ``GrownTree``,
``CommStrategy`` (the serial strategy's ``leaf_candidates`` and
``pair_candidates``, reference serial.py:96-197), ``resolve_hist_impl``,
``split_params_from_config``, ``hist_pool_fits`` (:645-652), the grower
choice of ``SerialTreeLearner`` (:727-776), its 4-bit packing decision
(:777-794), its EFB descriptors (:688-703) and its wave and partition
branches (:784-850, :901-967).
The masked (pool-less) grower and the parallel strategies are later
slices (ROADMAP queue 1); the histogram autotuner is
``learner/autotune.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import Config
from ..ops.histogram import PACK4_MAX_BINS
from ..ops.split import SplitParams, local_best_candidates
from ..utils.log import log_info, log_warning
from ..utils.random import host_key

__all__ = ["SerialTreeLearner", "GrownTree", "CommStrategy",
           "resolve_hist_impl", "split_params_from_config",
           "hist_pool_fits"]


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
    hist_passes: int                # full-data histogram passes (wave
    #                                 grower; 0 = untracked: the
    #                                 partitioned grower's builds scale
    #                                 with the split leaf, not with N)
    host_syncs: int = -1            # device-to-host reads of the grower
    #                                 (partitioned grower; -1 = not counted)
    cat_member: Optional[torch.Tensor] = None   # (L-1, B) bool LEFT bins
    #                                 of categorical nodes (None: no
    #                                 categorical feature)


class CommStrategy:
    """The serial (no-communication) strategy of the reference's growers:
    split candidates of one leaf, or of a split's two children in one
    batched scan (the reference's vmap).  Parallel strategies, which
    insert collectives at these points, are not ported yet (ROADMAP queue
    1)."""

    def __init__(self, num_bins: torch.Tensor, has_nan: torch.Tensor,
                 is_cat: Optional[torch.Tensor] = None):
        self.num_bins_full = num_bins
        self.has_nan_full = has_nan
        self.is_cat_full = is_cat

    def leaf_candidates(self, hist, leaf_sum, feature_mask, params,
                        rand_bins=None):
        """(gain, feat, bin, default_left, left_sum, right_sum,
        cat_member) of one leaf's (F, B, 3) f32 histogram; ``rand_bins``
        (F,) the node's extra-trees thresholds or None."""
        out = local_best_candidates(
            hist.unsqueeze(0), leaf_sum.unsqueeze(0), self.num_bins_full,
            self.has_nan_full, feature_mask.unsqueeze(0), params,
            rand_bins=None if rand_bins is None else rand_bins.unsqueeze(0),
            is_cat=self.is_cat_full)
        return tuple(o[0] for o in out)

    def pair_candidates(self, hist_l, hist_r, lsum, rsum, feature_mask,
                        params, rand_bins=None):
        """Both children's candidates in ONE batched scan;
        ``feature_mask`` (F,) or one row per child (2, F), ``rand_bins``
        (2, F) or None."""
        out = local_best_candidates(torch.stack([hist_l, hist_r]),
                                    torch.stack([lsum, rsum]),
                                    self.num_bins_full, self.has_nan_full,
                                    feature_mask.expand(2, -1), params,
                                    rand_bins=rand_bins,
                                    is_cat=self.is_cat_full)
        return tuple(o[0] for o in out), tuple(o[1] for o in out)


def resolve_hist_impl(config: Config, device: torch.device) -> str:
    """Pick the histogram implementation: ``auto`` (and the reference's
    ``pallas``) resolve to the hand-written CUDA kernels on a ``cuda``
    device and to their plain PyTorch versions on the CPU.  The wrappers
    dispatch on the tensors' device, so the name only records what ran.
    The kernels' bin layout is the learner's decision: packed 4-bit bins
    under ``tpu_hist_pack4`` unless ``tpu_pallas_pipeline=blockspec``
    (``SerialTreeLearner.pack4``)."""
    impl = str(config.tpu_histogram_impl)
    if impl not in ("auto", "pallas"):
        raise NotImplementedError(
            f"tpu_histogram_impl={impl!r} selects an XLA formulation of the "
            "reference; lightgbm_tpu_torch has the CUDA kernels and their "
            "plain versions only")
    return "cuda" if torch.device(device).type == "cuda" else "plain"


def split_params_from_config(config: Config,
                             num_bins: Optional[np.ndarray] = None,
                             is_cat: Optional[np.ndarray] = None
                             ) -> SplitParams:
    """The scan's parameters (reference serial.py:574-625): the
    sorted-subset search is on when some categorical feature has more
    than ``max_cat_to_onehot`` bins, and ``cat_idx`` lists the
    categorical features (the serial learners scan full feature space,
    reference serial.py:709-716)."""
    mc = config.monotone_constraints or []
    use_cegb = bool(config.cegb_penalty_split > 0.0 or
                    config.cegb_penalty_feature_coupled or
                    config.cegb_penalty_feature_lazy)
    cats = (np.zeros(0, bool) if is_cat is None
            else np.asarray(is_cat, bool))
    use_cat_subset = bool(
        num_bins is not None and
        np.any(cats & (np.asarray(num_bins) > int(config.max_cat_to_onehot))))
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
        use_cat_subset=use_cat_subset,
        cat_idx=tuple(int(j) for j in np.nonzero(cats)[0]),
        use_cegb=use_cegb,
        cegb_tradeoff=float(config.cegb_tradeoff),
        cegb_penalty_split=float(config.cegb_penalty_split),
        feature_fraction_bynode=float(config.feature_fraction_bynode),
        extra_trees=bool(config.extra_trees),
        any_cat=bool(cats.any()))


def hist_pool_fits(config: Config, num_features: int, max_bins: int) -> bool:
    """Keep per-leaf histograms when they fit the budget (reference
    histogram_pool_size, default -1 = a 1 GiB cap).  The budget counts
    the reference's f32 pool, so the port picks the grower it picks; the
    port's partitioned pool holds int64 sums, twice those bytes
    (:func:`pool_bytes`)."""
    pool = config.num_leaves * num_features * max_bins * 3 * 4
    budget = (float(config.histogram_pool_size) * (1 << 20)
              if config.histogram_pool_size > 0 else (1 << 30))
    return pool <= budget


def pool_bytes(config: Config, num_features: int, max_bins: int,
               grow_mode: str) -> int:
    """Bytes of the port's histogram pool: (L, F, B, 3) int64 fixed-point
    sums on the partitioned grower, f32 (exact) or int32 (quantized) on
    the wave grower."""
    item = 8 if grow_mode == "partition" else 4
    return config.num_leaves * num_features * max_bins * 3 * item


def _check_config(config: Config) -> None:
    """Raise for configurations neither ported grower carries."""
    unported = [
        ("forcedsplits_filename", bool(config.forcedsplits_filename)),
        ("interaction_constraints", bool(config.interaction_constraints)),
        ("feature_contri", bool(config.feature_contri)),
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
                 device: torch.device, is_cat: Optional[np.ndarray] = None,
                 efb=None):
        self.config = config
        self.device = torch.device(device)
        self.max_bins = int(max_bins)
        self.num_features = num_features
        self.num_bins = torch.as_tensor(num_bins, dtype=torch.int32,
                                        device=self.device)
        self.has_nan = torch.as_tensor(has_nan, dtype=torch.bool,
                                       device=self.device)
        if is_cat is None:
            is_cat = np.zeros(num_features, bool)
        self.is_cat = torch.as_tensor(is_cat, dtype=torch.bool,
                                      device=self.device)
        any_cat = bool(np.any(is_cat))
        self.split_params = split_params_from_config(config, num_bins, is_cat)
        self.hist_impl = resolve_hist_impl(config, self.device)
        # EFB (dataset.py ``efb``, a BundleInfo): the growers build and
        # pool histograms in bundle space (reference serial.py:688-703)
        self.efb = efb
        from ..efb import efb_arrays
        self._efb = None if efb is None else efb_arrays(efb, self.device)
        pool_f, pool_b = ((efb.n_bundles, efb.bundle_bins) if efb is not None
                          else (num_features, self.max_bins))
        # grower choice (reference serial.py:723-776); both of the port's
        # histogram paths (CUDA kernel, plain version) stand for the
        # reference's pallas impl
        self.use_hist_pool = hist_pool_fits(config, pool_f, pool_b)
        wave_ok = self.use_hist_pool and int(config.num_leaves) > 2
        mode = str(config.tree_grow_mode)
        if mode == "wave" and not wave_ok:
            log_warning("tree_grow_mode=wave is incompatible with "
                        "num_leaves<=2 / pool-less growth; "
                        "falling back to the partitioned grower")
            mode = "partition"
        elif mode == "auto":
            mode = "wave" if wave_ok else "partition"
        if not self.use_hist_pool:
            raise NotImplementedError(
                "the histogram pool does not fit histogram_pool_size: the "
                "reference takes its masked grower, which is not ported to "
                "lightgbm_tpu_torch yet (ROADMAP queue 1)")
        self.grow_mode = mode
        self.quantized = bool(config.use_quantized_grad) and mode == "wave"
        if config.use_quantized_grad and not self.quantized:
            log_warning("use_quantized_grad requires the wave grower "
                        "(tree_grow_mode=wave/auto); training with exact "
                        "gradients instead")
        _check_config(config)
        log_info(f"histogram pool: "
                 f"{pool_bytes(config, pool_f, pool_b, mode)} "
                 f"bytes on the {mode} grower")
        # the 4-bit packed bin layout (reference serial.py:777-794): two
        # codes per byte when every feature fits a nibble, on the wave
        # grower only, never under categorical features or EFB.  pack4
        # exists only on the reference's DMA pipeline, so an explicit
        # blockspec request turns it off.
        self.pack4 = bool(mode == "wave" and config.tpu_hist_pack4 and
                          self.max_bins <= PACK4_MAX_BINS and not any_cat and
                          efb is None and
                          config.tpu_pallas_pipeline != "blockspec")
        self._x_src = self._Xp = None
        self._quant_calls = 0
        if mode == "partition":
            from .partitioned import make_partitioned_grow_fn
            self._grow = make_partitioned_grow_fn(
                num_leaves=int(config.num_leaves), num_features=num_features,
                max_bins=self.max_bins, max_depth=int(config.max_depth),
                split_params=self.split_params, efb=self._efb)
            return
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
            renew_leaf=bool(config.quant_train_renew_leaf), pack4=self.pack4,
            efb=self._efb)

    def train(self, X_T: torch.Tensor, grad: torch.Tensor,
              hess: torch.Tensor, sample_mask: torch.Tensor,
              feature_mask: Optional[torch.Tensor] = None,
              node_key: Optional[torch.Tensor] = None,
              quant_key: Optional[torch.Tensor] = None) -> GrownTree:
        """Grow one tree.  ``X_T`` is the dataset's padded feature-major
        bin matrix (dataset.py ``device_bins``, or ``device_bins_packed4``
        when :attr:`pack4`: two rows per byte, the only copy of the bins on
        the device); the per-row vectors carry the N real rows and are
        zero-padded here (padded rows are out of the bag and contribute
        nothing).  The partitioned grower reads the ROW-MAJOR copy of
        ``X_T``, built once per dataset.  ``quant_key`` keys the
        quantized tree's stochastic rounding (a per-call stream when None,
        reference serial.py:933-939); ``node_key`` holds the keys of the
        by-node and extra-trees streams (zeros when None); both are host
        keys (utils/random.py)."""
        n = grad.shape[0]
        pad = X_T.shape[1] * (2 if self.pack4 else 1) - n
        if feature_mask is None:
            feature_mask = torch.ones((self.num_features,), dtype=torch.bool,
                                      device=self.device)
        if pad:
            grad = torch.nn.functional.pad(grad, (0, pad))
            hess = torch.nn.functional.pad(hess, (0, pad))
            sample_mask = torch.nn.functional.pad(sample_mask, (0, pad))
        if node_key is None:
            node_key = ((0, 0), (0, 0))
        if self.grow_mode == "partition":
            if self._x_src is not X_T:  # strong ref: ids can be recycled
                self._Xp = X_T.t().contiguous()
                self._x_src = X_T
            grown = self._grow(self._Xp, grad, hess, sample_mask,
                               self.num_bins, self.has_nan, feature_mask,
                               node_key, is_cat=self.is_cat)
        else:
            if self.quantized and quant_key is None:
                self._quant_calls += 1
                quant_key = host_key(self._quant_calls)
            grown = self._grow(X_T, grad, hess, sample_mask, self.num_bins,
                               self.has_nan, feature_mask, quant_key,
                               node_key, is_cat=self.is_cat)
        if pad:
            grown = grown._replace(row_leaf=grown.row_leaf[:n])
        return grown
