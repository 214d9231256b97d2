"""Distributed tree learners over a ``torch.distributed`` process group.

Port of ``lightgbm_tpu/parallel/`` (reference LightGBM's network layer
and parallel learners, src/network/ and
src/treelearner/parallel_tree_learner.h): the reference's ``jax.lax``
collectives over its device mesh become the collectives of
:mod:`.mesh` over the process group that ``distributed.init`` forms,
NCCL between cards and gloo between CPU ranks.
"""

from __future__ import annotations

from .data_parallel import DataParallelTreeLearner
from .feature_parallel import FeatureParallelTreeLearner
from .mesh import get_mesh
from .voting_parallel import VotingParallelTreeLearner

__all__ = ["create_parallel_learner", "DataParallelTreeLearner",
           "FeatureParallelTreeLearner", "VotingParallelTreeLearner",
           "get_mesh"]


def create_parallel_learner(config, num_features, max_bins, num_bins,
                            has_nan, device, is_cat=None, monotone=None,
                            efb=None, interaction_groups=(), cegb_lazy=(),
                            forced_splits=(), feature_contri=(), *,
                            num_data: int, block=None):
    """The learner of ``config.tree_learner`` (reference
    parallel/__init__.py:22-61, LightGBM tree_learner.h:104
    ``CreateTreeLearner``).  A world of one process runs the serial
    learner, as the reference does on a one-device mesh and LightGBM
    does with ``num_machines == 1``: the same tree without collectives."""
    kind = config.tree_learner
    if kind not in ("data", "feature", "voting"):
        raise ValueError(f"Unknown tree_learner: {kind}")
    if get_mesh(int(config.num_devices)).world == 1:
        from ..learner.serial import SerialTreeLearner
        from ..utils.log import log_info
        log_info(f"tree_learner={kind} on a single-device mesh: using "
                 "the serial learner (no collectives needed)")
        return SerialTreeLearner(
            config, num_features, max_bins, num_bins, has_nan, device,
            is_cat=is_cat, efb=efb, monotone=monotone,
            forced_splits=forced_splits,
            interaction_groups=interaction_groups,
            feature_contri=feature_contri, cegb_lazy=cegb_lazy)
    if kind == "data":
        return DataParallelTreeLearner(
            config, num_features, max_bins, num_bins, has_nan, device,
            is_cat=is_cat, monotone=monotone, forced_splits=forced_splits,
            interaction_groups=interaction_groups,
            feature_contri=feature_contri, cegb_lazy=cegb_lazy,
            num_data=num_data, block=block)
    if interaction_groups or cegb_lazy or forced_splits:
        from ..utils.log import log_warning
        log_warning("interaction_constraints / cegb_penalty_feature_lazy / "
                    "forcedsplits_filename are applied by the serial and "
                    "data-parallel learners only; this learner ignores them")
    if kind == "voting":
        return VotingParallelTreeLearner(
            config, num_features, max_bins, num_bins, has_nan, device,
            is_cat=is_cat, monotone=monotone, num_data=num_data,
            block=block)
    return FeatureParallelTreeLearner(config, num_features, max_bins,
                                      num_bins, has_nan, device,
                                      is_cat=is_cat, monotone=monotone)
