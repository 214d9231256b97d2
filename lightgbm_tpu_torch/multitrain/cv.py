"""Cross-validation through the model axis (the ``engine.cv`` fast path).

Port of ``lightgbm_tpu/multitrain/cv.py``.  Folds are models: fold k
trains with a held-out sample mask over the PARENT dataset, so binning
happens once, the bin matrix lives on the device once, and every fold's
trees grow in lockstep (``batched.BatchTrainer``).  The grower routes
EVERY row to a leaf (masked-out rows add nothing to the sums but still
follow the splits), so each fold's held-out scores already sit in its
training score: the validation metric reads its test rows there, with no
tree walk.

Aggregation and early stopping are ``engine.cv``'s own
(``engine.CVAggregator``).  The port's sums are integers (fixed point, or
quantized) whose scale does not depend on the masked rows, and a fold's
draws over row positions (bagging, stochastic rounding, the speculative
ramp's subsample) are the per-fold run's on its own rows
(``BatchTrainer`` ``own_rows``), so a fold trained here grows the per-fold
loop's trees and the metric history is the loop's.  The reference agrees
with its per-fold loop only to f32 reduction tolerance.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..dataset import Dataset
from ..metric import create_metrics
from ..utils.log import log_info
from .batched import BatchTrainer, MultiTrainError, _subset_metadata

__all__ = ["cv_many", "cv_reject_reason"]


def cv_reject_reason(fobj, feval, fpreproc, init_model,
                     callbacks) -> Optional[str]:
    """Why ``engine.cv`` cannot take the batched fold driver (None = it
    can; configuration limits are BatchTrainer's own)."""
    if fobj is not None:
        return "custom objective (fobj)"
    if feval is not None:
        return "custom metric (feval)"
    if fpreproc is not None:
        return "fpreproc rewrites per-fold params"
    if init_model is not None:
        return "init_model continuation"
    if callbacks:
        return "user callbacks observe per-fold boosters"
    return None


def cv_many(params: Dict[str, Any], train_set: Dataset,
            num_boost_round: int, folds, cfg: Config,
            eval_train_metric: bool = False,
            return_cvbooster: bool = False, device=None) -> Dict[str, Any]:
    """``engine.cv``'s fold loop as ONE batch.  ``folds`` is the list of
    (train_idx, test_idx) pairs.  Raises :class:`MultiTrainError` when the
    configuration cannot batch; the caller then runs the per-fold loop."""
    from ..engine import CVAggregator, CVBooster

    nfold = len(folds)
    if nfold == 0:
        raise MultiTrainError("empty fold list")
    n = train_set.num_data()
    masks = np.zeros((nfold, n), np.float32)
    for k, (train_idx, _) in enumerate(folds):
        masks[k, np.asarray(train_idx, np.int64)] = 1.0
    trainer = BatchTrainer([dict(params) for _ in range(nfold)], train_set,
                           sample_masks=masks, device=device)
    md = train_set.metadata

    def fold_metrics(k: int, idx) -> tuple:
        idx = np.asarray(idx, np.int64)
        mts = create_metrics(trainer.cfgs[k])
        for mt in mts:
            mt.init(_subset_metadata(md, idx), len(idx))
        return torch.as_tensor(idx, device=trainer.device), mts

    valid = [fold_metrics(k, te) for k, (_, te) in enumerate(folds)]
    trainer.track_heldout([te for _, te in folds])
    train = ([fold_metrics(k, tr) for k, (tr, _) in enumerate(folds)]
             if eval_train_metric else [])

    aggr = CVAggregator(cfg, num_boost_round)
    for it in range(num_boost_round):
        trainer.step_once(it)
        agg = collections.defaultdict(list)
        hib_map: Dict[str, bool] = {}
        for k in range(nfold):
            rows, mts = valid[k]
            held_out = trainer.host_heldout_score(k, rows)
            for mt in mts:
                for name, val, hib in mt.eval(held_out):
                    agg[f"valid {name}"].append(val)
                    hib_map[f"valid {name}"] = hib
            if eval_train_metric:
                rows, mts = train[k]
                in_fold = trainer.host_lane_score(k, rows)
                for mt in mts:
                    for name, val, _ in mt.eval(in_fold):
                        agg[f"train {name}"].append(val)
        if aggr.update(it, agg, hib_map):
            break

    log_info(f"cv: trained {nfold} folds in one batch "
             f"({trainer._steps} rounds)")
    cvbooster = CVBooster()
    out: Dict[str, Any] = aggr.finalize(cvbooster)
    if return_cvbooster:
        for bst in trainer.finalize():
            cvbooster.append(bst)
        out["cvbooster"] = cvbooster
    return out
