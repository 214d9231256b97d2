"""Chunked streamed training: boosting over a StreamedDataset.

Port of ``lightgbm_tpu/ingest/train.py``.  Drives
:class:`..ingest.grower.ChunkedWaveGrower` through the boosting loop with
every per-row array host-resident (score, gradients, bag mask, per-chunk
``row_leaf``): the device holds only the two-slot chunk ring and the wave
state, so total rows are limited by disk and host RAM (~20 B a row), not
by device memory.

Envelope (checked, typed errors, the reference's): numeric features,
objective ``regression`` / ``binary`` / ``multiclass`` (softmax), boosting
``gbdt`` / ``goss`` / ``dart``, no monotone / interaction / forced-split
/ CEGB / linear-tree / by-node / extra-trees / smoothing extras, at most
255 bins; ``stochastic_rounding`` and ``quant_train_renew_leaf`` are
forced off (both need full-row device passes).  Everything else —
bagging, ``feature_fraction``, quantized gradients, boost-from-average —
draws the in-core trainer's host sampling streams, so with the
speculative ramp and the exact endgame off on the in-core side too the
model text is the in-core ``engine.train`` text byte for byte, quantized
and exact (ingest/grower.py).

Gradients run per chunk through the objective's own formula on the
training device (elementwise per row, the softmax's max and sum within a
row), with the objective's per-row label, weight and one-hot arrays on
the host and their chunk slices uploaded per call.

GOSS draws its bag from the shared host sampler (``models.gbdt.
goss_sample_np``), so the streamed run thins the rows the in-core run
thins, warm-up included.  DART replays the in-core drop bookkeeping
(``models/boosting.py`` ``dart_drops`` / ``dart_shrinkage`` /
``dart_factor``) on the host: each iteration's raw base predictions stay
host f32 arrays and the drop subtraction and Normalize rescale run as
host f32 axpys, the IEEE ops the in-core device path runs.  DART does
not compose with checkpoint / resume (the per-tree drop weights are not
in the model text).

Validation sets may be StreamedDatasets (binned against the train set's
mappers through ``reference``) or in-core Datasets; each grown tree is
walked over the valid set's binned chunks (``models/gbdt._walk_binned``)
into a host f32 score, so metrics and early stopping see the in-core
run's values.  Checkpoint / resume rides ``resilience/checkpoint.py``
with the streamed crc as the dataset fingerprint.  The flight recorder
keeps one event an iteration (``telemetry/flight.py``), dumped into
``flight_dir`` (else next to the checkpoints) on a crash and into an
explicit ``flight_dir`` on success, as the reference's
(ingest/train.py:445-463).  ``publish_dir`` raises: the reference's
chunked path has no publish lane.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..basic import Booster, device_from
from ..callback import CallbackEnv, EarlyStopException, early_stopping
from ..config import Config
from ..learner.serial import resolve_hist_impl, split_params_from_config
from ..metric import create_metrics
from ..models.boosting import dart_drops, dart_factor, dart_shrinkage
from ..models.gbdt import (EPSILON, GBDT, _grown_to_tree, _walk_binned,
                           bagging_mask_np, feature_mask_np, goss_sample_np)
from ..objective import create_objective
from ..objective.binary import BinaryLogloss
from ..objective.multiclass import MulticlassSoftmax
from ..objective.regression import RegressionL2
from ..ops.quantize import quant_levels
from ..resilience.checkpoint import (CKPT_SOFT_KEYS, CKPT_STRUCTURAL_KEYS,
                                     Checkpoint, CheckpointManager,
                                     load_checkpoint, resolve_checkpoint)
from ..telemetry.trace import span
from ..utils.log import log_info, log_warning, set_verbosity
from ..utils.random import rng_checkpoint_state
from .grower import ChunkedWaveGrower, ChunkRing, StreamedEnvelopeError
from .stream import StreamedDataset

__all__ = ["train_streamed", "StreamedEnvelopeError"]


def _check_envelope(cfg: Config) -> None:
    bad = []
    if cfg.boosting not in ("gbdt", "goss", "dart"):
        bad.append(f"boosting={cfg.boosting}")
    if cfg.linear_tree:
        bad.append("linear_tree")
    if cfg.monotone_constraints and \
            any(int(v) != 0 for v in cfg.monotone_constraints):
        bad.append("monotone_constraints")
    if cfg.interaction_constraints:
        bad.append("interaction_constraints")
    if cfg.forcedsplits_filename:
        bad.append("forcedsplits_filename")
    if cfg.cegb_penalty_split > 0 or cfg.cegb_penalty_feature_coupled or \
            cfg.cegb_penalty_feature_lazy:
        bad.append("cegb penalties")
    if cfg.feature_fraction_bynode < 1.0:
        bad.append("feature_fraction_bynode")
    if cfg.extra_trees:
        bad.append("extra_trees")
    if cfg.path_smooth > 0:
        bad.append("path_smooth")
    if bad:
        raise StreamedEnvelopeError(
            "chunked streamed training (tpu_ingest_mode=chunked) does not "
            "support: " + ", ".join(bad) + "; train with "
            "tpu_ingest_mode=hbm (in-core from the streamed binned cache) "
            "instead")


def _host_objective(cfg: Config, md, n: int):
    """The objective initialized on the host (its per-row label, weight
    and one-hot arrays stay host tensors; chunk slices go to the device
    per gradient call)."""
    obj = create_objective(cfg.objective, cfg, torch.device("cpu"))
    ok = (type(obj) is BinaryLogloss or
          type(obj) is MulticlassSoftmax or
          (type(obj) is RegressionL2 and not obj.sqrt))
    if not ok:
        raise StreamedEnvelopeError(
            f"chunked streamed training supports objective=regression|"
            f"binary|multiclass (got {cfg.objective}; ranking needs "
            f"full-dataset query segments, multiclassova per-class label "
            f"weights); use tpu_ingest_mode=hbm")
    obj.init(md, n)
    return obj


# the objectives' per-row host arrays a gradient call slices
_ROW_ATTRS = ("label", "weight", "_lw", "onehot")


def _chunk_gradients(obj, score_c: np.ndarray, lo: int, hi: int, dev):
    """One chunk's gradients through the objective's own formula on
    ``dev``; elementwise per row, so per-chunk evaluation is the in-core
    full-array call's bits."""
    saved = {a: getattr(obj, a) for a in _ROW_ATTRS if hasattr(obj, a)}
    try:
        for a, v in saved.items():
            if v is not None:
                setattr(obj, a, v[lo:hi].to(dev))
        g, h = obj.get_gradients(torch.from_numpy(score_c).to(dev))
        return g.cpu().numpy(), h.cpu().numpy()
    finally:
        for a, v in saved.items():
            setattr(obj, a, v)


def _glue_gbdt(cfg: Config, train_set: StreamedDataset, obj, trees,
               k: int, max_bins: int, dev) -> GBDT:
    """A GBDT shell carrying the streamed-trained model (model text,
    prediction and the Booster's surface; no training state)."""
    g = GBDT(cfg, None, objective=obj, device=dev)
    g.train_set = train_set
    g.num_data = train_set.num_data()
    g.num_features = train_set.num_feature()
    g.max_bins = max_bins
    g.num_tree_per_iteration = k
    g.models = list(trees)
    g.iter_ = len(trees) // max(1, k)
    return g


class _ValidState:
    """One validation stream: host f32 score matrix + its metric set."""

    __slots__ = ("name", "vset", "nv", "vscore", "metrics")

    def __init__(self, name, vset, nv, vscore, metrics) -> None:
        self.name = name
        self.vset = vset
        self.nv = nv
        self.vscore = vscore
        self.metrics = metrics


def train_streamed(params: Dict[str, Any], train_set: StreamedDataset,
                   num_boost_round: int = 100,
                   valid_sets: Optional[List[Any]] = None,
                   valid_names: Optional[List[str]] = None,
                   resume_from: Optional[str] = None, device=None,
                   ring_profile: bool = False) -> Booster:
    """Boost ``num_boost_round`` trees over a StreamedDataset with
    chunk-accumulated histograms; returns a Booster.  ``device`` as in
    ``engine.train`` (the card unless the caller or ``device_type`` asks
    for the CPU).  The Booster's ``_ingest_stats`` holds the run's
    host-to-device bytes (``h2d_bytes``); with ``ring_profile`` on the
    card, also the seconds the compute stream waited on uploads and the
    seconds of the chunk passes (``ChunkRing.stall_stats``), timed by
    CUDA events around every upload wait."""
    from ..engine import reject_publishing
    params = dict(params)
    dev = device_from(params, device)
    cfg = Config(params)
    set_verbosity(int(cfg.verbosity))
    reject_publishing(cfg, "train_streamed", flight_lane=True)
    _check_envelope(cfg)
    if cfg.tree_learner not in ("serial", "auto"):
        raise NotImplementedError(
            f"tree_learner={cfg.tree_learner!r}: the parallel learners are "
            "not ported to lightgbm_tpu_torch yet (ROADMAP queue 1)")
    resolve_hist_impl(cfg, dev)
    if cfg.use_quantized_grad and cfg.stochastic_rounding:
        log_warning("chunked streamed training forces "
                    "stochastic_rounding=false (the per-row rounding "
                    "stream is not chunk-sliceable)")
        cfg.stochastic_rounding = False
    if cfg.use_quantized_grad and cfg.quant_train_renew_leaf:
        log_warning("chunked streamed training forces "
                    "quant_train_renew_leaf=false")
        cfg.quant_train_renew_leaf = False
    train_set.construct(cfg)
    n = train_set.num_data()
    f_used = train_set.num_feature()
    mappers = [train_set.bin_mappers[j] for j in train_set.used_feature_map]
    from ..binning import MissingType
    num_bins = np.array([m.num_bin for m in mappers], np.int32)
    is_cat = np.array([m.is_categorical for m in mappers], bool)
    has_nan = np.array([m.missing_type == MissingType.NAN for m in mappers],
                       bool)
    if np.any(is_cat):
        raise StreamedEnvelopeError(
            "chunked streamed training supports numeric features only; "
            "use tpu_ingest_mode=hbm for categorical data")
    max_bins = int(num_bins.max())
    if cfg.use_quantized_grad:
        # the int32 channel-sum exactness bound: past it the quantized
        # accumulator can wrap and the chunked == in-core contract is void
        _gq = max(quant_levels(int(cfg.num_grad_quant_bins)))
        if n > (1 << 31) // _gq:
            log_warning(
                f"num_data={n} exceeds the quantized histogram's int32 "
                f"channel-sum exactness bound (2^31/{_gq} rows at "
                f"num_grad_quant_bins={cfg.num_grad_quant_bins}); lower "
                f"num_grad_quant_bins")
    sp = split_params_from_config(cfg, num_bins, is_cat)
    gq_max, hq_max = quant_levels(int(cfg.num_grad_quant_bins))
    grower = ChunkedWaveGrower(
        num_leaves=int(cfg.num_leaves), num_features=f_used,
        max_bins=max_bins, max_depth=int(cfg.max_depth), split_params=sp,
        num_bins=num_bins, has_nan=has_nan, device=dev,
        quantized=bool(cfg.use_quantized_grad), gq_max=gq_max,
        hq_max=hq_max, wave_size=int(cfg.tpu_wave_size), num_data=n)
    # the upload ring's pinned and device buffers: once per run
    ring = ChunkRing(train_set, dev, rl_dtype=grower.rl_dtype,
                     profile=ring_profile)

    md = train_set.metadata
    obj = _host_objective(cfg, md, n)
    K = int(obj.num_model_per_iteration)
    shape = (n,) if K == 1 else (n, K)

    # ---- initial scores (GBDT._init_train's score0 logic) -----------------
    score = np.zeros(shape, np.float32)
    pending_bias = np.zeros(K)
    if md.init_score is not None:
        score = score + md.init_score.reshape(shape).astype(np.float32)
    elif cfg.boost_from_average:
        for cid in range(K):
            b = obj.boost_from_score(cid)
            pending_bias[cid] = b
            if abs(b) > EPSILON:
                log_info(f"Start training from score {b:.6f}")
        score = score + (np.float32(pending_bias[0]) if K == 1 else
                         pending_bias[None, :].astype(np.float32))

    def glue(trees_):
        return _glue_gbdt(cfg, train_set, obj, trees_, K, max_bins, dev)

    # ---- checkpoint / resume ----------------------------------------------
    ckpt_dir = str(cfg.checkpoint_dir or "")
    if not ckpt_dir and int(cfg.snapshot_freq) > 0:
        ckpt_dir = f"{cfg.output_model}.ckpt"
    manager = CheckpointManager(ckpt_dir, int(cfg.checkpoint_keep)) \
        if ckpt_dir else None
    freq = int(cfg.snapshot_freq) if int(cfg.snapshot_freq) > 0 else \
        max(1, num_boost_round // 100)
    if resume_from is None and str(cfg.resume).strip():
        want = str(cfg.resume).strip()
        if want in ("latest", "auto"):
            if not manager:
                raise ValueError("resume=latest needs snapshot_freq>0 or "
                                 "checkpoint_dir")
            resume_from = resolve_checkpoint(ckpt_dir)
        else:
            resume_from = want
    if cfg.boosting == "dart" and (manager is not None or resume_from):
        raise StreamedEnvelopeError(
            "chunked dart training does not support checkpoint/resume: "
            "the per-tree drop weights cannot be reconstructed from the "
            "checkpointed model text; drop checkpoint_dir/snapshot_freq/"
            "resume or use tpu_ingest_mode=hbm")
    trees: List[Any] = []
    start_iter = 0
    if resume_from:
        ckpt = load_checkpoint(str(resume_from))
        ckpt.validate_dataset(train_set)
        ckpt.validate_config(cfg)
        from ..models.model_text import string_to_model
        loaded = string_to_model(ckpt.model_text, cfg)
        # re-keyed onto this dataset's binning, as the in-core restore
        trees = [glue([])._align_loaded_tree(t) for t in loaded.models]
        start_iter = int(ckpt.iteration)
        score = np.asarray(ckpt.score, np.float32).reshape(shape).copy()
        log_info(f"train_streamed: resumed at iteration {start_iter} "
                 f"from {resume_from}")

    def _save_ckpt(it: int) -> None:
        if manager is None:
            return
        manager.save(Checkpoint(
            iteration=it, model_text=glue(trees).save_model_to_string(),
            score=score.copy(), rng_state=rng_checkpoint_state(cfg),
            fingerprint=train_set.fingerprint(),
            params={k: getattr(cfg, k)
                    for k in CKPT_STRUCTURAL_KEYS + CKPT_SOFT_KEYS}))

    # ---- validation streams (in-core add_valid, host-resident) ------------
    def _vchunks(vs):
        if getattr(vs, "is_streamed", False):
            for ci in range(vs.num_chunks()):
                lo, hi = vs.chunk_bounds(ci)
                yield lo, hi, vs.binned_chunk(ci)
        else:
            yield 0, vs.num_data(), np.asarray(vs.X_binned)

    def _valid_delta(vst, tree, lv_dev):
        """One tree's walk over the valid set, chunk at a time (the
        in-core _record_tree valid update on bounded device memory)."""
        out = np.empty(vst.nv, np.float32)
        for lo, hi, bins in _vchunks(vst.vset):
            out[lo:hi] = _walk_binned(torch.as_tensor(bins, device=dev),
                                      tree, lv_dev).cpu().numpy()
        return out

    def _add(arr, cid, delta):
        if K == 1:
            return arr + delta
        arr[:, cid] = arr[:, cid] + delta
        return arr

    valids: List[_ValidState] = []
    provide_train = bool(cfg.is_provide_training_metric)
    if valid_sets:
        if not isinstance(valid_sets, (list, tuple)):
            valid_sets = [valid_sets]
        for i, vs in enumerate(valid_sets):
            if vs is train_set:
                provide_train = True   # engine.train's vs-is-train contract
                continue
            nm = (valid_names[i] if valid_names is not None and
                  i < len(valid_names) else f"valid_{i}")
            if not vs.constructed and getattr(vs, "reference", None) is None:
                vs.reference = train_set
            vs.construct(cfg)
            if vs.bin_mappers is not train_set.bin_mappers:
                raise ValueError(
                    "cannot add validation data: it was constructed "
                    "without reference to the training Dataset (different "
                    "bin mappers); pass reference= when creating it")
            if vs.num_feature() != f_used:
                raise ValueError(
                    "validation set feature count differs from train")
            nv = vs.num_data()
            vshape = (nv,) if K == 1 else (nv, K)
            v0 = np.zeros(vshape, np.float32)
            if vs.metadata.init_score is not None:
                v0 = v0 + vs.metadata.init_score.reshape(vshape).astype(
                    np.float32)
            elif cfg.boost_from_average:
                v0 = v0 + (np.float32(pending_bias[0]) if K == 1 else
                           pending_bias[None, :].astype(np.float32))
            mts = create_metrics(cfg)
            for m in mts:
                m.init(vs.metadata, nv)
            vst = _ValidState(nm, vs, nv, v0, mts)
            for t, tree in enumerate(trees):   # resumed: the loaded trees
                lv = torch.as_tensor(tree.leaf_value.astype(np.float32),
                                     device=dev)
                vst.vscore = _add(vst.vscore, t % K,
                                  _valid_delta(vst, tree, lv))
            valids.append(vst)
    train_metrics: List[Any] = []
    if provide_train:
        train_metrics = create_metrics(cfg)
        for m in train_metrics:
            m.init(md, n)

    # ---- boosting loop -----------------------------------------------------
    goss = cfg.boosting == "goss"
    dart = cfg.boosting == "dart"
    if goss and cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0:
        # in-core GOSS ignores bagging too (models/boosting.py GOSS)
        log_warning("cannot use bagging in GOSS (ignored)")
    grad = np.empty(shape, np.float32)
    hess = np.empty(shape, np.float32)
    completed = start_iter
    label_np = np.asarray(md.label)

    # ---- the flight recorder (reference ingest/train.py:445-463): the
    # chunked path is where its host-to-device byte counter moves
    from ..engine import dump_flight
    from ..telemetry.flight import FlightRecorder
    flight = FlightRecorder(
        capacity=int(cfg.flight_events), enabled=bool(cfg.flight_recorder),
        meta={"boosting": str(cfg.boosting), "objective": str(cfg.objective),
              "num_data": int(n), "ingest_mode": "chunked"}, device=dev)

    def _flight_dump(reason: str) -> None:
        dump_flight(flight, str(cfg.flight_dir) or ckpt_dir, reason)

    # DART host state (models/boosting.py DART, host-resident): the raw
    # per-iteration base predictions and per-valid raw deltas back the
    # O(N) drop / Normalize axpys
    dart_weights: List[float] = []
    dart_sum_weight = 0.0
    dart_base: List[np.ndarray] = []
    dart_vb: List[List[np.ndarray]] = []
    cur_shrinkage = float(cfg.learning_rate)

    def _dart_normalize(drop: List[int]) -> None:
        """The in-core DART Normalize: shrink the dropped trees, re-add
        the train score at the new weight, move the valid scores by the
        weight's change."""
        nonlocal score, dart_sum_weight
        if not drop:
            return
        factor = dart_factor(cfg, len(drop))
        for d in drop:
            old_w = dart_weights[d]
            new_w = old_w * factor
            dart_weights[d] = new_w
            dart_sum_weight -= old_w - new_w
            for c in range(K):
                trees[d * K + c].shrink(factor)
            score = score + dart_base[d] * np.float32(new_w)
            for vi, vst in enumerate(valids):
                vst.vscore = vst.vscore + \
                    dart_vb[d][vi] * np.float32(new_w - old_w)

    def _one_iter(it: int) -> bool:
        """One streamed boosting iteration; True = stop (no more
        splittable leaves)."""
        nonlocal completed, score, cur_shrinkage, dart_sum_weight
        first_iter = it == start_iter and not trees
        drop: List[int] = []
        if dart:
            # drop BEFORE gradients (dart.hpp DroppingTrees): gradients
            # see the thinned ensemble's score
            drop = dart_drops(cfg, it, dart_weights, dart_sum_weight)
            for d in drop:
                score = score - dart_base[d] * np.float32(dart_weights[d])
            cur_shrinkage = dart_shrinkage(cfg, len(drop))
        shrinkage = cur_shrinkage if dart else float(cfg.learning_rate)
        for i in range(train_set.num_chunks()):
            lo, hi = train_set.chunk_bounds(i)
            grad[lo:hi], hess[lo:hi] = _chunk_gradients(
                obj, np.ascontiguousarray(score[lo:hi]), lo, hi, dev)
        gw, hw = grad, hess
        if goss:
            # GOSS replaces bagging (in-core GOSS overrides
            # _prepare_iter_sampling and never draws a bag)
            mask = np.ones(n, np.float32)
            gm = goss_sample_np(cfg, grad, hess, it)
            if gm is not None:
                mask, mult = gm
                scale = mult if K == 1 else mult[:, None]
                gw = grad * scale
                hw = hess * scale
        else:
            mask = bagging_mask_np(
                cfg, n, it,
                label=label_np if cfg.objective == "binary" else None)
            mask = np.ones(n, np.float32) if mask is None else mask
        fmask = feature_mask_np(cfg, f_used, it)
        grown_cls = []
        for cid in range(K):
            g_c = gw if K == 1 else np.ascontiguousarray(gw[:, cid])
            h_c = hw if K == 1 else np.ascontiguousarray(hw[:, cid])
            grown_cls.append(grower.grow(ring, g_c, h_c, mask,
                                         feature_mask=fmask))
        all_stump = all(int(g.num_leaves) <= 1 for g, _ in grown_cls)
        if not dart and all_stump and trees:
            # the in-core deferred-stump pop, without the round trip: an
            # all-stump iteration past the first never enters the model
            log_warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            return True
        base_this: Optional[np.ndarray] = None
        vb_this = [np.zeros_like(v.vscore) for v in valids] if dart else None
        for cid, (grown, rl_chunks) in enumerate(grown_cls):
            lv_raw = grown.leaf_value.cpu().numpy()
            lv = lv_raw * np.float32(shrinkage)
            tree = _grown_to_tree(grown, shrinkage, train_set)
            bias = pending_bias[cid] if first_iter else 0.0
            if abs(bias) > EPSILON:
                tree.add_bias(bias)
            trees.append(tree)
            # the in-core _update_score: score + (lv * shrinkage)[row_leaf]
            # per chunk, two host f32 ops (the same IEEE ops)
            for i, rl_c in enumerate(rl_chunks):
                lo, hi = train_set.chunk_bounds(i)
                step = lv[rl_c.astype(np.int64)]
                if K == 1:
                    score[lo:hi] = score[lo:hi] + step
                else:
                    score[lo:hi, cid] = score[lo:hi, cid] + step
                if dart:
                    if base_this is None:
                        base_this = np.zeros(shape, np.float32)
                    b = lv_raw[rl_c.astype(np.int64)]
                    if K == 1:
                        base_this[lo:hi] = b
                    else:
                        base_this[lo:hi, cid] = b
            if valids:
                lv_dev = torch.as_tensor(lv, device=dev)
                for vi, vst in enumerate(valids):
                    before = vst.vscore.copy()
                    vst.vscore = _add(vst.vscore, cid,
                                      _valid_delta(vst, tree, lv_dev))
                    if dart:
                        # the in-core bookkeeping: (after - before) / w
                        dv = (vst.vscore - before) / np.float32(shrinkage)
                        vb_this[vi] = vb_this[vi] + dv
        if dart:
            dart_base.append(base_this if base_this is not None
                             else np.zeros(shape, np.float32))
            dart_weights.append(float(shrinkage))
            dart_sum_weight += float(shrinkage)
            dart_vb.append(vb_this or [])
            _dart_normalize(drop)
        completed = it + 1
        flight.note_iter(completed,
                         num_leaves=int(grown_cls[-1][0].num_leaves))
        if all_stump:
            # the first gbdt/goss iteration, or any dart iteration (dart
            # records at once: stump trees stay; stop after Normalize)
            log_warning("Stopped training because there are no more "
                        "leaves that meet the split requirements")
            return True
        if manager is not None and completed % freq == 0:
            _save_ckpt(completed)
        return False

    stopper = None
    if valids and cfg.early_stopping_round and \
            int(cfg.early_stopping_round) > 0:
        stopper = early_stopping(int(cfg.early_stopping_round),
                                 bool(cfg.first_metric_only),
                                 verbose=cfg.verbosity >= 1)
    best_iteration = -1
    best_score: Dict[str, Dict[str, float]] = {}
    try:
        for it in range(start_iter, num_boost_round):
            with span("ingest/train/iteration"):
                if _one_iter(it):
                    break
            if valids or train_metrics:
                # eval AFTER the iteration, in engine.train's order
                # (training metrics first), on the in-core run's f32
                # score values
                results = []
                for m in train_metrics:
                    for mname, val, hib in m.eval(score):
                        results.append(("training", mname, val, hib))
                for vst in valids:
                    for m in vst.metrics:
                        for mname, val, hib in m.eval(vst.vscore):
                            results.append((vst.name, mname, val, hib))
                flight.note_eval(it + 1, results)
                if stopper is not None:
                    try:
                        stopper(CallbackEnv(None, dict(params), it, 0,
                                            num_boost_round, results))
                    except EarlyStopException as e:
                        best_iteration = e.best_iteration + 1
                        for ds_name, eval_name, sc, _ in e.best_score:
                            best_score.setdefault(
                                ds_name, {})[eval_name] = sc
                        break
    except (Exception, KeyboardInterrupt):
        _flight_dump("crash")
        raise
    if manager is not None:
        _save_ckpt(completed)
    if str(cfg.flight_dir):
        _flight_dump("completed")

    bst = Booster.__new__(Booster)
    bst.params = dict(params)
    bst.device = dev
    bst.best_iteration = best_iteration
    bst.best_score = best_score
    bst.config = cfg
    bst._gbdt = glue(trees)
    # the ring's buffers go with it: a kept model holds only its numbers
    bst._ingest_stats = {"h2d_bytes": ring.h2d_bytes}
    if ring.profile:
        bst._ingest_stats.update(ring.stall_stats())
    return bst
