"""Config / parameter system.

TPU-native re-implementation of the reference parameter surface
(reference: include/LightGBM/config.h:34 ``struct Config``, alias table in
src/io/config_auto.cpp:10 ``Config::alias_table``).  The reference drives its
parsing code off doc-comments via helpers/parameter_generator.py; here the
single source of truth is the ``_PARAMS`` schema table below, from which
parsing, alias resolution, validation and docs are all derived.

Every parameter keeps the reference's canonical name, aliases, default and
constraint so user params written for the reference work unmodified
(``device_type='tpu'`` is the only new value).


Copy of ``lightgbm_tpu/config.py`` (numpy only) kept inside the PyTorch port so
the port never imports the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["Config", "ParamSpec", "PARAM_ALIASES", "resolve_param_aliases"]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    name: str
    type: type
    default: Any
    aliases: Tuple[str, ...] = ()
    check: Optional[str] = None  # human-readable constraint, e.g. ">=0.0"


def _p(name, typ, default, aliases=(), check=None):
    return ParamSpec(name, typ, default, tuple(aliases), check)


# Schema mirroring reference include/LightGBM/config.h declarations (line refs
# there).  Types: bool/int/float/str and list[...] for vector params.
_PARAMS: List[ParamSpec] = [
    # --- core (config.h:93-268) ---
    _p("config", str, "", ("config_file",)),
    _p("task", str, "train", ("task_type",)),
    _p("objective", str, "regression", ("objective_type", "app", "application")),
    _p("boosting", str, "gbdt", ("boosting_type", "boost")),
    _p("linear_tree", bool, False),
    _p("data", str, "", ("train", "train_data", "train_data_file", "data_filename")),
    _p("valid", str, "", ("test", "valid_data", "valid_data_file", "test_data",
                          "test_data_file", "valid_filenames")),
    _p("num_iterations", int, 100,
       ("num_iteration", "n_iter", "num_tree", "num_trees", "num_round",
        "num_rounds", "num_boost_round", "n_estimators"), check=">=0"),
    _p("learning_rate", float, 0.1, ("shrinkage_rate", "eta"), check=">0.0"),
    _p("num_leaves", int, 31, ("num_leaf", "max_leaves", "max_leaf"), check="1<v<=131072"),
    _p("tree_learner", str, "serial", ("tree", "tree_type", "tree_learner_type")),
    _p("num_threads", int, 0, ("num_thread", "nthread", "nthreads", "n_jobs")),
    _p("device_type", str, "tpu", ("device",)),
    _p("seed", int, 0, ("random_seed", "random_state")),
    _p("deterministic", bool, False),
    _p("force_col_wise", bool, False),
    _p("force_row_wise", bool, False),
    _p("histogram_pool_size", float, -1.0, ("hist_pool_size",)),
    _p("max_depth", int, -1),
    _p("min_data_in_leaf", int, 20, ("min_data_per_leaf", "min_data", "min_child_samples"),
       check=">=0"),
    _p("min_sum_hessian_in_leaf", float, 1e-3,
       ("min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian", "min_child_weight"),
       check=">=0.0"),
    # --- learning control (config.h:292-546) ---
    _p("bagging_fraction", float, 1.0, ("sub_row", "subsample", "bagging"),
       check="0.0<v<=1.0"),
    _p("pos_bagging_fraction", float, 1.0, ("pos_sub_row", "pos_subsample", "pos_bagging"),
       check="0.0<v<=1.0"),
    _p("neg_bagging_fraction", float, 1.0, ("neg_sub_row", "neg_subsample", "neg_bagging"),
       check="0.0<v<=1.0"),
    _p("bagging_freq", int, 0, ("subsample_freq",)),
    _p("bagging_seed", int, 3, ("bagging_fraction_seed",)),
    _p("feature_fraction", float, 1.0, ("sub_feature", "colsample_bytree"),
       check="0.0<v<=1.0"),
    _p("feature_fraction_bynode", float, 1.0, ("sub_feature_bynode", "colsample_bynode"),
       check="0.0<v<=1.0"),
    _p("feature_fraction_seed", int, 2),
    _p("extra_trees", bool, False),
    _p("extra_seed", int, 6),
    _p("early_stopping_round", int, 0,
       ("early_stopping_rounds", "early_stopping", "n_iter_no_change")),
    _p("first_metric_only", bool, False),
    _p("max_delta_step", float, 0.0, ("max_tree_output", "max_leaf_output")),
    _p("lambda_l1", float, 0.0, ("reg_alpha",), check=">=0.0"),
    _p("lambda_l2", float, 0.0, ("reg_lambda", "lambda"), check=">=0.0"),
    _p("linear_lambda", float, 0.0, check=">=0.0"),
    _p("min_gain_to_split", float, 0.0, ("min_split_gain",), check=">=0.0"),
    _p("drop_rate", float, 0.1, ("rate_drop",), check="0.0<=v<=1.0"),
    _p("max_drop", int, 50),
    _p("skip_drop", float, 0.5, check="0.0<=v<=1.0"),
    _p("xgboost_dart_mode", bool, False),
    _p("uniform_drop", bool, False),
    _p("drop_seed", int, 4),
    _p("top_rate", float, 0.2, check="0.0<=v<=1.0"),
    _p("other_rate", float, 0.1, check="0.0<=v<=1.0"),
    _p("min_data_per_group", int, 100, check=">0"),
    _p("max_cat_threshold", int, 32, check=">0"),
    _p("cat_l2", float, 10.0, check=">=0.0"),
    _p("cat_smooth", float, 10.0, check=">=0.0"),
    _p("max_cat_to_onehot", int, 4, check=">0"),
    _p("top_k", int, 20, ("topk",), check=">0"),
    _p("monotone_constraints", list, None, ("mc", "monotone_constraint")),
    _p("monotone_constraints_method", str, "basic",
       ("monotone_constraining_method", "mc_method")),
    _p("monotone_penalty", float, 0.0, ("monotone_splits_penalty", "ms_penalty", "mc_penalty"),
       check=">=0.0"),
    _p("feature_contri", list, None, ("feature_contrib", "fc", "fp", "feature_penalty")),
    _p("forcedsplits_filename", str, "",
       ("fs", "forced_splits_filename", "forced_splits_file", "forced_splits")),
    _p("refit_decay_rate", float, 0.9, check="0.0<=v<=1.0"),
    _p("cegb_tradeoff", float, 1.0, check=">=0.0"),
    _p("cegb_penalty_split", float, 0.0, check=">=0.0"),
    _p("cegb_penalty_feature_lazy", list, None),
    _p("cegb_penalty_feature_coupled", list, None),
    _p("path_smooth", float, 0.0, check=">=0.0"),
    _p("interaction_constraints", str, ""),
    _p("verbosity", int, 1, ("verbose",)),
    # --- IO / model (config.h:559-711) ---
    _p("input_model", str, "", ("model_input", "model_in")),
    _p("output_model", str, "LightGBM_model.txt", ("model_output", "model_out")),
    _p("saved_feature_importance_type", int, 0),
    _p("snapshot_freq", int, -1, ("save_period",)),
    # fault tolerance (resilience/checkpoint.py): full-state checkpoint
    # bundles next to the reference's model-text snapshots.  checkpoint_dir
    # defaults to "<output_model>.ckpt" when snapshot_freq > 0; setting it
    # explicitly enables checkpointing even without snapshot_freq (then
    # every iteration).  resume: "" (off), "latest"/"auto" (newest bundle
    # in checkpoint_dir; cold-start friendly), or a bundle/directory path.
    _p("checkpoint_dir", str, "", ("checkpoint_directory",)),
    _p("checkpoint_keep", int, 3, ("checkpoint_ring",), check=">0"),
    _p("resume", str, "", ("resume_from",)),
    # training flight recorder (telemetry/flight.py): bounded ring of
    # per-iteration structured events, dumped to JSONL by the
    # PreemptionGuard/crash path (into flight_dir, defaulting to the
    # checkpoint dir).  Observation-only run directives like resume/
    # checkpoint_dir: excluded from the model-text params dump so
    # recorder-on and recorder-off models match byte for byte.
    _p("flight_recorder", bool, True),
    _p("flight_events", int, 1024, check=">0"),
    _p("flight_dir", str, ""),
    _p("max_bin", int, 255, check="1<v<=65535"),
    _p("min_data_in_bin", int, 3, check=">0"),
    _p("bin_construct_sample_cnt", int, 200000, ("subsample_for_bin",), check=">0"),
    _p("data_random_seed", int, 1, ("data_seed",)),
    _p("is_enable_sparse", bool, True, ("is_sparse", "enable_sparse", "sparse")),
    _p("enable_bundle", bool, True, ("is_enable_bundle", "bundle")),
    _p("use_missing", bool, True),
    _p("zero_as_missing", bool, False),
    _p("feature_pre_filter", bool, True),
    _p("pre_partition", bool, False, ("is_pre_partition",)),
    _p("two_round", bool, False, ("two_round_loading", "use_two_round_loading")),
    _p("header", bool, False, ("has_header",)),
    _p("label_column", str, "", ("label",)),
    _p("weight_column", str, "", ("weight",)),
    _p("group_column", str, "",
       ("group", "group_id", "query_column", "query", "query_id")),
    _p("ignore_column", str, "", ("ignore_feature", "blacklist")),
    _p("categorical_feature", str, "", ("cat_feature", "categorical_column", "cat_column")),
    _p("forcedbins_filename", str, ""),
    _p("save_binary", bool, False, ("is_save_binary", "is_save_binary_file")),
    # --- predict (config.h:721-779) ---
    _p("start_iteration_predict", int, 0),
    _p("num_iteration_predict", int, -1),
    _p("predict_raw_score", bool, False,
       ("is_predict_raw_score", "predict_rawscore", "raw_score")),
    _p("predict_leaf_index", bool, False, ("is_predict_leaf_index", "leaf_index")),
    _p("predict_contrib", bool, False, ("is_predict_contrib", "contrib")),
    _p("predict_disable_shape_check", bool, False),
    _p("pred_early_stop", bool, False),
    _p("pred_early_stop_freq", int, 10),
    _p("pred_early_stop_margin", float, 10.0),
    _p("output_result", str, "LightGBM_predict_result.txt",
       ("predict_result", "prediction_result", "predict_name", "prediction_name",
        "pred_name", "name_pred")),
    # --- convert (config.h:790-797) ---
    _p("convert_model_language", str, ""),
    _p("convert_model", str, "gbdt_prediction.cpp", ("convert_model_file",)),
    # --- objective (config.h:807-874) ---
    _p("objective_seed", int, 5),
    _p("num_class", int, 1, ("num_classes",), check=">0"),
    _p("is_unbalance", bool, False, ("unbalance", "unbalanced_sets")),
    _p("scale_pos_weight", float, 1.0, check=">0.0"),
    _p("sigmoid", float, 1.0, check=">0.0"),
    _p("boost_from_average", bool, True),
    _p("reg_sqrt", bool, False),
    _p("alpha", float, 0.9, check=">0.0"),
    _p("fair_c", float, 1.0, check=">0.0"),
    _p("poisson_max_delta_step", float, 0.7, check=">0.0"),
    _p("tweedie_variance_power", float, 1.5, check="1.0<=v<2.0"),
    _p("lambdarank_truncation_level", int, 30, check=">0"),
    _p("lambdarank_norm", bool, True),
    _p("label_gain", list, None),
    # --- metric (config.h:925-946) ---
    _p("metric", list, None, ("metrics", "metric_types")),
    _p("metric_freq", int, 1, ("output_freq",), check=">0"),
    _p("is_provide_training_metric", bool, False,
       ("training_metric", "is_training_metric", "train_metric")),
    _p("eval_at", list, None, ("ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at")),
    _p("multi_error_top_k", int, 1, check=">0"),
    _p("auc_mu_weights", list, None),
    # --- network (config.h:965-984) ---
    _p("num_machines", int, 1, ("num_machine",), check=">0"),
    _p("local_listen_port", int, 12400, ("local_port", "port"), check=">0"),
    _p("time_out", int, 120, check=">0"),
    _p("machine_list_filename", str, "", ("machine_list_file", "machine_list", "mlist")),
    _p("machines", str, "", ("workers", "nodes")),
    # --- device (config.h:993-1006; TPU additions) ---
    _p("gpu_platform_id", int, -1),
    _p("gpu_device_id", int, -1),
    _p("gpu_use_dp", bool, False),
    _p("num_gpu", int, 1, check=">0"),
    # TPU-specific knobs (new in this framework)
    # auto | segment | onehot | pallas | packed4 ("packed4" = the XLA
    # joint-nibble scatter formulation for max_bin<=16 data — two 4-bit
    # codes share one byte and one scatter builds BOTH features'
    # histograms; the CPU analog of the Pallas kernels' packed layout)
    _p("tpu_histogram_impl", str, "auto"),
    # Pallas histogram kernel pipeline: auto (= dma on TPU, blockspec
    # under off-TPU interpretation) | dma (explicit
    # double-buffered HBM->VMEM async-copy streaming overlapping the MXU
    # contraction) | blockspec (the v1 implicit per-grid-step fetch,
    # kept for A/B re-probing per PERF.md's measured-dead-ends rule)
    _p("tpu_pallas_pipeline", str, "auto"),
    # 4-bit bin packing (reference src/io/dense_bin.hpp 4-bit bins):
    # when every feature fits a nibble (max_bin <= 16) the wave grower's
    # device bin matrix stores two bin codes per int8 lane and the
    # Pallas kernels unpack in VMEM — half the streamed/held bin bytes
    _p("tpu_hist_pack4", bool, True),
    _p("tpu_rows_per_chunk", int, 0),        # 0 = auto-tune
    _p("tpu_double_precision_gain", bool, False),  # like gpu_use_dp for split gains
    # tree_grow_mode: auto | wave | partition.  "wave" = leaf-wise growth
    # with MXU leaf-batched histograms and no row movement (learner/wave.py,
    # up to tpu_wave_size splits committed per wave); "partition" = exact
    # sequential leaf-wise with leaf-contiguous packed rows
    # (learner/partitioned.py).  "auto" picks wave on TPU when no
    # wave-incompatible feature (forced splits / interaction constraints /
    # bynode sampling) is active.
    _p("tree_grow_mode", str, "auto"),
    # 0 = the kernel maximum (25 leaves/pass exact bf16, 42 quantized i8)
    _p("tpu_wave_size", int, 0, check=">=0"),
    # speculative ramp (learner/wave.py): grow a provisional subtree on a
    # row subsample, verify it against ONE full-data multi-channel
    # histogram pass, and commit every provisional split whose exact gain
    # is within tpu_spec_tolerance of that node's exact best — the
    # frontier ramp (1 -> 2 -> 4 ... leaves) collapses from ~log2(W)
    # full-data passes into one.  Exactness: every committed split's
    # gain/sums are computed from full data; the subsample only GUESSES
    # which splits to precompute.  Applies on the serial Pallas wave path
    # for numeric-only datasets with num_leaves >= 3*wave_size.
    _p("tpu_speculative_ramp", bool, True),
    _p("tpu_spec_tolerance", float, 0.3, check=">=0.0"),
    # exact device-side endgame (learner/wave.py + learner/endgame.py):
    # once the remaining leaf budget drops below 2*wave_size, ONE batched
    # kernel pass precomputes the frontier candidates' smaller-child
    # histograms (larger siblings via subtraction) and the remaining
    # splits are selected by the TRUE sequential best-first order in an
    # on-device while loop over the cached histogram bank — no more
    # full-data passes per taper wave.  Replaces the wave-halving taper
    # on numeric non-EFB shapes; reproduces the exact leaf-wise order.
    _p("tpu_exact_endgame", bool, True),
    # feature-sliced reduce-scatter histogram merging on the DP wave path
    # (learner/wave.py + parallel/data_parallel.py): each wave's histogram
    # batch is psum_scatter'd over a static feature-block axis so every
    # chip materializes only its F/k slice of the merged histogram, scans
    # that slice, and a tiny O(W*k) winner exchange picks the global best
    # split per frontier leaf — the reference DP learner's ReduceScatter
    # refinement (data_parallel_tree_learner.cpp:155-173) applied to the
    # wave path: ~1/k the ICI bytes and 1/k the scan FLOPs per pass.
    # False = the former full-histogram allreduce (one psum per wave).
    # Falls back to allreduce automatically for categorical/EFB/forced-
    # split/lazy-CEGB configurations; results are identical either way.
    _p("tpu_dp_hist_scatter", bool, True),
    _p("num_devices", int, 0),               # 0 = all visible devices
    # --- gradient quantization (config.h use_quantized_grad block;
    # gradient_discretizer.cpp) — int8 histogram training on the MXU
    # (ops/histogram_pallas.py build_histogram_pallas_leaves_q8).  Levels
    # beyond the reference's default 4 are free on the int8 lanes, up to
    # 254 (clamped to the int8 payload).
    _p("use_quantized_grad", bool, False),
    _p("num_grad_quant_bins", int, 4, check=">1"),
    _p("quant_train_renew_leaf", bool, False),
    _p("stochastic_rounding", bool, True),
    # --- one-program multi-model training (lightgbm_tpu/multitrain/) ---
    # tpu_cv_many: route engine.cv() through the vmapped train_many fast
    # path (folds = models with held-out sample masks sharing ONE binned
    # dataset and ONE compiled program) whenever the configuration
    # supports it; False = the per-fold boosting loop.
    _p("tpu_cv_many", bool, True),
    # cap on models trained in one compiled batch; larger variant sets
    # are chunked (HBM for stacked scores/histograms scales with M)
    _p("tpu_multitrain_batch", int, 256, check=">0"),
    # shard the model axis over local devices (pmap of the vmapped
    # grower) when the batch width divides the device count — every
    # chip grows M/k models concurrently; False = single-device vmap
    _p("tpu_multitrain_shard", bool, True),
    # out-of-core ingest (lightgbm_tpu/ingest/): how a StreamedDataset
    # trains.  "hbm" = upload the streamed binned cache to HBM once and
    # run the normal growers (bit-identical to in-core training on every
    # path); "chunked" = chunk-accumulated wave histograms with a
    # rows-independent HBM budget (the 10^8-10^9-row regime; envelope
    # checked by ingest/train.py).  An execution-strategy directive like
    # resume/checkpoint_dir: it never changes the model (quantized path)
    # and is excluded from the model-text params dump.
    _p("tpu_ingest_mode", str, "hbm"),
    # --- inference compiler (serve/compiler.py) ---
    # dense = force the fused dense program (threshold compares,
    # categorical bitset-membership contraction, quantized leaf tables);
    # walk = the sequential per-tree walk; auto = dense whenever the
    # ensemble lowers AND the device profits (always on cuda; on the CPU
    # the reference's cost model keeps the walk where it measured faster
    # and RECORDS the fallback reason in the serve_compiler_fallback
    # counter).
    _p("tpu_predict_compiler", str, "auto"),
    # leaf-table quantization for the dense program: 0 = exact f32
    # leaves, 8/16 = i8/i16 leaf codes + per-tree f32 scale dequantized
    # in the final contraction (abs error <= sum of per-tree scales / 2)
    _p("tpu_predict_leaf_bits", int, 0),
    # shard the dense program's tree axis over this many devices (0/1 =
    # single device); > 1 raises until the port serves across cards
    # (ROADMAP queue 1 item 10)
    _p("tpu_predict_shard", int, 0, check=">=0"),
    # --- explanation compiler (explain/) ---
    # dense = force the loop-free dense TreeSHAP program (per-leaf
    # root-path slot tensors contracted with the serving program's
    # condition matrix; exact f32 leaf values, never quantized); walk = the host
    # TreeSHAP recursion (models/shap.py); auto = dense whenever the
    # ensemble lowers — no CPU cost model: the host walk is Python-
    # recursive, so the vectorized program wins on every backend — with
    # any lowering fallback (depth/table budget) RECORDED in the
    # serve_explain_fallback counter, never silent
    _p("tpu_explain_compiler", str, "auto"),
    # --- continuous-learning lane (publish/; cv, train_many and the
    # chunked train_streamed raise on these: the reference's have no
    # publish lane) ---
    # publish_dir: when set, the trainer appends a per-round model delta
    # journal there (publish/delta.py) every publish_every rounds (0 =
    # every round) plus a forced publish on the preemption drain path
    # and at completion.  Run directives like checkpoint_dir: excluded
    # from the model-text params dump so publishing runs serialize byte-
    # identically to non-publishing ones.
    _p("publish_dir", str, ""),
    _p("publish_every", int, 0, check=">=0"),
]

PARAM_SCHEMA: Dict[str, ParamSpec] = {p.name: p for p in _PARAMS}

# alias -> canonical name (reference src/io/config_auto.cpp:10-168)
PARAM_ALIASES: Dict[str, str] = {}
for _spec in _PARAMS:
    for _a in _spec.aliases:
        PARAM_ALIASES[_a] = _spec.name

_OBJECTIVE_ALIASES = {
    # regression family (config.h:113-121)
    "regression_l2": "regression", "l2": "regression", "mean_squared_error": "regression",
    "mse": "regression", "l2_root": "regression", "root_mean_squared_error": "regression",
    "rmse": "regression",
    "l1": "regression_l1", "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "mean_absolute_percentage_error": "mape",
    # classification
    "softmax": "multiclass", "multiclass_ova": "multiclassova", "ova": "multiclassova",
    "ovr": "multiclassova",
    # cross-entropy
    "xentropy": "cross_entropy", "xentlambda": "cross_entropy_lambda",
    # ranking
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg", "xe_ndcg_mart": "rank_xendcg",
    "xendcg_mart": "rank_xendcg",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

_BOOSTING_ALIASES = {"gbrt": "gbdt", "random_forest": "rf"}

_TREE_LEARNER_ALIASES = {
    "feature_parallel": "feature", "data_parallel": "data", "voting_parallel": "voting",
}

_TASK_ALIASES = {"training": "train", "prediction": "predict", "test": "predict",
                 "refit_tree": "refit"}


def resolve_param_aliases(params: Dict[str, Any]) -> Dict[str, Any]:
    """Map alias keys to canonical keys (first writer wins, like
    ParameterAlias::KeyAliasTransform in the reference's config_auto.cpp)."""
    out: Dict[str, Any] = {}
    for k, v in params.items():
        canonical = PARAM_ALIASES.get(k, k)
        if canonical in out and out[canonical] != v:
            # canonical name beats alias; earlier alias beats later alias
            if k == canonical:
                out[canonical] = v
        else:
            out[canonical] = v
    return out


def _coerce(spec: ParamSpec, value: Any) -> Any:
    if value is None:
        return None
    if spec.type is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("true", "1", "yes", "+", "t")
        return bool(value)
    if spec.type is int:
        return int(value)
    if spec.type is float:
        return float(value)
    if spec.type is list:
        if isinstance(value, str):
            if not value.strip():
                return None
            return [_maybe_num(s) for s in value.replace(" ", "").split(",")]
        if isinstance(value, (list, tuple)):
            return list(value)
        return [value]
    return str(value)


def _maybe_num(s: str) -> Any:
    try:
        return int(s)
    except ValueError:
        try:
            return float(s)
        except ValueError:
            return s


class Config:
    """Typed parameter container (reference config.h:34).

    Construct from a dict of user params (aliases allowed); unknown keys are
    kept in ``extra`` so custom objective params pass through.
    """

    def __init__(self, params: Optional[Dict[str, Any]] = None, **kw: Any) -> None:
        merged = dict(params or {})
        merged.update(kw)
        merged = resolve_param_aliases(merged)
        self.extra: Dict[str, Any] = {}
        for spec in _PARAMS:
            object.__setattr__(self, spec.name, spec.default)
        for key, value in merged.items():
            if key in PARAM_SCHEMA:
                setattr(self, key, _coerce(PARAM_SCHEMA[key], value))
            else:
                self.extra[key] = value
        self._post_process()
        self._validate()

    def _post_process(self) -> None:
        self.objective = _OBJECTIVE_ALIASES.get(self.objective, self.objective)
        self.boosting = _BOOSTING_ALIASES.get(self.boosting, self.boosting)
        self.tree_learner = _TREE_LEARNER_ALIASES.get(self.tree_learner, self.tree_learner)
        self.task = _TASK_ALIASES.get(self.task, self.task)
        if self.eval_at is None:
            self.eval_at = [1, 2, 3, 4, 5]
        if self.label_gain is None:
            # reference config.cpp: default label_gain = 2^i - 1
            self.label_gain = [float((1 << i) - 1) for i in range(31)]
        # reference config.cpp:216-232: seed cascades to sub-seeds when set
        if self.seed != 0:
            import random as _random
            rng = _random.Random(self.seed)
            for sub in ("data_random_seed", "bagging_seed", "drop_seed",
                        "feature_fraction_seed", "extra_seed", "objective_seed"):
                setattr(self, sub, rng.randint(0, 2 ** 31 - 1))

    def _validate(self) -> None:
        checks = [
            (self.num_leaves >= 2, "num_leaves must be >=2"),
            (1 < self.max_bin <= 65535, "max_bin must be in (1, 65535]"),
            (0.0 < self.bagging_fraction <= 1.0, "bagging_fraction in (0,1]"),
            (0.0 < self.feature_fraction <= 1.0, "feature_fraction in (0,1]"),
            (self.lambda_l1 >= 0.0, "lambda_l1 must be >=0"),
            (self.lambda_l2 >= 0.0, "lambda_l2 must be >=0"),
            (self.min_data_in_leaf >= 0, "min_data_in_leaf must be >=0"),
            (self.num_class >= 1, "num_class must be >=1"),
            (self.top_rate + self.other_rate <= 1.0,
             "top_rate + other_rate must be <=1 (GOSS)"),
            (not (self.force_col_wise and self.force_row_wise),
             "cannot set both force_col_wise and force_row_wise"),
            (self.tree_grow_mode in ("auto", "wave", "partition"),
             "tree_grow_mode must be one of auto|wave|partition"),
            (self.tpu_histogram_impl in ("auto", "segment", "onehot",
                                         "pallas", "packed4"),
             "tpu_histogram_impl must be auto|segment|onehot|pallas|"
             "packed4"),
            (self.tpu_pallas_pipeline in ("auto", "dma", "blockspec"),
             "tpu_pallas_pipeline must be auto|dma|blockspec"),
            (self.tpu_ingest_mode in ("hbm", "chunked"),
             "tpu_ingest_mode must be hbm|chunked"),
            (self.tpu_predict_compiler in ("auto", "dense", "walk"),
             "tpu_predict_compiler must be auto|dense|walk"),
            (self.tpu_predict_leaf_bits in (0, 8, 16),
             "tpu_predict_leaf_bits must be 0|8|16"),
            (self.tpu_explain_compiler in ("auto", "dense", "walk"),
             "tpu_explain_compiler must be auto|dense|walk"),
        ]
        for ok, msg in checks:
            if not ok:
                raise ValueError(f"Invalid parameter: {msg}")
        if self.objective in ("multiclass", "multiclassova") and self.num_class <= 1:
            raise ValueError("num_class must be >1 for multiclass objectives")

    # -- helpers -------------------------------------------------------------
    @property
    def num_model_per_iteration(self) -> int:
        """Trees per boosting iteration (reference multiclass_objective.hpp
        NumModelPerIteration): num_class for softmax/OVA, else 1."""
        if self.objective in ("multiclass", "multiclassova"):
            return self.num_class
        return 1

    @property
    def is_parallel(self) -> bool:
        return self.tree_learner != "serial"

    def to_dict(self) -> Dict[str, Any]:
        d = {p.name: getattr(self, p.name) for p in _PARAMS}
        d.update(self.extra)
        return d

    def update(self, params: Dict[str, Any]) -> "Config":
        merged = self.to_dict()
        merged.update(params)
        return Config(merged)

    def __repr__(self) -> str:
        diffs = {p.name: getattr(self, p.name) for p in _PARAMS
                 if getattr(self, p.name) != p.default}
        return f"Config({diffs})"


# Parameters that are parsed (for reference-config compatibility) but whose
# behavior is not implemented yet.  Training warns LOUDLY when one is set to
# a non-default value — a silent no-op would hand users a different model
# than the same params produce on the reference (VERDICT r2 "what's weak" #5).
# Entries are removed as features land; tests assert this list shrinks only.
# `deterministic` is intentionally absent: training is deterministic by
# construction (fixed seeds, static schedules, no atomics), which satisfies
# the flag's contract without a switch.
_UNIMPLEMENTED_PARAMS: Tuple[str, ...] = ()


def warn_unimplemented_params(config: "Config") -> None:
    """Warn about accepted-but-inert parameters set away from defaults
    (called at training setup; loading/prediction stays quiet)."""
    from .utils.log import log_warning
    for name in _UNIMPLEMENTED_PARAMS:
        spec = PARAM_SCHEMA.get(name)
        if spec is None:
            continue
        if getattr(config, name) != spec.default:
            log_warning(
                f"parameter '{name}' is accepted for config compatibility "
                f"but NOT implemented yet in lightgbm_tpu — it has no "
                f"effect on this training run")


def parse_config_file(path: str) -> Dict[str, Any]:
    """Parse a reference-style ``key = value`` CLI config file
    (reference src/application/application.cpp:52 + common.h KV parsing)."""
    params: Dict[str, Any] = {}
    with open(path) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            params[key.strip()] = value.strip()
    return params
