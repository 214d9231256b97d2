"""Command-line application: ``python -m lightgbm_tpu_torch
[config=train.conf] [key=value ...]``.

Port of ``lightgbm_tpu/cli.py`` (LightGBM src/main.cpp:11 and
src/application/application.cpp:31-265): parse ``key=value`` args and a
config file, dispatch on config.task: train / predict / refit /
convert_model; data loaded from config.data with ``.weight`` / ``.query``
sidecar files; the model written to config.output_model, predictions to
config.output_result.  Config files use the reference's ``key = value``
format with ``#`` comments, so the same train.conf gives both packages'
CLIs the same model file.

The run takes the card unless the params name the CPU
(``device_type=cpu``, as ``train`` reads them).  The ``profile`` verb
wraps a run in ``torch.profiler`` where the reference takes
``jax.profiler``.  The reference's ``serve``, ``serve-fleet`` and
``lint-trace`` / ``lint-mem`` verbs (and ``task=serve``) raise
``NotImplementedError`` naming ROADMAP queue 1: the serving tier is item
11b, the program-contract lints item 12.
"""

from __future__ import annotations

import sys
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster
from .config import Config, parse_config_file
from .dataset import Dataset
from .engine import train as train_api
from .io_utils import load_sidecar
from .resilience.checkpoint import TrainingPreempted
from .utils.log import log_fatal, log_info, log_warning


def parse_cli_args(argv: List[str]) -> Dict[str, Any]:
    """``key=value`` arguments + optional config file, command line wins
    (reference application.cpp:52 LoadParameters).  ``--resume`` (bare)
    is sugar for ``resume=latest``; ``--key=value`` strips the dashes."""
    cli: Dict[str, Any] = {}
    for arg in argv:
        if arg.startswith("--"):
            arg = arg[2:]
            if "=" not in arg:
                if arg.strip() == "resume":
                    cli["resume"] = "latest"
                else:
                    # unknown bare flags must not silently become
                    # key=true params (they would land in Config.extra
                    # and leak into the saved model text)
                    log_warning(f"unknown CLI flag ignored: --{arg.strip()}")
                continue
        if "=" not in arg:
            log_warning(f"unknown CLI argument ignored: {arg}")
            continue
        key, value = arg.split("=", 1)
        cli[key.strip()] = value.strip()
    params: Dict[str, Any] = {}
    conf = cli.get("config", cli.get("config_file", ""))
    if conf:
        params.update(parse_config_file(conf))
    params.update(cli)
    return params


def _load_dataset(path: str, params: Dict[str, Any],
                  reference: Optional[Dataset] = None) -> Dataset:
    ds = Dataset(path, params=params) if reference is None else \
        reference.create_valid(path)
    weight = load_sidecar(path, "weight")
    if weight is not None:
        ds.set_weight(weight)
    group = load_sidecar(path, "query")
    if group is None:
        group = load_sidecar(path, "group")
    if group is not None:
        ds.set_group(group.astype(np.int64))
    return ds


def run_train(params: Dict[str, Any], cfg: Config) -> None:
    if not cfg.data:
        log_fatal("task=train needs data=<training file>")
    train_set = _load_dataset(cfg.data, params)
    valid_sets = []
    valid_names = []
    if cfg.valid:
        for i, path in enumerate(str(cfg.valid).split(",")):
            path = path.strip()
            if path:
                valid_sets.append(_load_dataset(path, params,
                                                reference=train_set))
                valid_names.append(f"valid_{i}" if i else "valid_1")
    try:
        booster = train_api(params, train_set,
                            num_boost_round=int(cfg.num_iterations),
                            valid_sets=valid_sets or None,
                            valid_names=valid_names or None)
    except TrainingPreempted as exc:
        # graceful drain done, final checkpoint flushed; exit with the
        # conventional 128+signum so orchestrators see the signal death
        # and re-schedule — the rescheduled run resumes with --resume
        log_warning(f"{exc}; restart with --resume (or resume=latest) "
                    f"to continue this run")
        raise SystemExit(128 + int(exc.signum))
    booster.save_model(cfg.output_model)
    log_info(f"Finished training; model saved to {cfg.output_model}")


def run_predict(params: Dict[str, Any], cfg: Config) -> None:
    if not cfg.input_model:
        log_fatal("task=predict needs input_model=<model file>")
    if not cfg.data:
        log_fatal("task=predict needs data=<data file>")
    booster = Booster(model_file=cfg.input_model, params=params)
    from .io_utils import load_data_file
    X, _, _ = load_data_file(cfg.data, params)
    preds = booster.predict(
        X,
        raw_score=bool(cfg.predict_raw_score),
        pred_leaf=bool(cfg.predict_leaf_index),
        pred_contrib=bool(cfg.predict_contrib),
        start_iteration=int(cfg.start_iteration_predict),
        num_iteration=(None if cfg.num_iteration_predict < 0
                       else int(cfg.num_iteration_predict)))
    out = np.atleast_1d(np.asarray(preds))
    with open(cfg.output_result, "w") as fh:
        if out.ndim == 1:
            fh.write("\n".join(f"{v:.18g}" for v in out) + "\n")
        else:
            for row in out:
                fh.write("\t".join(f"{v:.18g}" for v in row) + "\n")
    log_info(f"Finished prediction; results saved to {cfg.output_result}")


def run_refit(params: Dict[str, Any], cfg: Config) -> None:
    """task=refit / refit_tree (reference application.cpp refit path)."""
    if not cfg.input_model or not cfg.data:
        log_fatal("task=refit needs input_model= and data=")
    booster = Booster(model_file=cfg.input_model, params=params)
    from .io_utils import load_data_file
    X, _, label = load_data_file(cfg.data, params)
    if label is None:
        log_fatal("refit data must include labels")
    new_booster = booster.refit(X, label,
                                decay_rate=float(cfg.refit_decay_rate))
    new_booster.save_model(cfg.output_model)
    log_info(f"Finished refit; model saved to {cfg.output_model}")


def run_convert_model(params: Dict[str, Any], cfg: Config) -> None:
    """task=convert_model: emit the ensemble as standalone C++ if-else code
    (reference gbdt_model_text.cpp:124 ModelToIfElse)."""
    if not cfg.input_model:
        log_fatal("task=convert_model needs input_model=")
    if cfg.convert_model_language not in ("", "cpp"):
        log_fatal(f"convert_model_language="
                  f"{cfg.convert_model_language} not supported (cpp only)")
    booster = Booster(model_file=cfg.input_model, params=params)
    code = model_to_if_else(booster._gbdt)
    with open(cfg.convert_model, "w") as fh:
        fh.write(code)
    log_info(f"Finished converting model; code saved to {cfg.convert_model}")


def model_to_if_else(gbdt) -> str:
    """Standalone C++ prediction source for the ensemble (reference
    gbdt_model_text.cpp ModelToIfElse — per-tree branchy functions plus a
    summing PredictRaw)."""
    lines = ["#include <cmath>", "#include <cstring>", "",
             "// generated by lightgbm_tpu convert_model", ""]
    names = []
    for t, tree in enumerate(gbdt.models):
        name = f"PredictTree{t}"
        names.append(name)
        lines.append(f"static double {name}(const double* row) {{")

        def emit(node: int, indent: str) -> None:
            if node < 0:
                lines.append(f"{indent}return "
                             f"{tree.leaf_value[~node]:.17g};")
                return
            f_idx = int(tree.split_feature[node])
            dt = int(tree.decision_type[node])
            if dt & 1:  # categorical set membership
                cats = tree.cat_values(node)
                cond = " || ".join(
                    f"(long)row[{f_idx}] == {c}" for c in cats) or "false"
                cond = f"(!std::isnan(row[{f_idx}]) && ({cond}))"
                if dt & 2:
                    cond = f"(std::isnan(row[{f_idx}]) || {cond})"
            else:
                thr = float(tree.threshold[node])
                base = f"row[{f_idx}] <= {thr:.17g}"
                if (dt >> 2) & 3 == 2:  # missing nan
                    if dt & 2:
                        cond = f"(std::isnan(row[{f_idx}]) || ({base}))"
                    else:
                        cond = f"(!std::isnan(row[{f_idx}]) && ({base}))"
                else:
                    cond = (f"((std::isnan(row[{f_idx}]) ? 0.0 : "
                            f"row[{f_idx}]) <= {thr:.17g})")
            lines.append(f"{indent}if ({cond}) {{")
            emit(int(tree.left_child[node]), indent + "  ")
            lines.append(f"{indent}}} else {{")
            emit(int(tree.right_child[node]), indent + "  ")
            lines.append(f"{indent}}}")

        if tree.num_leaves <= 1:
            lines.append(f"  return {tree.leaf_value[0]:.17g};")
        else:
            emit(0, "  ")
        lines.append("}")
        lines.append("")
    lines.append("extern \"C\" double PredictRaw(const double* row) {")
    lines.append("  double sum = 0.0;")
    for name in names:
        lines.append(f"  sum += {name}(row);")
    lines.append("  return sum;")
    lines.append("}")
    return "\n".join(lines) + "\n"


def run_profile(argv: List[str]) -> int:
    """``python -m lightgbm_tpu_torch profile [config=train.conf]
    [key=value ...]``

    Wraps a train, predict or refit run (``config.task``, default train)
    in a ``torch.profiler`` capture (the CPU's activity, and the card's
    when the run has one) and writes into ``<profile_dir>/``:

      * ``trace.json``   — the capture as a chrome trace, unless
        ``torch_trace=0`` (the reference's ``jax_trace`` key is read the
        same);
      * ``profile.txt``  — ``key_averages()`` as a table, by total time.

    Keys consumed here: ``profile_dir`` (default ``lgbm_tpu_profile``),
    ``torch_trace`` / ``jax_trace`` (1).  The reference's
    ``telemetry_out`` and ``host_trace_out`` (its span tracer and
    TrainRecord, ROADMAP queue 1 item 11b) are refused.
    """
    import contextlib
    import os
    params = parse_cli_args(argv)
    for key in ("telemetry_out", "host_trace_out"):
        if params.get(key):
            raise NotImplementedError(
                f"profile {key}=: the telemetry span tracer and train "
                "record are not ported (ROADMAP queue 1 item 11b)")
    prof_dir = str(params.pop("profile_dir", "lgbm_tpu_profile"))
    flag = params.pop("torch_trace", params.pop("jax_trace", "1"))
    trace = str(flag).strip().lower() not in ("0", "false", "no", "off")
    os.makedirs(prof_dir, exist_ok=True)
    cfg = Config(params)
    task = cfg.task or "train"
    if task not in ("train", "predict", "refit"):
        log_fatal(f"profile wraps task=train/predict/refit only, got "
                  f"task={task}")
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    capture = profile(activities=acts) if trace else \
        contextlib.nullcontext()
    with capture:
        if task == "train":
            run_train(params, cfg)
        elif task == "predict":
            run_predict(params, cfg)
        else:
            run_refit(params, cfg)
    if trace:
        capture.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
        with open(os.path.join(prof_dir, "profile.txt"), "w") as fh:
            fh.write(capture.key_averages().table(
                sort_by="self_cpu_time_total", row_limit=60) + "\n")
    log_info(f"profile: {task} done" +
             (f", capture in {prof_dir}" if trace else ""))
    return 0


def _unported(verb: str, item: str) -> None:
    raise NotImplementedError(
        f"'{verb}' is not ported to lightgbm_tpu_torch yet (ROADMAP "
        f"queue 1 item {item})")


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in ("serve", "serve-fleet", "serve_fleet"):
        _unported(argv[0], "11b: the serving tier")
    if argv and argv[0] == "profile":
        # profiling verb: python -m lightgbm_tpu_torch profile config=...
        return run_profile(argv[1:])
    if argv and argv[0] in ("lint-trace", "lint_trace", "lint-mem",
                            "lint_mem"):
        _unported(argv[0], "12: the program contracts")
    params = parse_cli_args(argv)
    cfg = Config(params)
    task = cfg.task
    if task == "train":
        run_train(params, cfg)
    elif task == "predict":
        run_predict(params, cfg)
    elif task == "refit":
        run_refit(params, cfg)
    elif task == "convert_model":
        run_convert_model(params, cfg)
    elif task == "serve":
        _unported("task=serve", "11b: the serving tier")
    else:
        log_fatal(f"unknown task: {task}")
    return 0
