"""Model text serialization, reference-compatible.

Implements the reference's versioned model text format
(reference: src/boosting/gbdt_model_text.cpp:311 ``SaveModelToString`` — the
``version=v3`` header + per-tree blocks from src/io/tree.cpp:343
``Tree::ToString`` — and :583 model parsing; JSON dump per
gbdt_model_text.cpp:24 ``DumpModel``), so models interchange with the
reference implementation: a model trained here loads in reference LightGBM
and vice versa.

Split feature indices in the file are REAL (original column) indices; in
device tree arrays they are inner (used-feature) indices — the maps convert
on save/load (reference Dataset real<->inner feature mapping,
dataset.h:282).

Copy of ``lightgbm_tpu/models/model_text.py`` (numpy only) kept inside the PyTorch port so
the port never imports the JAX package."""

from __future__ import annotations

import io
from typing import Any, Dict, List

import numpy as np

from .tree import CAT_MASK, DEFAULT_LEFT_MASK, Tree

MODEL_VERSION = "v3"


class ModelCorruptError(ValueError):
    """A model text file/string is truncated or not a model at all.

    Typed so callers (serving registry reloads, checkpoint restore, CLI)
    can distinguish "this file is damaged" from ordinary ValueErrors;
    names the source and the byte offset where parsing failed — which
    for a crash-truncated file is its (short) length."""

    def __init__(self, source: str, offset: int, detail: str) -> None:
        super().__init__(f"{source}: corrupt or truncated model text at "
                         f"byte {offset}: {detail}")
        self.source = source
        self.offset = int(offset)


def _offset_of(lines: List[str], idx: int) -> int:
    """Byte offset of ``lines[idx]`` in the original utf-8 text (lines
    were split on '\\n', so each earlier line contributes len + 1)."""
    return sum(len(ln.encode("utf-8")) + 1 for ln in lines[:min(idx, len(lines))])


def _fmt(x: float) -> str:
    # %.17g round-trips doubles exactly (reference Common::DoubleToStr);
    # positional formatting would truncate tiny magnitudes to "0"
    return f"{float(x):.17g}"


def _join(arr, fmt=str) -> str:
    return " ".join(fmt(v) for v in arr)


def _objective_string(gbdt) -> str:
    cfg = gbdt.config
    obj = cfg.objective
    if obj == "binary":
        return f"binary sigmoid:{cfg.sigmoid:g}"
    if obj in ("multiclass", "multiclassova"):
        suffix = f" num_class:{cfg.num_class}"
        if obj == "multiclassova":
            return f"multiclassova{suffix} sigmoid:{cfg.sigmoid:g}"
        return f"multiclass{suffix}"
    if obj in ("lambdarank", "rank_xendcg"):
        return obj
    return obj


def _tree_to_string(tree: Tree, real_feature_map: np.ndarray, index: int) -> str:
    n_int = tree.num_internal()
    nl = tree.num_leaves
    buf = io.StringIO()
    buf.write(f"Tree={index}\n")
    buf.write(f"num_leaves={nl}\n")
    cat_nodes = [i for i in range(n_int)
                 if tree.decision_type[i] & CAT_MASK]
    buf.write(f"num_cat={len(cat_nodes)}\n")
    if nl > 1:
        real_feat = [int(real_feature_map[tree.split_feature[i]])
                     for i in range(n_int)]
        buf.write("split_feature=" + _join(real_feat) + "\n")
        buf.write("split_gain=" + _join(tree.split_gain[:n_int], _fmt) + "\n")
        # categorical nodes store the index into cat_boundaries as threshold;
        # cat_threshold carries the full bitset words over raw category
        # values (reference tree.cpp Tree::ToString cat fields)
        thresholds = []
        cat_boundaries = [0]
        cat_threshold: List[int] = []
        for i in range(n_int):
            if tree.decision_type[i] & CAT_MASK:
                if tree.cat_boundaries is not None:
                    rank = int(tree.threshold[i])
                    lo = int(tree.cat_boundaries[rank])
                    hi = int(tree.cat_boundaries[rank + 1])
                    words = [int(w) for w in tree.cat_threshold[lo:hi]]
                else:  # legacy single-category node
                    cat_val = int(tree.threshold[i])
                    words = [0] * (cat_val // 32 + 1)
                    words[cat_val // 32] |= 1 << (cat_val % 32)
                thresholds.append(float(len(cat_boundaries) - 1))
                cat_threshold.extend(words)
                cat_boundaries.append(len(cat_threshold))
            else:
                thresholds.append(float(tree.threshold[i]))
        buf.write("threshold=" + _join(thresholds, _fmt) + "\n")
        buf.write("decision_type=" + _join(tree.decision_type[:n_int]) + "\n")
        buf.write("left_child=" + _join(tree.left_child[:n_int]) + "\n")
        buf.write("right_child=" + _join(tree.right_child[:n_int]) + "\n")
        buf.write("leaf_value=" + _join(tree.leaf_value[:nl], _fmt) + "\n")
        buf.write("leaf_weight=" + _join(tree.leaf_weight[:nl], _fmt) + "\n")
        buf.write("leaf_count=" + _join(tree.leaf_count[:nl].astype(int)) + "\n")
        buf.write("internal_value=" + _join(tree.internal_value[:n_int], _fmt) + "\n")
        buf.write("internal_weight=" + _join(tree.internal_weight[:n_int], _fmt) + "\n")
        buf.write("internal_count=" + _join(tree.internal_count[:n_int].astype(int)) + "\n")
        if cat_nodes:
            buf.write("cat_boundaries=" + _join(cat_boundaries) + "\n")
            buf.write("cat_threshold=" + _join(cat_threshold) + "\n")
    else:
        buf.write("leaf_value=" + _fmt(tree.leaf_value[0]) + "\n")
    if tree.is_linear:
        # per-leaf linear models (reference tree.cpp:378-399 linear fields:
        # leaf_const + per-leaf feature lists/coefficients, flattened)
        buf.write("is_linear=1\n")
        buf.write("leaf_const=" + _join(tree.leaf_const[:nl], _fmt) + "\n")
        buf.write("num_features=" +
                  _join(len(f) for f in tree.leaf_features[:nl]) + "\n")
        buf.write("leaf_features=" + _join(
            f for fs in tree.leaf_features[:nl] for f in fs) + "\n")
        buf.write("leaf_coeff=" + _join(
            (c for cs in tree.leaf_coeff[:nl] for c in cs), _fmt) + "\n")
    else:
        buf.write("is_linear=0\n")
    buf.write(f"shrinkage={_fmt(tree.shrinkage)}\n")
    buf.write("\n")
    return buf.getvalue()


def model_to_string(gbdt, start_iteration: int = 0,
                    num_iteration: int = -1) -> str:
    ds = gbdt.train_set
    real_map, num_total, feature_names = gbdt.feature_mapping()
    if ds is not None:
        infos = []
        for j in range(num_total):
            m = ds.bin_mappers[j]
            if m.is_trivial:
                infos.append("none")
            elif m.is_categorical:
                infos.append(":".join(str(int(c)) for c in m.bin_to_cat))
            else:
                infos.append(f"[{_fmt(m.min_value)}:{_fmt(m.max_value)}]")
    else:
        infos = getattr(gbdt, "loaded_feature_infos", ["none"] * num_total)

    k = gbdt.num_tree_per_iteration
    t0 = start_iteration * k
    t1 = len(gbdt.models) if num_iteration <= 0 else min(
        len(gbdt.models), (start_iteration + num_iteration) * k)

    head = io.StringIO()
    head.write("tree\n")
    head.write(f"version={MODEL_VERSION}\n")
    head.write(f"num_class={gbdt.config.num_class}\n")
    head.write(f"num_tree_per_iteration={k}\n")
    head.write("label_index=0\n")
    head.write(f"max_feature_idx={num_total - 1}\n")
    head.write(f"objective={_objective_string(gbdt)}\n")
    if getattr(gbdt, "name", "gbdt") == "rf":
        head.write("average_output\n")
    head.write("feature_names=" + " ".join(feature_names) + "\n")
    head.write("feature_infos=" + " ".join(infos) + "\n")

    tree_strs = [_tree_to_string(gbdt.models[t], real_map, t - t0)
                 for t in range(t0, t1)]
    head.write("tree_sizes=" + _join(len(s) for s in tree_strs) + "\n\n")
    body = "".join(tree_strs)

    tail = io.StringIO()
    tail.write("end of trees\n\n")
    # feature_importance is full-length over ORIGINAL columns already
    imp = gbdt.feature_importance("split")
    pairs = sorted(((imp[i], feature_names[i])
                    for i in range(len(imp)) if imp[i] > 0), reverse=True)
    tail.write("feature_importances:\n")
    for val, name in pairs:
        tail.write(f"{name}={int(val)}\n")
    tail.write("\nparameters:\n")
    for key, value in sorted(gbdt.config.to_dict().items()):
        if key in ("resume", "checkpoint_dir", "checkpoint_keep",
                   "tpu_ingest_mode", "flight_recorder", "flight_events",
                   "flight_dir", "publish_dir", "publish_every"):
            # transient run directives, not training config: a preempted-
            # and-resumed run must produce byte-identical model text to
            # the run that never stopped, a shipped model must not embed
            # machine-local checkpoint paths, a model trained
            # streamed-chunked must match its in-core twin byte for byte,
            # and the flight recorder (observation only) must not fork
            # the model text between recorder-on and recorder-off runs
            continue
        if isinstance(value, list):
            value = ",".join(str(v) for v in value)
        tail.write(f"[{key}: {value}]\n")
    tail.write("end of parameters\n")
    tail.write("\npandas_categorical:null\n")
    return head.getvalue() + body + tail.getvalue()


def _parse_kv_block(lines: List[str], idx: int) -> Dict[str, str]:
    out = {}
    while idx < len(lines):
        line = lines[idx].strip()
        if not line:
            break
        if "=" in line:
            key, val = line.split("=", 1)
            out[key] = val
        idx += 1
    return out


def string_to_model(model_str: str, config, source: str = "<model string>",
                    device=None):
    """Parse a reference-format model file into a GBDT holding Tree objects
    (reference gbdt_model_text.cpp:583 LoadModelFromString).  ``device``
    is where the loaded model predicts.

    Raises :class:`ModelCorruptError` (naming ``source`` and the byte
    offset) on garbage input or a crash-truncated file instead of an
    arbitrary downstream parse exception."""
    from .gbdt import GBDT
    lines = model_str.split("\n")
    first = next((ln.strip() for ln in lines if ln.strip()), "")
    if first != "tree":
        raise ModelCorruptError(
            source, 0, "does not start with the 'tree' model header "
            f"(first content line: {first[:40]!r})")
    header: Dict[str, str] = {}
    i = 0
    average_output = False
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            break
        if line == "average_output":
            average_output = True
        elif "=" in line:
            key, val = line.split("=", 1)
            header[key] = val
        i += 1

    num_class = int(header.get("num_class", 1))
    k = int(header.get("num_tree_per_iteration", 1))
    max_feature_idx = int(header.get("max_feature_idx", 0))
    objective = header.get("objective", "regression")
    obj_name = objective.split(" ")[0]
    params = {"num_class": num_class, "objective": obj_name}
    for tok in objective.split(" ")[1:]:
        if ":" in tok:
            pk, pv = tok.split(":", 1)
            if pk == "sigmoid":
                params["sigmoid"] = float(pv)
            elif pk == "num_class":
                params["num_class"] = int(pv)
    cfg = config.update(params)

    if average_output:
        raise NotImplementedError(
            "random-forest models (average_output) are not ported to "
            "lightgbm_tpu_torch yet (ROADMAP queue 1, item 7)")
    gbdt = GBDT(cfg, None, device=device)
    gbdt.config = cfg
    gbdt.num_tree_per_iteration = k
    gbdt.num_features = max_feature_idx + 1
    gbdt.train_set = None
    gbdt.loaded_feature_names = header.get(
        "feature_names", "").split(" ") if header.get("feature_names") else \
        [f"Column_{j}" for j in range(max_feature_idx + 1)]
    gbdt.loaded_feature_infos = header.get("feature_infos", "").split(" ")
    gbdt.loaded_real_map = np.arange(max_feature_idx + 1)
    gbdt.loaded_num_total = max_feature_idx + 1
    if gbdt.objective is None and obj_name not in ("none", ""):
        from ..objective import create_objective
        try:
            gbdt.objective = create_objective(obj_name, cfg, gbdt.device)
        except (ValueError, NotImplementedError):
            gbdt.objective = None

    # trees
    expected = None
    if header.get("tree_sizes", "").strip():
        expected = len(header["tree_sizes"].split())
    trees: List[Tree] = []
    saw_end = False
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("Tree="):
            block = _parse_kv_block(lines, i)
            try:
                trees.append(_tree_from_block(block))
            except (KeyError, ValueError, IndexError) as exc:
                raise ModelCorruptError(
                    source, _offset_of(lines, i),
                    f"tree {len(trees)} is unparseable "
                    f"({type(exc).__name__}: {exc})") from exc
            while i < len(lines) and lines[i].strip():
                i += 1
        elif line.startswith("end of trees"):
            saw_end = True
            break
        else:
            i += 1
    if expected is not None and len(trees) != expected:
        raise ModelCorruptError(
            source, _offset_of(lines, i),
            f"header declares {expected} trees (tree_sizes) but only "
            f"{len(trees)} parsed before the text ended — the file was "
            f"cut off mid-write")
    if not saw_end and expected is None:
        raise ModelCorruptError(
            source, _offset_of(lines, i),
            "neither a tree_sizes header nor an 'end of trees' marker — "
            "not a complete model text")
    gbdt.models = trees
    gbdt.iter_ = len(trees) // max(k, 1)
    return gbdt


def _tree_from_block(block: Dict[str, str]) -> Tree:
    nl = int(block["num_leaves"])
    n_int = max(nl - 1, 0)

    def arr(key, dtype, size, default=0):
        if key not in block or not block[key].strip():
            return np.full(size, default, dtype)
        vals = block[key].split()
        if len(vals) != size:
            # a crash-truncated file ends mid-line; the default-fill path
            # above must never paper over a short field
            raise ValueError(f"field '{key}' has {len(vals)} values, "
                             f"expected {size}")
        out = np.asarray([float(v) for v in vals], np.float64)
        return out.astype(dtype)

    if nl <= 1:
        lv = float(block.get("leaf_value", "0"))
        return Tree(num_leaves=1,
                    split_feature=np.zeros(0, np.int32),
                    threshold_bin=np.zeros(0, np.int32),
                    nan_bin=np.full(0, -1, np.int32),
                    threshold=np.zeros(0, np.float64),
                    decision_type=np.zeros(0, np.uint8),
                    left_child=np.zeros(0, np.int32),
                    right_child=np.zeros(0, np.int32),
                    split_gain=np.zeros(0, np.float32),
                    internal_value=np.zeros(0, np.float64),
                    internal_weight=np.zeros(0, np.float64),
                    internal_count=np.zeros(0, np.int64),
                    leaf_value=np.asarray([lv]),
                    leaf_weight=np.zeros(1),
                    leaf_count=np.zeros(1, np.int64),
                    shrinkage=float(block.get("shrinkage", 1.0)))

    for req in ("split_feature", "threshold", "left_child", "right_child",
                "leaf_value"):
        if not block.get(req, "").strip():
            raise ValueError(f"split node block is missing required "
                             f"field '{req}'")
    decision_type = arr("decision_type", np.uint8, n_int)
    threshold = arr("threshold", np.float64, n_int)
    num_cat = int(block.get("num_cat", 0))
    cat_boundaries = None
    cat_threshold = None
    if num_cat > 0:
        # full bitset splits survive the round trip; threshold stays the
        # rank into cat_boundaries (reference gbdt_model_text.cpp parsing)
        cat_boundaries = arr("cat_boundaries", np.int32, num_cat + 1)
        cat_threshold = arr("cat_threshold", np.uint32,
                            int(cat_boundaries[-1]) if num_cat else 0)

    is_linear = int(block.get("is_linear", 0)) != 0
    leaf_const = None
    leaf_coeff = None
    leaf_features = None
    if is_linear:
        leaf_const = arr("leaf_const", np.float64, nl)
        nfeat = arr("num_features", np.int64, nl)
        flat_f = [int(v) for v in block.get("leaf_features", "").split()]
        flat_c = [float(v) for v in block.get("leaf_coeff", "").split()]
        leaf_features = []
        leaf_coeff = []
        pos = 0
        for i in range(nl):
            k = int(nfeat[i])
            leaf_features.append(flat_f[pos:pos + k])
            leaf_coeff.append(flat_c[pos:pos + k])
            pos += k

    return Tree(
        cat_boundaries=cat_boundaries,
        cat_threshold=cat_threshold,
        is_linear=is_linear,
        leaf_const=leaf_const,
        leaf_coeff=leaf_coeff,
        leaf_features=leaf_features,
        leaf_features_inner=leaf_features,  # loaded models: identity map
        num_leaves=nl,
        split_feature=arr("split_feature", np.int32, n_int),
        threshold_bin=np.zeros(n_int, np.int32),  # unknown without a Dataset
        nan_bin=np.full(n_int, -1, np.int32),
        threshold=threshold,
        decision_type=decision_type,
        left_child=arr("left_child", np.int32, n_int),
        right_child=arr("right_child", np.int32, n_int),
        split_gain=arr("split_gain", np.float32, n_int),
        internal_value=arr("internal_value", np.float64, n_int),
        internal_weight=arr("internal_weight", np.float64, n_int),
        internal_count=arr("internal_count", np.int64, n_int),
        leaf_value=arr("leaf_value", np.float64, nl),
        leaf_weight=arr("leaf_weight", np.float64, nl),
        leaf_count=arr("leaf_count", np.int64, nl),
        shrinkage=float(block.get("shrinkage", 1.0)))


def model_to_dict(gbdt, start_iteration: int = 0,
                  num_iteration: int = -1) -> Dict[str, Any]:
    """JSON model dump (reference gbdt_model_text.cpp:24 DumpModel)."""
    real_map, _num_total, feature_names = gbdt.feature_mapping()
    k = gbdt.num_tree_per_iteration
    t0 = start_iteration * k
    t1 = len(gbdt.models) if num_iteration <= 0 else min(
        len(gbdt.models), (start_iteration + num_iteration) * k)

    def node_to_dict(tree: Tree, node: int) -> Dict[str, Any]:
        if node < 0:
            leaf = ~node
            return {"leaf_index": int(leaf),
                    "leaf_value": float(tree.leaf_value[leaf]),
                    "leaf_weight": float(tree.leaf_weight[leaf]),
                    "leaf_count": int(tree.leaf_count[leaf])}
        dt = int(tree.decision_type[node])
        thr = ("||".join(str(c) for c in tree.cat_values(node))
               if dt & CAT_MASK else float(tree.threshold[node]))
        return {
            "split_index": int(node),
            "split_feature": int(real_map[tree.split_feature[node]]),
            "split_gain": float(tree.split_gain[node]),
            "threshold": thr,
            "decision_type": "==" if dt & CAT_MASK else "<=",
            "default_left": bool(dt & DEFAULT_LEFT_MASK),
            "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
            "internal_value": float(tree.internal_value[node]),
            "internal_weight": float(tree.internal_weight[node]),
            "internal_count": int(tree.internal_count[node]),
            "left_child": node_to_dict(tree, int(tree.left_child[node])),
            "right_child": node_to_dict(tree, int(tree.right_child[node])),
        }

    tree_infos = []
    for t in range(t0, t1):
        tree = gbdt.models[t]
        root = (node_to_dict(tree, 0) if tree.num_leaves > 1 else
                {"leaf_value": float(tree.leaf_value[0])})
        tree_infos.append({
            "tree_index": t - t0,
            "num_leaves": int(tree.num_leaves),
            "num_cat": 0,
            "shrinkage": float(tree.shrinkage),
            "tree_structure": root,
        })
    return {
        "name": "tree",
        "version": MODEL_VERSION,
        "num_class": gbdt.config.num_class,
        "num_tree_per_iteration": k,
        "label_index": 0,
        "max_feature_idx": len(feature_names) - 1,
        "objective": _objective_string(gbdt),
        "average_output": getattr(gbdt, "name", "gbdt") == "rf",
        "feature_names": feature_names,
        "feature_importances": {
            feature_names[i]: float(v)
            for i, v in enumerate(gbdt.feature_importance("split")) if v > 0},
        "tree_info": tree_infos,
    }
