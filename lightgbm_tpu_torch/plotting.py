"""Plotting utilities.

Copy of ``lightgbm_tpu/plotting.py`` over the port's ``Booster`` and
``LGBMModel`` (LightGBM's python-package/lightgbm/plotting.py — ``plot_importance``,
``plot_split_value_histogram``, ``plot_metric``, ``plot_tree``,
``create_tree_digraph``).  matplotlib / graphviz are imported lazily so the
core package has no hard dependency on either; all figures are built from
the Booster's ``feature_importance()`` / ``dump_model()`` surfaces, not from
any plotting-side re-walk of the model.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["plot_importance", "plot_split_value_histogram", "plot_metric",
           "plot_tree", "create_tree_digraph"]


def _require_pair(obj: Any, obj_name: str) -> None:
    if not isinstance(obj, (list, tuple)) or len(obj) != 2:
        raise TypeError(f"{obj_name} must be a list or tuple of 2 elements")


def _import_matplotlib():
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("You must install matplotlib and restart your "
                          "session to plot.") from e
    return plt


def _to_booster(booster):
    from .basic import Booster
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        return booster.booster_
    if isinstance(booster, Booster):
        return booster
    raise TypeError("booster must be a Booster or LGBMModel instance")


def plot_importance(booster, ax=None, height: float = 0.2,
                    xlim: Optional[Tuple[float, float]] = None,
                    ylim: Optional[Tuple[float, float]] = None,
                    title: str = "Feature importance",
                    xlabel: str = "Feature importance",
                    ylabel: str = "Features",
                    importance_type: str = "split",
                    max_num_features: Optional[int] = None,
                    ignore_zero: bool = True, figsize=None, dpi=None,
                    grid: bool = True, precision: Optional[int] = 3,
                    **kwargs):
    """Horizontal bar chart of feature importances
    (reference plotting.py plot_importance)."""
    plt = _import_matplotlib()
    booster = _to_booster(booster)

    importance = booster.feature_importance(importance_type=importance_type)
    feature_name = booster.feature_name()
    if not len(importance):
        raise ValueError("Booster's feature_importance is empty.")

    tuples = sorted(zip(feature_name, importance), key=lambda x: x[1])
    if ignore_zero:
        tuples = [x for x in tuples if x[1] > 0]
    if max_num_features is not None and max_num_features > 0:
        tuples = tuples[-max_num_features:]
    if not tuples:
        raise ValueError("There are no importances > 0 to plot.")
    labels, values = zip(*tuples)

    if ax is None:
        if figsize is not None:
            _require_pair(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    ylocs = np.arange(len(values))
    ax.barh(ylocs, values, align="center", height=height, **kwargs)
    for x, y in zip(values, ylocs):
        label = (f"{x:.{precision}f}" if importance_type == "gain" and
                 precision is not None else str(int(x)))
        ax.text(x + 1, y, label, va="center")
    ax.set_yticks(ylocs)
    ax.set_yticklabels(labels)
    if xlim is not None:
        _require_pair(xlim, "xlim")
    else:
        xlim = (0, max(values) * 1.1)
    ax.set_xlim(xlim)
    if ylim is not None:
        _require_pair(ylim, "ylim")
    else:
        ylim = (-1, len(values))
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_split_value_histogram(booster, feature, bins=None, ax=None,
                               width_coef: float = 0.8,
                               xlim=None, ylim=None,
                               title="Split value histogram for "
                                     "feature with @index/name@ @feature@",
                               xlabel="Feature split value",
                               ylabel="Count", figsize=None, dpi=None,
                               grid: bool = True, **kwargs):
    """Histogram of a feature's split THRESHOLD values across the model
    (reference plotting.py plot_split_value_histogram)."""
    plt = _import_matplotlib()
    booster = _to_booster(booster)

    # collect split thresholds of the requested feature from the trees
    names = booster.feature_name()
    if isinstance(feature, str):
        feat_idx = names.index(feature)
        feat_desc = f"name {feature}"
    else:
        feat_idx = int(feature)
        feat_desc = f"index {feature}"
    gbdt = booster._gbdt
    real_map, _, _ = gbdt.feature_mapping()
    values: List[float] = []
    for tree in gbdt.models:
        for i in range(tree.num_leaves - 1):
            f = tree.split_feature[i]
            if f >= 0 and int(real_map[f]) == feat_idx:
                values.append(float(tree.threshold[i]))
    if not values:
        raise ValueError("Cannot plot split value histogram, because "
                         f"feature {feature} was not used in splitting")
    hist, bin_edges = np.histogram(values, bins=bins or max(10, len(set(values))))
    centred = (bin_edges[:-1] + bin_edges[1:]) / 2.0

    if ax is None:
        if figsize is not None:
            _require_pair(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)
    ax.bar(centred, hist, align="center",
           width=width_coef * (bin_edges[1] - bin_edges[0]), **kwargs)
    if xlim is not None:
        _require_pair(xlim, "xlim")
        ax.set_xlim(xlim)
    if ylim is not None:
        _require_pair(ylim, "ylim")
    else:
        ylim = (0, max(hist) * 1.1)
    ax.set_ylim(ylim)
    if title is not None:
        ax.set_title(title.replace("@feature@", str(feature))
                     .replace("@index/name@", feat_desc.split(" ")[0]))
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    if ylabel is not None:
        ax.set_ylabel(ylabel)
    ax.grid(grid)
    return ax


def plot_metric(booster, metric: Optional[str] = None,
                dataset_names: Optional[List[str]] = None,
                ax=None, xlim=None, ylim=None,
                title: str = "Metric during training",
                xlabel: str = "Iterations", ylabel: str = "@metric@",
                figsize=None, dpi=None, grid: bool = True):
    """Plot one metric's evaluation history recorded by the
    ``record_evaluation`` callback (reference plotting.py plot_metric).

    ``booster`` is the evals_result dict from ``record_evaluation`` (the
    sklearn wrapper's ``evals_result_`` also works).
    """
    plt = _import_matplotlib()
    from .sklearn import LGBMModel
    if isinstance(booster, LGBMModel):
        eval_results = deepcopy(booster.evals_result_)
    elif isinstance(booster, dict):
        eval_results = deepcopy(booster)
    else:
        raise TypeError("booster must be a dict from record_evaluation() or "
                        "a fitted LGBMModel")
    if not eval_results:
        raise ValueError("eval results cannot be empty.")

    if ax is None:
        if figsize is not None:
            _require_pair(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    if dataset_names is None:
        dataset_names = list(eval_results.keys())
    elif not dataset_names:
        raise ValueError("dataset_names cannot be empty")

    name = dataset_names[0]
    metrics_for_one = eval_results[name]
    if metric is None:
        if len(metrics_for_one) > 1:
            raise ValueError("more than one metric available, pick one with "
                             "the metric parameter")
        metric, results = list(metrics_for_one.items())[0]
    else:
        if metric not in metrics_for_one:
            raise KeyError("No given metric in eval results.")
        results = metrics_for_one[metric]

    num_iteration = len(results)
    max_result = max(results)
    min_result = min(results)
    x_ = np.arange(num_iteration)
    ax.plot(x_, results, label=name)
    for name in dataset_names[1:]:
        results = eval_results[name][metric]
        max_result = max(max(results), max_result)
        min_result = min(min(results), min_result)
        ax.plot(x_, results, label=name)
    ax.legend(loc="best")
    if xlim is not None:
        _require_pair(xlim, "xlim")
    else:
        xlim = (0, num_iteration)
    ax.set_xlim(xlim)
    if ylim is not None:
        _require_pair(ylim, "ylim")
    else:
        range_result = max_result - min_result
        ylim = (min_result - range_result * 0.2,
                max_result + range_result * 0.2)
    ax.set_ylim(ylim)
    if ylabel is not None:
        ylabel = ylabel.replace("@metric@", metric)
        ax.set_ylabel(ylabel)
    if title is not None:
        ax.set_title(title)
    if xlabel is not None:
        ax.set_xlabel(xlabel)
    ax.grid(grid)
    return ax


def _float2str(value: float, precision: Optional[int] = None) -> str:
    if precision is not None and not isinstance(value, str):
        return f"{value:.{precision}f}"
    return str(value)


def _add_nodes(graph, root: Dict[str, Any], total_count: int,
               show_info: List[str], precision: Optional[int],
               orientation: str, parent: Optional[str] = None,
               decision: Optional[str] = None) -> None:
    """Recursively add one dump_model() subtree to a graphviz digraph."""
    if "split_index" in root:  # internal node
        name = f"split{root['split_index']}"
        label = (f"<B>{root['split_feature_name']}</B> "
                 f"{root['decision_type']} "
                 f"<B>{_float2str(root['threshold'], precision)}</B>")
        for info in ("split_gain", "internal_value", "internal_weight",
                     "internal_count", "data_percentage"):
            if info in show_info:
                if info == "data_percentage":
                    output = _float2str(
                        root["internal_count"] / total_count * 100, 2) + "% of data"
                else:
                    output = f"{info}: " + _float2str(root[info], precision)
                label += f"<br/>{output}"
        label = f"<{label}>"
        graph.node(name, label=label, shape="rectangle")
        l_dec, r_dec = (("yes", "no") if root["decision_type"] == "<=" else
                        ("is", "isn't"))
        _add_nodes(graph, root["left_child"], total_count, show_info,
                   precision, orientation, name, l_dec)
        _add_nodes(graph, root["right_child"], total_count, show_info,
                   precision, orientation, name, r_dec)
    else:  # leaf
        name = f"leaf{root['leaf_index']}"
        label = f"<B>leaf {root['leaf_index']}: </B>"
        label += f"<B>{_float2str(root['leaf_value'], precision)}</B>"
        if "leaf_weight" in show_info:
            label += "<br/>leaf_weight: " + _float2str(root["leaf_weight"],
                                                       precision)
        if "leaf_count" in show_info:
            label += "<br/>leaf_count: " + _float2str(root["leaf_count"])
        if "data_percentage" in show_info:
            label += "<br/>" + _float2str(
                root["leaf_count"] / total_count * 100, 2) + "% of data"
        label = f"<{label}>"
        graph.node(name, label=label)
    if parent is not None:
        graph.edge(parent, name, decision)


def create_tree_digraph(booster, tree_index: int = 0,
                        show_info: Optional[List[str]] = None,
                        precision: Optional[int] = 3,
                        orientation: str = "horizontal",
                        name=None, comment=None, filename=None,
                        directory=None, format=None, engine=None,
                        encoding=None, graph_attr=None, node_attr=None,
                        edge_attr=None, body=None, strict: bool = False):
    """Graphviz digraph of one tree (reference plotting.py
    create_tree_digraph); install graphviz to render."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError("You must install graphviz and restart your "
                          "session to plot tree.") from e
    booster = _to_booster(booster)

    model = booster.dump_model()
    tree_infos = model["tree_info"]
    feature_names = model.get("feature_names", None)
    if tree_index >= len(tree_infos):
        raise IndexError("tree_index is out of range.")
    tree_info = tree_infos[tree_index]

    # attach feature names to the dump for labels
    def _name_splits(node):
        if "split_index" in node:
            f = node["split_feature"]
            node["split_feature_name"] = (feature_names[f] if feature_names
                                          else f"Column_{f}")
            _name_splits(node["left_child"])
            _name_splits(node["right_child"])
    root = deepcopy(tree_info["tree_structure"])
    if "split_index" in root:
        _name_splits(root)

    show_info = show_info or []
    graph = Digraph(name=name, comment=comment, filename=filename,
                    directory=directory, format=format, engine=engine,
                    encoding=encoding, graph_attr=graph_attr,
                    node_attr=node_attr, edge_attr=edge_attr, body=body,
                    strict=strict)
    rankdir = "LR" if orientation == "horizontal" else "TB"
    graph.attr("graph", nodesep="0.05", ranksep="0.3", rankdir=rankdir)
    if "split_index" in root:
        total_count = int(root["internal_count"])
        _add_nodes(graph, root, total_count, show_info, precision, orientation)
    else:
        graph.node("leaf0", label=f"leaf0: {root['leaf_value']}")
    return graph


def plot_tree(booster, ax=None, tree_index: int = 0, figsize=None, dpi=None,
              show_info=None, precision: Optional[int] = 3,
              orientation: str = "horizontal", **kwargs):
    """Render one tree with matplotlib via the graphviz digraph
    (reference plotting.py plot_tree)."""
    plt = _import_matplotlib()
    try:
        import matplotlib.image as image
    except ImportError as e:
        raise ImportError("You must install matplotlib to plot tree.") from e
    if ax is None:
        if figsize is not None:
            _require_pair(figsize, "figsize")
        _, ax = plt.subplots(1, 1, figsize=figsize, dpi=dpi)

    graph = create_tree_digraph(booster=booster, tree_index=tree_index,
                                show_info=show_info, precision=precision,
                                orientation=orientation, **kwargs)
    from io import BytesIO
    s = BytesIO()
    s.write(graph.pipe(format="png"))
    s.seek(0)
    img = image.imread(s)
    ax.imshow(img)
    ax.axis("off")
    return ax
