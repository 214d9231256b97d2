"""The port's plotting helpers (``lightgbm_tpu_torch/plotting.py``) on the
CPU, mirroring the reference's tests/test_plotting.py (LightGBM's
test_plotting.py pattern: build each plot object and check its
structure, no pixel comparisons), plus the plotted values held against
the reference's plots of the same model text."""

import numpy as np
import pytest
import torch

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

import lightgbm_tpu as lgb  # noqa: E402
import lightgbm_tpu_torch as lt  # noqa: E402

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trained():
    rng = np.random.RandomState(7)
    X = rng.randn(300, 5)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(float)
    evals = {}
    ds = lt.Dataset(X, y, feature_name=[f"f{i}" for i in range(5)])
    bst = lt.train({"objective": "binary", "num_leaves": 7, "verbosity": -1,
                    "metric": "binary_logloss"}, ds, 10,
                   valid_sets=[ds.create_valid(X, y)],
                   callbacks=[lt.record_evaluation(evals)], device="cpu")
    return bst, evals


def test_plot_importance(trained):
    bst, _ = trained
    ax = lt.plot_importance(bst)
    assert ax.get_title() == "Feature importance"
    assert len(ax.patches) >= 1
    ax2 = lt.plot_importance(bst, importance_type="gain",
                             max_num_features=2, title="t2")
    assert len(ax2.patches) <= 2
    # the reference's plot of the same model draws the same bars
    ref = lgb.plot_importance(lgb.Booster(model_str=bst.model_to_string()))
    assert [p.get_width() for p in ax.patches] == \
        [p.get_width() for p in ref.patches]


def test_plot_metric(trained):
    _, evals = trained
    ax = lt.plot_metric(evals)
    assert ax.get_ylabel() == "binary_logloss"
    assert len(ax.get_lines()) == 1


def test_plot_split_value_histogram(trained):
    bst, _ = trained
    ax = lt.plot_split_value_histogram(bst, 0)
    assert len(ax.patches) >= 1
    with pytest.raises(ValueError):
        # a feature never split on
        lt.plot_split_value_histogram(bst, 4)


def test_create_tree_digraph(trained):
    pytest.importorskip("graphviz")
    bst, _ = trained
    graph = lt.create_tree_digraph(
        bst, tree_index=0,
        show_info=["split_gain", "internal_count", "leaf_count"])
    src = graph.source
    assert "split0" in src and "leaf" in src
    with pytest.raises(IndexError):
        lt.create_tree_digraph(bst, tree_index=99)
    ref = lgb.create_tree_digraph(
        lgb.Booster(model_str=bst.model_to_string()), tree_index=0,
        show_info=["split_gain", "internal_count", "leaf_count"])
    assert src == ref.source

