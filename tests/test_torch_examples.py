"""The repository's four ``examples/`` trained by both packages.

Each example's data files are loaded with numpy (the port's ``Dataset``
takes arrays, not file paths) together with its ``.weight`` / ``.query``
side files, and both ``lightgbm_tpu.train`` and
``lightgbm_tpu_torch.train`` (device="cpu") train it from the parameters
of its ``train.conf``.  The models are compared as
``tests/test_torch_objectives.py`` compares exact training: the same
trees (a split may take another threshold where both are a tie, which
the reference's rounding residues break at random), values within 1e-4,
predictions on the training and the held-out file within rtol 1e-5 of
their scale (1e-4 for the multiclass example, whose exact ties move a few
rows and, through their gradients, later leaves).

Rounds are cut to keep the file short: ``num_trees`` 50 / 60 / 30 / 40
become 10 / 10 / 6 / 10 (the multiclass example grows 5 trees per round).

The port also loads the reference LightGBM's model file
``tests/golden/golden_binary_model.txt`` and must reproduce its
predictions ``golden_binary_preds.txt`` on the binary example's test file.
"""

import os

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt

from test_torch_objectives import _assert_predictions, _assert_same_structure

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
EXAMPLES = os.path.join(HERE, "..", "examples")
GOLD = os.path.join(HERE, "golden")

# example -> (train file, test file, rounds after the cut)
CASES = {
    "binary_classification": ("binary.train", "binary.test", 10),
    "regression": ("regression.train", "regression.test", 10),
    "multiclass_classification": ("multiclass.train", "multiclass.test", 6),
    "lambdarank": ("rank.train", "rank.test", 10),
}
# train.conf keys that are training parameters (the rest name files, the
# task and the output)
CONF_PARAMS = ("objective", "num_leaves", "learning_rate", "max_bin",
               "min_data_in_leaf", "num_class", "metric", "ndcg_eval_at",
               "boosting_type")


def _conf(name):
    params = {}
    with open(os.path.join(EXAMPLES, name, "train.conf")) as fh:
        for line in fh:
            line = line.split("#", 1)[0].strip()
            if "=" in line:
                key, val = (t.strip() for t in line.split("=", 1))
                if key in CONF_PARAMS:
                    params[key] = val
    params.update(verbosity=-1, tpu_histogram_impl="pallas")
    return params


def _load(name, fname):
    """(X, y, weight, group) of one data file and its side files."""
    path = os.path.join(EXAMPLES, name, fname)
    data = np.loadtxt(path)
    side = {}
    for ext in ("weight", "query"):
        if os.path.exists(f"{path}.{ext}"):
            side[ext] = np.loadtxt(f"{path}.{ext}")
    return data[:, 1:], data[:, 0], side.get("weight"), side.get("query")


@pytest.mark.parametrize("name", list(CASES))
def test_example_trains_like_the_reference(name):
    train_file, test_file, rounds = CASES[name]
    params = _conf(name)
    X, y, w, q = _load(name, train_file)
    Xt, yt, _, qt = _load(name, test_file)
    if name == "binary_classification":
        assert w is not None        # the example's .weight file rides along
    if name == "lambdarank":
        assert q is not None and qt is not None
    ref = lgb.train(params, lgb.Dataset(X, y, weight=w, group=q), rounds)
    port = lt.train(params, lt.Dataset(X, y, weight=w, group=q), rounds,
                    device="cpu")
    k = int(params.get("num_class", 1))
    assert port.num_trees() == rounds * k
    # the multiclass example is unweighted: its first iteration's
    # gradients take two values per class, splits tie exactly, and the
    # reference's pick among them moves a few rows whose changed
    # gradients then move later leaves (by up to 8e-5 on these rows)
    rtol = 1e-4 if k > 1 else 1e-5
    _assert_same_structure(ref, port, ties=True)
    _assert_predictions(X, ref, port, rtol, ties=True)
    _assert_predictions(Xt, ref, port, rtol, ties=True)
    assert port.predict(Xt).shape == ((len(Xt),) if k == 1
                                      else (len(Xt), k))


def test_port_predicts_the_golden_reference_model():
    """A model file written by the reference LightGBM binary loads in the
    port and predicts the binary example's test rows as LightGBM did."""
    bst = lt.Booster(model_file=os.path.join(GOLD, "golden_binary_model.txt"),
                     device="cpu")
    test = np.loadtxt(os.path.join(EXAMPLES, "binary_classification",
                                   "binary.test"))
    want = np.loadtxt(os.path.join(GOLD, "golden_binary_preds.txt"))
    np.testing.assert_allclose(bst.predict(test[:, 1:]), want, rtol=1e-5,
                               atol=1e-7)
