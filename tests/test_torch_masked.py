"""The exact growers under the split options, and the pool-less masked
grower, held against the JAX package.

The same seeded data and params go through ``lightgbm_tpu.train``
(Pallas kernels in interpret mode) and ``lightgbm_tpu_torch.train`` on the
CPU.  Exact training is held to the tree structure, the values within
1e-4 of each field's scale and the predictions within rtol 1e-5, the bar
of the port's exact growers (tests/test_torch_slice.py): the reference's
f32 histograms carry bf16 hi+lo weights, the port's are fixed point.
One field may differ beyond that: a node whose NaN bin holds none of its
rows sends NaN either way for the same gain, and the two packages break
that tie by rounding residue (the node's counts, equal in both, show that
no training row changes side).

* The partitioned grower: basic monotone bounds and forced splits;
  smoothing, interaction constraints, the CEGB penalties and
  ``feature_contri``.
* The masked grower (a histogram pool over ``histogram_pool_size``): the
  options it carries (monotone basic, smoothing, the CEGB split penalty),
  two full passes of the single-leaf kernel per split.
* The exact wave grower under lazy CEGB and smoothing.
* The reference's refusals and warnings: EFB without a pool raises;
  intermediate monotone constraints and lazy CEGB off the wave grower
  warn.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.learner import serial as port_serial
from lightgbm_tpu_torch.models.tree import DEFAULT_LEFT_MASK

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

N, F, ROUNDS, LEAVES = 3000, 6, 3, 7
MONO = [1, -1, 0, 1, 0, 0]
STRUCTURE = ("num_leaves", "split_feature", "threshold", "left_child",
             "right_child", "leaf_count", "internal_count")
VALUES = ("leaf_value", "leaf_weight", "internal_value", "internal_weight",
          "split_gain")
# a pool of 7 x 6 x 64 x 3 f32 bins needs 32 KB: 0.01 MB leaves none
NO_POOL = 0.01

CASES = {
    "partition_monotone_forced": dict(tree_grow_mode="partition",
                                      monotone_constraints=MONO,
                                      forcedsplits_filename=True),
    "partition_penalties": dict(tree_grow_mode="partition", path_smooth=2.0,
                                interaction_constraints="[0,1,3],[2,4,5]",
                                cegb_penalty_split=0.02,
                                cegb_penalty_feature_coupled=[1.0] * F,
                                feature_contri=[1.0, 0.6, 1.0, 0.9, 1.0,
                                                0.5]),
    "masked": dict(histogram_pool_size=NO_POOL),
    "masked_options": dict(histogram_pool_size=NO_POOL,
                           monotone_constraints=MONO, path_smooth=2.0,
                           cegb_penalty_split=0.02),
    "wave_lazy_smooth": dict(tree_grow_mode="wave", path_smooth=2.0,
                             cegb_penalty_feature_lazy=[0.01, 0.002, 0.02,
                                                        0.0, 0.005, 0.01]),
}


def _data(seed=1):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F)
    X[rng.rand(N, F) < 0.05] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = 2 * x0 + np.sin(3 * x1) + np.nan_to_num(X[:, 3]) + 0.1 * rng.randn(N)
    return X, y


def _trees(text):
    out = []
    for block in text.split("Tree=")[1:]:
        body = block.split("\n\n")[0]
        out.append(dict(ln.split("=", 1) for ln in body.split("\n")[1:]
                        if "=" in ln))
    return out


def _assert_same_trees(ref, port, X):
    t_ref, t_port = _trees(ref.model_to_string()), \
        _trees(port.model_to_string())
    assert len(t_ref) == len(t_port) == ROUNDS
    for i, (a, b) in enumerate(zip(t_ref, t_port)):
        for k in STRUCTURE:
            assert a.get(k) == b.get(k), f"tree {i} field {k}"
        da = np.array(a["decision_type"].split(), int)
        db = np.array(b["decision_type"].split(), int)
        np.testing.assert_array_equal(da & ~DEFAULT_LEFT_MASK,
                                      db & ~DEFAULT_LEFT_MASK)
        for k in VALUES:
            want = np.array(a[k].split(), float)
            np.testing.assert_allclose(
                np.array(b[k].split(), float), want, rtol=1e-4,
                atol=1e-4 * np.abs(want).max(), err_msg=f"tree {i} field {k}")
    want = ref.predict(X)
    np.testing.assert_allclose(port.predict(X), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", list(CASES))
def test_exact_growers_match_reference(case, tmp_path, monkeypatch):
    X, y = _data()
    params = dict(objective="regression", num_leaves=LEAVES, max_bin=63,
                  verbosity=-1, tpu_histogram_impl="pallas", **CASES[case])
    if params.get("forcedsplits_filename"):
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({
            "feature": 1, "threshold": 0.5,
            "left": {"feature": 0, "threshold": -0.3},
            "right": {"feature": 3, "threshold": 0.1}}))
        params["forcedsplits_filename"] = str(path)
    ref = lgb.train(params, lgb.Dataset(X, y), ROUNDS)
    passes = []
    single = port_serial.hist_single
    monkeypatch.setattr(port_serial, "hist_single",
                        lambda *a, **k: passes.append(1) or single(*a, **k))
    port = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu")
    gbdt = port._gbdt
    want_mode = ("masked" if case.startswith("masked")
                 else params["tree_grow_mode"])
    assert gbdt.learner.grow_mode == ref._gbdt.learner.grow_mode == want_mode
    _assert_same_trees(ref, port, X)
    splits = sum(t.num_leaves - 1 for t in gbdt.models)
    assert splits > ROUNDS
    if want_mode == "masked":
        # the root pass, then two full passes per split
        assert len(passes) == ROUNDS + 2 * splits
    if params.get("forcedsplits_filename"):
        for t in gbdt.models:
            assert list(t.split_feature[:3]) == [1, 0, 3]


def test_refusals_and_warnings(capsys):
    """EFB without a pool raises the reference's ValueError; intermediate
    monotone constraints and lazy CEGB off the wave grower warn and train
    with basic bounds and without lazy costs."""
    rng = np.random.RandomState(2)
    X = np.zeros((N, 8))
    X[:, :2] = rng.randn(N, 2)
    pick = rng.randint(0, 7, N)
    for j in range(6):
        X[pick == j + 1, 2 + j] = 1.0
    y = X[:, 0] + X[:, 3] + 0.1 * rng.randn(N)
    with pytest.raises(ValueError, match="EFB requires the partitioned"):
        lt.train(dict(objective="regression", num_leaves=LEAVES,
                      verbosity=-1, histogram_pool_size=NO_POOL),
                 lt.Dataset(X, y), 1, device="cpu")
    base = dict(objective="regression", num_leaves=LEAVES, verbosity=0,
                tree_grow_mode="partition", enable_bundle=False)
    for extra, warned in (
            (dict(monotone_constraints=[1] + [0] * 7,
                  monotone_constraints_method="intermediate"),
             "falling back to 'basic'"),
            (dict(cegb_penalty_feature_lazy=[0.01] * 8),
             "applied by the wave grower only")):
        capsys.readouterr()
        bst = lt.train(dict(base, **extra), lt.Dataset(X, y), 1,
                       device="cpu")
        assert warned in capsys.readouterr().out
        assert bst._gbdt.models[0].num_leaves > 1
