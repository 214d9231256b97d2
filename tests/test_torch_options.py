"""The split and grower options of the port held against the JAX package.

The same seeded data and params go through ``lightgbm_tpu.train`` (the
wave grower with the Pallas kernels in interpret mode) and through
``lightgbm_tpu_torch.train`` on the CPU (the kernels' plain versions).

* The scan (``best_split_per_feature``) is bit for bit the reference's
  jitted scan under path smoothing, monotone constraints with bounds and
  penalty, the CEGB penalties and ``feature_contri``.  Where XLA:CPU fuses
  a multiply into an add, the port rounds the pair once too.
* Quantized wave training writes byte-identical model text for every
  option alone, with round-half-up and with stochastic rounding, and for
  two combinations: monotone (basic, intermediate, and advanced, which
  warns and runs intermediate), ``path_smooth`` (through the exact
  endgame, which stays on), interaction constraints, forced splits,
  ``feature_contri`` and CEGB (split penalty, coupled penalties over
  several trees, lazy penalties with a bitmap that lasts across trees).

Small on purpose: every reference configuration compiles its own grower
(about 3-5 s each on the CPU); the rows and rounds add little.
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.models.tree import DEFAULT_LEFT_MASK
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import split as ts

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

N, F, ROUNDS, LEAVES = 3000, 6, 3, 7
MONO = [1, -1, 0, 1, 0, 0]
LAZY = [0.01, 0.002, 0.02, 0.0, 0.005, 0.01]
# three forced splits in two forced waves (the root, then both children)
FORCED = {"feature": 1, "threshold": 0.5,
          "left": {"feature": 0, "threshold": -0.3},
          "right": {"feature": 2, "threshold": 0.1}}

OPTIONS = {
    "monotone_basic": dict(monotone_constraints=MONO),
    "monotone_intermediate": dict(monotone_constraints=MONO,
                                  monotone_constraints_method="intermediate"),
    "monotone_advanced": dict(monotone_constraints=MONO,
                              monotone_constraints_method="advanced"),
    "path_smooth": dict(path_smooth=2.0),
    "interaction": dict(interaction_constraints="[0,1],[2,3,4,5]"),
    "forced": dict(forcedsplits_filename=True),
    "contri": dict(feature_contri=[1.0, 0.6, 1.0, 0.9, 1.0, 0.5]),
    "cegb_split": dict(cegb_penalty_split=0.02),
    "cegb_coupled": dict(cegb_penalty_feature_coupled=[5.0, 1.0, 20.0, 2.0,
                                                       0.0, 8.0]),
    "cegb_lazy": dict(cegb_penalty_feature_lazy=LAZY),
    # the endgame-off options together (phase 11a's), and the endgame-on
    # penalties (phase 11b's but its forced splits: see
    # test_smoothing_combined_within_fma_rounding)
    "combo_constraints": dict(monotone_constraints=MONO,
                              monotone_constraints_method="intermediate",
                              monotone_penalty=1.5,
                              interaction_constraints="[0,1,3],[2,4,5]",
                              cegb_penalty_feature_lazy=LAZY),
    "combo_penalties": dict(path_smooth=2.0, cegb_penalty_split=0.01,
                            cegb_tradeoff=0.8,
                            cegb_penalty_feature_coupled=[2.0] * F,
                            feature_contri=[1.0, 0.6, 1.0, 0.9, 1.0, 0.5]),
}


def _data(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, F)
    X[rng.rand(N, F) < 0.05] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = (x0 + x1 ** 2 + 0.5 * np.nan_to_num(X[:, 3]) + 0.3 * rng.randn(N)
         > 0.8).astype(float)
    return X, y


def _params(options, stochastic, tmp_path):
    p = dict(objective="binary", num_leaves=LEAVES, max_bin=63,
             verbosity=0, tpu_histogram_impl="pallas",
             tree_grow_mode="wave", use_quantized_grad=True,
             stochastic_rounding=stochastic)
    p.update(options)
    if p.get("forcedsplits_filename"):
        path = tmp_path / "forced.json"
        path.write_text(json.dumps(FORCED))
        p["forcedsplits_filename"] = str(path)
    return p


@pytest.mark.parametrize("stochastic", [False, True],
                         ids=["half_up", "stochastic"])
@pytest.mark.parametrize("option", list(OPTIONS))
def test_quantized_text_matches_reference(option, stochastic, tmp_path,
                                          monkeypatch, capsys):
    X, y = _data()
    params = _params(OPTIONS[option], stochastic, tmp_path)
    ref = lgb.train(params, lgb.Dataset(X, y), ROUNDS)
    endgame = []
    trial = hc.wave_trial_channels
    monkeypatch.setattr(hc, "wave_trial_channels",
                        lambda *a, **k: endgame.append(1) or trial(*a, **k))
    capsys.readouterr()
    port = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu")
    assert port.model_to_string() == ref.model_to_string()
    gbdt = port._gbdt
    assert all(t.num_leaves > 2 for t in gbdt.models)
    if option == "monotone_advanced":
        assert "'advanced' is not implemented" in capsys.readouterr().out
    if option == "path_smooth":
        # the endgame stays on under smoothing (reference wave.py:360-363)
        assert endgame
    if option.startswith("monotone") or option == "interaction":
        assert not endgame
    if option == "cegb_coupled":
        assert gbdt._cegb_used.any() and not gbdt._cegb_used.all()
    if "cegb_lazy" in params:
        # the bitmap lasts across trees: the last tree's marks include
        # the first tree's
        assert gbdt.learner._lazy_used is not None
        assert int(gbdt.learner._lazy_used.count_nonzero()) > 0
    if "forcedsplits_filename" in params:
        for t in gbdt.models:
            assert list(t.split_feature[:3]) == [1, 0, 2]


def _scan_case(rng, option):
    """Dequantized histograms of one leaf and the option's scan inputs
    for both packages."""
    b = 32
    counts = rng.poisson(20, (F, b)).astype(np.int32)
    gq = rng.randint(-300, 300, (F, b)).astype(np.int32)
    hq = (counts * rng.randint(1, 5, (F, b))).astype(np.int32)
    scale = np.array([0.0123, 0.0071, 1.0], np.float32)
    hist = np.stack([gq, hq, counts], -1).astype(np.float32) * scale
    num_bins = np.array([b, b, 20, 9, b, 2], np.int32)
    has_nan = np.array([True, False, True, False, False, True])
    kw = dict(lambda_l1=0.5, lambda_l2=2.0, min_data_in_leaf=10,
              max_delta_step=0.7 if rng.rand() < 0.5 else 0.0,
              any_cat=False)
    extra = {}
    if option in ("smooth", "all"):
        kw["path_smooth"] = 3.0
        extra["parent_out"] = np.float32(rng.randn() * 0.3)
    if option in ("monotone", "all"):
        kw.update(use_monotone=True, monotone_penalty=1.5)
        extra.update(monotone=np.array(MONO, np.int32),
                     bound=np.array([-0.05, 0.08], np.float32),
                     depth=np.int32(2))
    if option in ("cegb", "all"):
        kw.update(use_cegb=True, cegb_tradeoff=0.9, cegb_penalty_split=0.013)
        extra["cegb_penalty"] = (rng.rand(F) * 3).astype(np.float32)
    if option in ("contri", "all"):
        extra["gain_scale"] = np.array([1, 0.5, 0.9, 1.1, 0.3, 1],
                                       np.float32)
    return hist, hist[0].sum(axis=0), num_bins, has_nan, kw, extra


@pytest.mark.parametrize("option", ["smooth", "monotone", "cegb", "contri",
                                    "all"])
def test_split_scan_options_bitwise(option):
    """Same f32 histograms and options -> the same gains, thresholds,
    directions and child sums as the reference's jitted scan."""
    rng = np.random.RandomState(11)
    for _ in range(4):
        hist, parent, nb, hn, kw, extra = _scan_case(rng, option)
        ref = js.best_split_per_feature(
            jnp.asarray(hist), jnp.asarray(parent), jnp.asarray(nb),
            jnp.zeros(F, bool), jnp.asarray(hn), js.SplitParams(**kw),
            **{k: jnp.asarray(v) for k, v in extra.items()})
        got = ts.best_split_per_feature(
            torch.as_tensor(hist), torch.as_tensor(parent),
            torch.as_tensor(nb), torch.as_tensor(hn), ts.SplitParams(**kw),
            **{k: torch.as_tensor(np.asarray(v)) for k, v in extra.items()})
        for name in ("gain", "threshold_bin", "default_left", "left_sum",
                     "right_sum"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)


@pytest.mark.parametrize("extra", [
    dict(forcedsplits_filename=True),
    dict(monotone_constraints=MONO, tpu_wave_size=4, num_leaves=31),
], ids=["forced", "monotone"])
def test_smoothing_combined_within_fma_rounding(extra, tmp_path):
    """Path smoothing with forced splits or monotone bounds.

    XLA:CPU fuses a multiply into the add that follows it (one rounding),
    and which product of the smoothing blend and of the gain
    -(2 t out + (h + l2) out^2) it fuses follows the operand order LLVM
    gives each fused loop.  The port fixes one choice per formula, the
    one the reference's root, wave and endgame scans take (byte-identical
    text under smoothing alone, test above).  The forced waves' scans
    recompute the NaN-left gain at its best bin with the parent gain's
    other product fused at W = 6, 14 and 42 (not at 4); the port mirrors
    that (ops/split.py ``FORCED_NAN_LEFT_REFUSED``), so forced splits
    (W = 6 here) write byte-identical text.  Under monotone bounds the
    W = 4 children scans fuse the NaN-left gains' square term; the port
    mirrors that too (``MONOTONE_SMOOTH_NAN_LEFT_SQUARE``), so monotone
    bounds (W = 4 here) write byte-identical text as well.  The same trees
    as the reference, split gains and values within 1e-6, are checked
    field by field first, so a failure names the field."""
    X, y = _data()
    params = _params(dict(path_smooth=2.0, **extra), False, tmp_path)
    ref = lgb.train(params, lgb.Dataset(X, y), ROUNDS)
    port = lt.train(params, lt.Dataset(X, y), ROUNDS, device="cpu")
    t_ref, t_port = _trees(ref.model_to_string()), \
        _trees(port.model_to_string())
    assert len(t_ref) == len(t_port) == ROUNDS
    for a, b in zip(t_ref, t_port):
        for k in ("num_leaves", "split_feature", "threshold", "left_child",
                  "right_child", "leaf_count", "internal_count"):
            assert a[k] == b[k], k
        # equal counts: a default direction that differs moves no row
        da = np.array(a["decision_type"].split(), int)
        db = np.array(b["decision_type"].split(), int)
        np.testing.assert_array_equal(da & ~DEFAULT_LEFT_MASK,
                                      db & ~DEFAULT_LEFT_MASK)
        for k in ("split_gain", "leaf_value", "internal_value"):
            want = np.array(a[k].split(), float)
            np.testing.assert_allclose(np.array(b[k].split(), float), want,
                                       rtol=1e-6,
                                       atol=1e-6 * np.abs(want).max())
    assert port.model_to_string() == ref.model_to_string()


def _trees(text):
    """Per-tree {field: value string} blocks of a model text."""
    out = []
    for block in text.split("Tree=")[1:]:
        body = block.split("\n\n")[0]
        out.append(dict(ln.split("=", 1) for ln in body.split("\n")[1:]
                        if "=" in ln))
    return out
