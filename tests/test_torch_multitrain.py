"""Multi-model training in the PyTorch port (``train_many``, ``cv``).

The contract is the reference's (tests/test_multitrain.py): model m of a
``train_many`` batch writes the model text of the port's standalone
``train(variant_params[m])``.  The batch grows every lane's tree in
lockstep through the model-axis kernel forms (their plain versions here);
each case below checks that text, per model.  The reference's own geometry
(1,200 rows x 8 features, 7-15 leaves, 2-5 rounds) keeps each case small.

Against the reference package: the quantized wave batch is byte-identical
to ``lightgbm_tpu``'s ``train_many`` (its Pallas kernels in interpret mode,
as ``test_bit_identity_pallas_wave`` runs them); the exact wave keeps the
established rule (same structure, values within rtol 1e-4; the reference
sums bf16 pairs, the port fixed point); the variant helpers, the
rejection reasons and the strict error equal the reference's; and ``cv``'s
metric means on the quantized wave equal the reference's ``cv``.
"""

import json

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.multitrain import batched as ref_batched
from lightgbm_tpu.multitrain import variants as ref_variants
from lightgbm_tpu_torch.config import Config as TConfig
from lightgbm_tpu_torch.learner import lanes as kc
from lightgbm_tpu_torch.multitrain import batched, variants
from test_torch_objectives import _assert_same_structure

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

BASE = {"objective": "regression", "num_leaves": 15, "learning_rate": 0.1,
        "min_data_in_leaf": 5, "verbosity": -1}
N, F = 1200, 8


def _data(seed=0, n=N, f=F):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f)
    y = X[:, 0] * 2 + np.sin(X[:, 1] * 3) + 0.1 * rng.randn(n)
    return X, y


def _assert_texts(mb, vparams, X, y, rounds, **kw):
    """Every model's text equals its standalone port ``train``."""
    for m, p in enumerate(vparams):
        ref = lt.train(p, lt.Dataset(X, y), rounds, device="cpu", **kw)
        assert mb[m].model_to_string() == ref.model_to_string(), \
            f"model {m} differs from standalone train()"
        assert mb[m].best_iteration == ref.best_iteration
    return ref


QUANT = {"use_quantized_grad": True, "stochastic_rounding": False,
         "tree_grow_mode": "wave"}
CASES = {
    # waves of 2, then the exact endgame
    "quantized_wave": (dict(QUANT, num_leaves=9, tpu_wave_size=2), 3),
    "quantized_wave_stochastic": (dict(QUANT, num_leaves=7,
                                       stochastic_rounding=True), 3),
    "exact_wave": (dict(tree_grow_mode="wave", num_leaves=11,
                        tpu_wave_size=3), 2),
    "partitioned": (dict(tree_grow_mode="partition", num_leaves=15), 3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_train_many_text_equals_train(case):
    """Swept lambda_l1 / lambda_l2 / min_data_in_leaf: one lane grower
    per variant's scan parameters, text per model equal."""
    extra, rounds = CASES[case]
    X, y = _data()
    variants_ = [{"lambda_l2": 0.0}, {"lambda_l1": 0.7, "lambda_l2": 2.0},
                 {"min_data_in_leaf": 20}]
    params = {**BASE, **extra}
    mb = lt.train_many(params, lt.Dataset(X, y), rounds, variants=variants_,
                       device="cpu")
    assert mb.fallback_indices == [] and mb.batched_indices == [0, 1, 2]
    _assert_texts(mb, mb.variant_params, X, y, rounds)


def test_bagging_feature_fraction_and_replicas():
    """Per-model host draws keyed by each variant's seeds, and replicas'
    derived seeds written into the variants."""
    X, y = _data()
    params = {**BASE, "num_leaves": 7, "bagging_fraction": 0.7,
              "bagging_freq": 2, "feature_fraction": 0.6, "seed": 3}
    mb = lt.train_many(params, lt.Dataset(X, y), 4,
                       variants=[{}, {"bagging_seed": 99},
                                 {"feature_fraction_seed": 17}],
                       device="cpu")
    _assert_texts(mb, mb.variant_params, X, y, 4)
    rep = lt.train_many({**params, "seed": 11}, lt.Dataset(X, y), 2,
                        replicas=3, device="cpu")
    assert len({b.model_to_string() for b in rep}) == 3
    _assert_texts(rep, rep.variant_params, X, y, 2)


def test_sample_masks_equal_subset_training():
    """A masked model is the standalone model of its rows: the fixed-point
    scale and the quantization scale depend on the masked rows only."""
    X, y = _data()
    masks = np.zeros((2, N), np.float32)
    rows = [np.arange(0, N, 2), np.arange(0, N, 3)]
    for m, r in enumerate(rows):
        masks[m, r] = 1.0
    params = {**BASE, **QUANT, "num_leaves": 7}
    mb = lt.train_many(params, lt.Dataset(X, y), 3, sample_masks=masks,
                       device="cpu")
    parent = lt.Dataset(X, y)
    parent.construct(TConfig(params))
    for m, r in enumerate(rows):
        ref = lt.train(params, parent.subset(r), 3, device="cpu")
        assert mb[m].model_to_string() == ref.model_to_string()


def test_early_stopping_per_model():
    X, y = _data()
    Xv, yv = _data(seed=1, n=400)
    params = {**BASE, "num_leaves": 7, "early_stopping_round": 2,
              "tree_grow_mode": "partition"}
    ds = lt.Dataset(X, y)
    vs = [lt.Dataset(Xv, yv, reference=ds)]
    variants_ = [{"learning_rate": 1.5}, {"learning_rate": 0.5}]
    mb = lt.train_many(params, ds, 20, variants=variants_, valid_sets=vs,
                       valid_names=["v0"], device="cpu")
    for m, p in enumerate(mb.variant_params):
        ds2 = lt.Dataset(X, y)
        ref = lt.train(p, ds2, 20, valid_sets=[lt.Dataset(Xv, yv,
                                                          reference=ds2)],
                       valid_names=["v0"], device="cpu")
        assert mb[m].best_iteration == ref.best_iteration > 0
        assert mb[m].model_to_string() == ref.model_to_string()
    assert mb.best_iteration[0] != mb.best_iteration[1]
    assert "v0" in mb.eval_histories[0]


def test_multiclass_lanes():
    """K = 3: an (M, K) grid of lanes, class-major."""
    X, _ = _data()
    y = np.digitize(X[:, 0] + 0.3 * X[:, 1], [-0.5, 0.5])
    params = {**BASE, **QUANT, "objective": "multiclass", "num_class": 3,
              "num_leaves": 7}
    mb = lt.train_many(params, lt.Dataset(X, y), 2,
                       variants=[{"lambda_l2": 0.0}, {"lambda_l2": 3.0}],
                       device="cpu")
    _assert_texts(mb, mb.variant_params, X, y, 2)
    assert mb.predict(X[:8]).shape == (2, 8, 3)


def test_categorical_monotone_forced(tmp_path):
    """One categorical column, monotone constraints and forced splits
    ride the lanes through the standalone grower's own options."""
    rng = np.random.RandomState(5)
    X, y = _data()
    X[:, 3] = rng.randint(0, 12, N)
    y = y + 3.0 * (X[:, 3] % 4 == 1)
    forced = tmp_path / "forced.json"
    forced.write_text(json.dumps({"feature": 1, "threshold": 0.0,
                                  "left": {"feature": 0, "threshold": 0.5}}))
    params = {**BASE, **QUANT, "num_leaves": 7,
              "monotone_constraints": [1, 0, 0, 0, 0, 0, 0, -1],
              "forcedsplits_filename": str(forced)}
    variants_ = [{"lambda_l2": 0.0}, {"lambda_l2": 2.0}]

    def ds():
        return lt.Dataset(X, y, categorical_feature=[3])
    mb = lt.train_many(params, ds(), 3, variants=variants_, device="cpu")
    for m, p in enumerate(mb.variant_params):
        ref = lt.train(p, ds(), 3, device="cpu")
        assert mb[m].model_to_string() == ref.model_to_string()
        assert any(ln.startswith("num_cat=") and ln != "num_cat=0"
                   for ln in ref.model_to_string().splitlines())


def test_launches_group_across_identical_lanes(monkeypatch):
    """Three identical variants run in lockstep: each round launches every
    kernel once for all three lanes, as many launches per kind as ONE
    standalone tree makes."""
    X, y = _data()
    single, group = {}, {}
    run_one, run_group = kc._run_one, kc._run_group

    def one(call):
        single[call.kind] = single.get(call.kind, 0) + 1
        return run_one(call)

    def grp(calls):
        assert len(calls) == 3
        group[calls[0].kind] = group.get(calls[0].kind, 0) + 1
        return run_group(calls)
    monkeypatch.setattr(kc, "_run_one", one)
    monkeypatch.setattr(kc, "_run_group", grp)
    params = {**BASE, **QUANT, "num_leaves": 15, "tpu_wave_size": 4}
    mb = lt.train_many(params, lt.Dataset(X, y), 2, replicas=None,
                       variants=[{}, {}, {}], device="cpu")
    ref = lt.train(params, lt.Dataset(X, y), 2, device="cpu")
    assert group == single and set(group) >= {"leaves_q8", "row_update",
                                              "trial"}
    assert all(b.model_to_string() == ref.model_to_string() for b in mb)


GOSS_DART = {
    # rate sweeps in one batch; learning_rate 0.5 so that iterations 2-4
    # of 5 sample (GOSS skips the first int(1 / learning_rate))
    "goss": ({"boosting": "goss", "learning_rate": 0.5},
             [{"top_rate": 0.2, "other_rate": 0.1},
              {"top_rate": 0.3, "other_rate": 0.2},
              {"top_rate": 0.2, "other_rate": 0.1, "lambda_l1": 0.5}]),
    "dart": ({"boosting": "dart", "skip_drop": 0.0},
             [{"drop_rate": 0.1}, {"drop_rate": 0.5},
              {"drop_rate": 0.5, "uniform_drop": True},
              {"drop_rate": 0.5, "xgboost_dart_mode": True}]),
}


@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_goss_and_dart_raise(boosting):
    """GOSS and DART no longer raise: a batch of them trains as ONE group
    (their rates are host-swept), each model's text that of its
    standalone ``train()``, and ``cv`` takes the batched fold path."""
    X, y = _data(n=400)
    extra, vs = GOSS_DART[boosting]
    params = {**BASE, **QUANT, "num_leaves": 7, **extra}
    mb = lt.train_many(params, lt.Dataset(X, y), 5, variants=vs,
                       device="cpu", strict=True)
    assert mb.num_groups == 1 and mb.batched_indices == list(range(len(vs)))
    _assert_texts(mb, mb.variant_params, X, y, 5)
    out = lt.cv(params, lt.Dataset(X, y), 2, nfold=2, device="cpu")
    assert len(out["valid l2-mean"]) == 2


@pytest.mark.parametrize("case", ["exact", "multiclass", "valid_early_stop"])
@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_goss_dart_lanes_equal_train(boosting, case):
    """GOSS and DART lanes against their standalone runs: the exact wave,
    3-class models (K lanes per model), and a valid set with per-model
    early stopping (DART rescales the valid scores per drop)."""
    X, y = _data()
    extra, vs = GOSS_DART[boosting]
    params = {**BASE, **QUANT, "num_leaves": 7, **extra}
    kw = {}
    if case == "exact":
        params = {**params, "use_quantized_grad": False}
    elif case == "multiclass":
        y = np.digitize(y, [-1.0, 1.0]).astype(float)
        params = {**params, "objective": "multiclass", "num_class": 3}
        vs = vs[:2]
    else:
        params = {**params, "early_stopping_round": 1, "metric": "l2"}
    rounds = 5
    if case == "valid_early_stop":
        Xv, yv = _data(seed=3, n=300)
        yv = yv + 2.0 * np.sin(Xv[:, 2] * 4)
        d = lt.Dataset(X, y)
        mb = lt.train_many(params, d, rounds, variants=vs, device="cpu",
                           valid_sets=[lt.Dataset(Xv, yv, reference=d)])
        for m, p in enumerate(mb.variant_params):
            d2 = lt.Dataset(X, y)
            ref = lt.train(p, d2, rounds, device="cpu",
                           valid_sets=[lt.Dataset(Xv, yv, reference=d2)])
            assert mb[m].model_to_string() == ref.model_to_string()
            assert mb[m].best_iteration == ref.best_iteration
        return
    mb = lt.train_many(params, lt.Dataset(X, y), rounds, variants=vs,
                       device="cpu", strict=True)
    _assert_texts(mb, mb.variant_params, X, y, rounds)


# -- against the reference package -------------------------------------------

@pytest.fixture(scope="module")
def pallas_wave():
    """The reference's ``test_bit_identity_pallas_wave`` configuration,
    quantized, and its train_many batch (trained once per module)."""
    X, y = _data()
    params = {**BASE, "num_leaves": 7, "tree_grow_mode": "wave",
              "tpu_wave_size": 2, "tpu_histogram_impl": "pallas",
              "tpu_speculative_ramp": False, "use_quantized_grad": True,
              "stochastic_rounding": False}
    variants_ = [{"lambda_l2": 0.0}, {"lambda_l2": 2.0}]
    ref = lgb.train_many(params, lgb.Dataset(X, y), num_boost_round=2,
                         variants=variants_)
    return X, y, params, variants_, ref


def test_quantized_train_many_matches_reference(pallas_wave):
    X, y, params, variants_, ref = pallas_wave
    assert ref.fallback_indices == []
    mb = lt.train_many(params, lt.Dataset(X, y), 2, variants=variants_,
                       device="cpu")
    for m in range(len(variants_)):
        assert mb[m].model_to_string() == ref[m].model_to_string()


def test_quantized_goss_train_many_matches_reference():
    """The reference's ``test_bit_identity_goss_batch`` sweep
    (tests/test_multitrain.py:177-191) on the quantized wave: each GOSS
    model of the port's batch writes the reference batch's text."""
    X, y = _data(n=600)
    params = {**BASE, "num_leaves": 7, "tree_grow_mode": "wave",
              "tpu_histogram_impl": "pallas", "tpu_speculative_ramp": False,
              "use_quantized_grad": True, "stochastic_rounding": False,
              "boosting": "goss", "learning_rate": 0.5}
    variants_ = GOSS_DART["goss"][1]
    ref = lgb.train_many(params, lgb.Dataset(X, y), num_boost_round=4,
                         variants=variants_)
    assert ref.fallback_indices == [] and ref.num_groups == 1
    mb = lt.train_many(params, lt.Dataset(X, y), 4, variants=variants_,
                       device="cpu")
    assert mb.fallback_indices == [] and mb.num_groups == 1
    for m in range(len(variants_)):
        assert mb[m].model_to_string() == ref[m].model_to_string()


def test_exact_train_many_same_structure_as_reference():
    """Exact training keeps the established rule: the same trees, values
    within rtol 1e-4 of each field's scale."""
    X, y = _data()
    params = {**BASE, "num_leaves": 7, "tree_grow_mode": "wave",
              "tpu_wave_size": 2, "tpu_histogram_impl": "pallas",
              "tpu_speculative_ramp": False}
    variants_ = [{"lambda_l2": 0.0}, {"lambda_l2": 2.0}]
    ref = lgb.train_many(params, lgb.Dataset(X, y), 2, variants=variants_)
    mb = lt.train_many(params, lt.Dataset(X, y), 2, variants=variants_,
                       device="cpu")
    for m in range(len(variants_)):
        _assert_same_structure(ref[m], mb[m])


SPECS = [
    (BASE, [{"lambda_l1": 0.0}, {"num_leaves": 7}, {"eta": 0.3}], None, None),
    (BASE, {"lambda_l2": [0.0, 1.0], "learning_rate": [0.1, 0.2]}, None,
     None),
    ({**BASE, "seed": 11, "bagging_seed": 5}, None, 4, None),
    (BASE, None, None, 3),
]


@pytest.mark.parametrize("spec", range(len(SPECS)))
def test_variant_helpers_match_reference(spec):
    base, vs, replicas, num_models = SPECS[spec]
    got = variants.normalize_variants(base, vs, replicas, num_models)
    want = ref_variants.normalize_variants(base, vs, replicas, num_models)
    assert got == want
    assert variants.group_variants(got) == ref_variants.group_variants(want)
    assert variants.TRACED_SWEEP == ref_variants.TRACED_SWEEP
    assert variants.HOST_SWEEP == ref_variants.HOST_SWEEP
    with pytest.raises(ValueError):
        variants.normalize_variants(BASE, [{}], replicas=2)


REJECT = [{"tree_learner": "data"},
          {"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.5},
          {"objective": "none"}, {"linear_tree": True},
          {"cegb_penalty_split": 0.1}, {"boosting": "goss"},
          {"boosting": "dart"}, {}]


def test_reject_reasons_and_strict_match_reference():
    X, y = _data(n=400)
    ds, rds = lt.Dataset(X, y), lgb.Dataset(X, y)
    ds.construct(TConfig(BASE))
    rds.construct(lgb.Config(BASE))
    for extra in REJECT:
        p = {**BASE, **extra}
        got = batched.batch_reject_reason(
            TConfig(p), ds)
        assert got == ref_batched.batch_reject_reason(lgb.Config(p), rds)
    msgs = []
    for pkg, d in ((lt, lt.Dataset(X, y)), (lgb, lgb.Dataset(X, y))):
        with pytest.raises(pkg.MultiTrainError) as err:
            kw = {"device": "cpu"} if pkg is lt else {}
            pkg.train_many({**BASE, "cegb_penalty_split": 0.1}, d, 2,
                           strict=True, **kw)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    mb = lt.train_many(BASE, lt.Dataset(X, y), 2, device="cpu",
                       variants=[{"lambda_l1": 0.5},
                                 {"cegb_penalty_split": 0.1}])
    assert mb.batched_indices == [0] and mb.fallback_indices == [1]


def test_cv_reject_reasons_match_reference():
    """``cv`` leaves the batched fold path for a custom objective or
    metric with the reference's reasons, and the batch refuses an
    objective-less (fobj) model as the reference does."""
    from lightgbm_tpu.multitrain import cv as ref_cv
    from lightgbm_tpu_torch.multitrain import cv as port_cv

    def fobj(p, d):
        return p, p

    for args in [(fobj, None, None, None, None),
                 (None, lambda p, d: ("e", 0.0, False), None, None, None),
                 (None, None, None, None, None)]:
        assert port_cv.cv_reject_reason(*args) == \
            ref_cv.cv_reject_reason(*args)
    assert batched._objective_reject_reason(None) == \
        ref_batched._objective_reject_reason(None)


@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_goss_dart_cv_fast_path_equals_fold_loop(boosting):
    """The batched folds of GOSS (each fold's draw over its own rows) and
    DART (the held-out rows scored as the loop scores its valid set) give
    the per-fold loop's metric history and trees."""
    X, y = _data()
    extra, _ = GOSS_DART[boosting]
    params = {**BASE, **QUANT, "num_leaves": 7, **extra,
              "drop_rate": 0.5}
    kw = dict(num_boost_round=5, nfold=3, seed=7, eval_train_metric=True,
              return_cvbooster=True, device="cpu")
    fast = lt.cv(params, lt.Dataset(X, y), **kw)
    slow = lt.cv({**params, "tpu_cv_many": False}, lt.Dataset(X, y), **kw)
    assert sorted(fast) == sorted(slow)
    for k in fast:
        if k != "cvbooster":
            assert fast[k] == slow[k], k
    assert [_trees_text(b) for b in fast["cvbooster"].boosters] == \
        [_trees_text(b) for b in slow["cvbooster"].boosters]


# -- cv ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["exact", "quantized_stochastic",
                                  "quantized_pack4"])
def test_masked_lane_draws_over_its_own_rows(mode):
    """Two lanes over one 20,000-row matrix, each training on its own
    rows (``own_rows``), grow the trees of standalone runs on their
    compacted rows: the speculative ramp subsamples a lane's rows
    (``spec_subsample=4096``: 15,000 rows pad to 16,384, a stride of 4;
    under pack4 every 4th pair of them) and stochastic rounding draws over
    them, as the compacted run does."""
    from lightgbm_tpu_torch.dataset import pad_rows
    from lightgbm_tpu_torch.learner.wave import make_wave_grow_fn
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import split as ts
    from lightgbm_tpu_torch.utils.random import host_key
    rng = np.random.RandomState(5)
    n, f, nb = 20_000, 6, 15
    bins = rng.randint(0, nb, (f, n)).astype(np.uint8)
    grad = ((bins[0] / nb - 0.5) * 3 + (bins[1] > 9) - 0.5 +
            (bins[2] / nb) * (bins[3] > 5) +
            rng.randn(n) * 0.5).astype(np.float32)
    hess = rng.uniform(0.1, 0.3, n).astype(np.float32)
    quantized, pack4 = mode != "exact", mode == "quantized_pack4"
    grow = make_wave_grow_fn(
        num_leaves=31, num_features=f, max_bins=nb, max_depth=0,
        split_params=ts.SplitParams(min_data_in_leaf=5,
                                    min_sum_hessian_in_leaf=0.0,
                                    any_cat=False),
        wave_size=4, quantized=quantized, stochastic=quantized,
        spec_ramp=True, spec_subsample=4096, pack4=pack4)

    def inputs(rows, compact: bool):
        m = len(rows) if compact else n
        n_pad = pad_rows(m)
        b = np.zeros((f, n_pad), np.uint8)
        b[:, :m] = bins[:, rows] if compact else bins
        vec = np.zeros((3, n_pad), np.float32)
        if compact:
            vec[:2, :m] = grad[rows], hess[rows]
            vec[2, :m] = 1.0
        else:
            vec[:2, :n] = grad, hess
            vec[2, rows] = 1.0
        bt = torch.as_tensor(b)
        return ((th.pack_bins4(bt) if pack4 else bt,
                 *torch.as_tensor(vec).unbind(0),
                 torch.full((f,), nb, dtype=torch.int32),
                 torch.zeros(f, dtype=torch.bool),
                 torch.ones(f, dtype=torch.bool), host_key(3)))

    own = [np.sort(rng.choice(n, 15_000, replace=False)),
           np.sort(rng.choice(n, 17_000, replace=False))]
    lanes = kc.run_lanes([grow.gen(*inputs(r, False),
                                   own_rows=torch.as_tensor(r))
                          for r in own])
    for rows, lane in zip(own, lanes):
        alone = grow(*inputs(rows, True))
        for name in alone._fields:
            a, b = getattr(alone, name), getattr(lane, name)
            if name == "row_leaf":
                a, b = a[:len(rows)], b[torch.as_tensor(rows)]
            assert (torch.equal(a, b) if torch.is_tensor(a)
                    else a == b), name
        assert alone.num_leaves > 20


@pytest.mark.parametrize("extra", [
    dict(QUANT, num_leaves=7), dict(QUANT, num_leaves=7,
                                    stochastic_rounding=True),
    dict(tree_grow_mode="wave", num_leaves=7)],
    ids=["quantized", "quantized_stochastic", "exact"])
def test_cv_fast_path_equals_fold_loop(extra):
    X, y = _data()
    params = {**BASE, **extra, "early_stopping_round": 2}
    kw = dict(num_boost_round=4, nfold=3, seed=7, eval_train_metric=True,
              return_cvbooster=True, device="cpu")
    fast = lt.cv(params, lt.Dataset(X, y), **kw)
    slow = lt.cv({**params, "tpu_cv_many": False}, lt.Dataset(X, y), **kw)
    assert sorted(fast) == sorted(slow)
    for k in fast:
        if k != "cvbooster":
            assert fast[k] == slow[k], k
    assert fast["cvbooster"].best_iteration == \
        slow["cvbooster"].best_iteration
    # the trees (the parameter dumps differ by tpu_cv_many and the fold
    # loop's is_provide_training_metric)
    assert [_trees_text(b) for b in fast["cvbooster"].boosters] == \
        [_trees_text(b) for b in slow["cvbooster"].boosters]


def _trees_text(bst) -> str:
    return bst.model_to_string().split("\nparameters:\n")[0]


def test_cv_means_match_reference(pallas_wave):
    """The quantized wave's fold metrics equal the reference's ``cv``
    (its fast path too).  l2 is a float64 mean over each fold's rows in
    both packages, and the fold scores are bitwise, so the means are
    equal."""
    X, y, params, _, _ = pallas_wave
    kw = dict(num_boost_round=2, nfold=3, seed=7)
    ref = lgb.cv(params, lgb.Dataset(X, y), **kw)
    got = lt.cv(params, lt.Dataset(X, y), device="cpu", **kw)
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_cv_falls_back_to_fold_loop_on_reject():
    """A configuration the batch rejects (CEGB) runs the per-fold loop."""
    X, y = _data(n=400)
    out = lt.cv({**BASE, "cegb_penalty_split": 0.1}, lt.Dataset(X, y),
                num_boost_round=2, nfold=2, device="cpu")
    assert len(out["valid l2-mean"]) == 2
