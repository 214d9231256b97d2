"""Nibble-packed 4-bit bins (max_bin <= 16) in the PyTorch port, held
against the JAX package.

The same seeded numpy inputs go through ``lightgbm_tpu`` (its packed
Pallas kernels in interpret mode, as tests/test_hist_kernel_v2.py runs
them; its wave grower unjitted) and through ``lightgbm_tpu_torch`` on the
CPU, where the wrappers take their plain versions: unpack the bins, then
the uint8 scatter.  The CUDA kernels are held to those plain versions on
the card (tests/test_torch_gpu.py, ``chip_smoke.py``).

Tolerances are those of the uint8 forms (tests/test_torch_kernels.py):
the packed q8 leaf histogram is bitwise the reference's; the exact leaf
histogram is within rtol=1e-4 and the single-leaf one within rtol=1e-5,
each with an absolute floor of 1e-5 of the largest sum (the reference's
bf16 hi+lo weights against the port's 64-bit fixed point), counts exact.
Every packed plain version is bitwise the port's uint8 plain version on
the unpacked bins.  The quantized pack4 grower is bitwise the reference's
unjitted pack4 grower with the ramp's subsample strided over packed bytes;
quantized L2 training writes byte-identical model text.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.learner.serial import SerialTreeLearner as JLearner
from lightgbm_tpu.learner.wave import make_wave_grow_fn as jax_grow_fn
from lightgbm_tpu.ops import histogram_pallas as hp
from lightgbm_tpu.ops import quantize as jq
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.config import Config
from lightgbm_tpu_torch.learner import autotune
from lightgbm_tpu_torch.learner.serial import SerialTreeLearner
from lightgbm_tpu_torch.learner.wave import make_wave_grow_fn
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import split as ts

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

F = 6
N = 8192


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _kernel_inputs(num_bins, seed=0):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, num_bins, (F, N)).astype(np.uint8)
    grad = (rng.randn(N) * 0.5).astype(np.float32)
    hess = (rng.rand(N) * 0.25 + 0.01).astype(np.float32)
    mask = (rng.rand(N) < 0.8).astype(np.float32)
    return rng, bins, grad, hess, mask


# -- (a) the layout -------------------------------------------------------------

@pytest.mark.parametrize("f,n,num_bins", [(F, N, 16), (3, 4096, 5),
                                          (1, 2, 16)])
def test_pack_unpack_bitwise(f, n, num_bins):
    bins = np.random.RandomState(f).randint(0, num_bins, (f, n)).astype(
        np.uint8)
    ref = np.asarray(hp.pack_bins4(jnp.asarray(bins)))
    got = th.pack_bins4(_t(bins))
    assert got.dtype == torch.uint8 and got.shape == (f, n // 2)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(th.unpack_bins4(got).numpy(),
                                  np.asarray(hp.unpack_bins4(jnp.asarray(ref))))
    np.testing.assert_array_equal(th.unpack_bins4(got).numpy(), bins)


def test_pack_rejects_an_odd_row_count():
    with pytest.raises(ValueError, match="even"):
        th.pack_bins4(torch.zeros((2, 5), dtype=torch.uint8))


# -- (b) the three packed histograms ----------------------------------------------

@pytest.mark.parametrize("num_bins", [5, 16])
def test_packed_leaves_q8_bitwise(num_bins):
    rng, bins, grad, hess, mask = _kernel_inputs(num_bins, seed=1)
    gs = np.float32(np.abs(grad * mask).max() / np.float32(127))
    hs = np.float32((hess * mask).max() / np.float32(127))
    wch = np.asarray(jq.quantize_wch(
        jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(mask),
        jnp.float32(gs), jnp.float32(hs), None, gq_max=127, hq_max=127,
        stochastic=False))
    ch = rng.randint(-1, hc.Q_LEAF_CHANNELS, N).astype(np.int8)
    packed = hp.pack_bins4(jnp.asarray(bins))
    ref = np.asarray(hp.build_histogram_pallas_leaves_q8(
        packed, jnp.asarray(wch), jnp.asarray(ch), num_bins=num_bins,
        interpret=True, bins_packed=True))
    got = hc.build_histogram_leaves_q8(
        _t(np.asarray(packed)), _t(wch), _t(ch), num_bins=num_bins,
        bins_packed=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert torch.equal(got, hc.build_histogram_leaves_q8_plain(
        _t(bins), _t(wch), _t(ch), num_bins=num_bins))


@pytest.mark.parametrize("num_bins", [5, 16])
def test_packed_leaves_f32_within_tolerance(num_bins):
    rng, bins, grad, hess, mask = _kernel_inputs(num_bins, seed=2)
    ch = rng.randint(-1, hc.LEAF_CHANNELS, N).astype(np.int8)
    packed = hp.pack_bins4(jnp.asarray(bins))
    ref = np.asarray(hp.build_histogram_pallas_leaves(
        packed, hp.pack_weights8(jnp.asarray(grad), jnp.asarray(hess),
                                 jnp.asarray(mask)),
        jnp.asarray(ch), num_bins=num_bins, interpret=True,
        bins_packed=True))
    w = th.pack_weights(_t(grad), _t(hess), _t(mask))
    got = hc.build_histogram_leaves(_t(np.asarray(packed)), w, _t(ch),
                                    num_bins=num_bins, bins_packed=True)
    assert got.shape == ref.shape and got.dtype == torch.float32
    g = got.numpy()
    np.testing.assert_array_equal(g[..., 2], ref[..., 2])
    for c in (0, 1):
        np.testing.assert_allclose(g[..., c], ref[..., c], rtol=1e-4,
                                   atol=1e-5 * np.abs(ref[..., c]).max())
    assert torch.equal(got, hc.build_histogram_leaves_plain(
        _t(bins), w, _t(ch), num_bins=num_bins))


@pytest.mark.parametrize("num_bins", [5, 16])
def test_packed_single_leaf_within_tolerance(num_bins):
    _, bins, grad, hess, mask = _kernel_inputs(num_bins, seed=3)
    packed = hp.pack_bins4(jnp.asarray(bins))
    ref = np.asarray(hp.build_histogram_pallas(
        packed, jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(mask),
        num_bins=num_bins, interpret=True, bins_packed=True))
    pk = _t(np.asarray(packed))
    got = hc.build_histogram(pk, _t(grad), _t(hess), _t(mask),
                             num_bins=num_bins, bins_packed=True).numpy()
    assert got.shape == ref.shape == (F, num_bins, 3)
    np.testing.assert_array_equal(got[..., 2], ref[..., 2])
    for c in (0, 1):
        np.testing.assert_allclose(got[..., c], ref[..., c], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[..., c]).max())
    # the fixed-point form: bitwise the uint8 form on the unpacked bins
    w = th.pack_weights(_t(grad), _t(hess), _t(mask))
    assert torch.equal(hc.hist_single(pk, w, num_bins=num_bins,
                                      bins_packed=True),
                       hc.hist_single(_t(bins), w, num_bins=num_bins))


def test_packed_wrappers_check_arguments():
    bins = torch.zeros((F, N // 2), dtype=torch.uint8)
    ch = torch.zeros(N, dtype=torch.int8)
    wch = torch.zeros((8, N), dtype=torch.int8)
    w = th.pack_weights(*(torch.zeros(N),) * 3)
    with pytest.raises(ValueError, match="num_bins <= 16, got 17"):
        hc.build_histogram_leaves_q8(bins, wch, ch, num_bins=17,
                                     bins_packed=True)
    with pytest.raises(ValueError, match="num_bins <= 16"):
        hc.hist_single(bins, w, num_bins=32, bins_packed=True)
    # the weights and channels carry N rows: (F, N) bins are not packed
    with pytest.raises(ValueError, match="shape"):
        hc.build_histogram_leaves(torch.zeros((F, N), dtype=torch.uint8), w,
                                  ch, num_bins=16, bins_packed=True)
    # a row count off the 4096-row block is refused, as _check_rows does
    odd = torch.zeros((F, 3000), dtype=torch.uint8)
    with pytest.raises(ValueError, match="pad_rows"):
        hc.build_histogram_leaves_q8(odd, torch.zeros((8, 6000),
                                                      dtype=torch.int8),
                                     torch.zeros(6000, dtype=torch.int8),
                                     num_bins=16, bins_packed=True)


# -- (c) the dataset's packed device matrix -------------------------------------

def test_dataset_device_bins_packed4():
    rng = np.random.RandomState(0)
    X = rng.randn(5000, 4)
    ds = lt.Dataset(X, rng.rand(5000), params={"max_bin": 15,
                                               "verbosity": -1})
    ds.construct()
    pk = ds.device_bins_packed4("cpu")
    assert pk.shape == (ds.num_feature(), 8192 // 2)
    assert pk.dtype == torch.uint8
    got = th.unpack_bins4(pk).numpy()
    np.testing.assert_array_equal(got[:, :5000], ds.X_binned.T)
    assert not got[:, 5000:].any()
    assert ds.device_bins_packed4("cpu") is pk   # cached
    np.testing.assert_array_equal(got, ds.device_bins("cpu").numpy())
    ds255 = lt.Dataset(X, rng.rand(5000), params={"verbosity": -1})
    ds255.construct()
    assert int(np.max(ds255.num_bins_per_feature)) > 16
    with pytest.raises(ValueError, match="max_bin"):
        ds255.device_bins_packed4("cpu")


# -- (d) the learner's pack4 decision ---------------------------------------------

@pytest.mark.parametrize("extra,max_bins,packs", [
    ({}, 15, True),
    ({}, 63, False),
    ({"tpu_hist_pack4": False}, 15, False),
    ({"tpu_pallas_pipeline": "blockspec"}, 15, False),
    ({"tpu_pallas_pipeline": "dma"}, 15, True),
    ({"tree_grow_mode": "partition"}, 15, False),
    ({"use_quantized_grad": True, "stochastic_rounding": False}, 16, True),
])
def test_learner_pack4_matches_reference(extra, max_bins, packs):
    params = dict({"num_leaves": 7, "tree_grow_mode": "wave",
                   "tpu_histogram_impl": "pallas", "max_bin": max_bins,
                   "verbosity": -1}, **extra)
    nb = np.full(4, max_bins, np.int32)
    flags = np.zeros(4, bool)
    ref = JLearner(JConfig(params), 4, max_bins, nb, flags, flags)
    port = SerialTreeLearner(Config(params), 4, max_bins, nb, flags, "cpu")
    assert port.pack4 is ref.pack4 is packs


# -- (e) the pack4 grower with the ramp's byte-pair subsample ---------------------

def _grower_case(seed=13, n=32768, nb=15):
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, nb, (F, n)).astype(np.uint8)
    logit = (bins[0].astype(np.float32) / nb - 0.5) * 3 + \
        ((bins[1] > 9).astype(np.float32) - 0.5) * 2 + \
        (bins[2].astype(np.float32) / nb) * (bins[3] > 5)
    y = (logit + rng.randn(n) * 0.7 > 0).astype(np.float32)
    grad = (0.5 - y).astype(np.float32)
    hess = np.full(n, 0.25, np.float32)
    mask = (rng.rand(n) < 0.9).astype(np.float32)
    return bins, grad, hess, mask


@pytest.mark.parametrize("quantized", [True, False])
def test_pack4_grower_matches_unjitted_reference(quantized):
    """32,768 rows with ``spec_subsample=4096``: the ramp strides 8 packed
    bytes (16 rows) at a time in both packages."""
    bins, grad, hess, mask = _grower_case()
    nb = 15
    sp = js.SplitParams(min_data_in_leaf=5, min_sum_hessian_in_leaf=0.0,
                        any_cat=False)
    kw = dict(num_leaves=31, num_features=F, max_bins=nb, max_depth=0,
              wave_size=4, quantized=quantized, spec_ramp=True,
              spec_subsample=4096, exact_endgame=True, pack4=True)
    packed = np.asarray(hp.pack_bins4(jnp.asarray(bins)))
    ref = jax_grow_fn(jit=False, split_params=sp, hist_impl="pallas",
                      any_cat=False, interpret=True, stochastic=False,
                      **kw)(
        jnp.asarray(packed), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(mask), jnp.full((F,), nb, jnp.int32),
        jnp.zeros((F,), bool), jnp.zeros((F,), bool),
        jnp.zeros((F,), jnp.int32), jnp.zeros((F,), jnp.float32), (),
        jnp.ones((F,), bool))
    got = make_wave_grow_fn(split_params=ts.SplitParams(**sp._asdict()),
                            **kw)(
        _t(packed), _t(grad), _t(hess), _t(mask),
        torch.full((F,), nb, dtype=torch.int32),
        torch.zeros(F, dtype=torch.bool), torch.ones(F, dtype=torch.bool))
    assert got.num_leaves == int(ref.num_leaves) == 31
    assert got.hist_passes == int(ref.hist_passes)
    for name in ("split_feature", "threshold_bin", "nan_bin",
                 "decision_type", "left_child", "right_child", "row_leaf",
                 "leaf_count", "internal_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    tol = 0 if quantized else 1e-5
    for name in ("leaf_value", "leaf_weight", "internal_value",
                 "internal_weight", "split_gain"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=tol, atol=tol, err_msg=name)


def test_pack4_ramp_subsample_keeps_row_pairs(monkeypatch):
    """The ramp strides over packed bytes: unpacked, its subsample holds
    rows (16k, 16k+1), not every 8th row, so it differs from the uint8
    grower's once the stride exceeds 1."""
    bins, grad, hess, mask = _grower_case()
    kw = dict(num_leaves=31, num_features=F, max_bins=15, max_depth=0,
              split_params=ts.SplitParams(min_data_in_leaf=5,
                                          min_sum_hessian_in_leaf=0.0,
                                          any_cat=False),
              wave_size=4, quantized=True, spec_ramp=True,
              spec_subsample=4096)
    args = (_t(grad), _t(hess), _t(mask),
            torch.full((F,), 15, dtype=torch.int32),
            torch.zeros(F, dtype=torch.bool), torch.ones(F, dtype=torch.bool))
    seen = []
    real = hc.build_histogram_leaves_q8

    def spy(b, w, ch, *, num_bins, bins_packed=False):
        seen.append((bins_packed, th.unpack_bins4(b) if bins_packed else b))
        return real(b, w, ch, num_bins=num_bins, bins_packed=bins_packed)
    monkeypatch.setattr(hc, "build_histogram_leaves_q8", spy)
    make_wave_grow_fn(pack4=True, **kw)(th.pack_bins4(_t(bins)), *args)
    ss = [b for packed, b in seen if packed and b.shape[1] == 4096]
    assert ss, "the ramp ran no subsample pass"
    rows = np.stack([np.arange(0, 32768, 16), np.arange(1, 32768, 16)],
                    1).reshape(-1)
    np.testing.assert_array_equal(ss[0].numpy(), bins[:, rows])


# -- (f) train() at max_bin=15 against lightgbm_tpu.train -------------------------

def _data(objective, seed=0, n=6000):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.05] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    if objective == "binary":
        y = (x0 + x1 ** 2 + 0.3 * rng.randn(n) > 0.8).astype(float)
    else:
        y = 2 * x0 + np.sin(3 * x1) + 0.1 * rng.randn(n)
    return X, y


def _trained_pair(objective, quantized):
    X, y = _data(objective)
    params = dict(objective=objective, num_leaves=15, verbosity=-1,
                  max_bin=15, tpu_histogram_impl="pallas",
                  tree_grow_mode="wave", use_quantized_grad=quantized,
                  stochastic_rounding=False)
    ref = lgb.train(params, lgb.Dataset(X, y), 5)
    port = lt.train(params, lt.Dataset(X, y), 5, device="cpu")
    assert ref._gbdt.learner.pack4 and port._gbdt.learner.pack4
    assert tuple(port._gbdt.X_T.shape) == (F, 8192 // 2)
    return X, ref, port


def test_pack4_quantized_l2_model_text_byte_identical():
    _, ref, port = _trained_pair("regression", True)
    assert port.model_to_string() == ref.model_to_string()


def test_pack4_exact_binary_matches_reference():
    X, ref, port = _trained_pair("binary", False)
    keys = ("num_leaves", "split_feature", "threshold", "decision_type",
            "left_child", "right_child", "leaf_count", "internal_count")

    def trees(text):
        return [dict(ln.split("=", 1) for ln in b.split("\n\n")[0]
                     .split("\n")[1:] if "=" in ln)
                for b in text.split("Tree=")[1:]]
    t_ref, t_port = trees(ref.model_to_string()), trees(port.model_to_string())
    assert len(t_ref) == len(t_port) == 5
    for a, b in zip(t_ref, t_port):
        assert all(a[k] == b[k] for k in keys)
    np.testing.assert_allclose(port.predict(X), ref.predict(X), rtol=1e-5,
                               atol=1e-6)


# -- (g) the autotuner ------------------------------------------------------------

def test_autotune_default_candidates():
    assert autotune.default_candidates("cuda", 255) == ("pallas",)
    assert autotune.default_candidates("cuda", 16) == ("pallas",
                                                       "pallas:packed4")
    assert autotune.default_candidates("cuda", 17) == ("pallas",)
    assert autotune.default_candidates("cpu", 15) == ("pallas",
                                                      "pallas:packed4")
    with pytest.raises(ValueError):
        autotune.default_candidates("tpu", 15)


def test_autotune_apply_winner():
    cfg = Config({})
    autotune.apply_winner(cfg, "pallas")
    # a PLAIN winner beat the packed candidate: pack4 must clear, else
    # training would run the form the probe just rejected
    assert cfg.tpu_histogram_impl == "pallas"
    assert cfg.tpu_hist_pack4 is False
    assert cfg.tpu_pallas_pipeline == "dma"
    autotune.apply_winner(cfg, "pallas:packed4")
    assert cfg.tpu_hist_pack4 is True
    # the reference's apply_winner maps the same two winners the same way
    from lightgbm_tpu.learner.autotune import apply_winner as japply
    for win in ("pallas", "pallas:packed4"):
        a, b = Config({}), JConfig({})
        autotune.apply_winner(a, win)
        japply(b, win)
        for k in ("tpu_histogram_impl", "tpu_hist_pack4",
                  "tpu_pallas_pipeline"):
            assert getattr(a, k) == getattr(b, k)


def test_autotune_disk_cache(tmp_path, monkeypatch):
    cache = tmp_path / "hist_autotune.json"
    monkeypatch.setenv("LGBM_TPU_TORCH_AUTOTUNE_CACHE", str(cache))
    monkeypatch.setattr(autotune, "_CACHE", {})
    monkeypatch.setattr(autotune, "_DISK_LOADED", {})
    X = np.random.RandomState(0).randint(0, 13, (5000, 4)).astype(np.uint8)
    win = autotune.pick_hist_impl(X, 13, "cpu", reps=2)
    assert win in ("pallas", "pallas:packed4")
    stored = json.loads(cache.read_text())
    assert stored["winners"] == {"cpu/5000x4x13/pallas,pallas:packed4": win}
    # a fresh process (simulated: cleared in-memory caches) reads the
    # winner from disk and runs no probe
    autotune._CACHE.clear()
    autotune._DISK_LOADED.clear()

    def no_probe(*a, **k):
        raise AssertionError("probed again despite a cached winner")
    monkeypatch.setattr(autotune, "_make_runner", no_probe)
    assert autotune.pick_hist_impl(X, 13, "cpu", reps=2) == win
    # one candidate: nothing to probe
    assert autotune.pick_hist_impl(X, 255, "cpu") == "pallas"


def test_autotune_probe_runs_both_forms(tmp_path, monkeypatch):
    monkeypatch.setenv("LGBM_TPU_TORCH_AUTOTUNE_CACHE", "")
    monkeypatch.setattr(autotune, "_CACHE", {})
    X = np.random.RandomState(1).randint(0, 15, (6000, 3)).astype(np.uint8)
    calls = []
    real = hc.hist_single

    def spy(bins_t, w, *, num_bins, bins_packed=False):
        calls.append((tuple(bins_t.shape), bins_packed))
        return real(bins_t, w, num_bins=num_bins, bins_packed=bins_packed)
    monkeypatch.setattr(hc, "hist_single", spy)
    autotune.pick_hist_impl(X, 15, "cpu", reps=1)
    assert ((3, 8192), False) in calls and ((3, 4096), True) in calls
    # both forms compute the same histogram
    a = autotune._make_runner("pallas", X, 15, torch.device("cpu"))()
    b = autotune._make_runner("pallas:packed4", X, 15, torch.device("cpu"))()
    assert torch.equal(a, b)


def test_train_on_cpu_never_autotunes(monkeypatch):
    """The probe times the card's kernels; on the CPU train() keeps the
    static choice (packed bins at max_bin <= 16)."""
    def refuse(*a, **k):
        raise AssertionError("autotune probed on the CPU")
    import lightgbm_tpu_torch.models.gbdt as gbdt_mod
    monkeypatch.setattr(gbdt_mod, "pick_hist_impl", refuse)
    X, y = _data("regression", n=3000)
    bst = lt.train(dict(objective="regression", num_leaves=7, max_bin=15,
                        verbosity=-1), lt.Dataset(X, y), 2, device="cpu")
    assert bst._gbdt.learner.pack4
