"""Exclusive Feature Bundling, sparse input and data files in the port,
held against the JAX package.

Both packages get the same seeded data.  Bundle-eligible data (dense
columns beside blocks of mutually exclusive indicator columns) is bundled
by both (``efb.py``): the device matrix holds one column per bundle, the
growers build histograms in bundle space and expand them to feature space
before each scan.  The bars:

* the bundling itself (bundles, offsets, the bundled matrix) equals the
  reference's, from dense, CSR and CSC input;
* quantized training (``tree_grow_mode=wave``, stochastic rounding off or
  on) writes byte-identical model text: the expansion's default-bin fix
  sums in XLA:CPU's order (``efb.sum_bins_xla``);
* exact training grows the same structure on both growers, predictions
  within rtol 1e-5 of their scale (tests/test_torch_objectives.py's bars);
* CSR / CSC input and data files train the models dense input trains.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu import efb as jefb
from lightgbm_tpu_torch import efb as tefb

from test_torch_objectives import (_assert_predictions,
                                   _assert_same_structure)

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
BINARY_TRAIN = os.path.join(HERE, "..", "examples", "binary_classification",
                            "binary.train")


def _bundle_data(n=6000, seed=0, groups=1, values=(1, 2)):
    """2 dense columns and ``groups`` blocks of 8 mutually exclusive
    indicator columns (each row sets at most one column of a block, to
    one of ``values``), with a label that reads both kinds."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 2 + 8 * groups))
    X[:, :2] = rng.randn(n, 2)
    for g in range(groups):
        pick = rng.randint(0, 9, n)          # 0: no column of the block set
        for j in range(8):
            m = pick == j + 1
            X[m, 2 + 8 * g + j] = rng.choice(values, m.sum())
    y = (X[:, 0] + 0.5 * (X[:, 3] > 0) - 0.7 * (X[:, 5] == 2) +
         0.3 * rng.randn(n) > 0).astype(float)
    return X, y


def _params(**kw):
    p = dict(objective="binary", num_leaves=15, verbosity=-1,
             tpu_histogram_impl="pallas", tree_grow_mode="wave")
    p.update(kw)
    return p


def _train_both(X, y, params, rounds=5, data=None):
    ref = lgb.train(params, lgb.Dataset(X if data is None else data, y),
                    rounds)
    port = lt.train(params, lt.Dataset(X if data is None else data, y),
                    rounds, device="cpu")
    return ref, port


# -- the bundling ------------------------------------------------------------

@pytest.mark.parametrize("form", ["dense", "csr", "csc"])
def test_bundles_match_reference(form):
    """Same bundles, offsets and bundled (N, G) matrix as the reference,
    from dense and from sparse input (the sparse path bins column by
    column and never densifies the raw values)."""
    X, y = _bundle_data(n=3000, groups=2)
    data = {"dense": X, "csr": sp.csr_matrix(X), "csc": sp.csc_matrix(X)}[
        form]
    ref = lgb.Dataset(data, y).construct()
    port = lt.Dataset(data, y).construct()
    assert port.efb is not None and ref.efb is not None
    assert port.efb.n_bundles == ref.efb.n_bundles == 4
    for name in ("bundle_bins", "f_bundle", "f_offset", "f_default",
                 "f_nbins", "f_single", "exp_map", "fix_mask"):
        np.testing.assert_array_equal(getattr(port.efb, name),
                                      getattr(ref.efb, name), err_msg=name)
    np.testing.assert_array_equal(port.X_binned, ref.X_binned)
    assert port.device_bins("cpu").shape[0] == 4


@pytest.mark.parametrize("b", [3, 32, 33, 255])
def test_sum_bins_matches_xla_reduction(b):
    """``sum_bins_xla`` rounds as the jitted ``jnp.sum`` over the bin
    axis: sequential within blocks of 32, then over the block totals."""
    rng = np.random.RandomState(b)
    x = (rng.randn(6, 5, b, 3) * rng.rand(6, 5, b, 3) * 100).astype(
        np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=2))(x))
    got = tefb.sum_bins_xla(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


def _efb_pair(n=3000):
    X, y = _bundle_data(n=n, groups=2)
    ds = lt.Dataset(X, y).construct()
    info = ds.efb
    ref_arrays = (jnp.asarray(info.exp_map), jnp.asarray(info.f_bundle),
                  jnp.asarray(info.f_offset), jnp.asarray(info.f_default),
                  jnp.asarray(info.f_nbins), jnp.asarray(info.f_single))
    return ds, info, ref_arrays, tefb.efb_arrays(info, "cpu")


def test_expand_and_decode_match_reference():
    """The histogram expansion (f32, the default bins restored from the
    totals) and the bundle decode equal the reference's closures; the
    expansion of fixed-point sums restores the default bins exactly."""
    ds, info, ref_arrays, arrays = _efb_pair()
    F = len(info.f_bundle)
    rng = np.random.RandomState(3)
    hb = (rng.randn(4, info.n_bundles, info.bundle_bins, 3) * 10).astype(
        np.float32)
    tot = (rng.randn(4, 3) * 100).astype(np.float32)
    expand_ref = jefb.make_expand_hist(ref_arrays, F, info.n_bundles,
                                       info.bundle_bins)
    want = np.asarray(jax.jit(jax.vmap(expand_ref))(jnp.asarray(hb),
                                                    jnp.asarray(tot)))
    expand = tefb.make_expand_hist(arrays, F)
    got = expand(torch.from_numpy(hb), torch.from_numpy(tot)).numpy()
    np.testing.assert_array_equal(got, want)
    # integer sums: the restored bins are the exact default-bin sums
    hi = torch.from_numpy(rng.randint(-50, 50, hb.shape).astype(np.int64))
    tot_i = hi[:, 0].sum(dim=1)
    fix = torch.from_numpy(info.fix_mask)
    e = expand(hi, tot_i)
    assert fix.any()
    assert torch.equal(e[:, fix].sum(dim=2),
                       tot_i.unsqueeze(1).expand(-1, int(fix.sum()), -1))
    v = torch.from_numpy(ds.X_binned.T.astype(np.int32))
    decode_ref = jefb.make_bundle_decode(ref_arrays)
    decode = tefb.make_bundle_decode(arrays)
    for f in range(F):
        col = v[int(info.f_bundle[f])]
        np.testing.assert_array_equal(
            decode(col, torch.tensor(f)).numpy(),
            np.asarray(decode_ref(jnp.asarray(col.numpy()), f)))


# -- training ----------------------------------------------------------------

@pytest.mark.parametrize("stochastic", [False, True])
def test_bundled_quantized_text_matches_reference(stochastic):
    """The bundle-eligible case (6,000 rows, 2 dense and 8 exclusive
    indicator columns, bundled into 3 device columns): quantized wave
    training writes the reference's model text byte for byte."""
    X, y = _bundle_data()
    ref, port = _train_both(X, y, _params(use_quantized_grad=True,
                                          stochastic_rounding=stochastic))
    assert port._gbdt.train_set.efb.n_bundles == 3
    assert port._gbdt.X_T.shape[0] == 3
    assert port.model_to_string() == ref.model_to_string()


@pytest.mark.parametrize("grow", ["wave", "partition"])
def test_bundled_exact_same_structure(grow):
    """Exact training on the bundle-eligible case: the same trees, with
    predictions within rtol 1e-5."""
    X, y = _bundle_data()
    ref, port = _train_both(X, y, _params(tree_grow_mode=grow))
    _assert_same_structure(ref, port, ties=True)
    _assert_predictions(X, ref, port, ties=True)


@pytest.mark.parametrize("form", ["csr", "csc"])
def test_sparse_input_trains_the_dense_model(form):
    """CSR and CSC input train the model dense input trains (quantized
    text identical), and the reference's model from the same matrix."""
    X, y = _bundle_data(n=4000, seed=1, groups=2, values=(1, 2, 3))
    params = _params(use_quantized_grad=True)
    mat = sp.csr_matrix(X) if form == "csr" else sp.csc_matrix(X)
    dense = lt.train(params, lt.Dataset(X, y), 3, device="cpu")
    ref, port = _train_both(X, y, params, rounds=3, data=mat)
    assert port.model_to_string() == dense.model_to_string()
    assert port.model_to_string() == ref.model_to_string()
    np.testing.assert_array_equal(port.predict(mat), dense.predict(X))


def test_data_file_trains_the_array_model():
    """``lt.Dataset(path)`` reads the CSV / TSV / LibSVM file as the
    reference does (label in the first column): the same model as the
    reference's from the file, and as the port's from the loaded array."""
    params = _params(use_quantized_grad=True)
    ref = lgb.train(params, lgb.Dataset(BINARY_TRAIN), 3)
    port = lt.train(params, lt.Dataset(BINARY_TRAIN), 3, device="cpu")
    data = np.loadtxt(BINARY_TRAIN)
    arr = lt.train(params, lt.Dataset(data[:, 1:], data[:, 0]), 3,
                   device="cpu")
    assert port.model_to_string() == ref.model_to_string()
    assert port.model_to_string() == arr.model_to_string()


def test_valid_set_and_continued_training_on_bundled_data():
    """A valid set aligned to the bundled training set decodes its bundle
    columns: its scores equal the model's predictions and the reference's
    metric; continued training (``init_model``) rescoring the bundled rows
    writes the reference's text."""
    X, y = _bundle_data(n=6000, seed=2)
    Xv, yv = _bundle_data(n=2000, seed=3)
    params = _params(use_quantized_grad=True, metric="binary_logloss")
    res_ref, res_port = {}, {}
    dref = lgb.Dataset(X, y)
    dport = lt.Dataset(X, y)
    ref = lgb.train(params, dref, 4, valid_sets=[dref.create_valid(Xv, yv)],
                    callbacks=[lgb.record_evaluation(res_ref)])
    port = lt.train(params, dport, 4,
                    valid_sets=[dport.create_valid(Xv, yv)],
                    callbacks=[lt.record_evaluation(res_port)],
                    device="cpu")
    vset = port._gbdt.valid_sets[0][1]
    assert vset.X_binned.shape[1] == port._gbdt.train_set.efb.n_bundles
    np.testing.assert_allclose(port._gbdt.valid_scores[0].numpy(),
                               port.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(res_port["valid_0"]["binary_logloss"],
                               res_ref["valid_0"]["binary_logloss"],
                               rtol=1e-6)
    more_ref = lgb.train(params, lgb.Dataset(X, y), 2, init_model=ref)
    more_port = lt.train(params, lt.Dataset(X, y), 2, init_model=port,
                         device="cpu")
    assert more_port.num_trees() == 6
    assert more_port.model_to_string() == more_ref.model_to_string()
