"""The port's dataset layer against the JAX package: forced bins
(``forcedbins_filename``), the binary dataset cache (``save_binary`` /
``load_binary`` in the reference's file format, either package's file
loading in the other), the ``Dataset`` setters and getters, and the
Booster surface that rides on them (``dump_model``, ``merge_from``,
``shuffle_models``).  Training is quantized on the wave grower
(``device="cpu"``), whose model text is byte-identical across the
packages.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.config import Config as RefConfig
from lightgbm_tpu_torch.config import Config

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

P = dict(objective="binary", num_leaves=7, verbosity=-1,
         tpu_histogram_impl="pallas", tree_grow_mode="wave",
         use_quantized_grad=True, stochastic_rounding=False)


def _data(n=2000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.rand(n, 4)
    X[:, 3] = rng.randint(0, 6, n)
    y = (X[:, 0] + 0.3 * (X[:, 3] == 2) > 0.5).astype(float)
    return X, y


# -- forced bins ----------------------------------------------------------------

@pytest.mark.parametrize("max_bin", [16, 255, 511])
def test_forced_bins_give_the_reference_bounds_and_text(tmp_path, max_bin):
    """The reference's test_forced_bins (tests/test_binning.py:104): the
    listed bounds appear among the feature's upper bounds; here every
    mapper equals the reference's and the model text too."""
    X, y = _data()
    fb = str(tmp_path / "forced.json")
    with open(fb, "w") as fh:
        json.dump([{"feature": 0, "bin_upper_bound": [0.3, 0.35, 0.4]},
                   {"feature": 2, "bin_upper_bound": [0.5]}], fh)
    params = dict(P, max_bin=max_bin, forcedbins_filename=fb)
    ref = lgb.Dataset(X, y, params=params)
    ref.construct(RefConfig(params))
    port = lt.Dataset(X, y, params=params)
    port.construct(Config(params))
    for a, b in zip(ref.bin_mappers, port.bin_mappers):
        np.testing.assert_array_equal(b.bin_upper_bound, a.bin_upper_bound)
    for bound in (0.3, 0.35, 0.4):
        assert np.any(np.isclose(port.bin_mappers[0].bin_upper_bound, bound))
    np.testing.assert_array_equal(port.X_binned, np.asarray(ref.X_binned))
    assert lt.train(params, lt.Dataset(X, y), 3, device="cpu"
                    ).model_to_string() == \
        lgb.train(params, lgb.Dataset(X, y), 3).model_to_string()


# -- the binary dataset cache ---------------------------------------------------

def _constructed(pkg, X, y, **kw):
    ds = pkg.Dataset(X, y, params=dict(P, max_bin=63),
                     categorical_feature=[3], **kw)
    return ds.construct()


def test_the_reference_s_binary_file_trains_identical_text(tmp_path):
    X, y = _data()
    w = np.linspace(0.5, 1.5, len(y))
    path = str(tmp_path / "ref.bin")
    _constructed(lgb, X, y, weight=w).save_binary(path)
    loaded = lt.Dataset.load_binary(path, params=dict(P, max_bin=63))
    assert type(loaded.bin_mappers[0]).__module__ == \
        "lightgbm_tpu_torch.binning"
    np.testing.assert_array_equal(loaded.get_weight(), w.astype(np.float32))
    direct = _constructed(lt, X, y, weight=w)
    assert loaded.fingerprint() == direct.fingerprint()
    params = dict(P, max_bin=63)
    assert lt.train(params, loaded, 3, device="cpu").model_to_string() == \
        lt.train(params, direct, 3, device="cpu").model_to_string()


def test_port_binary_file_round_trips_and_loads_in_the_reference(tmp_path):
    X, y = _data()
    path = str(tmp_path / "port.bin")
    ds = _constructed(lt, X, y)
    assert ds.save_binary(path) is ds
    assert [f for f in os.listdir(tmp_path) if f.startswith(".")] == []
    back = lt.Dataset.load_binary(path)
    np.testing.assert_array_equal(back.X_binned, ds.X_binned)
    np.testing.assert_array_equal(back.get_label(), ds.get_label())
    ref = lgb.Dataset.load_binary(path)
    np.testing.assert_array_equal(np.asarray(ref.X_binned), ds.X_binned)


def test_uint16_binary_file_round_trips(tmp_path):
    X, y = _data(n=3000)
    params = dict(P, max_bin=1023)
    ds = lt.Dataset(X[:, :3], y, params=params).construct()
    assert ds.X_binned.dtype == np.uint16
    path = str(tmp_path / "u16.bin")
    ds.save_binary(path)
    back = lt.Dataset.load_binary(path, params=params)
    assert back.X_binned.dtype == np.uint16
    assert lt.train(params, back, 2, device="cpu").model_to_string() == \
        lt.train(params, ds, 2, device="cpu").model_to_string()


def test_corrupt_binary_files_raise_dataset_corrupt_error(tmp_path):
    """The reference's test_save_binary_is_atomic_and_validated
    (tests/test_model_io.py:106-142), and a global outside the format."""
    X, y = _data()
    path = str(tmp_path / "d.bin")
    _constructed(lt, X, y).save_binary(path)
    raw = open(path, "rb").read()
    cases = {"trunc.bin": raw[:len(raw) // 2],
             "junk.bin": b"not a pickle at all",
             "other.bin": pickle.dumps({"format": "something.else"}),
             "missing.bin": pickle.dumps({"format":
                                          "lightgbm_tpu.dataset.v1"}),
             "global.bin": pickle.dumps({"format": "lightgbm_tpu.dataset.v1",
                                         "x": os.getcwd})}
    payload = pickle.loads(raw)
    payload["X_binned"] = payload["X_binned"].copy()
    payload["X_binned"][0, 0] ^= 1               # the stored crc no longer holds
    cases["tampered.bin"] = pickle.dumps(payload, protocol=4)
    for name, blob in cases.items():
        with open(str(tmp_path / name), "wb") as fh:
            fh.write(blob)
        with pytest.raises(lt.DatasetCorruptError):
            lt.Dataset.load_binary(str(tmp_path / name))
    with pytest.raises(OSError):
        lt.Dataset.load_binary(str(tmp_path / "absent.bin"))


# -- setters and getters ----------------------------------------------------------

def test_setters_return_self_and_match_the_reference():
    X, y = _data()
    w = np.linspace(0.5, 1.5, len(y))
    init = np.full(len(y), 0.25)
    group = np.full(20, len(y) // 20)
    for pkg in (lgb, lt):
        ds = pkg.Dataset(X, params=dict(P))
        assert ds.set_label(y) is ds and ds.set_weight(w) is ds
        assert ds.set_init_score(init) is ds and ds.set_group(group) is ds
        ds.construct()
        np.testing.assert_array_equal(ds.get_label(), y.astype(np.float32))
        np.testing.assert_array_equal(ds.get_weight(), w.astype(np.float32))
        np.testing.assert_array_equal(ds.get_init_score(), init)
        np.testing.assert_array_equal(ds.get_group(), group)
        ds.set_weight(None)                      # after construct, too
        assert ds.get_weight() is None
    a = lgb.Dataset(X, params=dict(P)).set_label(y).set_weight(w)
    b = lt.Dataset(X, params=dict(P)).set_label(y).set_weight(w)
    assert lt.train(P, b, 3, device="cpu").model_to_string() == \
        lgb.train(P, a, 3).model_to_string()


# -- the Booster surface ------------------------------------------------------------

def test_dump_model_merge_and_shuffle_match_the_reference():
    X, y = _data()
    ref = [lgb.train(P, lgb.Dataset(X, y), 3),
           lgb.train(dict(P, seed=5, learning_rate=0.3), lgb.Dataset(X, y),
                     2)]
    port = [lt.train(P, lt.Dataset(X, y), 3, device="cpu"),
            lt.train(dict(P, seed=5, learning_rate=0.3), lt.Dataset(X, y),
                     2, device="cpu")]
    assert json.dumps(port[0].dump_model()) == \
        json.dumps(ref[0].dump_model())
    assert port[0].dump_model(num_iteration=1, start_iteration=1) == \
        ref[0].dump_model(num_iteration=1, start_iteration=1)
    for bsts in (ref, port):
        bsts[0]._gbdt.merge_from(bsts[1]._gbdt)
        assert bsts[0].num_trees() == 5
    assert port[0].model_to_string() == ref[0].model_to_string()
    np.testing.assert_array_equal(port[0].predict(X), ref[0].predict(X))
    for bsts in (ref, port):
        bsts[0]._gbdt.shuffle_models(1, 4)
    assert port[0].model_to_string() == ref[0].model_to_string()
    # the training scores follow the merged, shuffled trees
    np.testing.assert_allclose(
        port[0]._gbdt.score.numpy(), port[0].predict(X, raw_score=True),
        rtol=1e-6, atol=1e-6)
