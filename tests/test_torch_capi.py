"""The port's ``LGBM_*`` C API (``lightgbm_tpu_torch/capi.py``) and its
native shim (``csrc/capi_shim.cc``), on the CPU (``device_type=cpu`` in
every booster's parameter string), held against the JAX package's C API
(``lightgbm_tpu/capi.py``) and its shim (``native/capi_shim.cc``).

Mirrors the reference's tests/test_capi.py, test_capi2.py and
test_capi_native.py (LightGBM's tests/c_api_test/test_.py patterns).
Each case runs one call sequence through both C APIs on the same inputs
and compares what comes out: model text, dumps and names byte for byte,
predictions of every ``predict_type``, eval names and values, leaf
values, bounds and importances in value and dtype; SHAP values within
the dense TreeSHAP program's rtol 1e-4 (tests/test_torch_explain.py),
and, where noted, probabilities within the dense serving program's rtol
1e-6 (tests/test_torch_dense_predict.py): on the CPU the reference's
dense XLA program can round a row's tree sum one f32 step away from its
own walk, which the port's dense program and walk both equal.  Boosters
train with quantized gradients on the wave grower (``QUANT``), where the
port's in-core text is the reference's byte for byte; the default exact
training, whose int64 fixed-point histograms differ from the reference's
f32 sums in the last bits, is held to the reference's tree structure
with rtol 1e-5.  The C API's text is also held against the port's
``train`` on the same data and parameters.  The native shims are
compiled with ``g++`` at first use and dlopen'd through ctypes; their
tests skip only when ``build_capi_shim()`` returns None (no toolchain or
Python headers).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import lightgbm_tpu.capi as ref_capi
from lightgbm_tpu.utils import native as ref_native

import lightgbm_tpu_torch as lt
import lightgbm_tpu_torch.capi as capi
from lightgbm_tpu_torch.utils.native import build_capi_shim

# many small tensor ops per test and several test processes: one
# intra-op thread each
torch.set_num_threads(1)

CPU = "device_type=cpu"
QUANT = "use_quantized_grad=true stochastic_rounding=false " \
        "tree_grow_mode=wave"
STRUCTURE = ("num_leaves", "split_feature", "threshold", "decision_type",
             "left_child", "right_child", "leaf_count", "internal_count")


def _p(s: str) -> str:
    """A booster parameter string: quantized wave training on the CPU."""
    return f"{s} {QUANT} {CPU}"


def _both(drive, *args):
    """``drive(m, *args)`` through the port's C API and the reference's:
    (the port's results, the reference's)."""
    return drive(capi, *args), drive(ref_capi, *args)


SHAP_RTOL = 1e-4    # dense TreeSHAP against the host walk
DENSE_RTOL = 1e-6   # the dense serving program against the walk


def _assert_same(got, want, close=None, where="result"):
    """The port's results equal the reference's: strings byte for byte,
    arrays in value, shape and dtype, containers item by item; a key of
    the ``close`` dict within its rtol, and that rtol times the array's
    scale (at least 1) as atol."""
    close = close or {}
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            if k in close:
                w = np.asarray(want[k].toarray() if sp.issparse(want[k])
                               else want[k])
                g = np.asarray(got[k].toarray() if sp.issparse(got[k])
                               else got[k])
                assert (g.dtype, g.shape) == (w.dtype, w.shape), k
                np.testing.assert_allclose(
                    g, w, rtol=close[k],
                    atol=close[k] * max(1.0, np.abs(w).max()), err_msg=k)
            else:
                _assert_same(got[k], want[k], close, f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_same(g, w, close, f"{where}[{i}]")
    elif sp.issparse(want):
        assert sp.issparse(got), where
        _assert_same(got.toarray(), want.toarray(), close, where)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert (got.dtype, got.shape) == (want.dtype, want.shape), where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, where


def _trees(text):
    out = []
    for block in text.split("Tree=")[1:]:
        body = block.split("\n\n")[0]
        out.append(dict(ln.split("=", 1) for ln in body.split("\n")[1:]
                        if "=" in ln))
    return out


def _assert_reference_structure(text, ref_text):
    """Exact training: the reference's trees, split for split, with every
    value (gains, leaf and internal values and weights) within rtol 1e-5."""
    t_port, t_ref = _trees(text), _trees(ref_text)
    assert len(t_port) == len(t_ref)
    for tp, tr in zip(t_port, t_ref):
        for key in STRUCTURE:
            assert tp[key] == tr[key], key
        for key in ("split_gain", "leaf_value", "leaf_weight",
                    "internal_value", "internal_weight"):
            np.testing.assert_allclose(
                np.array(tp[key].split(), float),
                np.array(tr[key].split(), float), rtol=1e-5, atol=1e-6,
                err_msg=key)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(8)
    X = rng.randn(400, 5)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def data2():
    rng = np.random.RandomState(11)
    X = rng.randn(500, 6)
    y = (X[:, 0] + 0.5 * X[:, 1] > 0.2).astype(np.float64)
    return X, y


@pytest.fixture(scope="module")
def boosters(data2):
    """One trained booster handle in each C API, keyed by the module."""
    X, y = data2

    def drive(m):
        _, dh = m.LGBM_DatasetCreateFromMat(
            X, "objective=binary verbosity=-1", label=y)
        _, bh = m.LGBM_BoosterCreate(
            dh, _p("objective=binary num_leaves=15 verbosity=-1 "
                   "metric=binary_logloss,auc"))
        for _ in range(8):
            m.LGBM_BoosterUpdateOneIter(bh)
        return bh
    return {capi: drive(capi), ref_capi: drive(ref_capi)}


def _train_text(m, X, y, params, rounds):
    _, dh = m.LGBM_DatasetCreateFromMat(X, params, label=y)
    _, bh = m.LGBM_BoosterCreate(dh, params)
    for _ in range(rounds):
        m.LGBM_BoosterUpdateOneIter(bh)
    return {"text": m.LGBM_BoosterSaveModelToString(bh)[1],
            "pred": m.LGBM_BoosterPredictForMat(bh, X)[1]}


def _kv(params):
    return dict(t.split("=") for t in params.split())


def test_model_text_equals_train(data, tmp_path):
    """Exact training through the C API writes the text ``train`` writes,
    and grows the reference C API's trees within rtol 1e-5."""
    X, y = data
    params = ("objective=binary num_leaves=15 verbosity=-1 "
              f"min_data_in_leaf=5 {CPU}")
    got, want = _both(_train_text, X, y, params, 6)
    # the same parameters, device_type included (it is in the dump)
    kv = _kv(params)
    ref = lt.train(kv, lt.Dataset(X, label=y, params=kv), 6)
    assert got["text"] == ref.model_to_string()
    np.testing.assert_array_equal(got["pred"], ref.predict(X))
    _assert_reference_structure(got["text"], want["text"])
    assert got["text"].split("parameters:")[1] == \
        want["text"].split("parameters:")[1]
    np.testing.assert_allclose(got["pred"], want["pred"], rtol=1e-5)


def test_quantized_model_text_equals_reference_and_train(data):
    """Quantized wave training through the C API writes the reference C
    API's text byte for byte, and the port's ``train``'s."""
    X, y = data
    params = _p("objective=binary num_leaves=15 verbosity=-1 "
                "min_data_in_leaf=5")
    got, want = _both(_train_text, X, y, params, 6)
    _assert_same(got, want)
    kv = _kv(params)
    assert got["text"] == lt.train(
        kv, lt.Dataset(X, label=y, params=kv), 6).model_to_string()


def test_loaded_booster_takes_its_device_from_the_predict_string(data):
    """A booster loaded from text is parsed on the host and predicts on
    the device its first parameter string names; with none it would take
    the card, which this machine refuses rather than falling back.  Its
    predictions are the reference's loaded booster's."""
    X, y = data

    def drive(m):
        _, dh = m.LGBM_DatasetCreateFromMat(
            X, "objective=binary verbosity=-1", label=y)
        _, bh = m.LGBM_BoosterCreate(dh, _p("objective=binary "
                                             "verbosity=-1"))
        m.LGBM_BoosterUpdateOneIter(bh)
        _, text = m.LGBM_BoosterSaveModelToString(bh)
        _, lh = m.LGBM_BoosterLoadModelFromString(text)
        if m is capi and not torch.cuda.is_available():
            with pytest.raises(lt.DeviceUnavailableError):
                m.LGBM_BoosterPredictForMat(lh, X)
        _, got = m.LGBM_BoosterPredictForMat(lh, X, parameter=CPU)
        np.testing.assert_array_equal(
            got, m.LGBM_BoosterPredictForMat(bh, X)[1])
        if m is capi:
            assert capi._get(lh).device.type == "cpu"
        return {"text": text, "loaded": got}
    _assert_same(*_both(drive))


# ---------------------------------------------------------------------------
# reference tests/test_capi.py
# ---------------------------------------------------------------------------

def test_dataset_booster_roundtrip(data, tmp_path):
    X, y = data

    def drive(m):
        code, dh = m.LGBM_DatasetCreateFromMat(
            X, "objective=binary verbosity=-1", label=y)
        assert code == 0
        assert m.LGBM_DatasetGetNumData(dh) == (0, 400)
        assert m.LGBM_DatasetGetNumFeature(dh) == (0, 5)

        code, bh = m.LGBM_BoosterCreate(
            dh, _p("objective=binary num_leaves=15 verbosity=-1 "
                   "metric=auc is_training_metric=true"))
        assert code == 0
        for _ in range(10):
            code, finished = m.LGBM_BoosterUpdateOneIter(bh)
            assert code == 0
        assert m.LGBM_BoosterGetCurrentIteration(bh) == (0, 10)
        assert m.LGBM_BoosterNumberOfTotalModel(bh) == (0, 10)

        code, evals = m.LGBM_BoosterGetEval(bh, 0)
        assert code == 0 and evals and evals[0][0] == "auc"
        assert evals[0][1] > 0.8

        code, preds = m.LGBM_BoosterPredictForMat(bh, X)
        assert code == 0 and preds.shape == (400,)

        path = str(tmp_path / f"{m.__name__}.txt")
        assert m.LGBM_BoosterSaveModel(bh, path)[0] == 0
        code, bh2 = m.LGBM_BoosterCreateFromModelfile(path)
        assert code == 0
        code, preds2 = m.LGBM_BoosterPredictForMat(bh2, X, parameter=CPU)
        np.testing.assert_allclose(preds2, preds, rtol=1e-5, atol=1e-6)

        assert m.LGBM_BoosterFree(bh)[0] == 0
        assert m.LGBM_DatasetFree(dh)[0] == 0
        return {"evals": evals, "preds": preds, "loaded": preds2,
                "file": open(path).read()}
    _assert_same(*_both(drive))


def test_fields_and_custom_update(data):
    X, y = data

    def drive(m):
        _, dh = m.LGBM_DatasetCreateFromMat(X, "objective=none "
                                               "verbosity=-1")
        assert m.LGBM_DatasetSetField(dh, "label", y)[0] == 0
        code, lab = m.LGBM_DatasetGetField(dh, "label")
        np.testing.assert_array_equal(lab, y.astype(np.float32))

        _, bh = m.LGBM_BoosterCreate(dh, _p("objective=none verbosity=-1 "
                                            "num_leaves=7"))
        score = np.zeros(len(y), np.float32)
        for _ in range(3):
            p = 1.0 / (1.0 + np.exp(-score))
            code, _ = m.LGBM_BoosterUpdateOneIterCustom(bh, p - y,
                                                        p * (1 - p))
            assert code == 0
            score = m.LGBM_BoosterPredictForMat(
                bh, X, predict_type=m.C_API_PREDICT_RAW_SCORE)[1]
        assert m.LGBM_BoosterNumberOfTotalModel(bh) == (0, 3)
        return {"label": lab, "score": score,
                "text": m.LGBM_BoosterSaveModelToString(bh)[1]}
    _assert_same(*_both(drive))


def test_error_contract():
    def drive(m):
        # default mode: exceptions propagate with real stack traces
        with pytest.raises(ValueError) as err:
            m.LGBM_BoosterCreate(99999, "")
        # ABI-strict mode restores the -1 + GetLastError contract
        m.strict_abi(True)
        try:
            code, _ = m.LGBM_BoosterCreate(99999, "")
            assert code == -1
            assert "handle" in m.LGBM_GetLastError()
            return {"raised": str(err.value), "code": code,
                    "last_error": m.LGBM_GetLastError()}
        finally:
            m.strict_abi(False)
    _assert_same(*_both(drive))


def test_streaming_push_rows_matches_from_mat(data):
    """PushRows ingestion == direct from-mat construction
    (c_api.h:66-270 streaming contract)."""
    X, y = data

    def drive(m):
        _, ref = m.LGBM_DatasetCreateFromMat(
            X, "objective=binary verbosity=-1 num_leaves=7", label=y)
        _, sh = m.LGBM_DatasetCreateByReference(ref, len(X))
        for lo in range(0, len(X), 150):
            code, _ = m.LGBM_DatasetPushRows(sh, X[lo:lo + 150], lo)
            assert code == 0
        m.LGBM_DatasetSetField(sh, "label", y)

        preds = {}
        for name, dh in (("mat", ref), ("stream", sh)):
            _, bh = m.LGBM_BoosterCreate(
                dh, _p("objective=binary num_leaves=7 verbosity=-1"))
            for _ in range(5):
                m.LGBM_BoosterUpdateOneIter(bh)
            _, preds[name] = m.LGBM_BoosterPredictForMat(bh, X)
        np.testing.assert_allclose(preds["stream"], preds["mat"], atol=1e-7)
        return preds
    _assert_same(*_both(drive))


def test_push_rows_by_csr_and_sparse_predict(data):
    X, y = data
    Xs = X.copy()
    Xs[np.abs(Xs) < 0.8] = 0.0
    csr = sp.csr_matrix(Xs)

    def drive(m):
        _, ref = m.LGBM_DatasetCreateFromMat(
            Xs, "objective=binary verbosity=-1 num_leaves=7", label=y)
        _, sh = m.LGBM_DatasetCreateByReference(ref, len(X))
        for lo in range(0, len(X), 128):
            m.LGBM_DatasetPushRowsByCSR(sh, csr[lo:lo + 128], lo)
        m.LGBM_DatasetSetField(sh, "label", y)
        _, bh = m.LGBM_BoosterCreate(
            sh, _p("objective=binary num_leaves=7 verbosity=-1"))
        for _ in range(4):
            m.LGBM_BoosterUpdateOneIter(bh)
        _, dense_pred = m.LGBM_BoosterPredictForMat(bh, Xs)
        _, sparse_pred = m.LGBM_BoosterPredictForCSR(bh, csr)
        np.testing.assert_allclose(sparse_pred, dense_pred, atol=1e-7)
        _, one = m.LGBM_BoosterPredictForCSRSingleRow(bh, csr[3])
        np.testing.assert_allclose(one, dense_pred[3], atol=1e-7)
        return {"dense": dense_pred, "sparse": sparse_pred, "one": one}
    _assert_same(*_both(drive))


def test_single_row_subset_and_file_predict(data, tmp_path):
    X, y = data
    f = tmp_path / "rows.csv"
    np.savetxt(f, np.column_stack([y, X]), delimiter="\t")

    def drive(m):
        _, dh = m.LGBM_DatasetCreateFromMat(
            X, "objective=binary verbosity=-1", label=y)
        _, bh = m.LGBM_BoosterCreate(
            dh, _p("objective=binary num_leaves=7 verbosity=-1"))
        for _ in range(4):
            m.LGBM_BoosterUpdateOneIter(bh)
        _, full = m.LGBM_BoosterPredictForMat(bh, X)
        _, single = m.LGBM_BoosterPredictForMatSingleRow(bh, X[7])
        np.testing.assert_allclose(single, full[7], atol=1e-9)

        # subset shares bin mappers
        idx = np.arange(0, 200)
        code, sub = m.LGBM_DatasetGetSubset(dh, idx)
        assert code == 0
        assert m.LGBM_DatasetGetNumData(sub) == (0, 200)

        # file prediction round trip
        out = tmp_path / f"preds_{m.__name__}.txt"
        code, _ = m.LGBM_BoosterPredictForFile(
            bh, str(f), result_filename=str(out))
        assert code == 0
        got = np.loadtxt(out)
        np.testing.assert_allclose(got, full, rtol=1e-6, atol=1e-7)
        return {"full": full, "single": single, "file": out.read_text()}
    _assert_same(*_both(drive))


def test_predict_types(data):
    X, y = data

    def drive(m):
        _, dh = m.LGBM_DatasetCreateFromMat(
            X, "objective=binary verbosity=-1", label=y)
        _, bh = m.LGBM_BoosterCreate(dh, _p("objective=binary verbosity=-1 "
                                            "num_leaves=7"))
        for _ in range(5):
            m.LGBM_BoosterUpdateOneIter(bh)
        out = {pt: m.LGBM_BoosterPredictForMat(bh, X, predict_type=pt)[1]
               for pt in (m.C_API_PREDICT_NORMAL,
                          m.C_API_PREDICT_RAW_SCORE,
                          m.C_API_PREDICT_LEAF_INDEX,
                          m.C_API_PREDICT_CONTRIB)}
        leaf = out[m.C_API_PREDICT_LEAF_INDEX]
        contrib = out[m.C_API_PREDICT_CONTRIB]
        assert leaf.shape == (400, 5) and leaf.dtype.kind == "i"
        assert contrib.shape == (400, 6)
        np.testing.assert_allclose(contrib.sum(1),
                                   out[m.C_API_PREDICT_RAW_SCORE],
                                   rtol=1e-4, atol=1e-4)
        return out
    _assert_same(*_both(drive),
                 close={capi.C_API_PREDICT_CONTRIB: SHAP_RTOL})


# ---------------------------------------------------------------------------
# reference tests/test_capi2.py
# ---------------------------------------------------------------------------

def test_csc_dataset_and_predict(data2):
    X, y = data2
    csc = sp.csc_matrix(X)

    def drive(m):
        code, dh = m.LGBM_DatasetCreateFromCSC(
            csc, "objective=binary verbosity=-1 min_data_in_bin=1", label=y)
        assert code == 0
        assert m.LGBM_DatasetGetNumData(dh)[1] == 500
        _, bh = m.LGBM_BoosterCreate(
            dh, _p("objective=binary num_leaves=15 verbosity=-1"))
        for _ in range(5):
            m.LGBM_BoosterUpdateOneIter(bh)
        _, p_csc = m.LGBM_BoosterPredictForCSC(bh, csc)
        _, p_mat = m.LGBM_BoosterPredictForMat(bh, X)
        np.testing.assert_allclose(p_csc, p_mat, rtol=1e-6)
        text = m.LGBM_BoosterSaveModelToString(bh)[1]
        m.LGBM_BoosterFree(bh)
        m.LGBM_DatasetFree(dh)
        return {"csc": p_csc, "mat": p_mat, "text": text}
    _assert_same(*_both(drive))


def test_eval_names_counts_predict(boosters):
    def drive(m):
        booster = boosters[m]
        code, n = m.LGBM_BoosterGetEvalCounts(booster)
        assert code == 0 and n == 2
        code, names = m.LGBM_BoosterGetEvalNames(booster)
        assert set(names) == {"binary_logloss", "auc"}
        code, npred = m.LGBM_BoosterGetNumPredict(booster, 0)
        assert (code, npred) == (0, 500)
        code, preds = m.LGBM_BoosterGetPredict(booster, 0)
        assert preds.shape == (500,)
        assert np.all((preds >= 0) & (preds <= 1))   # transformed probs
        return {"names": names, "evals": m.LGBM_BoosterGetEval(booster, 0),
                "preds": preds}
    _assert_same(*_both(drive))


def test_leaf_get_set(boosters, data2):
    X, _ = data2

    def drive(m):
        booster = boosters[m]
        code, v = m.LGBM_BoosterGetLeafValue(booster, 0, 0)
        assert code == 0
        before = m.LGBM_BoosterPredictForMat(booster, X)[1]
        m.LGBM_BoosterSetLeafValue(booster, 0, 0, v + 1.0)
        after = m.LGBM_BoosterPredictForMat(booster, X)[1]
        assert not np.allclose(before, after)
        m.LGBM_BoosterSetLeafValue(booster, 0, 0, v)   # restore
        restored = m.LGBM_BoosterPredictForMat(booster, X)[1]
        np.testing.assert_allclose(restored, before, rtol=1e-6)
        assert m.LGBM_BoosterGetLeafValue(booster, 0, 0)[1] == \
            pytest.approx(v)
        leaves = [m.LGBM_BoosterGetLeafValue(booster, t, j)[1]
                  for t in (0, 7) for j in range(15)]
        return {"leaves": leaves, "after": after, "restored": restored}
    _assert_same(*_both(drive))


def test_bounds_linear_calcnum(boosters):
    def drive(m):
        booster = boosters[m]
        _, lo = m.LGBM_BoosterGetLowerBoundValue(booster)
        _, hi = m.LGBM_BoosterGetUpperBoundValue(booster)
        assert lo < hi
        assert m.LGBM_BoosterGetLinear(booster)[1] == 0
        assert m.LGBM_BoosterCalcNumPredict(booster, 7, 0)[1] == 7
        assert m.LGBM_BoosterCalcNumPredict(
            booster, 7, m.C_API_PREDICT_LEAF_INDEX)[1] == 7 * 8
        assert m.LGBM_BoosterCalcNumPredict(
            booster, 3, m.C_API_PREDICT_CONTRIB)[1] == 3 * 7
        return {"bounds": (lo, hi),
                "split": m.LGBM_BoosterFeatureImportance(booster, -1, 0),
                "gain": m.LGBM_BoosterFeatureImportance(booster, -1, 1),
                "names": m.LGBM_BoosterGetFeatureNames(booster),
                "classes": m.LGBM_BoosterGetNumClasses(booster),
                "dump": m.LGBM_BoosterDumpModel(booster)}
    _assert_same(*_both(drive))


def test_fast_single_row(boosters, data2):
    X, _ = data2

    def drive(m):
        booster = boosters[m]
        _, fc = m.LGBM_BoosterPredictForMatSingleRowFastInit(
            booster, ncol=X.shape[1])
        _, p = m.LGBM_BoosterPredictForMatSingleRowFast(fc, X[3])
        _, ref = m.LGBM_BoosterPredictForMat(booster, X[3:4])
        assert p == pytest.approx(np.asarray(ref)[0])
        m.LGBM_FastConfigFree(fc)

        _, fc2 = m.LGBM_BoosterPredictForCSRSingleRowFastInit(
            booster, num_col=X.shape[1])
        row = sp.csr_matrix(X[5:6])
        _, p2 = m.LGBM_BoosterPredictForCSRSingleRowFast(fc2, row)
        assert p2 == pytest.approx(np.asarray(
            m.LGBM_BoosterPredictForMat(booster, X[5:6])[1])[0])
        # (indices, values) form
        nz = np.nonzero(X[5])[0]
        _, p3 = m.LGBM_BoosterPredictForCSRSingleRowFast(
            fc2, (nz, X[5][nz]))
        assert p3 == pytest.approx(p2)
        m.LGBM_FastConfigFree(fc2)
        return {"mat": p, "csr": p2, "pairs": p3}
    _assert_same(*_both(drive))


def test_predict_mats_and_sparse_contrib(boosters, data2):
    X, _ = data2

    def drive(m):
        booster = boosters[m]
        _, pm = m.LGBM_BoosterPredictForMats(booster, [X[0], X[1], X[2]])
        _, ref = m.LGBM_BoosterPredictForMat(booster, X[:3])
        np.testing.assert_allclose(pm, ref, rtol=1e-6)

        csr = sp.csr_matrix(X[:50])
        _, sparse = m.LGBM_BoosterPredictSparseOutput(
            booster, csr, m.C_API_PREDICT_CONTRIB)
        dense = m.LGBM_BoosterPredictForCSR(
            booster, csr, m.C_API_PREDICT_CONTRIB)[1]
        np.testing.assert_allclose(np.asarray(sparse.todense()), dense,
                                   rtol=1e-6, atol=1e-9)
        assert m.LGBM_BoosterFreePredictSparse()[0] == 0
        return {"mats": pm, "sparse": sparse, "dense": dense}
    _assert_same(*_both(drive),
                 close={"sparse": SHAP_RTOL, "dense": SHAP_RTOL})


def test_merge_and_shuffle(data2):
    X, y = data2

    def drive(m):
        def train(rounds, seed):
            _, dh = m.LGBM_DatasetCreateFromMat(
                X, f"objective=binary verbosity=-1 seed={seed}", label=y)
            _, bh = m.LGBM_BoosterCreate(
                dh, _p(f"objective=binary num_leaves=7 verbosity=-1 "
                       f"seed={seed}"))
            for _ in range(rounds):
                m.LGBM_BoosterUpdateOneIter(bh)
            return bh
        a, b = train(4, 1), train(3, 2)
        m.LGBM_BoosterMerge(a, b)
        assert m.LGBM_BoosterNumberOfTotalModel(a)[1] == 7
        pr = m.LGBM_BoosterPredictForMat(a, X)[1]
        assert np.all(np.isfinite(pr))
        merged = m.LGBM_BoosterSaveModelToString(a)[1]
        # shuffle changes tree order but not the (additive) predictions
        m.LGBM_BoosterShuffleModels(a, 0, -1)
        shuffled = m.LGBM_BoosterPredictForMat(a, X)[1]
        np.testing.assert_allclose(shuffled, pr, rtol=1e-5, atol=1e-7)
        return {"merged": merged, "pred": pr, "shuffled": shuffled,
                "order": m.LGBM_BoosterSaveModelToString(a)[1]}
    _assert_same(*_both(drive))


def test_reset_training_data(data2):
    X, y = data2
    rng = np.random.RandomState(3)
    X2 = rng.randn(300, 6)
    y2 = (X2[:, 0] + 0.5 * X2[:, 1] > 0.2).astype(np.float64)

    def drive(m):
        _, dh = m.LGBM_DatasetCreateFromMat(
            X, "objective=binary verbosity=-1", label=y)
        _, bh = m.LGBM_BoosterCreate(
            dh, _p("objective=binary num_leaves=7 verbosity=-1 "
                   "metric=binary_logloss"))
        for _ in range(4):
            m.LGBM_BoosterUpdateOneIter(bh)
        _, dh2 = m.LGBM_DatasetCreateFromMat(
            X2, "objective=binary verbosity=-1", label=y2, reference=dh)
        assert m.LGBM_BoosterResetTrainingData(bh, dh2)[0] == 0
        # model kept; training continues on the NEW data
        assert m.LGBM_BoosterNumberOfTotalModel(bh)[1] == 4
        assert m.LGBM_BoosterGetNumPredict(bh, 0)[1] == 300
        for _ in range(4):
            m.LGBM_BoosterUpdateOneIter(bh)
        assert m.LGBM_BoosterNumberOfTotalModel(bh)[1] == 8
        pr = m.LGBM_BoosterPredictForMat(bh, X2)[1]
        ll = -np.mean(y2 * np.log(np.clip(pr, 1e-9, 1)) +
                      (1 - y2) * np.log(np.clip(1 - pr, 1e-9, 1)))
        assert ll < 0.6
        return {"pred": pr, "evals": m.LGBM_BoosterGetEval(bh, 0),
                "text": m.LGBM_BoosterSaveModelToString(bh)[1]}
    # the texts are equal; the reference's dense program rounds 128 of
    # the 300 rows one f32 step from its walk (the port's equals the walk)
    _assert_same(*_both(drive), close={"pred": DENSE_RTOL})


def test_dataset_extras(data2, tmp_path):
    X, y = data2

    def drive(m):
        # feature names set/get
        _, dh = m.LGBM_DatasetCreateFromMat(
            X, "objective=binary verbosity=-1", label=y)
        names = [f"f{i}" for i in range(6)]
        m.LGBM_DatasetSetFeatureNames(dh, names)
        assert m.LGBM_DatasetGetFeatureNames(dh)[1] == names
        # dump text
        path = str(tmp_path / f"dump_{m.__name__}.txt")
        m.LGBM_DatasetDumpText(dh, path)
        dump = open(path).read()
        head = dump.splitlines()
        assert head[0] == "num_data: 500" and "f3" in head[2]
        # param checking
        assert m.LGBM_DatasetUpdateParamChecking(
            "max_bin=255 learning_rate=0.1",
            "max_bin=255 learning_rate=0.2")[0] == 0
        with pytest.raises(ValueError) as err:
            m.LGBM_DatasetUpdateParamChecking("max_bin=255", "max_bin=63")

        # mats create == mat create
        _, dh2 = m.LGBM_DatasetCreateFromMats(
            [X[:200], X[200:]], "objective=binary verbosity=-1", label=y)
        assert m.LGBM_DatasetGetNumData(dh2)[1] == 500

        # CSR-func create
        csr = sp.csr_matrix(X)

        def get_row(i):
            lo, hi = csr.indptr[i], csr.indptr[i + 1]
            return csr.indices[lo:hi], csr.data[lo:hi]
        _, dh3 = m.LGBM_DatasetCreateFromCSRFunc(
            get_row, 500, 6,
            "objective=binary verbosity=-1 min_data_in_bin=1", label=y)
        assert m.LGBM_DatasetGetNumData(dh3)[1] == 500

        # add features from (needs retained raw data)
        _, a = m.LGBM_DatasetCreateFromMat(
            X[:, :3], "verbosity=-1 free_raw_data=false")
        _, b = m.LGBM_DatasetCreateFromMat(
            X[:, 3:], "verbosity=-1 free_raw_data=false")
        assert m.LGBM_DatasetAddFeaturesFrom(a, b)[0] == 0
        ds = m._get(a)
        assert ds.data.shape == (500, 6)
        dumps = []
        for h in (dh2, dh3):
            p = str(tmp_path / f"dump{h}_{m.__name__}.txt")
            m.LGBM_DatasetDumpText(h, p)
            dumps.append(open(p).read())
        return {"dump": dump, "param_error": str(err.value),
                "dumps": dumps, "added": np.asarray(ds.data)}
    _assert_same(*_both(drive))


def test_sampled_column_streaming(data2):
    X, y = data2
    cols = [X[:100, j].copy() for j in range(6)]
    idx = [np.arange(100)] * 6

    def drive(m):
        code, dh = m.LGBM_DatasetCreateFromSampledColumn(
            cols, idx, 500, "objective=binary verbosity=-1")
        assert code == 0
        for lo in range(0, 500, 125):
            m.LGBM_DatasetPushRows(dh, X[lo:lo + 125], lo)
        m.LGBM_DatasetSetField(dh, "label", y)
        _, bh = m.LGBM_BoosterCreate(
            dh, _p("objective=binary num_leaves=7 verbosity=-1"))
        for _ in range(4):
            m.LGBM_BoosterUpdateOneIter(bh)
        pr = m.LGBM_BoosterPredictForMat(bh, X)[1]
        assert np.all(np.isfinite(pr))
        return {"pred": pr, "text": m.LGBM_BoosterSaveModelToString(bh)[1]}
    _assert_same(*_both(drive))


def test_log_callback_and_set_error():
    from lightgbm_tpu_torch.utils import log as port_log
    from lightgbm_tpu.utils import log as ref_log
    logs = {capi: port_log, ref_capi: ref_log}

    def drive(m):
        lines = []
        m.LGBM_RegisterLogCallback(lambda msg: lines.append(msg))
        logs[m].set_verbosity(1)
        logs[m].log_info("hello-capi")
        m.LGBM_RegisterLogCallback(None)
        assert any("hello-capi" in ln for ln in lines)
        m.LGBM_SetLastError("boom")
        assert m.LGBM_GetLastError() == "boom"
        return {"lines": lines}
    _assert_same(*_both(drive))


def test_network_with_functions_single():
    for m in (capi, ref_capi):
        assert m.LGBM_NetworkInitWithFunctions(1, 0)[0] == 0
        with pytest.raises(NotImplementedError):
            m.LGBM_NetworkInitWithFunctions(2, 0)


# ---------------------------------------------------------------------------
# reference tests/test_capi_native.py: the shims through ctypes
# ---------------------------------------------------------------------------

_SHIM = build_capi_shim()
_REF_SHIM = ref_native.build_capi_shim()

needs_shim = pytest.mark.skipif(
    _SHIM is None or _REF_SHIM is None,
    reason="native toolchain/python headers unavailable")


def _load(path):
    lib = ctypes.CDLL(path)
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    lib.LGBM_DatasetCreateFromMat.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.LGBM_DatasetSetField.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int]
    lib.LGBM_BoosterCreate.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.LGBM_BoosterUpdateOneIter.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    lib.LGBM_BoosterPredictForMat.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double)]
    lib.LGBM_BoosterSaveModel.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_char_p]
    lib.LGBM_BoosterCreateFromModelfile.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p)]
    return lib


def _both_shims(drive, *args):
    """``drive(lib, tag, *args)`` through the port's shim and the
    reference's: (the port's results, the reference's)."""
    return (drive(_load(_SHIM), "port", *args),
            drive(_load(_REF_SHIM), "ref", *args))


@needs_shim
def test_native_abi_train_predict_roundtrip(tmp_path):
    rng = np.random.RandomState(4)
    X = np.ascontiguousarray(rng.randn(300, 4))
    y = np.ascontiguousarray(
        (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32))

    def drive(lib, tag):
        dh = ctypes.c_void_p()
        code = lib.LGBM_DatasetCreateFromMat(
            X.ctypes.data_as(ctypes.c_void_p), 1, 300, 4, 1,
            b"objective=binary verbosity=-1 min_data_in_leaf=5", None,
            ctypes.byref(dh))
        assert code == 0, lib.LGBM_GetLastError()
        code = lib.LGBM_DatasetSetField(
            dh, b"label", y.ctypes.data_as(ctypes.c_void_p), 300, 0)
        assert code == 0, lib.LGBM_GetLastError()

        bh = ctypes.c_void_p()
        code = lib.LGBM_BoosterCreate(
            dh, _p("objective=binary num_leaves=7 verbosity=-1 "
                   "min_data_in_leaf=5").encode(), ctypes.byref(bh))
        assert code == 0, lib.LGBM_GetLastError()
        fin = ctypes.c_int(0)
        for _ in range(5):
            assert lib.LGBM_BoosterUpdateOneIter(bh, ctypes.byref(fin)) == 0

        out = np.zeros(300, np.float64)
        out_len = ctypes.c_int64(0)
        code = lib.LGBM_BoosterPredictForMat(
            bh, X.ctypes.data_as(ctypes.c_void_p), 1, 300, 4, 1, 0, 0, -1,
            b"", ctypes.byref(out_len),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        assert code == 0, lib.LGBM_GetLastError()
        assert out_len.value == 300
        assert np.isfinite(out).all() and 0 < out.mean() < 1
        # the model learned something
        auc_ord = np.argsort(out)
        assert y[auc_ord[-50:]].mean() > y[auc_ord[:50]].mean()

        # model file round trip through the ABI, checked against python API
        model = str(tmp_path / f"native_model_{tag}.txt").encode()
        assert lib.LGBM_BoosterSaveModel(bh, 0, -1, 0, model) == 0
        it = ctypes.c_int(0)
        bh2 = ctypes.c_void_p()
        assert lib.LGBM_BoosterCreateFromModelfile(
            model, ctypes.byref(it), ctypes.byref(bh2)) == 0
        assert it.value == 5
        out2 = np.zeros(300, np.float64)
        assert lib.LGBM_BoosterPredictForMat(
            bh2, X.ctypes.data_as(ctypes.c_void_p), 1, 300, 4, 1, 0, 0, -1,
            CPU.encode(), ctypes.byref(out_len),
            out2.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) == 0
        np.testing.assert_allclose(out2, out, rtol=1e-9)

        if tag == "port":
            py_pred = lt.Booster(model_file=model.decode(),
                                 device="cpu").predict(X)
            np.testing.assert_allclose(out, py_pred, rtol=1e-7, atol=1e-9)

        # float32 column-major input path
        X32 = np.asfortranarray(X.astype(np.float32))
        out3 = np.zeros(300, np.float64)
        assert lib.LGBM_BoosterPredictForMat(
            bh, X32.ctypes.data_as(ctypes.c_void_p), 0, 300, 4, 0, 0, 0, -1,
            b"", ctypes.byref(out_len),
            out3.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) == 0
        np.testing.assert_allclose(out3, out, rtol=1e-5, atol=1e-6)

        # error contract through the ABI
        bad = ctypes.c_void_p()
        code = lib.LGBM_BoosterCreate(ctypes.c_void_p(99999), b"",
                                      ctypes.byref(bad))
        assert code == -1
        err = lib.LGBM_GetLastError()
        assert b"handle" in err

        assert lib.LGBM_BoosterFree(bh) == 0
        assert lib.LGBM_BoosterFree(bh2) == 0
        assert lib.LGBM_DatasetFree(dh) == 0
        return {"out": out, "loaded": out2, "f32_fortran": out3,
                "file": open(model, "rb").read(), "error": err}
    _assert_same(*_both_shims(drive))


_ALL_C_SYMBOLS = [
    # the complete extern-C surface of reference include/LightGBM/c_api.h
    "LGBM_BoosterAddValidData", "LGBM_BoosterCalcNumPredict",
    "LGBM_BoosterCreate", "LGBM_BoosterCreateFromModelfile",
    "LGBM_BoosterDumpModel", "LGBM_BoosterFeatureImportance",
    "LGBM_BoosterFree", "LGBM_BoosterFreePredictSparse",
    "LGBM_BoosterGetCurrentIteration", "LGBM_BoosterGetEval",
    "LGBM_BoosterGetEvalCounts", "LGBM_BoosterGetEvalNames",
    "LGBM_BoosterGetFeatureNames", "LGBM_BoosterGetLeafValue",
    "LGBM_BoosterGetLinear", "LGBM_BoosterGetLowerBoundValue",
    "LGBM_BoosterGetNumClasses", "LGBM_BoosterGetNumFeature",
    "LGBM_BoosterGetNumPredict", "LGBM_BoosterGetPredict",
    "LGBM_BoosterGetUpperBoundValue", "LGBM_BoosterLoadModelFromString",
    "LGBM_BoosterMerge", "LGBM_BoosterNumModelPerIteration",
    "LGBM_BoosterNumberOfTotalModel", "LGBM_BoosterPredictForCSC",
    "LGBM_BoosterPredictForCSR", "LGBM_BoosterPredictForCSRSingleRow",
    "LGBM_BoosterPredictForCSRSingleRowFast",
    "LGBM_BoosterPredictForCSRSingleRowFastInit",
    "LGBM_BoosterPredictForFile", "LGBM_BoosterPredictForMat",
    "LGBM_BoosterPredictForMatSingleRow",
    "LGBM_BoosterPredictForMatSingleRowFast",
    "LGBM_BoosterPredictForMatSingleRowFastInit",
    "LGBM_BoosterPredictForMats", "LGBM_BoosterPredictSparseOutput",
    "LGBM_BoosterRefit", "LGBM_BoosterResetParameter",
    "LGBM_BoosterResetTrainingData", "LGBM_BoosterRollbackOneIter",
    "LGBM_BoosterSaveModel", "LGBM_BoosterSaveModelToString",
    "LGBM_BoosterSetLeafValue", "LGBM_BoosterShuffleModels",
    "LGBM_BoosterUpdateOneIter", "LGBM_BoosterUpdateOneIterCustom",
    "LGBM_DatasetAddFeaturesFrom", "LGBM_DatasetCreateByReference",
    "LGBM_DatasetCreateFromCSC", "LGBM_DatasetCreateFromCSR",
    "LGBM_DatasetCreateFromCSRFunc", "LGBM_DatasetCreateFromFile",
    "LGBM_DatasetCreateFromMat", "LGBM_DatasetCreateFromMats",
    "LGBM_DatasetCreateFromSampledColumn", "LGBM_DatasetDumpText",
    "LGBM_DatasetFree", "LGBM_DatasetGetFeatureNames",
    "LGBM_DatasetGetField", "LGBM_DatasetGetNumData",
    "LGBM_DatasetGetNumFeature", "LGBM_DatasetGetSubset",
    "LGBM_DatasetPushRows", "LGBM_DatasetPushRowsByCSR",
    "LGBM_DatasetSaveBinary", "LGBM_DatasetSetFeatureNames",
    "LGBM_DatasetSetField", "LGBM_DatasetUpdateParamChecking",
    "LGBM_FastConfigFree", "LGBM_NetworkFree", "LGBM_NetworkInit",
    "LGBM_NetworkInitWithFunctions", "LGBM_RegisterLogCallback",
    "LGBM_GetLastError",
]


def _reference_shim_symbols():
    """The ``LGBM_*`` functions the reference's shim source defines."""
    src = os.path.join(ref_native._NATIVE_DIR, "capi_shim.cc")
    with open(src) as fh:
        return sorted(set(re.findall(
            r"^(?:int|const char\*)\s+(LGBM_\w+)\(", fh.read(), re.M)))


@needs_shim
def test_all_c_api_symbols_resolve():
    """Every c_api.h symbol, and every symbol the reference's shim
    defines, must dlsym from the port's shim (and the reference's) — a
    real C/R/Java client never hits an unresolved symbol."""
    ref_symbols = _reference_shim_symbols()
    assert set(_ALL_C_SYMBOLS) <= set(ref_symbols)
    for path in (_SHIM, _REF_SHIM):
        lib = ctypes.CDLL(path)
        missing = []
        for name in ref_symbols:
            try:
                getattr(lib, name)
            except AttributeError:
                missing.append(name)
        assert not missing, f"unresolved in {path}: {missing}"


@needs_shim
def test_reference_style_csr_fast_and_strings(tmp_path):
    """Reference tests/c_api_test/test_.py style drive: CSR dataset,
    training, GetEvalNames (char** convention), SaveModelToString,
    fast single-row init/predict, leaf get/set, bounds."""
    rng = np.random.RandomState(5)
    X = np.ascontiguousarray(rng.randn(400, 5))
    X[X < -1.2] = 0.0
    y = np.ascontiguousarray(
        (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.float32))
    csr = sp.csr_matrix(X)
    indptr = np.ascontiguousarray(csr.indptr.astype(np.int32))
    indices = np.ascontiguousarray(csr.indices.astype(np.int32))
    data = np.ascontiguousarray(csr.data.astype(np.float64))

    def drive(lib, tag):
        dh = ctypes.c_void_p()
        rc = lib.LGBM_DatasetCreateFromCSR(
            indptr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(0),
            indices.ctypes.data_as(ctypes.c_void_p),
            data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(1),
            ctypes.c_int64(len(indptr)), ctypes.c_int64(csr.nnz),
            ctypes.c_int64(5),
            b"objective=binary verbosity=-1 min_data_in_bin=1", None,
            ctypes.byref(dh))
        assert rc == 0, lib.LGBM_GetLastError()
        rc = lib.LGBM_DatasetSetField(
            dh, b"label", y.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_int(400), ctypes.c_int(0))
        assert rc == 0, lib.LGBM_GetLastError()

        bh = ctypes.c_void_p()
        rc = lib.LGBM_BoosterCreate(
            dh, _p("objective=binary num_leaves=15 verbosity=-1 "
                   "metric=binary_logloss,auc").encode(), ctypes.byref(bh))
        assert rc == 0, lib.LGBM_GetLastError()
        fin = ctypes.c_int(0)
        for _ in range(8):
            assert lib.LGBM_BoosterUpdateOneIter(bh, ctypes.byref(fin)) == 0

        # GetEvalNames through the (len, buffer_len, char**) convention
        n_metrics = ctypes.c_int(0)
        assert lib.LGBM_BoosterGetEvalCounts(bh,
                                             ctypes.byref(n_metrics)) == 0
        assert n_metrics.value == 2
        bufs = [(ctypes.c_char * 64)() for _ in range(n_metrics.value)]
        arr = (ctypes.c_char_p * n_metrics.value)(
            *[ctypes.addressof(b) for b in bufs])
        out_n = ctypes.c_int(0)
        out_buf = ctypes.c_size_t(0)
        rc = lib.LGBM_BoosterGetEvalNames(
            bh, ctypes.c_int(n_metrics.value), ctypes.byref(out_n),
            ctypes.c_size_t(64), ctypes.byref(out_buf), arr)
        assert rc == 0, lib.LGBM_GetLastError()
        names = [bufs[i].value.decode() for i in range(out_n.value)]
        assert set(names) == {"binary_logloss", "auc"}

        # eval values land in a double buffer
        evals = np.zeros(2, np.float64)
        out_len = ctypes.c_int(0)
        rc = lib.LGBM_BoosterGetEval(
            bh, ctypes.c_int(0), ctypes.byref(out_len),
            evals.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        assert rc == 0 and out_len.value == 2

        # model string round trip
        out_sz = ctypes.c_int64(0)
        rc = lib.LGBM_BoosterSaveModelToString(
            bh, 0, -1, 0, ctypes.c_int64(0), ctypes.byref(out_sz), None)
        assert rc == 0 and out_sz.value > 100
        buf = ctypes.create_string_buffer(out_sz.value)
        rc = lib.LGBM_BoosterSaveModelToString(
            bh, 0, -1, 0, ctypes.c_int64(out_sz.value),
            ctypes.byref(out_sz), buf)
        assert rc == 0 and b"tree" in buf.value
        bh2 = ctypes.c_void_p()
        it2 = ctypes.c_int(0)
        assert lib.LGBM_BoosterLoadModelFromString(
            buf.value, ctypes.byref(it2), ctypes.byref(bh2)) == 0
        assert it2.value == 8

        # dense predict == CSR predict
        pred = np.zeros(400, np.float64)
        plen = ctypes.c_int64(0)
        Xc = np.ascontiguousarray(X, np.float64)
        assert lib.LGBM_BoosterPredictForMat(
            bh, Xc.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(1),
            ctypes.c_int32(400), ctypes.c_int32(5), ctypes.c_int(1),
            ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(-1), b"",
            ctypes.byref(plen),
            pred.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) == 0
        pred_csr = np.zeros(400, np.float64)
        assert lib.LGBM_BoosterPredictForCSR(
            bh, indptr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(0),
            indices.ctypes.data_as(ctypes.c_void_p),
            data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(1),
            ctypes.c_int64(len(indptr)), ctypes.c_int64(csr.nnz),
            ctypes.c_int64(5), ctypes.c_int(0), ctypes.c_int(0),
            ctypes.c_int(-1), b"", ctypes.byref(plen),
            pred_csr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) == 0
        np.testing.assert_allclose(pred_csr, pred, rtol=1e-6)

        # fast single-row
        fc = ctypes.c_void_p()
        assert lib.LGBM_BoosterPredictForMatSingleRowFastInit(
            bh, ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(-1),
            ctypes.c_int(1), ctypes.c_int32(5), b"", ctypes.byref(fc)) == 0
        row = np.ascontiguousarray(X[7], np.float64)
        one = np.zeros(1, np.float64)
        assert lib.LGBM_BoosterPredictForMatSingleRowFast(
            fc, row.ctypes.data_as(ctypes.c_void_p), ctypes.byref(plen),
            one.ctypes.data_as(ctypes.POINTER(ctypes.c_double))) == 0
        assert one[0] == pytest.approx(pred[7], rel=1e-6)
        assert lib.LGBM_FastConfigFree(fc) == 0

        # leaf get/set + bounds
        lv = ctypes.c_double(0.0)
        assert lib.LGBM_BoosterGetLeafValue(
            bh, 0, 0, ctypes.byref(lv)) == 0
        assert lib.LGBM_BoosterSetLeafValue(
            bh, 0, 0, ctypes.c_double(lv.value)) == 0
        lo = ctypes.c_double(0.0)
        hi = ctypes.c_double(0.0)
        assert lib.LGBM_BoosterGetLowerBoundValue(bh, ctypes.byref(lo)) == 0
        assert lib.LGBM_BoosterGetUpperBoundValue(bh, ctypes.byref(hi)) == 0
        assert lo.value < hi.value

        lib.LGBM_BoosterFree(bh)
        lib.LGBM_BoosterFree(bh2)
        lib.LGBM_DatasetFree(dh)
        return {"names": names, "evals": evals, "text": buf.value,
                "pred": pred, "pred_csr": pred_csr, "one": one,
                "leaf": lv.value, "bounds": (lo.value, hi.value)}
    _assert_same(*_both_shims(drive))


@needs_shim
def test_native_sparse_contrib_output_of_a_loaded_model(tmp_path):
    """PredictSparseOutput through the ABI on a booster loaded from a
    model file: the predict ``parameter`` string reaches the port (it
    places the loaded booster on the CPU here), and the CSR buffers the
    shim allocates hold the dense contributions and the reference C
    API's sparse output on the same model file.  (The reference's shim
    relays this call with too few arguments and returns -1, so the
    reference is driven through its Python C API here.)"""
    rng = np.random.RandomState(6)
    X = rng.randn(200, 4)
    y = (X[:, 0] > 0).astype(np.float64)
    bst = lt.train({"objective": "binary", "num_leaves": 7,
                    "verbosity": -1}, lt.Dataset(X, label=y), 3,
                   device="cpu")
    path = str(tmp_path / "m.txt")
    bst.save_model(path)
    csr = sp.csr_matrix(X[:20])
    indptr = np.ascontiguousarray(csr.indptr.astype(np.int32))
    indices = np.ascontiguousarray(csr.indices.astype(np.int32))
    data = np.ascontiguousarray(csr.data.astype(np.float64))

    lib = ctypes.CDLL(_SHIM)
    lib.LGBM_GetLastError.restype = ctypes.c_char_p
    bh = ctypes.c_void_p()
    it = ctypes.c_int(0)
    assert lib.LGBM_BoosterCreateFromModelfile(
        path.encode(), ctypes.byref(it), ctypes.byref(bh)) == 0
    out_len = (ctypes.c_int64 * 2)()
    o_ip, o_ix, o_dv = (ctypes.c_void_p(), ctypes.POINTER(ctypes.c_int32)(),
                        ctypes.c_void_p())
    rc = lib.LGBM_BoosterPredictSparseOutput(
        bh, indptr.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(0),
        indices.ctypes.data_as(ctypes.c_void_p),
        data.ctypes.data_as(ctypes.c_void_p), ctypes.c_int(1),
        ctypes.c_int64(len(indptr)), ctypes.c_int64(csr.nnz),
        ctypes.c_int64(4), ctypes.c_int(capi.C_API_PREDICT_CONTRIB),
        ctypes.c_int(0), ctypes.c_int(-1), CPU.encode(),
        ctypes.c_int(0), out_len, ctypes.byref(o_ip), ctypes.byref(o_ix),
        ctypes.byref(o_dv))
    assert rc == 0, lib.LGBM_GetLastError()
    nnz, nptr = out_len[0], out_len[1]
    ip = np.ctypeslib.as_array(ctypes.cast(o_ip, ctypes.POINTER(
        ctypes.c_int32)), (nptr,)).copy()
    ix = np.ctypeslib.as_array(o_ix, (nnz,)).copy()
    dv = np.ctypeslib.as_array(ctypes.cast(o_dv, ctypes.POINTER(
        ctypes.c_double)), (nnz,)).copy()
    got = sp.csr_matrix((dv, ix, ip), shape=(20, 5))
    np.testing.assert_allclose(got.toarray(),
                               bst.predict(X[:20], pred_contrib=True),
                               rtol=1e-6, atol=1e-9)
    assert lib.LGBM_BoosterFreePredictSparse(o_ip, o_ix, o_dv, 0, 1) == 0
    assert lib.LGBM_BoosterFree(bh) == 0

    _, rh = ref_capi.LGBM_BoosterCreateFromModelfile(path)
    _, want = ref_capi.LGBM_BoosterPredictSparseOutput(
        rh, csr, ref_capi.C_API_PREDICT_CONTRIB)
    assert got.shape == want.shape
    _assert_same({"contrib": got}, {"contrib": want},
                 close={"contrib": SHAP_RTOL})
