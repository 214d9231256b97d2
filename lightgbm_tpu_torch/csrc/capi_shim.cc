// Native LGBM_* ABI shim of lightgbm_tpu_torch: the port's own copy of
// native/capi_shim.cc, the FULL 74-symbol extern "C" surface of LightGBM
// (include/LightGBM/c_api.h), with LightGBM's out-pointer calling
// convention, backed by the port's in-process Python surface
// (lightgbm_tpu_torch/capi.py) through an embedded CPython interpreter.
//
// Design: every exported function is a thin relay — scalars, strings and
// RAW POINTER ADDRESSES cross into a Python helper prelude (defined
// below) which wraps the addresses with ctypes+numpy, calls
// lightgbm_tpu_torch.capi, and writes results back through the caller's out
// pointers.  Handles are the Python registry's integer ids cast to
// void*.  The -1 + LGBM_GetLastError error contract is preserved
// (exceptions are swallowed inside the helper _wrap, so the in-process
// Python capi's raise-by-default mode is untouched).
//
// Lifecycle: if a Python interpreter already exists in the process (the
// common embedding test: ctypes.CDLL from Python), it is reused via
// PyGILState; otherwise one is initialized and its GIL released so any
// thread may call in.
//
// Build: lightgbm_tpu_torch/utils/native.py build_capi_shim() —
//   g++ -O2 -shared -fPIC -std=c++17 capi_shim.cc -I<python include>
//   -lpython3.X -o build/capi/liblightgbm_tpu_torch_capi-py3.X.so

#include <Python.h>

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <string>

namespace {

std::mutex g_mu;
PyObject* g_helpers = nullptr;  // module dict holding the prelude
// thread-local like the reference's last-error storage, so concurrent
// callers never race on the message buffer
thread_local std::string g_last_error = "ok";

const char* safe_utf8(PyObject* s, const char* fallback) {
  const char* c = s ? PyUnicode_AsUTF8(s) : nullptr;
  if (c == nullptr) {
    PyErr_Clear();
    return fallback;
  }
  return c;
}

const char kPrelude[] = R"PY(
import ctypes
import numpy as np
import lightgbm_tpu_torch.capi as capi

_DT = {0: np.float32, 1: np.float64, 2: np.int32, 3: np.int64}
# keep-alive store for arrays whose raw pointers were handed to C
# (DatasetGetField, PredictSparseOutput) — freed by the matching Free call
_keep = {}


def _wrap(fn):
    """-1 codes for the C surface: exceptions are caught HERE, so the
    in-process Python capi keeps its raise-by-default mode untouched
    (no global flag flip; safe under concurrent in-process users)."""
    def inner(*args):
        try:
            return fn(*args)
        except Exception as e:  # noqa: BLE001 — the ABI swallows into -1
            capi._last_error[0] = f"{type(e).__name__}: {e}"
            return (-1,)
    return inner


def _mat(addr, data_type, nrow, ncol, is_row_major):
    n = int(nrow) * int(ncol)
    dt = _DT[int(data_type)]
    buf = (ctypes.c_char * (n * np.dtype(dt).itemsize)).from_address(addr)
    a = np.frombuffer(buf, dtype=dt, count=n)
    return a.reshape((nrow, ncol)) if is_row_major else \
        a.reshape((ncol, nrow)).T


def _vec(addr, data_type, n):
    dt = _DT[int(data_type)]
    buf = (ctypes.c_char * (int(n) * np.dtype(dt).itemsize)).from_address(
        addr)
    return np.frombuffer(buf, dtype=dt, count=int(n))


def _csr(indptr, indptr_type, indices, data, data_type, nindptr, nelem,
         num_col):
    import scipy.sparse as sp
    ip = np.array(_vec(indptr, 2 if indptr_type == 0 else 3, nindptr),
                  np.int64)
    ix = np.array(_vec(indices, 2, nelem), np.int32)
    dv = np.array(_vec(data, data_type, nelem), np.float64)
    return sp.csr_matrix((dv, ix, ip),
                         shape=(int(nindptr) - 1, int(num_col)))


def _csc(col_ptr, col_ptr_type, indices, data, data_type, ncol_ptr, nelem,
         num_row):
    import scipy.sparse as sp
    cp = np.array(_vec(col_ptr, 2 if col_ptr_type == 0 else 3, ncol_ptr),
                  np.int64)
    ix = np.array(_vec(indices, 2, nelem), np.int32)
    dv = np.array(_vec(data, data_type, nelem), np.float64)
    return sp.csc_matrix((dv, ix, cp),
                         shape=(int(num_row), int(ncol_ptr) - 1))


def _out_f64(addr, arr):
    arr = np.atleast_1d(np.asarray(arr, np.float64)).ravel()
    np.copyto(_vec(addr, 1, len(arr)), arr)
    return len(arr)


def _err():
    return capi.LGBM_GetLastError()


# ---- dataset helpers ----

def dataset_from_mat(addr, data_type, nrow, ncol, is_row_major, params,
                     ref):
    X = np.array(_mat(addr, data_type, nrow, ncol, is_row_major),
                 np.float64)
    code, h = capi.LGBM_DatasetCreateFromMat(
        X, params, reference=(ref or None))
    return code, (h or 0)


def dataset_from_mats(addrs_addr, nmat, data_type, nrows_addr, ncol,
                      is_row_major, params, ref):
    addrs = np.array(_vec(addrs_addr, 3, nmat), np.int64)
    nrows = np.array(_vec(nrows_addr, 2, nmat), np.int32)
    mats = [np.array(_mat(int(a), data_type, int(nr), ncol, is_row_major),
                     np.float64) for a, nr in zip(addrs, nrows)]
    code, h = capi.LGBM_DatasetCreateFromMats(
        mats, params, reference=(ref or None))
    return code, (h or 0)


def dataset_from_csr(indptr, indptr_type, indices, data, data_type,
                     nindptr, nelem, num_col, params, ref):
    m = _csr(indptr, indptr_type, indices, data, data_type, nindptr,
             nelem, num_col)
    code, h = capi.LGBM_DatasetCreateFromCSR(m, params,
                                             reference=(ref or None))
    return code, (h or 0)


def dataset_from_csc(col_ptr, col_ptr_type, indices, data, data_type,
                     ncol_ptr, nelem, num_row, params, ref):
    m = _csc(col_ptr, col_ptr_type, indices, data, data_type, ncol_ptr,
             nelem, num_row)
    code, h = capi.LGBM_DatasetCreateFromCSC(m, params,
                                             reference=(ref or None))
    return code, (h or 0)


def dataset_from_file(filename, params, ref):
    code, h = capi.LGBM_DatasetCreateFromFile(filename, params,
                                              reference=(ref or None))
    return code, (h or 0)


def dataset_from_sampled(sample_addr, indices_addr, ncol, num_per_col_addr,
                         num_sample_row, num_total_row, params):
    col_addrs = np.array(_vec(sample_addr, 3, ncol), np.int64)
    idx_addrs = np.array(_vec(indices_addr, 3, ncol), np.int64)
    counts = np.array(_vec(num_per_col_addr, 2, ncol), np.int32)
    cols = [np.array(_vec(int(a), 1, int(c))) for a, c in
            zip(col_addrs, counts)]
    idxs = [np.array(_vec(int(a), 2, int(c))) for a, c in
            zip(idx_addrs, counts)]
    code, h = capi.LGBM_DatasetCreateFromSampledColumn(
        cols, idxs, num_total_row, params, num_sample_row=num_sample_row)
    return code, (h or 0)


def dataset_by_reference(ref, num_total_row):
    code, h = capi.LGBM_DatasetCreateByReference(ref, num_total_row)
    return code, (h or 0)


def dataset_push_rows(handle, addr, data_type, nrow, ncol, start_row):
    X = np.array(_mat(addr, data_type, nrow, ncol, 1), np.float64)
    code, _ = capi.LGBM_DatasetPushRows(handle, X, start_row)
    return code, 0


def dataset_push_rows_csr(handle, indptr, indptr_type, indices, data,
                          data_type, nindptr, nelem, num_col, start_row):
    m = _csr(indptr, indptr_type, indices, data, data_type, nindptr,
             nelem, num_col)
    code, _ = capi.LGBM_DatasetPushRowsByCSR(handle, m, start_row)
    return code, 0


def dataset_get_subset(handle, idx_addr, n_idx, params):
    idx = np.array(_vec(idx_addr, 2, n_idx), np.int64)
    code, h = capi.LGBM_DatasetGetSubset(handle, idx, params)
    return code, (h or 0)


def dataset_set_feature_names(handle, joined):
    code, _ = capi.LGBM_DatasetSetFeatureNames(handle, joined.split("\t"))
    return code, 0


def dataset_get_feature_names(handle):
    code, names = capi.LGBM_DatasetGetFeatureNames(handle)
    return code, "\t".join(names)


def dataset_set_field(handle, name, addr, num_element, data_type):
    v = np.array(_vec(addr, data_type, num_element))
    code, _ = capi.LGBM_DatasetSetField(handle, name, v)
    return code, 0


def dataset_get_field(handle, name):
    code, v = capi.LGBM_DatasetGetField(handle, name)
    if v is None:
        return 0, 0, 0, 0
    if name in ("group", "query"):
        arr = np.ascontiguousarray(v, np.int32)
        dtype = 2
    else:
        arr = np.ascontiguousarray(v, np.float32)
        dtype = 0
    # APPEND (never replace): the reference keeps every pointer handed
    # out valid until DatasetFree, including older results of repeated
    # GetField calls for the same field
    _keep.setdefault(("field", handle, name), []).append(arr)
    return code, len(arr), arr.ctypes.data, dtype


def dataset_free(handle):
    _keep_keys = [k for k in _keep if k[0] == "field" and k[1] == handle]
    for k in _keep_keys:
        del _keep[k]
    code, _ = capi.LGBM_DatasetFree(handle)
    return code, 0


def dataset_save_binary(handle, filename):
    code, _ = capi.LGBM_DatasetSaveBinary(handle, filename)
    return code, 0


def dataset_dump_text(handle, filename):
    code, _ = capi.LGBM_DatasetDumpText(handle, filename)
    return code, 0


def dataset_update_param_checking(old, new):
    code, _ = capi.LGBM_DatasetUpdateParamChecking(old, new)
    return code, 0


def dataset_num_data(handle):
    return capi.LGBM_DatasetGetNumData(handle)


def dataset_num_feature(handle):
    return capi.LGBM_DatasetGetNumFeature(handle)


def dataset_add_features_from(target, source):
    code, _ = capi.LGBM_DatasetAddFeaturesFrom(target, source)
    return code, 0


# ---- booster helpers ----

def booster_create(train_handle, params):
    code, h = capi.LGBM_BoosterCreate(train_handle, params)
    return code, (h or 0)


def booster_from_modelfile(filename):
    code, h = capi.LGBM_BoosterCreateFromModelfile(filename)
    if code != 0:
        return code, 0, 0
    code2, it = capi.LGBM_BoosterGetCurrentIteration(h)
    return code, (h or 0), (it or 0)


def booster_from_string(model_str):
    code, h = capi.LGBM_BoosterLoadModelFromString(model_str)
    if code != 0:
        return code, 0, 0
    code2, it = capi.LGBM_BoosterGetCurrentIteration(h)
    return code, (h or 0), (it or 0)


def booster_free(handle):
    code, _ = capi.LGBM_BoosterFree(handle)
    return code, 0


def booster_shuffle_models(handle, s, e):
    code, _ = capi.LGBM_BoosterShuffleModels(handle, s, e)
    return code, 0


def booster_merge(handle, other):
    code, _ = capi.LGBM_BoosterMerge(handle, other)
    return code, 0


def booster_add_valid(handle, valid):
    code, _ = capi.LGBM_BoosterAddValidData(handle, valid)
    return code, 0


def booster_reset_training_data(handle, train):
    code, _ = capi.LGBM_BoosterResetTrainingData(handle, train)
    return code, 0


def booster_reset_parameter(handle, params):
    code, _ = capi.LGBM_BoosterResetParameter(handle, params)
    return code, 0


def booster_update(handle):
    code, fin = capi.LGBM_BoosterUpdateOneIter(handle)
    return code, int(bool(fin))


def booster_update_custom(handle, grad_addr, hess_addr):
    bst = capi._get(handle)
    g = bst._gbdt
    n = g.num_data * max(g.num_tree_per_iteration, 1)
    grad = np.array(_vec(grad_addr, 0, n), np.float32)
    hess = np.array(_vec(hess_addr, 0, n), np.float32)
    code, fin = capi.LGBM_BoosterUpdateOneIterCustom(handle, grad, hess)
    return code, int(bool(fin))


def booster_rollback(handle):
    code, _ = capi.LGBM_BoosterRollbackOneIter(handle)
    return code, 0


def booster_refit(handle, leaf_addr, nrow, ncol):
    bst = capi._get(handle)
    lp = np.array(_mat(leaf_addr, 2, nrow, ncol, 1), np.int32)
    bst._gbdt.refit_trees(bst._gbdt, lp)
    return 0, 0


def booster_int_prop(handle, which):
    fn = {
        "cur_iter": capi.LGBM_BoosterGetCurrentIteration,
        "models_per_iter": capi.LGBM_BoosterNumModelPerIteration,
        "total_models": capi.LGBM_BoosterNumberOfTotalModel,
        "num_classes": capi.LGBM_BoosterGetNumClasses,
        "num_feature": capi.LGBM_BoosterGetNumFeature,
        "eval_counts": capi.LGBM_BoosterGetEvalCounts,
        "linear": capi.LGBM_BoosterGetLinear,
    }[which]
    code, v = fn(handle)
    return code, int(v)


def booster_eval_names(handle):
    code, names = capi.LGBM_BoosterGetEvalNames(handle)
    return code, "\t".join(names)


def booster_feature_names(handle):
    code, names = capi.LGBM_BoosterGetFeatureNames(handle)
    return code, "\t".join(names)


def booster_get_eval(handle, data_idx, out_addr):
    code, pairs = capi.LGBM_BoosterGetEval(handle, data_idx)
    vals = np.asarray([v for _, v in pairs], np.float64)
    return code, _out_f64(out_addr, vals) if len(vals) else 0


def booster_get_num_predict(handle, data_idx):
    return capi.LGBM_BoosterGetNumPredict(handle, data_idx)


def booster_get_predict(handle, data_idx, out_addr):
    code, out = capi.LGBM_BoosterGetPredict(handle, data_idx)
    return code, _out_f64(out_addr, out)


def booster_predict_for_file(handle, data_filename, has_header,
                             predict_type, start_iteration, num_iteration,
                             parameter, result_filename):
    code, _ = capi.LGBM_BoosterPredictForFile(
        handle, data_filename, bool(has_header), predict_type,
        start_iteration, num_iteration, parameter, result_filename)
    return code, 0


def booster_calc_num_predict(handle, num_row, predict_type,
                             start_iteration, num_iteration):
    return capi.LGBM_BoosterCalcNumPredict(
        handle, num_row, predict_type, start_iteration, num_iteration)


def booster_predict_mat_into(handle, addr, data_type, nrow, ncol,
                             is_row_major, predict_type, start_iteration,
                             num_iteration, out_addr, parameter=""):
    X = np.array(_mat(addr, data_type, nrow, ncol, is_row_major),
                 np.float64)
    code, out = capi.LGBM_BoosterPredictForMat(
        handle, X, predict_type, start_iteration, num_iteration,
        parameter)
    return code, _out_f64(out_addr, out)


def booster_predict_mats_into(handle, addrs_addr, nmat, data_type, ncol,
                              predict_type, start_iteration,
                              num_iteration, out_addr, parameter=""):
    addrs = np.array(_vec(addrs_addr, 3, nmat), np.int64)
    mats = [np.array(_vec(int(a), data_type, ncol), np.float64)
            for a in addrs]
    code, out = capi.LGBM_BoosterPredictForMats(
        handle, mats, predict_type, start_iteration, num_iteration,
        parameter)
    return code, _out_f64(out_addr, out)


def booster_predict_csr_into(handle, indptr, indptr_type, indices, data,
                             data_type, nindptr, nelem, num_col,
                             predict_type, start_iteration, num_iteration,
                             out_addr, parameter=""):
    m = _csr(indptr, indptr_type, indices, data, data_type, nindptr,
             nelem, num_col)
    code, out = capi.LGBM_BoosterPredictForCSR(
        handle, m, predict_type, start_iteration, num_iteration,
        parameter)
    return code, _out_f64(out_addr, out)


def booster_predict_csc_into(handle, col_ptr, col_ptr_type, indices, data,
                             data_type, ncol_ptr, nelem, num_row,
                             predict_type, start_iteration, num_iteration,
                             out_addr, parameter=""):
    m = _csc(col_ptr, col_ptr_type, indices, data, data_type, ncol_ptr,
             nelem, num_row)
    code, out = capi.LGBM_BoosterPredictForCSC(
        handle, m, predict_type, start_iteration, num_iteration,
        parameter)
    return code, _out_f64(out_addr, out)


def booster_predict_single_into(handle, addr, data_type, ncol,
                                is_row_major, predict_type,
                                start_iteration, num_iteration, out_addr, parameter=""):
    row = np.array(_vec(addr, data_type, ncol), np.float64)
    code, out = capi.LGBM_BoosterPredictForMatSingleRow(
        handle, row, predict_type, start_iteration, num_iteration,
        parameter)
    return code, _out_f64(out_addr, out)


def booster_predict_csr_single_into(handle, indptr, indptr_type, indices,
                                    data, data_type, nindptr, nelem,
                                    num_col, predict_type,
                                    start_iteration, num_iteration,
                                    out_addr, parameter=""):
    m = _csr(indptr, indptr_type, indices, data, data_type, nindptr,
             nelem, num_col)
    code, out = capi.LGBM_BoosterPredictForCSRSingleRow(
        handle, m, predict_type, start_iteration, num_iteration,
        parameter)
    return code, _out_f64(out_addr, out)


def fast_init_mat(handle, predict_type, start_iteration, num_iteration,
                  data_type, ncol, parameter):
    code, h = capi.LGBM_BoosterPredictForMatSingleRowFastInit(
        handle, predict_type, start_iteration, num_iteration, data_type,
        ncol, parameter)
    return code, (h or 0)


def fast_init_csr(handle, predict_type, start_iteration, num_iteration,
                  data_type, num_col, parameter):
    code, h = capi.LGBM_BoosterPredictForCSRSingleRowFastInit(
        handle, predict_type, start_iteration, num_iteration, data_type,
        num_col, parameter)
    return code, (h or 0)


def fast_predict_mat(fast_handle, addr, out_addr):
    fc = capi._get(fast_handle)
    row = np.array(_vec(addr, fc.dtype, fc.ncol), np.float64)
    code, out = capi.LGBM_BoosterPredictForMatSingleRowFast(
        fast_handle, row)
    return code, _out_f64(out_addr, out)


def fast_predict_csr(fast_handle, indptr, indptr_type, indices, data,
                     nindptr, nelem, out_addr):
    fc = capi._get(fast_handle)
    m = _csr(indptr, indptr_type, indices, data, fc.dtype, nindptr, nelem,
             fc.ncol)
    code, out = capi.LGBM_BoosterPredictForCSRSingleRowFast(fast_handle, m)
    return code, _out_f64(out_addr, out)


def fast_config_free(fast_handle):
    code, _ = capi.LGBM_FastConfigFree(fast_handle)
    return code, 0


def booster_predict_sparse(handle, indptr, indptr_type, indices, data,
                           data_type, nindptr, nelem, num_col_or_row,
                           predict_type, start_iteration, num_iteration,
                           matrix_type, parameter=""):
    """Two-phase sparse output: compute, stash, report sizes; C allocates
    and calls booster_predict_sparse_fill to copy."""
    m = _csr(indptr, indptr_type, indices, data, data_type, nindptr,
             nelem, num_col_or_row)
    code, sm = capi.LGBM_BoosterPredictSparseOutput(
        handle, m, predict_type, start_iteration, num_iteration,
        matrix_type, parameter)
    if code != 0:
        return code, 0, 0
    key = ("sparse", id(sm))
    _keep[key] = sm
    return 0, id(sm), len(sm.indptr), sm.nnz


def booster_predict_sparse_fill(key_id, indptr_addr, indices_addr,
                                data_addr, indptr_type):
    sm = _keep.pop(("sparse", key_id))
    ipt = 2 if indptr_type == 0 else 3
    np.copyto(_vec(indptr_addr, ipt, len(sm.indptr)),
              sm.indptr.astype(_DT[ipt]))
    np.copyto(_vec(indices_addr, 2, sm.nnz), sm.indices.astype(np.int32))
    np.copyto(_vec(data_addr, 1, sm.nnz), sm.data.astype(np.float64))
    return 0, 0


def booster_get_leaf_value(handle, tree_idx, leaf_idx):
    code, v = capi.LGBM_BoosterGetLeafValue(handle, tree_idx, leaf_idx)
    return code, float(v)


def booster_set_leaf_value(handle, tree_idx, leaf_idx, val):
    code, _ = capi.LGBM_BoosterSetLeafValue(handle, tree_idx, leaf_idx,
                                            val)
    return code, 0


def booster_feature_importance(handle, num_iteration, importance_type,
                               out_addr):
    code, out = capi.LGBM_BoosterFeatureImportance(
        handle, num_iteration, importance_type)
    return code, _out_f64(out_addr, out)


def booster_bound(handle, upper):
    fn = capi.LGBM_BoosterGetUpperBoundValue if upper else \
        capi.LGBM_BoosterGetLowerBoundValue
    code, v = fn(handle)
    return code, float(v)


def booster_save(handle, start_iteration, num_iteration,
                 importance_type, filename):
    code, _ = capi.LGBM_BoosterSaveModel(handle, filename,
                                         start_iteration, num_iteration)
    return code, 0


def booster_to_string(handle, start_iteration, num_iteration,
                      importance_type):
    code, s = capi.LGBM_BoosterSaveModelToString(handle, start_iteration,
                                                 num_iteration)
    return code, s


def booster_dump_model(handle, start_iteration, num_iteration,
                       importance_type):
    import json
    code, d = capi.LGBM_BoosterDumpModel(handle, start_iteration,
                                         num_iteration)
    return code, d if isinstance(d, str) else json.dumps(d)


def register_log_callback(addr):
    if not addr:
        capi.LGBM_RegisterLogCallback(None)
        return 0, 0
    cfunc = ctypes.CFUNCTYPE(None, ctypes.c_char_p)(addr)
    capi.LGBM_RegisterLogCallback(
        lambda msg: cfunc(msg.encode("utf-8", "replace")))
    return 0, 0


def network_init(machines, port, timeout, num_machines):
    code, _ = capi.LGBM_NetworkInit(machines, port, timeout, num_machines)
    return code, 0


def network_init_with_functions(num_machines, rank):
    code, _ = capi.LGBM_NetworkInitWithFunctions(num_machines, rank)
    return code, 0


def network_free():
    code, _ = capi.LGBM_NetworkFree()
    return code, 0


for _n in [k for k, v in list(globals().items())
           if callable(v) and not k.startswith("_")]:
    globals()[_n] = _wrap(globals()[_n])
)PY";

// Run one helper and unpack its (code, value...) tuple.  Caller holds
// the GIL.
PyObject* call_helper(const char* name, PyObject* args) {
  PyObject* fn = PyDict_GetItemString(g_helpers, name);  // borrowed
  if (fn == nullptr) {
    g_last_error = std::string("helper missing: ") + name;
    return nullptr;
  }
  PyObject* res = PyObject_CallObject(fn, args);
  if (res == nullptr) {
    PyObject *t, *v, *tb;
    PyErr_Fetch(&t, &v, &tb);
    PyObject* s = v ? PyObject_Str(v) : nullptr;
    g_last_error = safe_utf8(s, "python exception");
    Py_XDECREF(s);
    Py_XDECREF(t);
    Py_XDECREF(v);
    Py_XDECREF(tb);
    return nullptr;
  }
  return res;
}

bool fetch_py_error() {
  // after a swallowed exception the message lives in LGBM_GetLastError
  PyObject* args = PyTuple_New(0);
  PyObject* res = call_helper("_err", args);
  Py_DECREF(args);
  if (res != nullptr) {
    if (PyUnicode_Check(res))
      g_last_error = safe_utf8(res, "unavailable error message");
    Py_DECREF(res);
  }
  return true;
}

int ensure_python() {
  std::lock_guard<std::mutex> lk(g_mu);
  static bool owns_interp = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    owns_interp = true;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = 0;
  if (g_helpers == nullptr) {
    PyObject* mod = PyModule_New("lightgbm_tpu_torch_capi_shim");
    PyObject* dict = PyModule_GetDict(mod);
    PyDict_SetItemString(dict, "__builtins__", PyEval_GetBuiltins());
    PyObject* res = PyRun_String(kPrelude, Py_file_input, dict, dict);
    if (res == nullptr) {
      PyObject *t, *v, *tb;
      PyErr_Fetch(&t, &v, &tb);
      PyObject* s = v ? PyObject_Str(v) : nullptr;
      g_last_error = safe_utf8(
          s, "failed to initialize lightgbm_tpu_torch shim prelude");
      Py_XDECREF(s);
      Py_XDECREF(t);
      Py_XDECREF(v);
      Py_XDECREF(tb);
      rc = -1;
    } else {
      Py_DECREF(res);
      Py_INCREF(dict);
      g_helpers = dict;
    }
    Py_DECREF(mod);
  }
  PyGILState_Release(gil);
  if (owns_interp) {
    // release the GIL the embedded init left held so any thread can
    // PyGILState_Ensure later; do this exactly once
    static bool released = false;
    if (!released) {
      released = true;
      PyEval_SaveThread();
    }
  }
  return rc;
}

// Relay returning `code` and writing up to three int64 outputs.
int relay(const char* helper, PyObject* args, int64_t* out1,
          int64_t* out2, int64_t* out3 = nullptr) {
  if (ensure_python() != 0) {
    Py_XDECREF(args);
    return -1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int code = -1;
  PyObject* res = call_helper(helper, args);
  Py_XDECREF(args);
  if (res != nullptr && PyTuple_Check(res) && PyTuple_Size(res) >= 1) {
    code = (int)PyLong_AsLong(PyTuple_GetItem(res, 0));
    if (code == 0) {
      if (out1 != nullptr && PyTuple_Size(res) >= 2)
        *out1 = PyLong_AsLongLong(PyTuple_GetItem(res, 1));
      if (out2 != nullptr && PyTuple_Size(res) >= 3)
        *out2 = PyLong_AsLongLong(PyTuple_GetItem(res, 2));
      if (out3 != nullptr && PyTuple_Size(res) >= 4)
        *out3 = PyLong_AsLongLong(PyTuple_GetItem(res, 3));
    } else {
      fetch_py_error();
    }
  }
  Py_XDECREF(res);
  PyGILState_Release(gil);
  return code;
}

// Relay whose second tuple element is a double.
int relay_f64(const char* helper, PyObject* args, double* out) {
  if (ensure_python() != 0) {
    Py_XDECREF(args);
    return -1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int code = -1;
  PyObject* res = call_helper(helper, args);
  Py_XDECREF(args);
  if (res != nullptr && PyTuple_Check(res) && PyTuple_Size(res) >= 1) {
    code = (int)PyLong_AsLong(PyTuple_GetItem(res, 0));
    if (code == 0) {
      if (out != nullptr && PyTuple_Size(res) >= 2)
        *out = PyFloat_AsDouble(PyTuple_GetItem(res, 1));
    } else {
      fetch_py_error();
    }
  }
  Py_XDECREF(res);
  PyGILState_Release(gil);
  return code;
}

// Relay whose second tuple element is a string; copied into out_str with
// truncation, the full length reported through out_len.
int relay_str(const char* helper, PyObject* args, char* out_str,
              int64_t buffer_len, int64_t* out_len) {
  if (ensure_python() != 0) {
    Py_XDECREF(args);
    return -1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int code = -1;
  PyObject* res = call_helper(helper, args);
  Py_XDECREF(args);
  if (res != nullptr && PyTuple_Check(res) && PyTuple_Size(res) >= 1) {
    code = (int)PyLong_AsLong(PyTuple_GetItem(res, 0));
    if (code != 0 || PyTuple_Size(res) < 2) {
      if (code == 0) code = -1;
      fetch_py_error();
    } else {
      Py_ssize_t n = 0;
      const char* s =
          PyUnicode_AsUTF8AndSize(PyTuple_GetItem(res, 1), &n);
      if (s == nullptr) {
        PyErr_Clear();
        code = -1;
        g_last_error = "non-utf8 result string";
      } else {
        if (out_len != nullptr) *out_len = (int64_t)n + 1;
        if (out_str != nullptr && buffer_len > 0) {
          int64_t c = n + 1 < buffer_len ? n + 1 : buffer_len;
          std::memcpy(out_str, s, (size_t)(c - 1));
          out_str[c - 1] = '\0';
        }
      }
    }
  }
  Py_XDECREF(res);
  PyGILState_Release(gil);
  return code;
}

// Relay whose second element is a '\t'-joined string list, scattered into
// the (len x buffer_len) char* array convention of the reference.
int relay_strlist(const char* helper, PyObject* args, int len,
                  int* out_len, size_t buffer_len, size_t* out_buffer_len,
                  char** out_strs) {
  if (ensure_python() != 0) {
    Py_XDECREF(args);
    return -1;
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  int code = -1;
  PyObject* res = call_helper(helper, args);
  Py_XDECREF(args);
  if (res != nullptr && PyTuple_Check(res) && PyTuple_Size(res) >= 1) {
    code = (int)PyLong_AsLong(PyTuple_GetItem(res, 0));
    if (code != 0 || PyTuple_Size(res) < 2) {
      if (code == 0) code = -1;
      fetch_py_error();
    } else {
      const char* joined = safe_utf8(PyTuple_GetItem(res, 1), "");
      // split on '\t'
      size_t max_needed = 1;
      int count = 0;
      const char* p = joined;
      while (*p != '\0' || count == 0) {
        const char* q = std::strchr(p, '\t');
        size_t seg = q ? (size_t)(q - p) : std::strlen(p);
        if (seg + 1 > max_needed) max_needed = seg + 1;
        if (out_strs != nullptr && count < len && buffer_len > 0) {
          size_t c = seg + 1 < buffer_len ? seg + 1 : buffer_len;
          std::memcpy(out_strs[count], p, c - 1);
          out_strs[count][c - 1] = '\0';
        }
        ++count;
        if (q == nullptr) break;
        p = q + 1;
      }
      if (joined[0] == '\0') count = 0;
      if (out_len != nullptr) *out_len = count;
      if (out_buffer_len != nullptr) *out_buffer_len = max_needed;
    }
  }
  Py_XDECREF(res);
  PyGILState_Release(gil);
  return code;
}

PyObject* build_args(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* args = Py_VaBuildValue(fmt, ap);
  PyGILState_Release(gil);
  va_end(ap);
  return args;
}

#define ADDR(p) ((long long)(intptr_t)(p))

}  // namespace

extern "C" {

typedef void* DatasetHandle;
typedef void* BoosterHandle;
typedef void* FastConfigHandle;

const char* LGBM_GetLastError() { return g_last_error.c_str(); }

// ---- dataset ------------------------------------------------------------

int LGBM_DatasetCreateFromFile(const char* filename, const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("dataset_from_file",
                   build_args("(ssL)", filename ? filename : "",
                              parameters ? parameters : "",
                              ADDR(reference)),
                   &h, nullptr);
  if (code == 0 && out) *out = (DatasetHandle)(intptr_t)h;
  return code;
}

int LGBM_DatasetCreateFromSampledColumn(double** sample_data,
                                        int** sample_indices, int32_t ncol,
                                        const int* num_per_col,
                                        int32_t num_sample_row,
                                        int32_t num_total_row,
                                        const char* parameters,
                                        DatasetHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("dataset_from_sampled",
                   build_args("(LLiLiis)", ADDR(sample_data),
                              ADDR(sample_indices), (int)ncol,
                              ADDR(num_per_col), (int)num_sample_row,
                              (int)num_total_row,
                              parameters ? parameters : ""),
                   &h, nullptr);
  if (code == 0 && out) *out = (DatasetHandle)(intptr_t)h;
  return code;
}

int LGBM_DatasetCreateByReference(const DatasetHandle reference,
                                  int64_t num_total_row,
                                  DatasetHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("dataset_by_reference",
                   build_args("(LL)", ADDR(reference),
                              (long long)num_total_row),
                   &h, nullptr);
  if (code == 0 && out) *out = (DatasetHandle)(intptr_t)h;
  return code;
}

int LGBM_DatasetPushRows(DatasetHandle dataset, const void* data,
                         int data_type, int32_t nrow, int32_t ncol,
                         int32_t start_row) {
  if (ensure_python() != 0) return -1;
  return relay("dataset_push_rows",
               build_args("(LLiiii)", ADDR(dataset), ADDR(data), data_type,
                          (int)nrow, (int)ncol, (int)start_row),
               nullptr, nullptr);
}

int LGBM_DatasetPushRowsByCSR(DatasetHandle dataset, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int64_t start_row) {
  if (ensure_python() != 0) return -1;
  return relay("dataset_push_rows_csr",
               build_args("(LLiLLiLLLL)", ADDR(dataset), ADDR(indptr),
                          indptr_type, ADDR(indices), ADDR(data), data_type,
                          (long long)nindptr, (long long)nelem,
                          (long long)num_col, (long long)start_row),
               nullptr, nullptr);
}

int LGBM_DatasetCreateFromCSR(const void* indptr, int indptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t nindptr, int64_t nelem,
                              int64_t num_col, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("dataset_from_csr",
                   build_args("(LiLLiLLLsL)", ADDR(indptr), indptr_type,
                              ADDR(indices), ADDR(data), data_type,
                              (long long)nindptr, (long long)nelem,
                              (long long)num_col,
                              parameters ? parameters : "",
                              ADDR(reference)),
                   &h, nullptr);
  if (code == 0 && out) *out = (DatasetHandle)(intptr_t)h;
  return code;
}

int LGBM_DatasetCreateFromCSRFunc(void* get_row_funptr, int num_rows,
                                  int64_t num_col, const char* parameters,
                                  const DatasetHandle reference,
                                  DatasetHandle* out) {
  (void)get_row_funptr;
  (void)num_rows;
  (void)num_col;
  (void)parameters;
  (void)reference;
  (void)out;
  // the reference consumes a C++ std::function here (not a C-ABI
  // pointer); no stable cross-compiler contract exists to relay it.
  // The in-process surface (lightgbm_tpu_torch.capi.LGBM_DatasetCreateFromCSRFunc)
  // supports callables; native callers should use CreateFromCSR.
  g_last_error =
      "LGBM_DatasetCreateFromCSRFunc takes a C++ std::function in the "
      "reference ABI and cannot cross a C boundary portably; use "
      "LGBM_DatasetCreateFromCSR (or the in-process Python capi)";
  return -1;
}

int LGBM_DatasetCreateFromCSC(const void* col_ptr, int col_ptr_type,
                              const int32_t* indices, const void* data,
                              int data_type, int64_t ncol_ptr,
                              int64_t nelem, int64_t num_row,
                              const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("dataset_from_csc",
                   build_args("(LiLLiLLLsL)", ADDR(col_ptr), col_ptr_type,
                              ADDR(indices), ADDR(data), data_type,
                              (long long)ncol_ptr, (long long)nelem,
                              (long long)num_row,
                              parameters ? parameters : "",
                              ADDR(reference)),
                   &h, nullptr);
  if (code == 0 && out) *out = (DatasetHandle)(intptr_t)h;
  return code;
}

int LGBM_DatasetCreateFromMat(const void* data, int data_type,
                              int32_t nrow, int32_t ncol,
                              int is_row_major, const char* parameters,
                              const DatasetHandle reference,
                              DatasetHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("dataset_from_mat",
                   build_args("(LiiiisL)", ADDR(data), data_type, (int)nrow,
                              (int)ncol, is_row_major,
                              parameters ? parameters : "",
                              ADDR(reference)),
                   &h, nullptr);
  if (code == 0 && out) *out = (DatasetHandle)(intptr_t)h;
  return code;
}

int LGBM_DatasetCreateFromMats(int32_t nmat, const void** data,
                               int data_type, int32_t* nrow, int32_t ncol,
                               int is_row_major, const char* parameters,
                               const DatasetHandle reference,
                               DatasetHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("dataset_from_mats",
                   build_args("(LiiLiisL)", ADDR(data), (int)nmat,
                              data_type, ADDR(nrow), (int)ncol,
                              is_row_major, parameters ? parameters : "",
                              ADDR(reference)),
                   &h, nullptr);
  if (code == 0 && out) *out = (DatasetHandle)(intptr_t)h;
  return code;
}

int LGBM_DatasetGetSubset(const DatasetHandle handle,
                          const int32_t* used_row_indices,
                          int32_t num_used_row_indices,
                          const char* parameters, DatasetHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("dataset_get_subset",
                   build_args("(LLis)", ADDR(handle),
                              ADDR(used_row_indices),
                              (int)num_used_row_indices,
                              parameters ? parameters : ""),
                   &h, nullptr);
  if (code == 0 && out) *out = (DatasetHandle)(intptr_t)h;
  return code;
}

int LGBM_DatasetSetFeatureNames(DatasetHandle handle,
                                const char** feature_names,
                                int num_feature_names) {
  if (ensure_python() != 0) return -1;
  std::string joined;
  for (int i = 0; i < num_feature_names; ++i) {
    if (i) joined += '\t';
    joined += feature_names[i] ? feature_names[i] : "";
  }
  return relay("dataset_set_feature_names",
               build_args("(Ls)", ADDR(handle), joined.c_str()),
               nullptr, nullptr);
}

int LGBM_DatasetGetFeatureNames(DatasetHandle handle, const int len,
                                int* num_feature_names,
                                const size_t buffer_len,
                                size_t* out_buffer_len,
                                char** feature_names) {
  if (ensure_python() != 0) return -1;
  return relay_strlist("dataset_get_feature_names",
                       build_args("(L)", ADDR(handle)), len,
                       num_feature_names, buffer_len, out_buffer_len,
                       feature_names);
}

int LGBM_DatasetFree(DatasetHandle handle) {
  if (ensure_python() != 0) return -1;
  return relay("dataset_free", build_args("(L)", ADDR(handle)), nullptr,
               nullptr);
}

int LGBM_DatasetSaveBinary(DatasetHandle handle, const char* filename) {
  if (ensure_python() != 0) return -1;
  return relay("dataset_save_binary",
               build_args("(Ls)", ADDR(handle), filename ? filename : ""),
               nullptr, nullptr);
}

int LGBM_DatasetDumpText(DatasetHandle handle, const char* filename) {
  if (ensure_python() != 0) return -1;
  return relay("dataset_dump_text",
               build_args("(Ls)", ADDR(handle), filename ? filename : ""),
               nullptr, nullptr);
}

int LGBM_DatasetSetField(DatasetHandle handle, const char* field_name,
                         const void* field_data, int num_element,
                         int type) {
  if (ensure_python() != 0) return -1;
  return relay("dataset_set_field",
               build_args("(LsLii)", ADDR(handle), field_name,
                          ADDR(field_data), num_element, type),
               nullptr, nullptr);
}

int LGBM_DatasetGetField(DatasetHandle handle, const char* field_name,
                         int* out_len, const void** out_ptr,
                         int* out_type) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0, addr = 0, dtype = 0;
  int code = relay("dataset_get_field",
                   build_args("(Ls)", ADDR(handle), field_name), &n, &addr,
                   &dtype);
  if (code == 0) {
    if (out_len) *out_len = (int)n;
    if (out_ptr) *out_ptr = (const void*)(intptr_t)addr;
    if (out_type) *out_type = (int)dtype;
  }
  return code;
}

int LGBM_DatasetUpdateParamChecking(const char* old_parameters,
                                    const char* new_parameters) {
  if (ensure_python() != 0) return -1;
  return relay("dataset_update_param_checking",
               build_args("(ss)", old_parameters ? old_parameters : "",
                          new_parameters ? new_parameters : ""),
               nullptr, nullptr);
}

int LGBM_DatasetGetNumData(DatasetHandle handle, int* out) {
  if (ensure_python() != 0) return -1;
  int64_t v = 0;
  int code = relay("dataset_num_data", build_args("(L)", ADDR(handle)), &v,
                   nullptr);
  if (code == 0 && out) *out = (int)v;
  return code;
}

int LGBM_DatasetGetNumFeature(DatasetHandle handle, int* out) {
  if (ensure_python() != 0) return -1;
  int64_t v = 0;
  int code = relay("dataset_num_feature", build_args("(L)", ADDR(handle)),
                   &v, nullptr);
  if (code == 0 && out) *out = (int)v;
  return code;
}

int LGBM_DatasetAddFeaturesFrom(DatasetHandle target,
                                DatasetHandle source) {
  if (ensure_python() != 0) return -1;
  return relay("dataset_add_features_from",
               build_args("(LL)", ADDR(target), ADDR(source)), nullptr,
               nullptr);
}

// ---- booster ------------------------------------------------------------

int LGBM_BoosterGetLinear(BoosterHandle handle, bool* out) {
  if (ensure_python() != 0) return -1;
  int64_t v = 0;
  int code = relay("booster_int_prop",
                   build_args("(Ls)", ADDR(handle), "linear"), &v, nullptr);
  if (code == 0 && out) *out = v != 0;
  return code;
}

int LGBM_BoosterCreate(const DatasetHandle train_data,
                       const char* parameters, BoosterHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("booster_create",
                   build_args("(Ls)", ADDR(train_data),
                              parameters ? parameters : ""),
                   &h, nullptr);
  if (code == 0 && out) *out = (BoosterHandle)(intptr_t)h;
  return code;
}

int LGBM_BoosterCreateFromModelfile(const char* filename,
                                    int* out_num_iterations,
                                    BoosterHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0, it = 0;
  int code = relay("booster_from_modelfile",
                   build_args("(s)", filename ? filename : ""), &h, &it);
  if (code == 0) {
    if (out) *out = (BoosterHandle)(intptr_t)h;
    if (out_num_iterations) *out_num_iterations = (int)it;
  }
  return code;
}

int LGBM_BoosterLoadModelFromString(const char* model_str,
                                    int* out_num_iterations,
                                    BoosterHandle* out) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0, it = 0;
  int code = relay("booster_from_string",
                   build_args("(s)", model_str ? model_str : ""), &h, &it);
  if (code == 0) {
    if (out) *out = (BoosterHandle)(intptr_t)h;
    if (out_num_iterations) *out_num_iterations = (int)it;
  }
  return code;
}

int LGBM_BoosterFree(BoosterHandle handle) {
  if (ensure_python() != 0) return -1;
  return relay("booster_free", build_args("(L)", ADDR(handle)), nullptr,
               nullptr);
}

int LGBM_BoosterShuffleModels(BoosterHandle handle, int start_iter,
                              int end_iter) {
  if (ensure_python() != 0) return -1;
  return relay("booster_shuffle_models",
               build_args("(Lii)", ADDR(handle), start_iter, end_iter),
               nullptr, nullptr);
}

int LGBM_BoosterMerge(BoosterHandle handle, BoosterHandle other_handle) {
  if (ensure_python() != 0) return -1;
  return relay("booster_merge",
               build_args("(LL)", ADDR(handle), ADDR(other_handle)),
               nullptr, nullptr);
}

int LGBM_BoosterAddValidData(BoosterHandle handle,
                             const DatasetHandle valid_data) {
  if (ensure_python() != 0) return -1;
  return relay("booster_add_valid",
               build_args("(LL)", ADDR(handle), ADDR(valid_data)), nullptr,
               nullptr);
}

int LGBM_BoosterResetTrainingData(BoosterHandle handle,
                                  const DatasetHandle train_data) {
  if (ensure_python() != 0) return -1;
  return relay("booster_reset_training_data",
               build_args("(LL)", ADDR(handle), ADDR(train_data)), nullptr,
               nullptr);
}

int LGBM_BoosterResetParameter(BoosterHandle handle,
                               const char* parameters) {
  if (ensure_python() != 0) return -1;
  return relay("booster_reset_parameter",
               build_args("(Ls)", ADDR(handle),
                          parameters ? parameters : ""),
               nullptr, nullptr);
}

int LGBM_BoosterGetNumClasses(BoosterHandle handle, int* out_len) {
  if (ensure_python() != 0) return -1;
  int64_t v = 0;
  int code = relay("booster_int_prop",
                   build_args("(Ls)", ADDR(handle), "num_classes"), &v,
                   nullptr);
  if (code == 0 && out_len) *out_len = (int)v;
  return code;
}

int LGBM_BoosterUpdateOneIter(BoosterHandle handle, int* is_finished) {
  if (ensure_python() != 0) return -1;
  int64_t fin = 0;
  int code = relay("booster_update", build_args("(L)", ADDR(handle)), &fin,
                   nullptr);
  if (code == 0 && is_finished) *is_finished = (int)fin;
  return code;
}

int LGBM_BoosterRefit(BoosterHandle handle, const int32_t* leaf_preds,
                      int32_t nrow, int32_t ncol) {
  if (ensure_python() != 0) return -1;
  return relay("booster_refit",
               build_args("(LLii)", ADDR(handle), ADDR(leaf_preds),
                          (int)nrow, (int)ncol),
               nullptr, nullptr);
}

int LGBM_BoosterUpdateOneIterCustom(BoosterHandle handle,
                                    const float* grad, const float* hess,
                                    int* is_finished) {
  if (ensure_python() != 0) return -1;
  int64_t fin = 0;
  int code = relay("booster_update_custom",
                   build_args("(LLL)", ADDR(handle), ADDR(grad),
                              ADDR(hess)),
                   &fin, nullptr);
  if (code == 0 && is_finished) *is_finished = (int)fin;
  return code;
}

int LGBM_BoosterRollbackOneIter(BoosterHandle handle) {
  if (ensure_python() != 0) return -1;
  return relay("booster_rollback", build_args("(L)", ADDR(handle)),
               nullptr, nullptr);
}

static int int_prop(BoosterHandle handle, const char* which, int* out) {
  if (ensure_python() != 0) return -1;
  int64_t v = 0;
  int code = relay("booster_int_prop",
                   build_args("(Ls)", ADDR(handle), which), &v, nullptr);
  if (code == 0 && out) *out = (int)v;
  return code;
}

int LGBM_BoosterGetCurrentIteration(BoosterHandle handle,
                                    int* out_iteration) {
  return int_prop(handle, "cur_iter", out_iteration);
}

int LGBM_BoosterNumModelPerIteration(BoosterHandle handle,
                                     int* out_tree_per_iteration) {
  return int_prop(handle, "models_per_iter", out_tree_per_iteration);
}

int LGBM_BoosterNumberOfTotalModel(BoosterHandle handle, int* out_models) {
  return int_prop(handle, "total_models", out_models);
}

int LGBM_BoosterGetEvalCounts(BoosterHandle handle, int* out_len) {
  return int_prop(handle, "eval_counts", out_len);
}

int LGBM_BoosterGetEvalNames(BoosterHandle handle, const int len,
                             int* out_len, const size_t buffer_len,
                             size_t* out_buffer_len, char** out_strs) {
  if (ensure_python() != 0) return -1;
  return relay_strlist("booster_eval_names",
                       build_args("(L)", ADDR(handle)), len, out_len,
                       buffer_len, out_buffer_len, out_strs);
}

int LGBM_BoosterGetFeatureNames(BoosterHandle handle, const int len,
                                int* out_len, const size_t buffer_len,
                                size_t* out_buffer_len, char** out_strs) {
  if (ensure_python() != 0) return -1;
  return relay_strlist("booster_feature_names",
                       build_args("(L)", ADDR(handle)), len, out_len,
                       buffer_len, out_buffer_len, out_strs);
}

int LGBM_BoosterGetNumFeature(BoosterHandle handle, int* out_len) {
  return int_prop(handle, "num_feature", out_len);
}

int LGBM_BoosterGetEval(BoosterHandle handle, int data_idx, int* out_len,
                        double* out_results) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_get_eval",
                   build_args("(LiL)", ADDR(handle), data_idx,
                              ADDR(out_results)),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = (int)n;
  return code;
}

int LGBM_BoosterGetNumPredict(BoosterHandle handle, int data_idx,
                              int64_t* out_len) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_get_num_predict",
                   build_args("(Li)", ADDR(handle), data_idx), &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterGetPredict(BoosterHandle handle, int data_idx,
                           int64_t* out_len, double* out_result) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_get_predict",
                   build_args("(LiL)", ADDR(handle), data_idx,
                              ADDR(out_result)),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterPredictForFile(BoosterHandle handle,
                               const char* data_filename,
                               int data_has_header, int predict_type,
                               int start_iteration, int num_iteration,
                               const char* parameter,
                               const char* result_filename) {
  if (ensure_python() != 0) return -1;
  return relay("booster_predict_for_file",
               build_args("(Lsiiiiss)", ADDR(handle),
                          data_filename ? data_filename : "",
                          data_has_header, predict_type, start_iteration,
                          num_iteration, parameter ? parameter : "",
                          result_filename ? result_filename : ""),
               nullptr, nullptr);
}

int LGBM_BoosterCalcNumPredict(BoosterHandle handle, int num_row,
                               int predict_type, int start_iteration,
                               int num_iteration, int64_t* out_len) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_calc_num_predict",
                   build_args("(Liiii)", ADDR(handle), num_row,
                              predict_type, start_iteration, num_iteration),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_FastConfigFree(FastConfigHandle fastConfig) {
  if (ensure_python() != 0) return -1;
  return relay("fast_config_free", build_args("(L)", ADDR(fastConfig)),
               nullptr, nullptr);
}

int LGBM_BoosterPredictForCSR(BoosterHandle handle, const void* indptr,
                              int indptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t nindptr, int64_t nelem,
                              int64_t num_col, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_predict_csr_into",
                   build_args("(LLiLLiLLLiiiLs)", ADDR(handle), ADDR(indptr),
                              indptr_type, ADDR(indices), ADDR(data),
                              data_type, (long long)nindptr,
                              (long long)nelem, (long long)num_col,
                              predict_type, start_iteration, num_iteration,
                              ADDR(out_result),
                              parameter ? parameter : ""),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterPredictSparseOutput(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col_or_row,
    int predict_type, int start_iteration, int num_iteration,
    const char* parameter, int matrix_type, int64_t* out_len,
    void** out_indptr, int32_t** out_indices, void** out_data) {
  if (ensure_python() != 0) return -1;
  int64_t key = 0, n_indptr = 0, nnz = 0;
  int code = relay("booster_predict_sparse",
                   build_args("(LLiLLiLLLiiiis)", ADDR(handle), ADDR(indptr),
                              indptr_type, ADDR(indices), ADDR(data),
                              data_type, (long long)nindptr,
                              (long long)nelem, (long long)num_col_or_row,
                              predict_type, start_iteration, num_iteration,
                              matrix_type,
                              parameter ? parameter : ""),
                   &key, &n_indptr, &nnz);
  if (code != 0) return code;
  size_t ipsz = indptr_type == 0 ? 4 : 8;
  void* ip = std::malloc((size_t)n_indptr * ipsz);
  int32_t* ix = (int32_t*)std::malloc((size_t)nnz * sizeof(int32_t));
  double* dv = (double*)std::malloc((size_t)nnz * sizeof(double));
  if (ip == nullptr || ix == nullptr || dv == nullptr) {
    std::free(ip);
    std::free(ix);
    std::free(dv);
    g_last_error = "out of memory for sparse predict buffers";
    return -1;
  }
  code = relay("booster_predict_sparse_fill",
               build_args("(LLLLi)", (long long)key, ADDR(ip), ADDR(ix),
                          ADDR(dv), indptr_type),
               nullptr, nullptr);
  if (code != 0) {
    std::free(ip);
    std::free(ix);
    std::free(dv);
    return code;
  }
  // reference contract (c_api.cpp PredictSparseOutput): out_len is an
  // int64[2] — [0] = element count (nnz), [1] = indptr length
  if (out_len) {
    out_len[0] = nnz;
    out_len[1] = n_indptr;
  }
  if (out_indptr) *out_indptr = ip;
  if (out_indices) *out_indices = ix;
  if (out_data) *out_data = dv;
  return 0;
}

int LGBM_BoosterFreePredictSparse(void* indptr, int32_t* indices,
                                  void* data, int indptr_type,
                                  int data_type) {
  (void)indptr_type;
  (void)data_type;
  std::free(indptr);
  std::free(indices);
  std::free(data);
  return 0;
}

int LGBM_BoosterPredictForCSRSingleRow(
    BoosterHandle handle, const void* indptr, int indptr_type,
    const int32_t* indices, const void* data, int data_type,
    int64_t nindptr, int64_t nelem, int64_t num_col, int predict_type,
    int start_iteration, int num_iteration, const char* parameter,
    int64_t* out_len, double* out_result) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_predict_csr_single_into",
                   build_args("(LLiLLiLLLiiiLs)", ADDR(handle), ADDR(indptr),
                              indptr_type, ADDR(indices), ADDR(data),
                              data_type, (long long)nindptr,
                              (long long)nelem, (long long)num_col,
                              predict_type, start_iteration, num_iteration,
                              ADDR(out_result),
                              parameter ? parameter : ""),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterPredictForCSRSingleRowFastInit(
    BoosterHandle handle, const int predict_type, const int start_iteration,
    const int num_iteration, const int data_type, const int64_t num_col,
    const char* parameter, FastConfigHandle* out_fastConfig) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("fast_init_csr",
                   build_args("(LiiiiLs)", ADDR(handle), predict_type,
                              start_iteration, num_iteration, data_type,
                              (long long)num_col,
                              parameter ? parameter : ""),
                   &h, nullptr);
  if (code == 0 && out_fastConfig)
    *out_fastConfig = (FastConfigHandle)(intptr_t)h;
  return code;
}

int LGBM_BoosterPredictForCSRSingleRowFast(
    FastConfigHandle fastConfig_handle, const void* indptr,
    const int indptr_type, const int32_t* indices, const void* data,
    const int64_t nindptr, const int64_t nelem, int64_t* out_len,
    double* out_result) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("fast_predict_csr",
                   build_args("(LLiLLLLL)", ADDR(fastConfig_handle),
                              ADDR(indptr), indptr_type, ADDR(indices),
                              ADDR(data), (long long)nindptr,
                              (long long)nelem, ADDR(out_result)),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterPredictForCSC(BoosterHandle handle, const void* col_ptr,
                              int col_ptr_type, const int32_t* indices,
                              const void* data, int data_type,
                              int64_t ncol_ptr, int64_t nelem,
                              int64_t num_row, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_predict_csc_into",
                   build_args("(LLiLLiLLLiiiLs)", ADDR(handle), ADDR(col_ptr),
                              col_ptr_type, ADDR(indices), ADDR(data),
                              data_type, (long long)ncol_ptr,
                              (long long)nelem, (long long)num_row,
                              predict_type, start_iteration, num_iteration,
                              ADDR(out_result),
                              parameter ? parameter : ""),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterPredictForMat(BoosterHandle handle, const void* data,
                              int data_type, int32_t nrow, int32_t ncol,
                              int is_row_major, int predict_type,
                              int start_iteration, int num_iteration,
                              const char* parameter, int64_t* out_len,
                              double* out_result) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_predict_mat_into",
                   build_args("(LLiiiiiiiLs)", ADDR(handle), ADDR(data),
                              data_type, (int)nrow, (int)ncol, is_row_major,
                              predict_type, start_iteration, num_iteration,
                              ADDR(out_result),
                              parameter ? parameter : ""),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterPredictForMatSingleRow(
    BoosterHandle handle, const void* data, int data_type, int ncol,
    int is_row_major, int predict_type, int start_iteration,
    int num_iteration, const char* parameter, int64_t* out_len,
    double* out_result) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_predict_single_into",
                   build_args("(LLiiiiiiLs)", ADDR(handle), ADDR(data),
                              data_type, ncol, is_row_major, predict_type,
                              start_iteration, num_iteration,
                              ADDR(out_result),
                              parameter ? parameter : ""),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterPredictForMatSingleRowFastInit(
    BoosterHandle handle, const int predict_type, const int start_iteration,
    const int num_iteration, const int data_type, const int32_t ncol,
    const char* parameter, FastConfigHandle* out_fastConfig) {
  if (ensure_python() != 0) return -1;
  int64_t h = 0;
  int code = relay("fast_init_mat",
                   build_args("(Liiiiis)", ADDR(handle), predict_type,
                              start_iteration, num_iteration, data_type,
                              (int)ncol, parameter ? parameter : ""),
                   &h, nullptr);
  if (code == 0 && out_fastConfig)
    *out_fastConfig = (FastConfigHandle)(intptr_t)h;
  return code;
}

int LGBM_BoosterPredictForMatSingleRowFast(
    FastConfigHandle fastConfig_handle, const void* data, int64_t* out_len,
    double* out_result) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("fast_predict_mat",
                   build_args("(LLL)", ADDR(fastConfig_handle), ADDR(data),
                              ADDR(out_result)),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterPredictForMats(BoosterHandle handle, const void** data,
                               int data_type, int32_t nrow, int32_t ncol,
                               int predict_type, int start_iteration,
                               int num_iteration, const char* parameter,
                               int64_t* out_len, double* out_result) {
  if (ensure_python() != 0) return -1;
  int64_t n = 0;
  int code = relay("booster_predict_mats_into",
                   build_args("(LLiiiiiiLs)", ADDR(handle), ADDR(data),
                              (int)nrow, data_type, (int)ncol, predict_type,
                              start_iteration, num_iteration,
                              ADDR(out_result),
                              parameter ? parameter : ""),
                   &n, nullptr);
  if (code == 0 && out_len) *out_len = n;
  return code;
}

int LGBM_BoosterSaveModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, int feature_importance_type,
                          const char* filename) {
  if (ensure_python() != 0) return -1;
  return relay("booster_save",
               build_args("(Liiis)", ADDR(handle), start_iteration,
                          num_iteration, feature_importance_type,
                          filename ? filename : ""),
               nullptr, nullptr);
}

int LGBM_BoosterSaveModelToString(BoosterHandle handle, int start_iteration,
                                  int num_iteration,
                                  int feature_importance_type,
                                  int64_t buffer_len, int64_t* out_len,
                                  char* out_str) {
  if (ensure_python() != 0) return -1;
  return relay_str("booster_to_string",
                   build_args("(Liii)", ADDR(handle), start_iteration,
                              num_iteration, feature_importance_type),
                   out_str, buffer_len, out_len);
}

int LGBM_BoosterDumpModel(BoosterHandle handle, int start_iteration,
                          int num_iteration, int feature_importance_type,
                          int64_t buffer_len, int64_t* out_len,
                          char* out_str) {
  if (ensure_python() != 0) return -1;
  return relay_str("booster_dump_model",
                   build_args("(Liii)", ADDR(handle), start_iteration,
                              num_iteration, feature_importance_type),
                   out_str, buffer_len, out_len);
}

int LGBM_BoosterGetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double* out_val) {
  if (ensure_python() != 0) return -1;
  return relay_f64("booster_get_leaf_value",
                   build_args("(Lii)", ADDR(handle), tree_idx, leaf_idx),
                   out_val);
}

int LGBM_BoosterSetLeafValue(BoosterHandle handle, int tree_idx,
                             int leaf_idx, double val) {
  if (ensure_python() != 0) return -1;
  return relay("booster_set_leaf_value",
               build_args("(Liid)", ADDR(handle), tree_idx, leaf_idx, val),
               nullptr, nullptr);
}

int LGBM_BoosterFeatureImportance(BoosterHandle handle, int num_iteration,
                                  int importance_type,
                                  double* out_results) {
  if (ensure_python() != 0) return -1;
  return relay("booster_feature_importance",
               build_args("(LiiL)", ADDR(handle), num_iteration,
                          importance_type, ADDR(out_results)),
               nullptr, nullptr);
}

int LGBM_BoosterGetUpperBoundValue(BoosterHandle handle,
                                   double* out_results) {
  if (ensure_python() != 0) return -1;
  return relay_f64("booster_bound",
                   build_args("(Li)", ADDR(handle), 1), out_results);
}

int LGBM_BoosterGetLowerBoundValue(BoosterHandle handle,
                                   double* out_results) {
  if (ensure_python() != 0) return -1;
  return relay_f64("booster_bound",
                   build_args("(Li)", ADDR(handle), 0), out_results);
}

// ---- misc ---------------------------------------------------------------

int LGBM_RegisterLogCallback(void (*callback)(const char*)) {
  if (ensure_python() != 0) return -1;
  return relay("register_log_callback",
               build_args("(L)", ADDR(callback)), nullptr, nullptr);
}

int LGBM_NetworkInit(const char* machines, int local_listen_port,
                     int listen_time_out, int num_machines) {
  if (ensure_python() != 0) return -1;
  return relay("network_init",
               build_args("(siii)", machines ? machines : "",
                          local_listen_port, listen_time_out, num_machines),
               nullptr, nullptr);
}

int LGBM_NetworkFree() {
  if (ensure_python() != 0) return -1;
  return relay("network_free", build_args("()"), nullptr, nullptr);
}

int LGBM_NetworkInitWithFunctions(int num_machines, int rank,
                                  void* reduce_scatter_ext_fun,
                                  void* allgather_ext_fun) {
  (void)reduce_scatter_ext_fun;
  (void)allgather_ext_fun;
  if (ensure_python() != 0) return -1;
  return relay("network_init_with_functions",
               build_args("(ii)", num_machines, rank), nullptr, nullptr);
}

}  // extern "C"
