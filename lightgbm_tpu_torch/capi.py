"""The ``LGBM_*`` C-API surface (reference: include/LightGBM/c_api.h,
src/c_api.cpp — the stable handle-based ABI behind the Python/R/SWIG
bindings).

Port of ``lightgbm_tpu/capi.py`` over the port's ``Booster`` and
``Dataset``.  The boosting loop is in-process Python, so the ABI's
raw-pointer marshalling collapses: handles are integers in a registry,
matrices are numpy arrays, and every function keeps the reference's NAME,
argument order, and 0/-1 + ``LGBM_GetLastError`` error contract.  Code
written against the reference's ctypes surface ports by swapping
``_LIB.LGBM_x(...)`` for ``capi.LGBM_x(...)``; ``csrc/capi_shim.cc``
(``utils/native.py`` ``build_capi_shim``) re-exports the symbols as real
C functions.

Device: as in the CLI, ``device_type`` / ``device`` in a parameter
string chooses the card (the default) or the CPU.  A booster created for
training takes it from its creation parameters; a booster loaded from a
model file or string (whose C signature carries no parameters) is parsed
on the host and takes its device from the first prediction's
``parameter`` string, the card when that names none; a later
``parameter`` string that names a device moves it there.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

import numpy as np

from .basic import Booster, device_from
from .config import Config
from .dataset import Dataset
from .utils.log import log_warning

__all__ = [n for n in dir() if n.startswith("LGBM_")]

_lock = threading.Lock()
_handles: Dict[int, Any] = {}
_next_handle = [1]
_last_error = [""]

C_API_DTYPE_FLOAT32 = 0
C_API_DTYPE_FLOAT64 = 1
C_API_DTYPE_INT32 = 2
C_API_DTYPE_INT64 = 3

C_API_PREDICT_NORMAL = 0
C_API_PREDICT_RAW_SCORE = 1
C_API_PREDICT_LEAF_INDEX = 2
C_API_PREDICT_CONTRIB = 3


def _register(obj: Any) -> int:
    with _lock:
        h = _next_handle[0]
        _next_handle[0] += 1
        _handles[h] = obj
    return h


def _get(handle: int):
    try:
        return _handles[handle]
    except KeyError:
        raise ValueError(f"invalid handle {handle}")


_abi_errors = [False]


def strict_abi(enable: bool = True) -> None:
    """Select the error mode.  Default (False): exceptions PROPAGATE —
    in-process Python callers get real stack traces (the reference's own
    Python wrapper raises on nonzero codes, basic.py _safe_call).
    ``strict_abi(True)`` restores the raw ABI contract: -1 +
    ``LGBM_GetLastError`` (c_api.cpp API_BEGIN/API_END), for code that
    ports the ctypes call pattern verbatim."""
    _abi_errors[0] = bool(enable)


def _api(fn):
    """0 on success; failures raise (default) or return -1 under
    ``strict_abi(True)`` — see :func:`strict_abi`."""
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — the ABI swallows into -1
            _last_error[0] = f"{type(e).__name__}: {e}"
            if _abi_errors[0]:
                return -1, None
            raise
    wrapper.__name__ = fn.__name__
    wrapper.__doc__ = fn.__doc__
    return wrapper


def LGBM_GetLastError() -> str:
    """reference c_api.h:46."""
    return _last_error[0]


def _check_stream_complete(ds) -> None:
    """A streaming dataset must be fully pushed before first use —
    training on the zero-filled allocation would be silently wrong."""
    filled = getattr(ds, "_stream_filled", None)
    if filled is not None and not ds.constructed and \
            filled < len(ds.data):
        raise ValueError(
            f"streaming dataset incomplete: {filled} of {len(ds.data)} "
            "rows pushed (LGBM_DatasetPushRows*)")


def _free_raw(params: Dict[str, Any]) -> bool:
    """C-API datasets drop raw data after binning by default (the
    reference keeps only binned features); pass free_raw_data=false in
    the parameters string to retain it (needed by AddFeaturesFrom)."""
    return str(params.get("free_raw_data", "true")).lower() not in (
        "false", "0")


def _parse_params(parameters: Optional[str]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for tok in (parameters or "").replace("\n", " ").split(" "):
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k.strip()] = v.strip()
    return out


def _names_device(params: Dict[str, Any]) -> bool:
    return any(str(params.get(k, "")).lower() in ("cpu", "cuda", "gpu")
               for k in ("device_type", "device"))


def _loaded(**source) -> Booster:
    """A booster parsed from a model file or string on the host; its
    device is chosen at its first prediction (:func:`_on_device`)."""
    bst = Booster(device="cpu", **source)
    bst._device_pending = True
    return bst


def _on_device(bst: Booster, parameter: str = "") -> Booster:
    """A loaded booster on the device ``parameter`` names or, while its
    device is still open, on the default (the card).  A booster created
    for training predicts on its training device."""
    if not hasattr(bst, "_device_pending"):
        return bst
    params = _parse_params(parameter)
    if _names_device(params) or bst._device_pending:
        dev = device_from(params)
        if dev != bst.device:
            bst.device = dev
            bst._gbdt.device = dev
            if bst._gbdt.objective is not None:
                bst._gbdt.objective.device = dev
        bst._device_pending = False
    return bst


# ---- Dataset surface (c_api.h:66-398) -----------------------------------

@_api
def LGBM_DatasetCreateFromMat(data, parameters: str = "",
                              label=None, reference: Optional[int] = None):
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(np.asarray(data), label=label, reference=ref,
                 params=params, free_raw_data=_free_raw(params))
    ds.construct(Config(params) if ref is None else None)
    return 0, _register(ds)


@_api
def LGBM_DatasetCreateFromCSR(csr, parameters: str = "", label=None,
                              reference: Optional[int] = None):
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(csr, label=label, reference=ref, params=params,
                 free_raw_data=_free_raw(params))
    ds.construct(Config(params) if ref is None else None)
    return 0, _register(ds)


@_api
def LGBM_DatasetCreateFromFile(filename: str, parameters: str = "",
                               reference: Optional[int] = None):
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(filename, reference=ref, params=params)
    ds.construct(Config(params) if ref is None else None)
    return 0, _register(ds)


@_api
def LGBM_DatasetCreateByReference(reference: int, num_total_row: int):
    """Streaming ingestion step 1 (c_api.h:232 DatasetCreateByReference):
    allocate an empty dataset aligned to a constructed reference; fill it
    with LGBM_DatasetPushRows* and it bins lazily on first use."""
    ref = _get(reference)
    if not ref.constructed:
        ref.construct(Config(ref.params))
    buf = np.zeros((int(num_total_row), ref.num_total_features), np.float64)
    ds = Dataset(buf, reference=ref, params=dict(ref.params),
                 free_raw_data=False)
    ds._stream_filled = 0
    return 0, _register(ds)


@_api
def LGBM_DatasetPushRows(dataset: int, data, start_row: int):
    """Streaming ingestion step 2 (c_api.h:66 DatasetPushRows): copy a
    dense row block into [start_row, start_row+nrow)."""
    ds = _get(dataset)
    if ds.constructed:
        raise ValueError("cannot push rows into a dataset already used "
                         "for training/validation")
    rows = np.asarray(data, np.float64)
    if rows.ndim == 1:
        rows = rows.reshape(1, -1)
    ds.data[int(start_row):int(start_row) + len(rows)] = rows
    ds._stream_filled = max(getattr(ds, "_stream_filled", 0),
                            int(start_row) + len(rows))
    return 0, None


@_api
def LGBM_DatasetPushRowsByCSR(dataset: int, csr_block, start_row: int):
    """Streaming ingestion of one sparse row block (c_api.h:105
    DatasetPushRowsByCSR); only the pushed block densifies."""
    ds = _get(dataset)
    if ds.constructed:
        raise ValueError("cannot push rows into a dataset already used "
                         "for training/validation")
    block = np.asarray(csr_block.todense()
                       if hasattr(csr_block, "todense") else csr_block,
                       np.float64)
    ds.data[int(start_row):int(start_row) + len(block),
            :block.shape[1]] = block
    ds._stream_filled = max(getattr(ds, "_stream_filled", 0),
                            int(start_row) + len(block))
    return 0, None


@_api
def LGBM_DatasetGetSubset(handle: int, used_row_indices,
                          parameters: str = ""):
    """Row subset sharing the parent's bin mappers (c_api.h:286)."""
    ds = _get(handle)
    _check_stream_complete(ds)
    if not ds.constructed:
        ds.construct(Config(ds.params))
    idx = np.asarray(used_row_indices, np.int64)
    return 0, _register(ds.subset(idx))


@_api
def LGBM_DatasetFree(handle: int):
    with _lock:
        _handles.pop(handle, None)
    return 0, None


@_api
def LGBM_DatasetGetNumData(handle: int):
    return 0, _get(handle).num_data()


@_api
def LGBM_DatasetGetNumFeature(handle: int):
    return 0, _get(handle).num_feature()


@_api
def LGBM_DatasetSetField(handle: int, field_name: str, field_data):
    ds = _get(handle)
    if field_name == "label":
        ds.set_label(field_data)
    elif field_name == "weight":
        ds.set_weight(field_data)
    elif field_name in ("group", "query"):
        ds.set_group(field_data)
    elif field_name == "init_score":
        ds.set_init_score(field_data)
    else:
        raise ValueError(f"unknown field {field_name}")
    return 0, None


@_api
def LGBM_DatasetGetField(handle: int, field_name: str):
    ds = _get(handle)
    md = ds.metadata
    val = {"label": md.label, "weight": md.weight, "group": md.group,
           "query": md.group, "init_score": md.init_score}.get(field_name)
    if val is None and field_name not in ("label", "weight", "group",
                                          "query", "init_score"):
        raise ValueError(f"unknown field {field_name}")
    return 0, val


@_api
def LGBM_DatasetSaveBinary(handle: int, filename: str):
    _get(handle).save_binary(filename)
    return 0, None


# ---- Booster surface (c_api.h:418-1263) ---------------------------------

@_api
def LGBM_BoosterCreate(train_data: int, parameters: str = ""):
    _check_stream_complete(_get(train_data))
    ds = _get(train_data)
    params = _parse_params(parameters)
    bst = Booster(params=params, train_set=ds, device=device_from(params))
    return 0, _register(bst)


@_api
def LGBM_BoosterCreateFromModelfile(filename: str):
    return 0, _register(_loaded(model_file=filename))


@_api
def LGBM_BoosterLoadModelFromString(model_str: str):
    return 0, _register(_loaded(model_str=model_str))


@_api
def LGBM_BoosterFree(handle: int):
    with _lock:
        _handles.pop(handle, None)
    return 0, None


@_api
def LGBM_BoosterAddValidData(handle: int, valid_data: int):
    _check_stream_complete(_get(valid_data))
    bst = _get(handle)
    bst.add_valid(_get(valid_data), f"valid_{len(bst._gbdt.valid_sets)}")
    return 0, None


@_api
def LGBM_BoosterUpdateOneIter(handle: int):
    finished = _get(handle).update()
    return 0, 1 if finished else 0


@_api
def LGBM_BoosterUpdateOneIterCustom(handle: int, grad, hess):
    bst = _get(handle)
    finished = bst._gbdt.train_one_iter(np.asarray(grad, np.float32),
                                        np.asarray(hess, np.float32))
    return 0, 1 if finished else 0


@_api
def LGBM_BoosterRollbackOneIter(handle: int):
    _get(handle).rollback_one_iter()
    return 0, None


@_api
def LGBM_BoosterGetCurrentIteration(handle: int):
    return 0, _get(handle).current_iteration


@_api
def LGBM_BoosterNumModelPerIteration(handle: int):
    return 0, _get(handle).num_model_per_iteration()


@_api
def LGBM_BoosterNumberOfTotalModel(handle: int):
    return 0, _get(handle).num_trees()


@_api
def LGBM_BoosterGetNumClasses(handle: int):
    return 0, _get(handle)._gbdt.config.num_class


@_api
def LGBM_BoosterGetNumFeature(handle: int):
    return 0, _get(handle).num_feature()


@_api
def LGBM_BoosterGetFeatureNames(handle: int):
    return 0, _get(handle).feature_name()


@_api
def LGBM_BoosterGetEval(handle: int, data_idx: int):
    """data_idx 0 = training, i+1 = i-th validation set (c_api.h:648).
    The reference's Booster always creates training metrics from the
    metric config (c_api.cpp CreateObjectiveAndMetrics), so data_idx=0
    works without is_provide_training_metric — lazily instantiate."""
    bst = _get(handle)
    if data_idx == 0:
        _eval_metrics(handle)
    res = bst.eval_train() if data_idx == 0 else bst.eval_valid()
    if data_idx > 0:
        names = [n for n, _ in bst._gbdt.valid_sets]
        want = names[data_idx - 1]
        res = [r for r in res if r[0] == want]
    return 0, [(name, val) for _, name, val, _ in res]


@_api
def LGBM_BoosterSaveModel(handle: int, filename: str,
                          start_iteration: int = 0,
                          num_iteration: int = -1):
    _get(handle).save_model(filename,
                            None if num_iteration < 0 else num_iteration,
                            start_iteration)
    return 0, None


@_api
def LGBM_BoosterSaveModelToString(handle: int, start_iteration: int = 0,
                                  num_iteration: int = -1):
    return 0, _get(handle).model_to_string(
        None if num_iteration < 0 else num_iteration, start_iteration)


@_api
def LGBM_BoosterDumpModel(handle: int, start_iteration: int = 0,
                          num_iteration: int = -1):
    return 0, _get(handle).dump_model(
        None if num_iteration < 0 else num_iteration, start_iteration)


@_api
def LGBM_BoosterPredictForMat(handle: int, data, predict_type: int = 0,
                              start_iteration: int = 0,
                              num_iteration: int = -1,
                              parameter: str = ""):
    bst = _on_device(_get(handle), parameter)
    out = bst.predict(np.asarray(data),
                      start_iteration=start_iteration,
                      num_iteration=None if num_iteration < 0 else
                      num_iteration,
                      raw_score=predict_type == C_API_PREDICT_RAW_SCORE,
                      pred_leaf=predict_type == C_API_PREDICT_LEAF_INDEX,
                      pred_contrib=predict_type == C_API_PREDICT_CONTRIB)
    return 0, out


def _predict_kwargs(predict_type, start_iteration, num_iteration):
    return dict(
        start_iteration=start_iteration,
        num_iteration=None if num_iteration < 0 else num_iteration,
        raw_score=predict_type == C_API_PREDICT_RAW_SCORE,
        pred_leaf=predict_type == C_API_PREDICT_LEAF_INDEX,
        pred_contrib=predict_type == C_API_PREDICT_CONTRIB)


@_api
def LGBM_BoosterPredictForCSR(handle: int, csr, predict_type: int = 0,
                              start_iteration: int = 0,
                              num_iteration: int = -1,
                              parameter: str = ""):
    """Sparse prediction.  Rows densify in bounded chunks only — a
    Bosch-shaped CSR never materializes as one dense matrix
    (c_api.h:896 PredictForCSR)."""
    bst = _on_device(_get(handle), parameter)
    kw = _predict_kwargs(predict_type, start_iteration, num_iteration)
    n, f = csr.shape
    step = max(1024, (1 << 24) // max(1, f))
    if n <= step:
        return 0, bst.predict(np.asarray(csr.todense()), **kw)
    parts = [bst.predict(np.asarray(csr[lo:lo + step].todense()), **kw)
             for lo in range(0, n, step)]
    return 0, np.concatenate(parts, axis=0)


@_api
def LGBM_BoosterPredictForMatSingleRow(handle: int, row,
                                       predict_type: int = 0,
                                       start_iteration: int = 0,
                                       num_iteration: int = -1,
                                       parameter: str = ""):
    """Single-row fast path (c_api.h:1018 PredictForMatSingleRow)."""
    bst = _on_device(_get(handle), parameter)
    kw = _predict_kwargs(predict_type, start_iteration, num_iteration)
    out = bst.predict(np.asarray(row, np.float64).reshape(1, -1), **kw)
    return 0, np.asarray(out)[0]


@_api
def LGBM_BoosterPredictForCSRSingleRow(handle: int, csr_row,
                                       predict_type: int = 0,
                                       start_iteration: int = 0,
                                       num_iteration: int = -1,
                                       parameter: str = ""):
    """Single sparse row (c_api.h:961 PredictForCSRSingleRow)."""
    bst = _on_device(_get(handle), parameter)
    kw = _predict_kwargs(predict_type, start_iteration, num_iteration)
    dense = np.asarray(csr_row.todense()).reshape(1, -1)
    return 0, np.asarray(bst.predict(dense, **kw))[0]


@_api
def LGBM_BoosterPredictForFile(handle: int, data_filename: str,
                               data_has_header: bool = False,
                               predict_type: int = 0,
                               start_iteration: int = 0,
                               num_iteration: int = -1,
                               parameter: str = "",
                               result_filename: str =
                               "LightGBM_predict_result.txt"):
    """File -> prediction file (c_api.h:858 PredictForFile; the CLI's
    task=predict body, application.cpp Predict)."""
    bst = _on_device(_get(handle), parameter)
    params = _parse_params(parameter)
    if data_has_header:
        params.setdefault("header", True)
    from .io_utils import load_data_file
    X, _, _ = load_data_file(data_filename, params)
    kw = _predict_kwargs(predict_type, start_iteration, num_iteration)
    out = np.atleast_1d(np.asarray(bst.predict(np.asarray(X), **kw)))
    with open(result_filename, "w") as fh:
        if out.ndim == 1:
            fh.write("\n".join(f"{v:.18g}" for v in out) + "\n")
        else:
            for r in out:
                fh.write("\t".join(f"{v:.18g}" for v in r) + "\n")
    return 0, None


@_api
def LGBM_BoosterFeatureImportance(handle: int, num_iteration: int = -1,
                                  importance_type: int = 0):
    kind = "split" if importance_type == 0 else "gain"
    return 0, _get(handle).feature_importance(kind)


@_api
def LGBM_BoosterRefit(handle: int, data, label, decay_rate: float = 0.9):
    new_bst = _get(handle).refit(np.asarray(data), np.asarray(label),
                                 decay_rate)
    return 0, _register(new_bst)


@_api
def LGBM_BoosterResetParameter(handle: int, parameters: str):
    _get(handle).reset_parameter(_parse_params(parameters))
    return 0, None


def LGBM_SetLastError(msg: str):
    """reference c_api.h:54 (the reverse direction of GetLastError)."""
    _last_error[0] = str(msg)
    return 0


@_api
def LGBM_RegisterLogCallback(callback):
    """Route every log line through ``callback(str)``
    (c_api.h:62 LGBM_RegisterLogCallback; None restores stdout)."""
    from .utils.log import register_log_callback
    register_log_callback(callback)
    return 0, None


# ---- Dataset surface, part 2 --------------------------------------------

@_api
def LGBM_DatasetCreateFromCSC(csc, parameters: str = "", label=None,
                              reference: Optional[int] = None):
    """Column-sparse create (c_api.h:160 DatasetCreateFromCSC) — the
    column-major layout feeds the EFB sparse bundler directly."""
    params = _parse_params(parameters)
    ref = _get(reference) if reference else None
    ds = Dataset(csc.tocsc() if hasattr(csc, "tocsc") else csc,
                 label=label, reference=ref, params=params,
                 free_raw_data=_free_raw(params))
    ds.construct(Config(params) if ref is None else None)
    return 0, _register(ds)


@_api
def LGBM_DatasetCreateFromMats(mats, parameters: str = "", label=None,
                               reference: Optional[int] = None):
    """Multiple dense row blocks -> one dataset (c_api.h:137
    DatasetCreateFromMats)."""
    data = np.vstack([np.asarray(m, np.float64) for m in mats])
    return LGBM_DatasetCreateFromMat(data, parameters, label, reference)


@_api
def LGBM_DatasetCreateFromCSRFunc(get_row_fun, num_rows: int,
                                  num_col: int, parameters: str = "",
                                  label=None,
                                  reference: Optional[int] = None):
    """Row-callback create (c_api.h:121 DatasetCreateFromCSRFunc): the C
    ABI pulls rows through a function pointer; here ``get_row_fun(i)``
    returns ``(indices, values)`` for row i."""
    import scipy.sparse as _sp
    indptr = [0]
    indices: List[int] = []
    values: List[float] = []
    for i in range(int(num_rows)):
        idx, val = get_row_fun(i)
        indices.extend(int(j) for j in idx)
        values.extend(float(v) for v in val)
        indptr.append(len(indices))
    csr = _sp.csr_matrix(
        (np.asarray(values), np.asarray(indices, np.int32),
         np.asarray(indptr, np.int64)),
        shape=(int(num_rows), int(num_col)))
    return LGBM_DatasetCreateFromCSR(csr, parameters, label, reference)


@_api
def LGBM_DatasetCreateFromSampledColumn(sample_data, sample_indices,
                                        num_total_row: int,
                                        parameters: str = "",
                                        num_sample_row: int = 0):
    """Streaming ingestion step 0 (c_api.h:210): bin mappers are fitted
    from per-column SAMPLES, then an empty dataset of ``num_total_row``
    rows awaits LGBM_DatasetPushRows*.  ``sample_data[j]`` /
    ``sample_indices[j]`` are column j's sampled values / row indices
    within the ``num_sample_row``-row sample — unsampled cells are zero,
    so the zero fraction matches the reference's FindBin contract
    (dataset_loader.cpp:666: zeros = total_sample_size - num_per_col)."""
    params = _parse_params(parameters)
    ncol = len(sample_data)
    if not num_sample_row:
        num_sample_row = max(
            (int(np.max(np.atleast_1d(ix))) + 1 if len(np.atleast_1d(ix))
             else 0 for ix in (sample_indices or [])),
            default=0) or max(
            (len(np.atleast_1d(s)) for s in sample_data), default=0)
    samp = np.zeros((int(num_sample_row), ncol), np.float64)
    for j in range(ncol):
        vals = np.atleast_1d(sample_data[j])
        idx = np.asarray(sample_indices[j], np.int64) \
            if sample_indices is not None else np.arange(len(vals))
        samp[idx, j] = vals
    ref = Dataset(samp, params=params)
    ref.construct(Config(params))
    buf = np.zeros((int(num_total_row), ncol), np.float64)
    ds = Dataset(buf, reference=ref, params=dict(params),
                 free_raw_data=False)
    ds._stream_filled = 0
    return 0, _register(ds)


@_api
def LGBM_DatasetSetFeatureNames(handle: int, feature_names):
    ds = _get(handle)
    names = [str(n) for n in feature_names]
    ds.feature_name = names
    if getattr(ds, "feature_names_", None) is not None:
        # capi datasets construct at creation: propagate into the frozen
        # post-construct names so boosters/saved models see them too
        if len(names) != len(ds.feature_names_):
            raise ValueError(f"expected {len(ds.feature_names_)} names, "
                             f"got {len(names)}")
        ds.feature_names_ = list(names)
    return 0, None


@_api
def LGBM_DatasetGetFeatureNames(handle: int):
    ds = _get(handle)
    names = getattr(ds, "feature_name", None) or "auto"
    if names == "auto":
        names = [f"Column_{i}" for i in range(ds.num_total_features)]
    return 0, [str(n) for n in names]


@_api
def LGBM_DatasetAddFeaturesFrom(target: int, source: int):
    """Append ``source``'s features to ``target`` (c_api.h:317
    DatasetAddFeaturesFrom); both must hold raw data and equal rows."""
    tgt, src = _get(target), _get(source)
    if tgt.data is None or src.data is None:
        raise ValueError("AddFeaturesFrom needs datasets that still hold "
                         "their raw data (free_raw_data=False)")
    td = np.asarray(tgt.data.todense()
                    if hasattr(tgt.data, "todense") else tgt.data)
    sd = np.asarray(src.data.todense()
                    if hasattr(src.data, "todense") else src.data)
    if len(td) != len(sd):
        raise ValueError(f"row mismatch: {len(td)} vs {len(sd)}")

    def _names(ds, width):
        n = getattr(ds, "feature_name", None) or "auto"
        return list(n) if n != "auto" else \
            [f"Column_{i}" for i in range(width)]

    merged = Dataset(np.hstack([td, sd]),
                     label=tgt.metadata.label if tgt.constructed
                     else getattr(tgt, "_label_arg", None),
                     params=dict(tgt.params), free_raw_data=False)
    merged.feature_name = _names(tgt, td.shape[1]) + _names(src, sd.shape[1])
    if tgt.constructed:
        merged.construct(Config(tgt.params))
        # the reference mutates the target in place and keeps its
        # Metadata — weight/group/init_score must survive the merge
        md = tgt.metadata
        if md.weight is not None:
            merged.set_weight(md.weight)
        if md.group is not None:
            merged.set_group(md.group)
        if md.init_score is not None:
            merged.set_init_score(md.init_score)
    # the merged dataset replaces the target IN PLACE so the caller's
    # handle stays valid (the reference mutates the target Dataset too)
    tgt.__dict__.clear()
    tgt.__dict__.update(merged.__dict__)
    return 0, None


@_api
def LGBM_DatasetDumpText(handle: int, filename: str):
    """Dump the BINNED dataset as text (c_api.h:372 DatasetDumpText;
    reference dataset.cpp DumpTextFile) — a debugging surface."""
    ds = _get(handle)
    _check_stream_complete(ds)
    if not ds.constructed:
        ds.construct(Config(ds.params))
    with open(filename, "w") as fh:
        fh.write(f"num_data: {ds.num_data()}\n")
        fh.write(f"num_features: {ds.num_feature()}\n")
        names = LGBM_DatasetGetFeatureNames(handle)[1]
        fh.write("feature_names: " + "\t".join(names) + "\n")
        xb = ds.X_binned
        if ds.efb is not None:
            # device columns are EFB bundles, not per-feature bins —
            # label the rows honestly so the dump stays self-consistent
            fh.write(f"num_device_columns: {xb.shape[1]} "
                     "(EFB bundle-space bin codes follow)\n")
        for i in range(min(len(xb), ds.num_data())):
            fh.write("\t".join(str(int(v)) for v in xb[i]) + "\n")
    return 0, None


@_api
def LGBM_DatasetUpdateParamChecking(old_parameters: str,
                                    new_parameters: str):
    """Validate that changed params do not alter the binned data
    (c_api.h:351; reference Dataset::ValidateSampleCount /
    config.cpp CheckParamConflict)."""
    frozen = ("max_bin", "min_data_in_bin", "bin_construct_sample_cnt",
              "enable_bundle", "use_missing", "zero_as_missing",
              "categorical_feature", "feature_pre_filter",
              "forcedbins_filename", "data_random_seed", "two_round",
              "pre_partition", "header", "label_column", "weight_column",
              "group_column", "ignore_column", "is_enable_sparse",
              "linear_tree", "precise_float_parser")
    old = _parse_params(old_parameters)
    new = _parse_params(new_parameters)
    for k in frozen:
        if old.get(k) != new.get(k):
            raise ValueError(
                f"cannot change {k} after the Dataset was constructed "
                f"({old.get(k)!r} -> {new.get(k)!r}); build a new Dataset")
    return 0, None


# ---- Booster surface, part 2 --------------------------------------------

@_api
def LGBM_BoosterMerge(handle: int, other_handle: int):
    """Append ``other``'s trees to ``handle``'s model (c_api.h:489)."""
    bst, other = _get(handle), _get(other_handle)
    bst._gbdt.merge_from(other._gbdt)
    return 0, None


@_api
def LGBM_BoosterResetTrainingData(handle: int, train_data: int):
    """Swap the training dataset, keeping the model (c_api.h:478;
    reference GBDT::ResetTrainingData) — continued training resumes on
    the new rows with scores rebuilt from the existing trees."""
    _check_stream_complete(_get(train_data))
    _get(handle).reset_train_data(_get(train_data))
    return 0, None


@_api
def LGBM_BoosterShuffleModels(handle: int, start_iter: int, end_iter: int):
    """Shuffle tree order in [start_iter, end_iter) (c_api.h:497)."""
    _get(handle)._gbdt.shuffle_models(int(start_iter), int(end_iter))
    return 0, None


def _eval_metrics(handle: int):
    """Training metrics, lazily created + CACHED on the booster (the
    reference's Booster always builds them from the metric config,
    c_api.cpp CreateObjectiveAndMetrics)."""
    g = _get(handle)._gbdt
    if not g.train_metrics and g.train_set is not None:
        from .metric import create_metrics
        ms = create_metrics(g.config)
        for m in ms:
            m.init(g.train_set.metadata, g.num_data)
        g.train_metrics = ms
    return g.train_metrics


@_api
def LGBM_BoosterGetEvalCounts(handle: int):
    """Number of eval VALUES per GetEval call — multi-position metrics
    (ndcg/map with eval_at) count one per position, matching the
    reference's sum over Metric::GetName() sizes (c_api.cpp:772)."""
    return 0, sum(len(m.eval_names) for m in _eval_metrics(handle))


@_api
def LGBM_BoosterGetEvalNames(handle: int):
    return 0, [n for m in _eval_metrics(handle) for n in m.eval_names]


@_api
def LGBM_BoosterGetNumPredict(handle: int, data_idx: int):
    """Length of the inner prediction buffer for train (0) / valid i
    (c_api.h:724)."""
    g = _get(handle)._gbdt
    score = g.score if data_idx == 0 else g.valid_scores[data_idx - 1]
    return 0, int(np.asarray(score).size)


@_api
def LGBM_BoosterGetPredict(handle: int, data_idx: int):
    """Inner predictions (objective-transformed scores) of the training
    (0) or i-th validation data (c_api.h:736; c_api.cpp GetPredictAt)."""
    g = _get(handle)._gbdt
    score = g.score if data_idx == 0 else g.valid_scores[data_idx - 1]
    out = np.asarray(g.objective.convert_output(score))
    return 0, out.reshape(-1) if out.ndim == 1 else out


@_api
def LGBM_BoosterGetLeafValue(handle: int, tree_idx: int, leaf_idx: int):
    t = _get(handle)._gbdt.models[int(tree_idx)]
    return 0, float(t.leaf_value[int(leaf_idx)])


@_api
def LGBM_BoosterSetLeafValue(handle: int, tree_idx: int, leaf_idx: int,
                             val: float):
    g = _get(handle)._gbdt
    # mutates the host-side model only (like the reference's
    # Tree::SetLeafOutput): predictions read host trees per call, while
    # training scores keep their pre-edit values, same as the reference
    g.models[int(tree_idx)].leaf_value[int(leaf_idx)] = float(val)
    return 0, None


@_api
def LGBM_BoosterGetLinear(handle: int):
    g = _get(handle)._gbdt
    return 0, int(any(getattr(t, "is_linear", False) for t in g.models))


@_api
def LGBM_BoosterGetLowerBoundValue(handle: int):
    """Sum over trees of each tree's minimum leaf value (c_api.h:565)."""
    g = _get(handle)._gbdt
    return 0, float(sum(
        float(np.min(t.leaf_value[:t.num_leaves])) for t in g.models))


@_api
def LGBM_BoosterGetUpperBoundValue(handle: int):
    g = _get(handle)._gbdt
    return 0, float(sum(
        float(np.max(t.leaf_value[:t.num_leaves])) for t in g.models))


@_api
def LGBM_BoosterCalcNumPredict(handle: int, num_row: int,
                               predict_type: int = 0,
                               start_iteration: int = 0,
                               num_iteration: int = -1):
    """Output length of a predict call (c_api.h:771 CalcNumPredict)."""
    g = _get(handle)._gbdt
    k = g.num_tree_per_iteration
    total_iter = len(g.models) // max(k, 1)
    ni = max(0, total_iter - start_iteration if num_iteration < 0 else
             min(num_iteration, total_iter - start_iteration))
    if predict_type == C_API_PREDICT_LEAF_INDEX:
        per_row = ni * k
    elif predict_type == C_API_PREDICT_CONTRIB:
        per_row = (g.num_features + 1) * k
    else:
        per_row = k
    return 0, int(num_row) * per_row


@_api
def LGBM_BoosterPredictForCSC(handle: int, csc, predict_type: int = 0,
                              start_iteration: int = 0,
                              num_iteration: int = -1,
                              parameter: str = ""):
    """Column-sparse prediction (c_api.h:1003 PredictForCSC): converted
    to row-sparse once, then the bounded-chunk CSR path."""
    return LGBM_BoosterPredictForCSR(handle, csc.tocsr(), predict_type,
                                     start_iteration, num_iteration,
                                     parameter)


@_api
def LGBM_BoosterPredictForMats(handle: int, mats, predict_type: int = 0,
                               start_iteration: int = 0,
                               num_iteration: int = -1,
                               parameter: str = ""):
    """Predict rows given as a list of single-row arrays (c_api.h:1097
    PredictForMats)."""
    data = np.vstack([np.asarray(m, np.float64).reshape(1, -1)
                      for m in mats])
    return LGBM_BoosterPredictForMat(handle, data, predict_type,
                                     start_iteration, num_iteration,
                                     parameter)


@_api
def LGBM_BoosterPredictSparseOutput(handle: int, csr, predict_type: int = 3,
                                    start_iteration: int = 0,
                                    num_iteration: int = -1,
                                    matrix_type: int = 0,
                                    parameter: str = ""):
    """SHAP contributions as a sparse matrix (c_api.h:920
    PredictSparseOutput; matrix_type 0 = CSR, 1 = CSC).  Zero
    contributions are squeezed out, like the reference's sparse
    contrib path."""
    import scipy.sparse as _sp
    if predict_type != C_API_PREDICT_CONTRIB:
        raise ValueError("sparse output is defined for contrib "
                         "predictions (predict_type=3)")
    rc, dense = LGBM_BoosterPredictForCSR(
        handle, csr, predict_type, start_iteration, num_iteration,
        parameter)
    dense = np.asarray(dense)
    if dense.ndim == 3:   # multiclass: (n, k, f+1) -> stacked rows
        dense = dense.reshape(dense.shape[0] * dense.shape[1], -1)
    out = _sp.csr_matrix(dense)
    return 0, out.tocsc() if matrix_type == 1 else out


@_api
def LGBM_BoosterFreePredictSparse(handle_or_matrix=None):
    """No-op here: sparse predict results are garbage-collected Python
    objects, not C allocations (c_api.h:950 FreePredictSparse)."""
    return 0, None


# ---- fast single-row predict (c_api.h:1018-1140) -------------------------

class _FastConfig:
    __slots__ = ("booster", "kwargs", "ncol", "dtype")

    def __init__(self, booster, kwargs, ncol, dtype=1):
        self.booster = booster
        self.kwargs = kwargs
        self.ncol = ncol
        self.dtype = dtype


@_api
def LGBM_BoosterPredictForMatSingleRowFastInit(handle: int,
                                               predict_type: int = 0,
                                               start_iteration: int = 0,
                                               num_iteration: int = -1,
                                               data_type: int = 1,
                                               ncol: int = -1,
                                               parameter: str = ""):
    """Bind predict configuration once (c_api.h:1060 SingleRowFastInit);
    per-call overhead then drops to the row marshalling alone."""
    bst = _on_device(_get(handle), parameter)
    kw = _predict_kwargs(predict_type, start_iteration, num_iteration)
    return 0, _register(_FastConfig(bst, kw, int(ncol), int(data_type)))


@_api
def LGBM_BoosterPredictForMatSingleRowFast(fast_config: int, row):
    """Predict one dense row against a bound config (c_api.h:1090)."""
    fc = _get(fast_config)
    r = np.asarray(row, np.float64).reshape(1, -1)
    return 0, np.asarray(fc.booster.predict(r, **fc.kwargs))[0]


@_api
def LGBM_BoosterPredictForCSRSingleRowFastInit(handle: int,
                                               predict_type: int = 0,
                                               start_iteration: int = 0,
                                               num_iteration: int = -1,
                                               data_type: int = 1,
                                               num_col: int = -1,
                                               parameter: str = ""):
    """c_api.h:1018 CSRSingleRowFastInit."""
    bst = _on_device(_get(handle), parameter)
    kw = _predict_kwargs(predict_type, start_iteration, num_iteration)
    return 0, _register(_FastConfig(bst, kw, int(num_col), int(data_type)))


@_api
def LGBM_BoosterPredictForCSRSingleRowFast(fast_config: int, csr_row):
    """c_api.h:1043 CSRSingleRowFast."""
    fc = _get(fast_config)
    if hasattr(csr_row, "todense"):
        dense = np.asarray(csr_row.todense(), np.float64).reshape(1, -1)
    else:  # (indices, values) pair against the bound ncol
        idx, val = csr_row
        dense = np.zeros((1, fc.ncol), np.float64)
        dense[0, np.asarray(idx, np.int64)] = np.asarray(val, np.float64)
    return 0, np.asarray(fc.booster.predict(dense, **fc.kwargs))[0]


@_api
def LGBM_FastConfigFree(fast_config: int):
    with _lock:
        _handles.pop(fast_config, None)
    return 0, None


# ---- network (c_api.h:1274) ---------------------------------------------

@_api
def LGBM_NetworkInit(machines: str, local_listen_port: int,
                     listen_time_out: int, num_machines: int):
    if num_machines > 1:
        raise NotImplementedError(
            "socket meshes are replaced by torch.distributed: call "
            "lightgbm_tpu_torch.distributed.init(...) per process instead")
    log_warning("LGBM_NetworkInit with one machine is a no-op")
    return 0, None


@_api
def LGBM_NetworkFree():
    return 0, None


@_api
def LGBM_NetworkInitWithFunctions(num_machines: int, rank: int,
                                  reduce_scatter_ext_fun=None,
                                  allgather_ext_fun=None):
    """External-collective bootstrap (c_api.h:1293).  LightGBM lets
    MPI-like runtimes inject reduce-scatter/allgather function pointers;
    the port's collectives are torch.distributed's, and multi-process
    setups use ``lightgbm_tpu_torch.distributed.init``, which takes the
    same degrees of freedom (rank, world size), as the reference refuses
    these (lightgbm_tpu/capi.py:1000-1016)."""
    if num_machines > 1:
        raise NotImplementedError(
            "external collective functions are replaced by "
            "torch.distributed collectives: call "
            "lightgbm_tpu_torch.distributed.init(...) per process instead")
    return 0, None


__all__ = sorted(n for n in dir() if n.startswith("LGBM_"))
