"""Dataset: binned feature matrix + metadata, resident on the training device.

Port of ``lightgbm_tpu/dataset.py`` (reference: include/LightGBM/dataset.h:282
``Dataset``, dataset.h:41 ``Metadata``, src/io/dataset_loader.cpp).  Bin
construction is the same host numpy code (row sample, ``find_bin`` per
feature, trivial-feature pre-filter), so a port Dataset and a reference
Dataset built from the same data carry the same bin mappers and codes.

What the port carries: dense numpy / pandas input, scipy sparse matrices
(binned column by column, never densified), CSV / TSV / LibSVM data files
(``io_utils.load_data_file``), categorical features, and Exclusive
Feature Bundling (``efb.py``; reference dataset.py:437-484): when
bundling shrinks the matrix, the device copy holds one column per bundle.
Under ``linear_tree`` the raw used columns stay too, in f32 (``raw_used``,
dense input only), forced bin bounds (``forcedbins_filename``) and the
binary dataset cache (:meth:`Dataset.save_binary` / ``load_binary``,
the reference's file format).  Pre-partitioned multi-process ingest is a
later slice (ROADMAP queue 1).  The device copy is the FEATURE-MAJOR
``(G, N_pad)`` tensor the histogram and row-update kernels stream (G =
features, or bundles under EFB), uint8 codes, or uint16 when some feature
has more than 256 bins (``max_bin`` > 255), rows padded with zeros to the
kernels' 4096-row block, or, when every feature fits 16 bins, its
nibble-packed ``(F, N_pad/2)`` form (:meth:`Dataset.device_bins_packed4`).
"""

from __future__ import annotations

import copy
import pickle
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from .binning import BinMapper, bin_matrix, find_bin
from .config import Config
from .utils.log import log_info

__all__ = ["Dataset", "Metadata", "DatasetCorruptError", "ROW_BLOCK",
           "pad_rows", "BINARY_FORMAT"]

# the binary dataset file's format marker, the reference's
# (lightgbm_tpu/dataset.py save_binary): a file either package writes
# loads in the other
BINARY_FORMAT = "lightgbm_tpu.dataset.v1"


class DatasetCorruptError(ValueError):
    """A binary dataset file could not be read or failed validation
    (truncated or garbage payload, an unknown class in it, missing fields,
    or a fingerprint that does not match the stored binned matrix).  Copy
    of the reference's (lightgbm_tpu/dataset.py:36)."""

    def __init__(self, source: str, detail: str) -> None:
        super().__init__(f"{source}: {detail}")
        self.source = source
        self.detail = detail

# the kernels' row block (lightgbm_tpu/ops/histogram_pallas.py
# DEFAULT_ROW_BLOCK): the wave grower pads rows to a multiple of it, and
# the speculative ramp's subsample stride is derived from the padded count,
# so the port keeps the same padding to grow the same trees
ROW_BLOCK = 4096

_ArrayLike = Union[np.ndarray, Sequence[float], "Any"]


def pad_rows(n: int, row_block: int = ROW_BLOCK) -> int:
    """Rows the wave grower pads to (lightgbm_tpu/ops/histogram_pallas.py
    ``pad_rows``)."""
    return -(-max(n, row_block) // row_block) * row_block


def sample_row_indices(n: int, sample_cnt: int, seed: int,
                       rng: Optional[np.random.RandomState] = None
                       ) -> np.ndarray:
    """The deterministic bin-construct row sample (copy of
    ``lightgbm_tpu/ingest/sketch.py`` ``sample_row_indices``): the one
    copy of the port, which ``ingest/sketch.py`` imports, so the streamed
    sketch pass and the in-core construct draw the same rows."""
    if rng is None:
        rng = np.random.RandomState(seed)
    sample_cnt = min(n, int(sample_cnt))
    if sample_cnt < n:
        return np.sort(rng.choice(n, size=sample_cnt, replace=False))
    return np.arange(n)


class Metadata:
    """Labels / weights / init scores (reference dataset.h:41).  Copy of
    the reference package's ``Metadata``."""

    def __init__(self) -> None:
        self.label: Optional[np.ndarray] = None
        self.weight: Optional[np.ndarray] = None
        self.group: Optional[np.ndarray] = None
        self.query_boundaries: Optional[np.ndarray] = None
        self.init_score: Optional[np.ndarray] = None

    def set_label(self, label: _ArrayLike) -> None:
        self.label = np.asarray(label, dtype=np.float32).ravel()

    def set_weight(self, weight: Optional[_ArrayLike]) -> None:
        if weight is None:
            self.weight = None
        else:
            w = np.asarray(weight, dtype=np.float32).ravel()
            if (w < 0).any():
                raise ValueError("weights must be non-negative")
            self.weight = w

    def set_group(self, group: Optional[_ArrayLike]) -> None:
        if group is None:
            self.group = None
            self.query_boundaries = None
            return
        g = np.asarray(group, dtype=np.int64).ravel()
        self.group = g
        self.query_boundaries = np.concatenate([[0], np.cumsum(g)]).astype(
            np.int64)

    def set_init_score(self, init_score: Optional[_ArrayLike]) -> None:
        if init_score is None:
            self.init_score = None
        else:
            self.init_score = np.asarray(init_score, dtype=np.float64).ravel()

    @property
    def num_queries(self) -> int:
        return 0 if self.group is None else len(self.group)


class Dataset:
    """User-facing dataset, lazily constructed (reference python-package
    basic.py ``Dataset``).  ``data`` is a dense numpy array or a pandas
    DataFrame."""

    def __init__(self, data: Any, label: Optional[_ArrayLike] = None,
                 reference: Optional["Dataset"] = None,
                 weight: Optional[_ArrayLike] = None,
                 group: Optional[_ArrayLike] = None,
                 init_score: Optional[_ArrayLike] = None,
                 feature_name: Union[str, List[str]] = "auto",
                 categorical_feature: Union[str, List[Union[int, str]]] = "auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True) -> None:
        self.data = data
        self.params = dict(params or {})
        self.reference = reference
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.free_raw_data = free_raw_data
        self.metadata = Metadata()
        self._label_arg = label
        self._weight_arg = weight
        self._group_arg = group
        self._init_score_arg = init_score
        self.constructed = False
        self.bin_mappers: List[BinMapper] = []
        self.X_binned: Optional[np.ndarray] = None   # (N, F or G) uint8/16
        self.num_bins_per_feature: Optional[np.ndarray] = None
        self.used_feature_map: Optional[np.ndarray] = None  # inner -> real
        self.num_total_features = 0
        self.efb = None  # BundleInfo when EFB-bundled (efb.py)
        self.raw_used: Optional[np.ndarray] = None  # (N, F) f32, linear_tree
        self._device_cache: Dict[Any, Any] = {}

    # -- construction --------------------------------------------------------
    def construct(self, config: Optional[Config] = None) -> "Dataset":
        if self.constructed:
            return self
        cfg = config or Config(self.params)
        raw, feature_names = self._materialize_raw()
        sparse = hasattr(raw, "tocsc")
        if sparse:
            raw = raw.tocsc()
        n, f = raw.shape
        self.num_total_features = f
        self.feature_names_ = feature_names
        self.efb = None
        cat_indices = self._resolve_categoricals(feature_names)
        if cfg.linear_tree and sparse:
            # linear leaves fit on RAW dense values (linear_tree_learner.cpp
            # reads raw columns); the reference refuses this too
            raise ValueError("linear_tree requires dense input (the "
                             "per-leaf linear fits read raw feature "
                             "values); densify or disable linear_tree")

        rng = np.random.RandomState(cfg.data_random_seed)
        sample_idx = sample_row_indices(n, int(cfg.bin_construct_sample_cnt),
                                        cfg.data_random_seed, rng=rng)
        sample_cnt = len(sample_idx)
        if self.reference is not None:
            ref = self.reference
            if not ref.constructed:
                ref.construct(config)
            # align bins and bundles with the reference dataset
            # (dataset.h:304)
            self.bin_mappers = ref.bin_mappers
            self.used_feature_map = ref.used_feature_map
            self.num_bins_per_feature = ref.num_bins_per_feature
            self.efb = ref.efb
        else:
            forced_bins = self._load_forced_bins(cfg)
            self.bin_mappers = []
            for j in range(f):
                if sparse:
                    # sampled nonzeros + proportional implied zeros (the
                    # reference's sparse sample, dataset.py:278-290; the
                    # shared generator keeps its draws in step)
                    lo, hi = raw.indptr[j], raw.indptr[j + 1]
                    vals = np.asarray(raw.data[lo:hi], np.float64)
                    if len(vals) > sample_cnt:
                        vals = vals[np.sort(rng.choice(len(vals),
                                                       sample_cnt, False))]
                    zfrac = 1.0 - (hi - lo) / max(n, 1)
                    nz = int(round(len(vals) * zfrac /
                                   max(1e-9, 1 - zfrac))) \
                        if zfrac < 1.0 else sample_cnt
                    nz = min(nz, sample_cnt)
                    col_sample = np.concatenate([vals, np.zeros(nz)])
                else:
                    col_sample = raw[sample_idx, j]
                # the reference's pre-filter threshold scales
                # min_data_in_leaf by the sample fraction
                # (dataset_loader.cpp filter_cnt); 0 disables it
                filt = max(1, int(cfg.min_data_in_leaf * len(col_sample) /
                                  max(1, n))) \
                    if cfg.feature_pre_filter else 0
                self.bin_mappers.append(find_bin(
                    col_sample, max_bin=cfg.max_bin,
                    min_data_in_bin=cfg.min_data_in_bin,
                    total_cnt=len(col_sample),
                    is_categorical=(j in cat_indices),
                    use_missing=cfg.use_missing,
                    zero_as_missing=cfg.zero_as_missing,
                    forced_bounds=forced_bins.get(j),
                    pre_filter_cnt=filt))
            self._finalize_used_features(f)

        used = self.used_feature_map
        mappers = [self.bin_mappers[j] for j in used]
        # uint16 codes when some feature has more than 256 bins (reference
        # binning.py bin_matrix)
        code_dtype = (np.uint8 if max(m.num_bin for m in mappers) <= 256
                      else np.uint16)
        if self.efb is None and self.reference is None:
            self.efb = self._maybe_bundle(cfg, raw, sparse, used, mappers,
                                          sample_idx)
        if self.efb is not None:
            from .efb import bundle_binned_matrix, bundle_sparse_csc
            if sparse:
                self.X_binned = bundle_sparse_csc(raw[:, used].tocsc(),
                                                  mappers, self.efb)
            else:
                self.X_binned = bundle_binned_matrix(
                    bin_matrix(raw[:, used], mappers), self.efb)
            log_info(f"EFB: bundled {len(used)} features into "
                     f"{self.efb.n_bundles} device columns "
                     f"({self.efb.bundle_bins} bundle bins)")
        elif sparse:
            # no bundling: densify the BINNED codes (uint8), never the
            # raw float64 values (reference dataset.py:329-340)
            csc = raw[:, used].tocsc()
            self.X_binned = np.empty((n, len(used)), code_dtype)
            for jj, m in enumerate(mappers):
                col = np.full(n, m.default_bin, code_dtype)
                lo, hi = csc.indptr[jj], csc.indptr[jj + 1]
                col[csc.indices[lo:hi]] = m.value_to_bin(
                    np.asarray(csc.data[lo:hi], np.float64)).astype(
                        code_dtype)
                self.X_binned[:, jj] = col
        else:
            self.X_binned = bin_matrix(raw[:, used], mappers)
        # linear trees fit on the raw values of the used columns
        # (reference dataset.py:343-351)
        self.raw_used = (np.ascontiguousarray(raw[:, used], np.float32)
                         if cfg.linear_tree else None)
        self._set_metadata(n)
        self.constructed = True
        if self.free_raw_data:
            self.data = None
        return self

    @staticmethod
    def _load_forced_bins(cfg) -> Dict[int, list]:
        """forcedbins_filename JSON -> {feature: [upper bounds]} (copy of
        the reference's ``Dataset._load_forced_bins``, dataset.py:361-372;
        LightGBM dataset_loader.cpp:641 GetForcedBins)."""
        forced_bins: Dict[int, list] = {}
        if getattr(cfg, "forcedbins_filename", ""):
            import json as _json
            with open(cfg.forcedbins_filename) as fh:
                for ent in _json.load(fh):
                    forced_bins[int(ent["feature"])] = \
                        list(ent["bin_upper_bound"])
        return forced_bins

    def _maybe_bundle(self, cfg, raw, sparse, used, mappers, sample_idx):
        """Decide + build EFB bundles (reference dataset.py:437-484,
        dataset.cpp:239 FastFeatureBundling): serial-learner training
        only, and only when it shrinks the device matrix.  Categorical
        features stay singleton (their set-membership decisions read raw
        bins)."""
        from .efb import MAX_BUNDLE_BINS, build_bundle_info, find_bundles
        if (not cfg.enable_bundle or cfg.tree_learner != "serial"
                or cfg.linear_tree or len(used) < 3):
            return None
        if max(m.num_bin for m in mappers) > MAX_BUNDLE_BINS:
            # bundle columns are uint8: the reference keeps a >256-bin
            # feature as its own bundle and casts its codes to uint8
            # (lightgbm_tpu/efb.py:149, dataset.py:455), which wraps
            # them; the port does not bundle a uint16 matrix (ROADMAP
            # queue 3 item 8)
            return None
        nondefault = []
        cand = []
        for jj, m in enumerate(mappers):
            if m.is_categorical or m.num_bin > MAX_BUNDLE_BINS:
                continue
            j = int(used[jj])
            if sparse:
                lo, hi = raw.indptr[j], raw.indptr[j + 1]
                mask = np.zeros(len(sample_idx), bool)
                mask[np.searchsorted(sample_idx,
                                     np.intersect1d(raw.indices[lo:hi],
                                                    sample_idx))] = True
            else:
                col = m.value_to_bin(raw[sample_idx, j])
                mask = col != m.default_bin
            # only near-sparse features are worth bundling
            if mask.mean() <= 0.5:
                nondefault.append(mask)
                cand.append(jj)
        if len(cand) < 2:
            return None
        bundles_local = find_bundles([mappers[jj] for jj in cand],
                                     nondefault, raw.shape[0],
                                     len(sample_idx))
        bundles = [[cand[i] for i in b] for b in bundles_local]
        in_bundle = {jj for b in bundles for jj in b}
        bundles += [[jj] for jj in range(len(mappers)) if jj not in in_bundle]
        if len(bundles) > 0.9 * len(mappers):
            return None  # not worth the indirection
        return build_bundle_info(mappers, bundles,
                                 max(m.num_bin for m in mappers))

    def _finalize_used_features(self, f: int) -> None:
        """Trivial-feature pre-filter (config.h feature_pre_filter) ->
        used_feature_map / num_bins_per_feature."""
        used = [j for j, m in enumerate(self.bin_mappers)
                if not m.is_trivial]
        if len(used) == 0:
            raise ValueError("cannot construct Dataset: all features are "
                             "trivial (constant); nothing to split on")
        if len(used) < f:
            log_info(f"Dataset: filtered {f - len(used)} trivial features, "
                     f"{len(used)} remain")
        self.used_feature_map = np.asarray(used, dtype=np.int32)
        self.num_bins_per_feature = np.asarray(
            [self.bin_mappers[j].num_bin for j in used], dtype=np.int32)

    def _materialize_raw(self):
        data = self.data
        if data is None:
            raise ValueError("Dataset raw data was freed; pass "
                             "free_raw_data=False to reuse it")
        if isinstance(data, str):
            from .io_utils import load_data_file
            raw, names, label = load_data_file(data, self.params)
            if label is not None and self._label_arg is None:
                self._label_arg = label
            return raw, names
        try:  # pandas without a hard dependency
            import pandas as pd  # type: ignore
            if isinstance(data, pd.DataFrame):
                names = [str(c) for c in data.columns]
                return data.to_numpy(dtype=np.float64, na_value=np.nan), names
        except ImportError:
            pass
        if hasattr(data, "tocsc"):   # scipy sparse: binned column by
            raw = data               # column in construct()
        else:
            raw = np.asarray(data, dtype=np.float64)
            if raw.ndim == 1:
                raw = raw.reshape(-1, 1)
        if self.feature_name != "auto" and self.feature_name is not None:
            names = list(self.feature_name)
        else:
            names = [f"Column_{i}" for i in range(raw.shape[1])]
        return raw, names

    def _resolve_categoricals(self, feature_names: List[str]) -> set:
        cats = self.categorical_feature
        if cats == "auto" or cats is None:
            from_params = self.params.get("categorical_feature", "")
            if isinstance(from_params, str) and from_params:
                cats = from_params.split(",")
            else:
                return set()
        out = set()
        for c in cats:
            if isinstance(c, str) and c in feature_names:
                out.add(feature_names.index(c))
            elif isinstance(c, str) and c.strip().isdigit():
                out.add(int(c))
            elif isinstance(c, (int, np.integer)):
                out.add(int(c))
        return out

    def _set_metadata(self, n: int) -> None:
        if self._label_arg is not None:
            self.metadata.set_label(self._label_arg)
            if len(self.metadata.label) != n:
                raise ValueError(f"label length {len(self.metadata.label)} "
                                 f"!= rows {n}")
        self.metadata.set_weight(self._weight_arg)
        self.metadata.set_group(self._group_arg)
        self.metadata.set_init_score(self._init_score_arg)

    # -- reference-API surface ----------------------------------------------
    def create_valid(self, data: Any, label: Optional[_ArrayLike] = None,
                     weight: Optional[_ArrayLike] = None,
                     group: Optional[_ArrayLike] = None,
                     init_score: Optional[_ArrayLike] = None,
                     params: Optional[Dict[str, Any]] = None) -> "Dataset":
        return Dataset(data, label=label, reference=self, weight=weight,
                       group=group, init_score=init_score,
                       params=params or self.params)

    # setters and getters (reference dataset.py:556-592): each setter
    # records the value for construct() and, once constructed, sets it
    def set_label(self, label: _ArrayLike) -> "Dataset":
        self._label_arg = label
        if self.constructed:
            self.metadata.set_label(label)
        return self

    def set_weight(self, weight: Optional[_ArrayLike]) -> "Dataset":
        self._weight_arg = weight
        if self.constructed:
            self.metadata.set_weight(weight)
        return self

    def set_group(self, group: Optional[_ArrayLike]) -> "Dataset":
        self._group_arg = group
        if self.constructed:
            self.metadata.set_group(group)
        return self

    def set_init_score(self, init_score: Optional[_ArrayLike]) -> "Dataset":
        self._init_score_arg = init_score
        if self.constructed:
            self.metadata.set_init_score(init_score)
        return self

    def get_label(self) -> Optional[np.ndarray]:
        return self.metadata.label if self.constructed else (
            None if self._label_arg is None else np.asarray(self._label_arg))

    def get_weight(self) -> Optional[np.ndarray]:
        return self.metadata.weight

    def get_group(self) -> Optional[np.ndarray]:
        return self.metadata.group

    def get_init_score(self) -> Optional[np.ndarray]:
        return self.metadata.init_score

    def num_data(self) -> int:
        self._check_constructed()
        return int(self.X_binned.shape[0])

    def num_feature(self) -> int:
        self._check_constructed()
        return int(len(self.used_feature_map))

    @property
    def feature_names(self) -> List[str]:
        self._check_constructed()
        return [self.feature_names_[j] for j in self.used_feature_map]

    def subset(self, used_indices: Sequence[int],
               params: Optional[Dict[str, Any]] = None) -> "Dataset":
        """Row subset sharing this dataset's bin mappers (reference
        Dataset::CopySubrow)."""
        self._check_constructed()
        idx = np.asarray(used_indices, dtype=np.int64)
        sub = copy.copy(self)
        sub._device_cache = {}
        sub.X_binned = self.X_binned[idx]
        if self.raw_used is not None:
            sub.raw_used = self.raw_used[idx]
        sub.metadata = Metadata()
        if self.metadata.label is not None:
            sub.metadata.set_label(self.metadata.label[idx])
        if self.metadata.weight is not None:
            sub.metadata.set_weight(self.metadata.weight[idx])
        if self.metadata.init_score is not None:
            sub.metadata.set_init_score(self.metadata.init_score[idx])
        return sub

    def fingerprint(self) -> Dict[str, Any]:
        """Identity of the binned training matrix for checkpoint/resume
        validation (reference dataset.py:605-648): the shape, a sha256
        over every used mapper's bin edges and category map, and a crc32
        over the binned codes, the same fields and values as the
        reference's for the same data.  Cached: the crc over the host's
        ``X_binned`` is the one non-trivial cost, and the binned matrix
        does not change once constructed."""
        self._check_constructed()
        fp = self._device_cache.get("_fingerprint")
        if fp is not None:
            return fp
        import zlib
        fp = self._fingerprint_with_crc(int(zlib.crc32(
            np.ascontiguousarray(self.X_binned).tobytes())))
        self._device_cache["_fingerprint"] = fp
        return fp

    def _fingerprint_with_crc(self, crc: int) -> Dict[str, Any]:
        """The fingerprint from a crc32 of the binned codes computed
        elsewhere (ingest/stream.py streams it over chunks), so the
        streamed and in-core fingerprints share every other field
        (reference dataset.py:627-650)."""
        import hashlib
        h = hashlib.sha256()
        for j in self.used_feature_map:
            m = self.bin_mappers[j]
            h.update(f"{int(j)}:{m.num_bin}:{int(m.is_categorical)}:"
                     f"{m.missing_type.value}".encode())
            if m.bin_upper_bound is not None:
                h.update(np.ascontiguousarray(
                    m.bin_upper_bound, np.float64).tobytes())
            if m.cat_to_bin:
                h.update(repr(sorted(m.cat_to_bin.items())).encode())
        return {
            "num_data": int(self.num_data()),
            "binned_shape": [int(v) for v in self.X_binned.shape],
            "num_features": int(self.num_feature()),
            "binning_sha256": h.hexdigest(),
            "data_crc32": int(crc),
        }

    # -- the binary dataset cache (reference Dataset::SaveBinaryFile /
    #    DatasetLoader::LoadFromBinFile; lightgbm_tpu/dataset.py:690-776) --
    def save_binary(self, filename: str) -> "Dataset":
        """Crash-safe binary save in the reference's format: the payload
        lands through ``io_utils.atomic_write_bytes`` (temp + fsync +
        rename) and carries the :meth:`fingerprint`, which
        :meth:`load_binary` checks against the stored matrix.  The bin
        mappers and bundles are the port's classes; the reference loads
        them as its own (:class:`_BinaryUnpickler` maps the other way)."""
        self._check_constructed()
        import pickle
        from .io_utils import atomic_write_bytes
        payload = {
            "format": BINARY_FORMAT,
            "X_binned": np.asarray(self.X_binned),
            "bin_mappers": self.bin_mappers,
            "used_feature_map": self.used_feature_map,
            "num_bins_per_feature": self.num_bins_per_feature,
            "feature_names": self.feature_names_,
            "efb": self.efb,
            "label": self.metadata.label,
            "weight": self.metadata.weight,
            "group": self.metadata.group,
            "init_score": self.metadata.init_score,
            "fingerprint": self.fingerprint(),
        }
        atomic_write_bytes(filename, pickle.dumps(payload, protocol=4))
        return self

    _BINARY_REQUIRED = ("X_binned", "bin_mappers", "used_feature_map",
                        "num_bins_per_feature", "feature_names", "label",
                        "weight", "group", "init_score")

    @staticmethod
    def load_binary(filename: str,
                    params: Optional[Dict[str, Any]] = None) -> "Dataset":
        """Load a binary dataset file written by either package's
        ``save_binary``.  A truncated or garbage payload, a global outside
        the format's classes, a missing field or a binned matrix that no
        longer matches its stored fingerprint raises
        :class:`DatasetCorruptError` (never a raw pickle exception)."""
        try:
            with open(filename, "rb") as fh:
                payload = _BinaryUnpickler(fh).load()
        except OSError:
            raise
        except Exception as exc:
            raise DatasetCorruptError(
                str(filename), f"not a readable binary dataset "
                f"({type(exc).__name__}: {exc})") from exc
        if not isinstance(payload, dict) or \
                payload.get("format") != BINARY_FORMAT:
            raise DatasetCorruptError(
                str(filename), "not a lightgbm_tpu binary dataset "
                "(missing/unknown format marker)")
        missing = [k for k in Dataset._BINARY_REQUIRED if k not in payload]
        if missing:
            raise DatasetCorruptError(
                str(filename),
                f"binary dataset is missing fields: {', '.join(missing)}")
        ds = Dataset(None, params=params)
        ds.X_binned = payload["X_binned"]
        ds.bin_mappers = payload["bin_mappers"]
        ds.used_feature_map = payload["used_feature_map"]
        ds.num_bins_per_feature = payload["num_bins_per_feature"]
        ds.feature_names_ = payload["feature_names"]
        ds.efb = payload.get("efb")
        ds.num_total_features = len(ds.feature_names_)
        if payload["label"] is not None:
            ds.metadata.set_label(payload["label"])
        ds.metadata.set_weight(payload["weight"])
        ds.metadata.set_group(payload["group"])
        ds.metadata.set_init_score(payload["init_score"])
        ds.constructed = True
        stored = payload.get("fingerprint")
        if stored:  # absent in pre-fingerprint files: accept
            try:
                got = ds.fingerprint()
            except Exception as exc:
                raise DatasetCorruptError(
                    str(filename), f"stored arrays are inconsistent "
                    f"({type(exc).__name__}: {exc})") from exc
            diffs = [k for k in stored if k in got and got[k] != stored[k]]
            if diffs:
                raise DatasetCorruptError(
                    str(filename),
                    "stored binned matrix does not match its recorded "
                    "fingerprint (" + ", ".join(
                        f"{k}: stored={stored[k]!r} got={got[k]!r}"
                        for k in diffs) + ")")
        return ds

    def _check_constructed(self) -> None:
        if not self.constructed:
            raise RuntimeError("Dataset not constructed yet; call construct() "
                               "(done automatically by train())")

    # -- device placement ----------------------------------------------------
    def device_bins(self, device: torch.device,
                    row_block: int = ROW_BLOCK) -> torch.Tensor:
        """The FEATURE-MAJOR ``(F, N_pad)`` uint8 (uint16 past 256 bins)
        bin matrix on ``device``,
        rows zero-padded to a multiple of ``row_block`` (cached).  The
        reference keeps a row-major device copy and transposes/pads it in
        the learner (learner/serial.py:909-916); the port builds the
        kernels' layout once here."""
        self._check_constructed()
        device = torch.device(device)
        key = ("bins_fm", str(device), row_block)
        if key not in self._device_cache:
            n, f = self.X_binned.shape
            xt = np.zeros((f, pad_rows(n, row_block)), self.X_binned.dtype)
            xt[:, :n] = self.X_binned.T
            self._device_cache[key] = torch.from_numpy(xt).to(device)
        return self._device_cache[key]

    def device_bins_packed4(self, device: torch.device) -> torch.Tensor:
        """The FEATURE-MAJOR nibble-packed ``(F, N_pad/2)`` bin matrix on
        ``device`` (reference ``lightgbm_tpu/dataset.py:793``
        ``device_bins_packed4``): two 4-bit bin codes per byte, row 2j in
        the low nibble of byte j (reference src/io/dense_bin.hpp 4-bit
        bins), rows zero-padded to a multiple of :data:`ROW_BLOCK`; half
        the device bytes of :meth:`device_bins`.  Requires every used
        feature to fit 16 bins.  Cached per device."""
        self._check_constructed()
        from .ops.histogram import PACK4_MAX_BINS, pack_bins4
        device = torch.device(device)
        key = ("bins_packed4", str(device))
        if key not in self._device_cache:
            max_b = int(np.max(self.num_bins_per_feature))
            if max_b > PACK4_MAX_BINS:
                raise ValueError(
                    f"device_bins_packed4 requires every feature to fit "
                    f"{PACK4_MAX_BINS} bins (max is {max_b}); set "
                    f"max_bin<={PACK4_MAX_BINS}")
            n, f = self.X_binned.shape
            xt = np.zeros((f, pad_rows(n)), np.uint8)
            xt[:, :n] = self.X_binned.T
            self._device_cache[key] = pack_bins4(
                torch.from_numpy(xt)).to(device)
        return self._device_cache[key]


class _BinaryUnpickler(pickle.Unpickler):
    """The binary dataset file's reader: the few classes its payload holds
    (bin mappers, their missing type, EFB bundles, numpy arrays and
    scalars), each mapped to the port's copy whichever package wrote the
    file; any other global is refused.  The port never imports the
    reference, so a file of ``lightgbm_tpu.binning.BinMapper`` objects
    loads as :class:`binning.BinMapper`."""

    _CLASSES = {"BinMapper": ("binning", "BinMapper"),
                "MissingType": ("binning", "MissingType"),
                "BundleInfo": ("efb", "BundleInfo")}
    _PACKAGES = ("lightgbm_tpu", "lightgbm_tpu_torch")
    _NUMPY = {("numpy", "ndarray"), ("numpy", "dtype"),
              ("numpy.core.multiarray", "_reconstruct"),
              ("numpy._core.multiarray", "_reconstruct"),
              ("numpy.core.multiarray", "scalar"),
              ("numpy._core.multiarray", "scalar")}

    def find_class(self, module: str, name: str):
        pkg, _, sub = module.partition(".")
        if pkg in self._PACKAGES and name in self._CLASSES and \
                sub == self._CLASSES[name][0]:
            import importlib
            mod = importlib.import_module(f"lightgbm_tpu_torch.{sub}")
            return getattr(mod, self._CLASSES[name][1])
        if (module, name) in self._NUMPY or (
                module == "numpy" and name.endswith("DType")) or (
                module.startswith("numpy.dtypes") and name.endswith("DType")):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"global {module}.{name} is not part of a binary dataset file")
