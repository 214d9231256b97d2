"""Feature quantization: value -> integer bin codes.

TPU-native re-implementation of the reference BinMapper
(reference: include/LightGBM/bin.h:61 ``BinMapper``, src/io/bin.cpp:150
``GreedyFindBin`` / ``FindBinWithZeroAsOneBin`` / ``BinMapper::FindBin``).

Runs host-side (numpy) once at ingest; the result is a dense integer matrix
(uint8 for <=256 bins) that is ``device_put`` / mesh-sharded once and stays
on device for the whole training run.  Bin semantics follow the reference:

* zero gets its own bin (kZeroThreshold band), negatives/positives binned
  separately around it with greedy equal-frequency boundaries;
* missing handling is None / Zero / NaN (bin.h:26 ``MissingType``): with
  ``MissingType.NaN`` an extra trailing bin holds the NaNs;
* categorical features map category ids to bins by descending frequency,
  keeping categories that cover 99% of the sample (src/io/bin.cpp categorical
  branch of FindBin).


Copy of ``lightgbm_tpu/binning.py`` (numpy only) kept inside the PyTorch port so
the port never imports the JAX package."""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["MissingType", "BinMapper", "find_bin", "bin_matrix",
           "ColumnSummary", "summarize_column", "merge_column_summaries",
           "find_bin_from_summary"]

# reference include/LightGBM/bin.h:29 kZeroThreshold
ZERO_THRESHOLD = 1e-35
# reference include/LightGBM/bin.h:27 kSparseThreshold unused here (dense device layout)


class MissingType(enum.Enum):
    NONE = 0
    ZERO = 1
    NAN = 2


def _dbl_up(a: float) -> float:
    """Next representable double above ``a`` (common.h GetDoubleUpperBound;
    boundary values sit strictly above the midpoint so ValueToBin's
    left-search puts the midpoint's lower neighbor in the lower bin)."""
    return float(np.nextafter(a, np.inf))


def _greedy_find_bin(distinct_values, counts, max_bin: int, total_cnt: int,
                     min_data_in_bin: int) -> List[float]:
    """Greedy equal-frequency boundary search over distinct sample values —
    exact behavioral mirror of the reference (src/io/bin.cpp:78
    GreedyFindBin): big-count values get dedicated bins, the running mean
    bin size re-adapts as bins close, boundaries are the next double above
    the midpoint, and one-ULP-adjacent boundaries dedupe.

    Returns upper bin boundaries; the last boundary is +inf.
    """
    dv = [float(v) for v in distinct_values]
    ct = [int(c) for c in counts]
    nd = len(dv)
    out: List[float] = []
    if nd == 0:
        return [np.inf]
    if nd <= max_bin:
        cur = 0
        for i in range(nd - 1):
            cur += ct[i]
            if cur >= min_data_in_bin:
                val = _dbl_up((dv[i] + dv[i + 1]) / 2.0)
                if not out or val > _dbl_up(out[-1]):
                    out.append(val)
                    cur = 0
        out.append(np.inf)
        return out

    if min_data_in_bin > 0:
        max_bin = max(1, min(max_bin, int(total_cnt) // min_data_in_bin))
    mean_bin_size = total_cnt / max_bin
    is_big = [c >= mean_bin_size for c in ct]
    rest_bin = max_bin - sum(is_big)
    rest_cnt = int(total_cnt) - sum(c for c, b in zip(ct, is_big) if b)
    mean_bin_size = rest_cnt / rest_bin if rest_bin else np.inf
    uppers: List[float] = []
    lowers: List[float] = [dv[0]]
    cur = 0
    for i in range(nd - 1):
        if not is_big[i]:
            rest_cnt -= ct[i]
        cur += ct[i]
        if is_big[i] or cur >= mean_bin_size or \
                (is_big[i + 1] and cur >= max(1.0, mean_bin_size * 0.5)):
            uppers.append(dv[i])
            lowers.append(dv[i + 1])
            if len(uppers) >= max_bin - 1:
                break
            cur = 0
            if not is_big[i]:
                rest_bin -= 1
                mean_bin_size = rest_cnt / rest_bin if rest_bin else np.inf
    for i in range(len(uppers)):
        val = _dbl_up((uppers[i] + lowers[i + 1]) / 2.0)
        if not out or val > _dbl_up(out[-1]):
            out.append(val)
    out.append(np.inf)
    return out


def _distinct_with_zero(vals_sorted: np.ndarray, zero_cnt: int):
    """Distinct (value, count) pairs with the implicit zero block injected
    at its sorted position (BinMapper::FindBin's construction,
    bin.cpp:355-383: the sample carries only |v| > kZeroThreshold values;
    everything else is the zero block).  One-ULP-adjacent values merge,
    keeping the larger value."""
    return _distinct_with_zero_counts(
        vals_sorted, np.ones(len(vals_sorted), np.int64), zero_cnt)


def _distinct_with_zero_counts(dv: np.ndarray, cv: np.ndarray,
                               zero_cnt: int):
    """Counts-based core of :func:`_distinct_with_zero`: ``dv`` are sorted
    values (duplicates allowed — exact-duplicate runs are 0 ULP apart and
    merge into one group anyway), ``cv`` their multiplicities.  Operating
    on (value, count) pairs makes the construction *mergeable*: chunk
    summaries built by :func:`summarize_column` merge exactly and
    finalize through this same code, so streamed sketch binning is
    bit-identical to the one-shot path."""
    n = len(dv)
    if n == 0:
        return [0.0], [int(zero_cnt)]
    new_grp = np.empty(n, bool)
    new_grp[0] = True
    if n > 1:
        new_grp[1:] = dv[1:] > np.nextafter(dv[:-1], np.inf)
    starts = np.flatnonzero(new_grp)
    ends = np.append(starts[1:], n) - 1
    dl = np.asarray(dv)[ends].tolist()
    cl = np.add.reduceat(np.asarray(cv, np.int64), starts).tolist()
    out_d: List[float] = []
    out_c: List[int] = []
    if dl[0] > 0.0 and zero_cnt > 0:
        out_d.append(0.0)
        out_c.append(int(zero_cnt))
    for i, (d, c) in enumerate(zip(dl, cl)):
        if i > 0 and dl[i - 1] < 0.0 and d > 0.0:
            # the zero block sits between the signs (inserted even when
            # empty, like the reference)
            out_d.append(0.0)
            out_c.append(int(zero_cnt))
        out_d.append(float(d))
        out_c.append(int(c))
    if dl[-1] < 0.0 and zero_cnt > 0:
        out_d.append(0.0)
        out_c.append(int(zero_cnt))
    return out_d, out_c


def _split_zero_counts(distinct, counts):
    left_cnt_data = cnt_zero = right_cnt_data = 0
    for d, c in zip(distinct, counts):
        if d <= -ZERO_THRESHOLD:
            left_cnt_data += c
        elif d > ZERO_THRESHOLD:
            right_cnt_data += c
        else:
            cnt_zero += c
    left_cnt = next((i for i, d in enumerate(distinct)
                     if d > -ZERO_THRESHOLD), len(distinct))
    right_start = next((i for i in range(left_cnt, len(distinct))
                        if distinct[i] > ZERO_THRESHOLD), -1)
    return left_cnt_data, cnt_zero, right_cnt_data, left_cnt, right_start


def _find_bin_zero_as_one(distinct, counts, max_bin: int, total_cnt: int,
                          min_data_in_bin: int) -> List[float]:
    """Exact mirror of the reference's FindBinWithZeroAsOneBin
    (bin.cpp:256): the negative range gets a budget proportional to its
    row share (floored), its last boundary becomes -kZeroThreshold, the
    positive range takes whatever budget remains past the zero bin."""
    left_cnt_data, cnt_zero, right_cnt_data, left_cnt, right_start = \
        _split_zero_counts(distinct, counts)
    ub: List[float] = []
    if left_cnt > 0 and max_bin > 1:
        left_max_bin = int(left_cnt_data / (total_cnt - cnt_zero) *
                           (max_bin - 1))
        left_max_bin = max(1, left_max_bin)
        ub = _greedy_find_bin(distinct[:left_cnt], counts[:left_cnt],
                              left_max_bin, left_cnt_data, min_data_in_bin)
        if ub:
            ub[-1] = -ZERO_THRESHOLD
    right_max_bin = max_bin - 1 - len(ub)
    if right_start >= 0 and right_max_bin > 0:
        rb = _greedy_find_bin(distinct[right_start:], counts[right_start:],
                              right_max_bin, right_cnt_data, min_data_in_bin)
        ub.append(ZERO_THRESHOLD)
        ub.extend(rb)
    else:
        ub.append(np.inf)
    return ub


def _find_bin_predefined(distinct, counts, max_bin: int, total_cnt: int,
                         min_data_in_bin: int, forced) -> List[float]:
    """Exact mirror of FindBinWithPredefinedBin (bin.cpp:157): zero-bin
    boundaries and inf seed the set, forced bounds outside the zero band
    fill up to the budget, and each inter-bound segment gets greedy
    sub-bins proportional to its row share."""
    (left_cnt_data, cnt_zero, right_cnt_data, left_cnt,
     right_start) = _split_zero_counts(distinct, counts)
    ub: List[float] = []
    if max_bin == 2:
        ub.append(ZERO_THRESHOLD if left_cnt == 0 else -ZERO_THRESHOLD)
    elif max_bin >= 3:
        if left_cnt > 0:
            ub.append(-ZERO_THRESHOLD)
        if right_start >= 0:
            ub.append(ZERO_THRESHOLD)
    ub.append(np.inf)
    max_to_insert = max_bin - len(ub)
    num_inserted = 0
    for b in forced:
        if num_inserted >= max_to_insert:
            break
        if abs(float(b)) > ZERO_THRESHOLD:
            ub.append(float(b))
            num_inserted += 1
    ub.sort()
    free_bins = max_bin - len(ub)
    bounds_to_add: List[float] = []
    value_ind = 0
    nd = len(distinct)
    for i in range(len(ub)):
        cnt_in_bin = 0
        bin_start = value_ind
        while value_ind < nd and distinct[value_ind] < ub[i]:
            cnt_in_bin += counts[value_ind]
            value_ind += 1
        bins_remaining = max_bin - len(ub) - len(bounds_to_add)
        num_sub_bins = int(np.floor(cnt_in_bin * free_bins / total_cnt + 0.5)) \
            if total_cnt > 0 else 0
        num_sub_bins = min(num_sub_bins, bins_remaining) + 1
        if i == len(ub) - 1:
            num_sub_bins = bins_remaining + 1
        nb = _greedy_find_bin(distinct[bin_start:value_ind],
                              counts[bin_start:value_ind], num_sub_bins,
                              cnt_in_bin, min_data_in_bin)
        bounds_to_add.extend(nb[:-1])  # last bound is inf
    ub.extend(bounds_to_add)
    ub.sort()
    return ub


@dataclass
class BinMapper:
    """Per-feature value->bin quantizer (reference bin.h:61)."""

    num_bin: int = 1
    is_categorical: bool = False
    missing_type: MissingType = MissingType.NONE
    # numerical: ascending upper boundaries, len == num_bin (minus NaN bin)
    bin_upper_bound: Optional[np.ndarray] = None
    # categorical: category id (int) -> bin
    cat_to_bin: Dict[int, int] = field(default_factory=dict)
    bin_to_cat: Optional[np.ndarray] = None
    default_bin: int = 0          # bin containing value 0.0 (bin.h GetDefaultBin)
    most_freq_bin: int = 0
    min_value: float = 0.0
    max_value: float = 0.0
    # set by the pre-filter when no boundary separates enough rows
    # (bin.cpp NeedFilter); the feature is dropped like num_bin <= 1
    forced_trivial: bool = False

    @property
    def is_trivial(self) -> bool:
        """True when the feature carries no split information."""
        return self.num_bin <= 1 or self.forced_trivial

    # -- quantization --------------------------------------------------------
    def value_to_bin(self, values: np.ndarray) -> np.ndarray:
        """Vectorized value -> bin (reference bin.h:464 ValueToBin)."""
        values = np.asarray(values, dtype=np.float64)
        if self.is_categorical:
            out = np.zeros(values.shape, dtype=np.int32)
            nan_mask = ~np.isfinite(values)
            ivals = np.where(nan_mask, -1, np.nan_to_num(values, nan=-1)).astype(np.int64)
            # vectorized dict lookup through a dense table when ids are small
            if self.bin_to_cat is not None and len(self.cat_to_bin):
                max_cat = max(self.cat_to_bin)
                table = np.zeros(max_cat + 2, dtype=np.int32)  # unseen -> bin 0
                for cat, b in self.cat_to_bin.items():
                    table[cat] = b
                ivals = np.clip(ivals, -1, max_cat)
                out = np.where(ivals < 0, 0, table[np.clip(ivals, 0, max_cat)])
            return out.astype(np.int32)

        nan_mask = np.isnan(values)
        if self.missing_type != MissingType.NAN:
            values = np.where(nan_mask, 0.0, values)
        bins = np.searchsorted(self.bin_upper_bound, values, side="left").astype(np.int32)
        nbins = len(self.bin_upper_bound)
        bins = np.minimum(bins, nbins - 1)
        if self.missing_type == MissingType.NAN:
            bins = np.where(nan_mask, self.num_bin - 1, bins)
        return bins

    def bin_to_value(self, b: int) -> float:
        """Representative threshold value for a bin upper edge (used when
        serializing split thresholds as raw doubles, reference
        bin.h BinToValue)."""
        if self.is_categorical:
            return float(self.bin_to_cat[b]) if self.bin_to_cat is not None else float(b)
        ub = self.bin_upper_bound
        if b >= len(ub):
            b = len(ub) - 1
        v = ub[b]
        if not np.isfinite(v):
            v = self.max_value + 1.0
        return float(v)


@dataclass
class ColumnSummary:
    """Mergeable one-pass summary of one feature's sampled values.

    The streamed-sketch form of the reference's per-feature sample
    (dataset_loader.cpp:966): exact distinct nonzero finite values (or
    category ids) with multiplicities, plus NaN/total counters.  Two
    summaries over disjoint row sets merge *exactly*
    (:func:`merge_column_summaries`), and :func:`find_bin_from_summary`
    produces the same BinMapper a one-shot :func:`find_bin` over the
    concatenated sample would — the property the out-of-core ingest
    subsystem (lightgbm_tpu/ingest/) builds on.  Memory is bounded by the
    number of distinct sampled values, never by the dataset row count.
    """

    distinct: np.ndarray          # sorted distinct values / category ids
    counts: np.ndarray            # int64 multiplicities
    na_cnt: int = 0
    total_cnt: int = 0            # rows summarized (zeros + NaNs included)
    is_categorical: bool = False


def summarize_column(values: np.ndarray,
                     is_categorical: bool = False) -> ColumnSummary:
    """Summarize one chunk of one feature's values (NaN allowed)."""
    values = np.asarray(values, dtype=np.float64).ravel()
    na_cnt = int(np.isnan(values).sum())
    finite = values[~np.isnan(values)]
    if is_categorical:
        ivals = finite.astype(np.int64)
        if len(ivals) and ivals.min() < 0:
            raise ValueError(
                "categorical features must be non-negative integers")
        cats, counts = (np.unique(ivals, return_counts=True) if len(ivals)
                        else (np.array([], np.int64), np.array([], np.int64)))
        return ColumnSummary(distinct=cats.astype(np.float64),
                             counts=counts.astype(np.int64), na_cnt=na_cnt,
                             total_cnt=len(values), is_categorical=True)
    # only |v| > kZeroThreshold values are kept; zeros are implicit
    # (total - nonzero - na), exactly like the reference's sample
    vals = finite[np.abs(finite) > ZERO_THRESHOLD]
    distinct, counts = (np.unique(vals, return_counts=True) if len(vals)
                        else (np.array([], np.float64),
                              np.array([], np.int64)))
    return ColumnSummary(distinct=distinct, counts=counts.astype(np.int64),
                         na_cnt=na_cnt, total_cnt=len(values))


def merge_column_summaries(a: ColumnSummary,
                           b: ColumnSummary) -> ColumnSummary:
    """Exact merge of two disjoint-row summaries (order-insensitive)."""
    if a.is_categorical != b.is_categorical:
        raise ValueError("cannot merge categorical and numerical summaries")
    d = np.concatenate([a.distinct, b.distinct])
    c = np.concatenate([a.counts, b.counts]).astype(np.int64)
    ud, inv = np.unique(d, return_inverse=True)
    uc = np.zeros(len(ud), np.int64)
    np.add.at(uc, inv, c)
    return ColumnSummary(distinct=ud, counts=uc,
                         na_cnt=a.na_cnt + b.na_cnt,
                         total_cnt=a.total_cnt + b.total_cnt,
                         is_categorical=a.is_categorical)


def find_bin(sample_values: np.ndarray, max_bin: int, min_data_in_bin: int = 3,
             *, total_cnt: Optional[int] = None, is_categorical: bool = False,
             use_missing: bool = True, zero_as_missing: bool = False,
             forced_bounds: Optional[Sequence[float]] = None,
             pre_filter_cnt: int = 1) -> BinMapper:
    """Construct a BinMapper from a sample of one feature's values
    (reference src/io/bin.cpp BinMapper::FindBin).

    ``sample_values`` may contain NaN.  ``total_cnt`` is the full dataset row
    count when the sample is a subsample (affects zero-count accounting).
    ``forced_bounds`` are mandatory bin upper bounds from
    ``forcedbins_filename`` (reference dataset_loader.cpp:641
    ``DatasetLoader::GetForcedBins`` + bin.cpp FindBin forced_upper_bounds):
    they always appear as boundaries; the greedy boundaries fill the
    remaining budget.

    One thin wrapper over :func:`summarize_column` +
    :func:`find_bin_from_summary` — the SAME code path streamed sketch
    binning (lightgbm_tpu/ingest/sketch.py) and distributed summary-merge
    binning (dataset.py pre_partition) take, so all three produce
    identical mappers from identical samples.
    """
    summary = summarize_column(sample_values, is_categorical=is_categorical)
    return find_bin_from_summary(
        summary, max_bin, min_data_in_bin, total_cnt=total_cnt,
        use_missing=use_missing, zero_as_missing=zero_as_missing,
        forced_bounds=forced_bounds, pre_filter_cnt=pre_filter_cnt)


def find_bin_from_summary(summary: ColumnSummary, max_bin: int,
                          min_data_in_bin: int = 3, *,
                          total_cnt: Optional[int] = None,
                          use_missing: bool = True,
                          zero_as_missing: bool = False,
                          forced_bounds: Optional[Sequence[float]] = None,
                          pre_filter_cnt: int = 1) -> BinMapper:
    """BinMapper from a (possibly merged) :class:`ColumnSummary`."""
    if total_cnt is None:
        total_cnt = summary.total_cnt
    na_cnt = int(summary.na_cnt)

    if summary.is_categorical:
        return _find_bin_categorical_counts(
            summary.distinct.astype(np.int64),
            np.asarray(summary.counts, np.int64), max_bin, na_cnt,
            use_missing)

    if zero_as_missing:
        missing_type = MissingType.ZERO
    elif use_missing and na_cnt > 0:
        missing_type = MissingType.NAN
    else:
        missing_type = MissingType.NONE
        # without use_missing NaNs are folded into zero (bin.cpp FindBin)

    # The reference's per-feature sample holds only |v| > kZeroThreshold
    # values (dataset_loader.cpp:966); everything else is the implicit
    # zero block of size total - sample - na.
    nonzero_cnt = int(np.asarray(summary.counts, np.int64).sum())
    na_eff = na_cnt if missing_type == MissingType.NAN else 0
    zero_cnt = int(total_cnt - nonzero_cnt - na_eff)
    distinct, counts = _distinct_with_zero_counts(
        summary.distinct, summary.counts, zero_cnt)

    if missing_type == MissingType.NAN:
        mb, tot = max_bin - 1, int(total_cnt) - na_eff
    else:
        mb, tot = max_bin, int(total_cnt)
    forced = [float(b) for b in forced_bounds] if forced_bounds else []
    if forced:
        ub_list = _find_bin_predefined(distinct, counts, mb, tot,
                                       min_data_in_bin, forced)
    else:
        ub_list = _find_bin_zero_as_one(distinct, counts, mb, tot,
                                        min_data_in_bin)
    if missing_type == MissingType.ZERO and len(ub_list) == 2:
        missing_type = MissingType.NONE

    ub = np.asarray(ub_list, dtype=np.float64)
    num_bin = len(ub)
    if missing_type == MissingType.NAN:
        num_bin += 1  # trailing NaN bin

    # per-bin sample counts (the reference's cnt_in_bin walk) drive
    # most_freq_bin; when the winner is not the zero/default bin and the
    # feature is not sparse enough, the default bin wins (bin.cpp:506-514)
    cnt_in_bin = np.zeros(num_bin, np.int64)
    i_bin = 0
    for d, c in zip(distinct, counts):
        # `while`, not the reference's single-step `if`: forced bounds can
        # place two boundaries between consecutive distinct values, and a
        # single step would misattribute counts across the empty bin
        while d > ub[i_bin]:
            i_bin += 1
        cnt_in_bin[i_bin] += c
    if missing_type == MissingType.NAN:
        cnt_in_bin[num_bin - 1] = na_cnt

    mapper = BinMapper(
        num_bin=num_bin,
        is_categorical=False,
        missing_type=missing_type,
        bin_upper_bound=ub,
        min_value=float(distinct[0]),
        max_value=float(distinct[-1]),
    )
    # pre-filter: a feature no boundary of which can separate
    # pre_filter_cnt rows on both sides can never split (bin.cpp:489
    # NeedFilter; the threshold is min_data_in_leaf scaled to the sample)
    if num_bin > 1 and pre_filter_cnt > 0:
        sum_left = 0
        need = True
        for i in range(num_bin - 1):
            sum_left += int(cnt_in_bin[i])
            if sum_left >= pre_filter_cnt and \
                    int(total_cnt) - sum_left >= pre_filter_cnt:
                need = False
                break
        mapper.forced_trivial = need
    mapper.default_bin = int(np.searchsorted(ub, 0.0, side="left"))
    most_freq = int(cnt_in_bin.argmax())
    sparse_rate = cnt_in_bin[most_freq] / max(1, int(total_cnt))
    if most_freq != mapper.default_bin and sparse_rate < 0.8:
        most_freq = mapper.default_bin  # kSparseThreshold
    mapper.most_freq_bin = most_freq
    return mapper


def _find_bin_categorical(finite: np.ndarray, max_bin: int, na_cnt: int,
                          use_missing: bool) -> BinMapper:
    ivals = finite.astype(np.int64)
    if len(ivals) and ivals.min() < 0:
        raise ValueError("categorical features must be non-negative integers")
    cats, counts = (np.unique(ivals, return_counts=True) if len(ivals)
                    else (np.array([], np.int64), np.array([], np.int64)))
    return _find_bin_categorical_counts(cats, counts, max_bin, na_cnt,
                                        use_missing)


def _find_bin_categorical_counts(cats: np.ndarray, counts: np.ndarray,
                                 max_bin: int, na_cnt: int,
                                 use_missing: bool) -> BinMapper:
    """Counts-based core (``cats`` ascending-sorted distinct ids): the
    mergeable-summary form of the categorical FindBin, shared by the
    one-shot and streamed-sketch paths."""
    order = np.argsort(-counts, kind="stable")
    cats, counts = cats[order], counts[order]
    # keep categories covering 99% of samples, capped at max_bin
    # (reference bin.cpp categorical FindBin: cut_cnt = 99%)
    total = counts.sum()
    if len(cats) > max_bin - 1:
        keep = max_bin - 1
    else:
        keep = len(cats)
    if total > 0 and keep < len(cats):
        pass  # cap dominates
    elif total > 0:
        cum = np.cumsum(counts)
        keep = int(np.searchsorted(cum, 0.99 * total) + 1)
        keep = min(keep, len(cats))
    cats = cats[:keep]
    cat_to_bin = {int(c): i for i, c in enumerate(cats)}
    num_bin = max(len(cats), 1)
    # NaN categoricals map to the most frequent category (bin 0) at both
    # train and inference (tree.py stores default_left = (split category ==
    # most frequent) on cat nodes), so no NaN bin is allocated and
    # missing_type stays NONE — mirrors reference CategoricalDecision
    # semantics for missing values.
    mapper = BinMapper(
        num_bin=num_bin,
        is_categorical=True,
        missing_type=MissingType.NONE,
        cat_to_bin=cat_to_bin,
        bin_to_cat=cats.copy(),
        most_freq_bin=0,
    )
    return mapper


def bin_matrix(X: np.ndarray, mappers: Sequence[BinMapper]) -> np.ndarray:
    """Quantize a raw (N, F) float matrix into bin codes using per-feature
    mappers.  Returns uint8 when every feature fits in 256 bins else uint16.

    The reference's threaded native path (native/binning.cc) is not
    carried over: this copy always takes the numpy per-column path,
    which produces the same codes."""
    n, f = X.shape
    assert f == len(mappers)
    max_bins = max(m.num_bin for m in mappers)
    dtype = np.uint8 if max_bins <= 256 else np.uint16
    out = np.empty((n, f), dtype=dtype)
    for j, m in enumerate(mappers):
        out[:, j] = m.value_to_bin(X[:, j]).astype(dtype)
    return out
