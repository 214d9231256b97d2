"""Exclusive Feature Bundling (EFB).

Port of ``lightgbm_tpu/efb.py`` (reference: src/io/dataset.cpp:53
``GetConflictCount``, :100 ``FindGroups``, :239 ``FastFeatureBundling``).
``BundleInfo``, :func:`find_bundles`, :func:`build_bundle_info`,
:func:`bundle_binned_matrix` and :func:`bundle_sparse_csc` are copies of
the reference's numpy code (efb.py:33-188); :func:`make_expand_hist` and
:func:`make_bundle_decode` are torch versions of its device helpers
(:191, :216).

The device matrix holds one uint8 column per BUNDLE; histograms are built
and pooled in bundle space (G, Bb, 3), and :func:`make_expand_hist`
rebuilds per-feature (F, B, 3) histograms right before each split scan,
restoring each bundled feature's default bin from the leaf totals (the
reference's Dataset::FixHistogram, dataset.cpp:1239).  Tree structure,
split finding and the model format stay in feature space.

Bundle bin layout: bundle bin 0 = "every member feature at its default
bin"; member feature f with nb_f bins gets the range
[offset_f, offset_f + nb_f - 1) for its non-default bins (the default is
elided).  Singleton bundles keep their feature's bins verbatim.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

__all__ = ["BundleInfo", "MAX_BUNDLE_BINS", "CONFLICT_RATE", "find_bundles",
           "build_bundle_info", "bundle_binned_matrix", "bundle_sparse_csc",
           "EfbArrays", "efb_arrays", "make_expand_hist",
           "make_bundle_decode", "sum_bins_xla"]

MAX_BUNDLE_BINS = 256    # uint8 device columns
CONFLICT_RATE = 1e-4     # max conflicting rows per bundle, as fraction of N


@dataclasses.dataclass
class BundleInfo:
    """Static bundling descriptors over INNER (used) features."""
    n_bundles: int
    bundle_bins: int                 # Bb: max bins over bundles
    f_bundle: np.ndarray             # (F,) bundle id per feature
    f_offset: np.ndarray             # (F,) non-default bin offset in bundle
    f_default: np.ndarray            # (F,) the feature's default bin
    f_nbins: np.ndarray              # (F,) the feature's bin count
    f_single: np.ndarray             # (F,) bool: singleton bundle (verbatim)
    exp_map: np.ndarray              # (F, B) flat bundle-bin id or -1
    fix_mask: np.ndarray             # (F,) bool: restore default via totals

    @property
    def needs_fix(self) -> bool:
        return bool(self.fix_mask.any())


def find_bundles(mappers: Sequence, nondefault: List[np.ndarray], n_rows: int,
                 sample_rows: int,
                 max_bundle_bins: int = MAX_BUNDLE_BINS,
                 conflict_rate: float = CONFLICT_RATE) -> List[List[int]]:
    """Greedy conflict-bounded grouping (dataset.cpp:100 FindGroups).

    nondefault[f] is a bool mask over the SAMPLED rows where feature f is
    away from its default bin.  Returns bundles as lists of feature ids.
    """
    max_conflict = max(0, int(conflict_rate * sample_rows))
    counts = np.array([int(m.sum()) for m in nondefault])
    order = np.argsort(-counts, kind="stable")

    bundles: List[List[int]] = []
    bundle_mask: List[np.ndarray] = []
    bundle_conflict: List[int] = []
    bundle_bins: List[int] = []
    for f in order:
        nb_extra = int(mappers[f].num_bin) - 1
        placed = False
        for bi in range(len(bundles)):
            if bundle_bins[bi] + nb_extra >= max_bundle_bins:
                continue
            conflict = int(np.count_nonzero(bundle_mask[bi] & nondefault[f]))
            if bundle_conflict[bi] + conflict <= max_conflict:
                bundles[bi].append(int(f))
                bundle_mask[bi] |= nondefault[f]
                bundle_conflict[bi] += conflict
                bundle_bins[bi] += nb_extra
                placed = True
                break
        if not placed:
            bundles.append([int(f)])
            bundle_mask.append(nondefault[f].copy())
            bundle_conflict.append(0)
            bundle_bins.append(1 + nb_extra)
    return bundles


def build_bundle_info(mappers: Sequence, bundles: List[List[int]],
                      max_feature_bins: int) -> BundleInfo:
    F = len(mappers)
    B = max_feature_bins
    f_bundle = np.zeros(F, np.int32)
    f_offset = np.zeros(F, np.int32)
    f_default = np.asarray([int(m.default_bin) for m in mappers], np.int32)
    f_nbins = np.asarray([int(m.num_bin) for m in mappers], np.int32)
    f_single = np.zeros(F, bool)
    bb = 1
    for g, feats in enumerate(bundles):
        if len(feats) == 1:
            f = feats[0]
            f_bundle[f] = g
            f_offset[f] = 0
            f_single[f] = True
            bb = max(bb, int(f_nbins[f]))
        else:
            off = 1
            for f in feats:
                f_bundle[f] = g
                f_offset[f] = off
                off += int(f_nbins[f]) - 1
            bb = max(bb, off)

    G = len(bundles)
    exp_map = np.full((F, B), -1, np.int64)
    fix_mask = np.zeros(F, bool)
    for f in range(F):
        g = int(f_bundle[f])
        nb = int(f_nbins[f])
        if f_single[f]:
            exp_map[f, :nb] = g * bb + np.arange(nb)
        else:
            fix_mask[f] = True
            d = int(f_default[f])
            o = int(f_offset[f])
            for b in range(nb):
                if b == d:
                    continue  # restored from leaf totals (FixHistogram)
                exp_map[f, b] = g * bb + o + b - (1 if b > d else 0)
    return BundleInfo(n_bundles=G, bundle_bins=bb, f_bundle=f_bundle,
                      f_offset=f_offset, f_default=f_default,
                      f_nbins=f_nbins, f_single=f_single,
                      exp_map=exp_map.astype(np.int32), fix_mask=fix_mask)


def bundle_binned_matrix(X_binned: np.ndarray, info: BundleInfo) -> np.ndarray:
    """Compress a per-feature binned matrix (N, F) into bundle columns
    (N, G) (dense-input path)."""
    n = X_binned.shape[0]
    out = np.zeros((n, info.n_bundles), np.uint8)
    for f in range(X_binned.shape[1]):
        g = int(info.f_bundle[f])
        col = X_binned[:, f].astype(np.int32)
        if info.f_single[f]:
            out[:, g] = col.astype(np.uint8)
        else:
            d = int(info.f_default[f])
            o = int(info.f_offset[f])
            nd = col != d
            vals = o + col[nd] - (col[nd] > d)
            out[nd, g] = vals.astype(np.uint8)
    return out


def bundle_sparse_csc(csc, mappers: Sequence, info: BundleInfo) -> np.ndarray:
    """Build the bundled matrix straight from a scipy CSC matrix — the raw
    data is never densified."""
    n = csc.shape[0]
    out = np.zeros((n, info.n_bundles), np.uint8)
    for f in range(len(mappers)):
        g = int(info.f_bundle[f])
        lo, hi = csc.indptr[f], csc.indptr[f + 1]
        rows = csc.indices[lo:hi]
        vals = np.asarray(csc.data[lo:hi], np.float64)
        bins = mappers[f].value_to_bin(vals).astype(np.int32)
        d = int(mappers[f].default_bin)
        if info.f_single[f]:
            if d:
                out[:, g] = np.uint8(d)  # implied zeros sit in bin(0.0)
            out[rows, g] = bins.astype(np.uint8)
        else:
            o = int(info.f_offset[f])
            nd = bins != d
            out[rows[nd], g] = (o + bins[nd] - (bins[nd] > d)).astype(np.uint8)
    return out


# ---------------------------------------------------------------------------
# Device-side helpers shared by the growers (learner/partitioned.py and
# learner/wave.py).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EfbArrays:
    """A :class:`BundleInfo`'s descriptors as tensors on the training
    device (the reference's ``efb_arrays`` tuple), plus the widest
    bundled feature ``fix_bins`` (the bins a default-bin fix sums)."""
    exp_map: torch.Tensor    # (F, B) int64 flat bundle-bin id or -1
    f_bundle: torch.Tensor   # (F,) int32
    f_offset: torch.Tensor   # (F,) int32
    f_default: torch.Tensor  # (F,) int64
    f_nbins: torch.Tensor    # (F,) int32
    f_single: torch.Tensor   # (F,) bool
    n_bundles: int
    bundle_bins: int
    fix_bins: int


def efb_arrays(info: BundleInfo, device) -> EfbArrays:
    dev = torch.device(device)
    fix = info.f_nbins[~info.f_single]
    return EfbArrays(
        exp_map=torch.as_tensor(info.exp_map, dtype=torch.int64, device=dev),
        f_bundle=torch.as_tensor(info.f_bundle, dtype=torch.int32,
                                 device=dev),
        f_offset=torch.as_tensor(info.f_offset, dtype=torch.int32,
                                 device=dev),
        f_default=torch.as_tensor(info.f_default, dtype=torch.int64,
                                  device=dev),
        f_nbins=torch.as_tensor(info.f_nbins, dtype=torch.int32, device=dev),
        f_single=torch.as_tensor(info.f_single, dtype=torch.bool,
                                 device=dev),
        n_bundles=int(info.n_bundles), bundle_bins=int(info.bundle_bins),
        fix_bins=int(fix.max()) if fix.size else 0)


_XLA_REDUCE_BLOCK = 32


def sum_bins_xla(x: torch.Tensor, length: int = None) -> torch.Tensor:
    """f32 sum over axis -2 of (..., B, 3) in XLA:CPU's order.

    XLA:CPU rewrites a reduction over more than 32 elements into a
    reduce-window of 32 (``TreeReductionRewriter``): the axis is padded
    with zeros to a multiple of 32, half the padding in front, each window
    is summed sequentially, then the window totals in order.  The
    reference's ``jnp.sum`` in its histogram expansion rounds in that
    order, so the port's default-bin fixes equal its bits.  ``length``:
    the axis length the reference reduces when ``x`` holds only its head
    (the rest zeros, which leave every partial sum unchanged)."""
    b = x.shape[-2]
    n = b if length is None else length
    block = _XLA_REDUCE_BLOCK if n > _XLA_REDUCE_BLOCK else max(n, 1)
    front = (-(-n // block) * block - n) // 2
    acc = None
    for lo in range(-front, b, block):
        part = None
        for i in range(max(lo, 0), min(lo + block, b)):
            part = x[..., i, :] if part is None else part + x[..., i, :]
        if part is not None:
            acc = part if acc is None else acc + part
    if acc is None:
        return x.new_zeros(x.shape[:-2] + x.shape[-1:])
    return acc


def make_expand_hist(efb: EfbArrays, num_features: int):
    """Closure mapping bundle-space (..., G, Bb, 3) histograms to
    per-feature (..., F, B, 3) space, each bundled feature's default bin
    restored as ``total - sum`` of its other bins (Dataset::FixHistogram,
    reference src/io/dataset.cpp:1239).  Identity when ``efb`` is None.

    f32 histograms (the scan's form) fix in f32 with the reference's
    summation order (:func:`sum_bins_xla`), so quantized training, which
    expands its dequantized sums as the reference does
    (learner/wave.py:593-599 of the reference), keeps its bits; integer
    histograms (the partitioned grower's fixed-point sums) fix exactly,
    with ``total`` in the same integers."""
    if efb is None:
        return lambda hb, total: hb
    F = num_features
    fix_rows = torch.nonzero(~efb.f_single).squeeze(1)
    fb = efb.fix_bins

    def expand(hb: torch.Tensor, total: torch.Tensor) -> torch.Tensor:
        lead = hb.shape[:-3]
        flat = hb.reshape(*lead, -1, 3)
        idx = efb.exp_map.clamp(min=0).reshape(-1)
        e = flat.index_select(-2, idx).reshape(*lead, F, -1, 3)
        e = torch.where((efb.exp_map >= 0).unsqueeze(-1), e,
                        torch.zeros((), dtype=e.dtype, device=e.device))
        if fix_rows.numel() == 0:
            return e
        # the bins past a bundled feature's count are zeros, which leave
        # an f32 sum unchanged: only the widest bundled feature's bins
        ef = e.index_select(-3, fix_rows)[..., :fb, :]
        s = (sum_bins_xla(ef, e.shape[-2]) if e.dtype == torch.float32
             else ef.sum(dim=-2))
        fix = total.unsqueeze(-2).to(e.dtype) - s       # (..., nfix, 3)
        d = efb.f_default.index_select(0, fix_rows)
        e[..., fix_rows, d, :] = e[..., fix_rows, d, :] + fix
        return e

    return expand


def make_bundle_decode(efb: EfbArrays):
    """Closure mapping BUNDLE-space bin codes ``v`` (int32, of feature
    ``feat``'s bundle column) to FEATURE-space bin codes, the inverse of
    the offset encoding of :func:`bundle_binned_matrix`.  ``feat``
    broadcasts against ``v``.  Identity when ``efb`` is None."""
    if efb is None:
        return lambda v, feat: v

    def decode(v: torch.Tensor, feat: torch.Tensor) -> torch.Tensor:
        feat = feat.long()
        off = efb.f_offset[feat]
        dft = efb.f_default[feat].to(torch.int32)
        u = v - off
        inr = (u >= 0) & (u < efb.f_nbins[feat] - 1)
        mapped = torch.where(inr, u + (u >= dft).to(torch.int32), dft)
        return torch.where(efb.f_single[feat], v, mapped)

    return decode
