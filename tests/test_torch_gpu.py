"""Dispatch of the port's kernel wrappers by tensor device.

A CPU tensor takes the plain PyTorch version and never loads the CUDA
library; a CUDA tensor launches the hand-written kernel and never calls
the plain version.  The tests marked ``gpu`` need the card and skip
elsewhere; this file imports neither ``jax`` nor ``lightgbm_tpu``, so it
runs on the card as it is:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""

import os
import re
import subprocess

import numpy as np
import pytest
import torch

import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import cuda_lib
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import quantize as tq

F = 6
PLAINS = ("build_histogram_leaves_q8_plain", "build_histogram_leaves_plain",
          "wave_row_update_plain")
WAVE_KERNELS = ("hist_leaves_q8", "hist_leaves", "wave_row_update",
                "wave_trial_channels")


@pytest.fixture
def cuda_device():
    """The card; decided at run time so every worker collects the same
    tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _inputs(n, num_bins, device, seed=0, w=25, n_active=25):
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    bins = t(rng.randint(0, num_bins, (F, n)).astype(np.uint8))
    grad = t((rng.randn(n) * 0.5).astype(np.float32))
    hess = t((rng.rand(n) * 0.25 + 0.01).astype(np.float32))
    mask = t((rng.rand(n) < 0.8).astype(np.float32))
    ch = t(rng.randint(-1, hc.LEAF_CHANNELS, n).astype(np.int8))
    cols = t(rng.randint(0, num_bins, (w, n)).astype(np.uint8))
    rl = t(rng.randint(0, 60, n).astype(np.int32))
    act = (np.arange(w) < n_active).astype(np.int32)
    tab = t(np.stack([
        rng.randint(0, num_bins, w), np.where(rng.rand(w) < 0.5,
                                              num_bins - 1, -1),
        rng.randint(0, 2, w), rng.randint(0, 2, w),
        rng.choice(60, w, replace=False), 60 + np.arange(w), act,
        np.zeros(w, int)]).astype(np.int32))
    return bins, grad, hess, mask, ch, cols, rl, tab


def _run_all(bins, grad, hess, mask, ch, cols, rl, tab, num_bins):
    wch = tq.quantize_wch(grad, hess, mask, torch.tensor(0.01).to(bins.device),
                          torch.tensor(0.002).to(bins.device), gq_max=127,
                          hq_max=127)
    h8 = hc.build_histogram_leaves_q8(bins, wch, ch, num_bins=num_bins)
    w = th.pack_weights(grad, hess, mask)
    hx = hc.build_histogram_leaves(bins, w, ch, num_bins=num_bins)
    ru = hc.wave_row_update(cols, rl, tab)
    tr = hc.wave_trial_channels(cols, rl, tab[4], tab[0], tab[1], tab[2] > 0,
                                tab[3] > 0, tab[6] > 0)
    return wch, w, h8, hx, ru, tr


def test_cpu_tensors_never_load_the_kernel_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CUDA library {name} loaded for CPU tensors")
    monkeypatch.setattr(cuda_lib, "library", refuse)
    before = dict(hc.LAUNCHES)
    _, _, h8, hx, (rl2, ch2), tr = _run_all(*_inputs(4096, 17, "cpu"),
                                            num_bins=17)
    assert h8.dtype == torch.int32 and hx.dtype == torch.float32
    assert rl2.dtype == torch.int32 and ch2.dtype == tr.dtype == torch.int8
    assert hc.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("n,num_bins,n_active", [(65536, 256, 25),
                                                 (100_003, 17, 10)])
def test_kernels_match_plain_on_card(cuda_device, monkeypatch, n, num_bins,
                                     n_active):
    args = _inputs(n, num_bins, cuda_device, w=25, n_active=n_active)
    bins, grad, hess, mask, ch, cols, rl, tab = args
    for name in PLAINS:   # the wrappers must launch, never fall back
        monkeypatch.setattr(hc, name, None)
    before = dict(hc.LAUNCHES)
    wch, w, h8, hx, (rl_k, ch_k), tr = _run_all(*args, num_bins=num_bins)
    hx2 = hc.build_histogram_leaves(bins, w, ch, num_bins=num_bins)
    torch.cuda.synchronize()
    assert all(hc.LAUNCHES[k] > before[k] for k in WAVE_KERNELS)
    monkeypatch.undo()
    assert torch.equal(h8, hc.build_histogram_leaves_q8_plain(
        bins, wch, ch, num_bins=num_bins))
    assert torch.equal(hx, hx2)
    assert torch.equal(hx, hc.build_histogram_leaves_plain(
        bins, w, ch, num_bins=num_bins))
    rl_p, ch_p = hc.wave_row_update_plain(cols, rl, tab)
    assert torch.equal(rl_k, rl_p) and torch.equal(ch_k, ch_p)
    assert torch.equal(tr, hc.wave_trial_channels_plain(
        cols, rl, tab[4], tab[0], tab[1], tab[2] > 0, tab[3] > 0,
        tab[6] > 0))


def _single_case(device, f, n, num_bins, layout, seed=1):
    """bins view, fixed-point weights: feature-major, or a row-major
    segment ``P[s:e, :F].T`` read through its two strides."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    grad = t((rng.randn(n) * 0.5).astype(np.float32))
    hess = t((rng.rand(n) * 0.25 + 0.01).astype(np.float32))
    mask = t((rng.rand(n) < 0.8).astype(np.float32))
    w = th.pack_weights(grad, hess, mask)
    if layout == "segment":
        P = t(rng.randint(0, num_bins, (2 * n, f + 5)).astype(np.uint8))
        bins = P[n // 2:n // 2 + n, :f].t()
    else:
        bins = t(rng.randint(0, num_bins, (f, n)).astype(np.uint8))
    return bins, w


def test_single_leaf_histogram_on_cpu_never_loads_the_kernel_library(
        monkeypatch):
    def refuse(name):
        raise AssertionError(f"CUDA library {name} loaded for CPU tensors")
    monkeypatch.setattr(cuda_lib, "library", refuse)
    before = dict(hc.LAUNCHES)
    bins, w = _single_case("cpu", F, 5000, 17, "segment")
    h = hc.hist_single(bins, w, num_bins=17)
    assert h.dtype == torch.int64 and h.shape == (F, 17, 3)
    assert hc.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("f,n,num_bins,layout", [
    (28, 65536, 256, "feature_major"), (28, 40_000, 256, "segment"),
    (6, 100_003, 17, "feature_major"), (1, 65536, 256, "feature_major")])
def test_hist_single_matches_plain_on_card(cuda_device, monkeypatch, f, n,
                                           num_bins, layout):
    bins, w = _single_case(cuda_device, f, n, num_bins, layout)
    monkeypatch.setattr(hc, "hist_single_plain", None)  # must launch
    before = hc.LAUNCHES["hist_single"]
    got = hc.hist_single(bins, w, num_bins=num_bins)
    again = hc.hist_single(bins, w, num_bins=num_bins)
    torch.cuda.synchronize()
    assert hc.LAUNCHES["hist_single"] == before + 2
    monkeypatch.undo()
    assert torch.equal(got, again)
    assert torch.equal(got, hc.hist_single_plain(bins, w, num_bins=num_bins))


@pytest.mark.gpu
def test_partition_training_on_card_matches_cpu(cuda_device):
    """The partitioned grower on the card grows the CPU's model: integer
    histograms and the port's own f32 exp round the same on both."""
    rng = np.random.RandomState(2)
    X = rng.randn(6000, F)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.8).astype(float)
    params = dict(objective="binary", num_leaves=15, verbosity=-1,
                  tree_grow_mode="partition")
    on_cpu = lt.train(params, lt.Dataset(X, y), 5, device="cpu")
    on_card = lt.train(params, lt.Dataset(X, y), 5, device=cuda_device)
    assert on_card.model_to_string() == on_cpu.model_to_string()


@pytest.mark.gpu
def test_training_on_card_matches_cpu(cuda_device):
    """Quantized L2 training on the card grows the model the CPU path grows
    (integer histograms: the same bits whatever the summation order)."""
    rng = np.random.RandomState(0)
    X = rng.randn(6000, F)
    y = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(6000)
    params = dict(objective="regression", num_leaves=15, verbosity=-1,
                  use_quantized_grad=True, stochastic_rounding=False)
    on_cpu = lt.train(params, lt.Dataset(X, y), 5, device="cpu")
    on_card = lt.train(params, lt.Dataset(X, y), 5, device=cuda_device)
    assert on_card.model_to_string() == on_cpu.model_to_string()


def _leaf_stress(case, device):
    """(bins, wch, w, ch, num_bins) of one stress case:
    ``one_bin``: every row in channel 0 and bin 3 of every feature, q8
    weights at g=-127, h=127 (the most contention, and the largest sums
    of the q8 kernel's packed (g, h));
    ``sparse``: 5% of the rows in a channel (a late wave);
    ``ragged``: B=256 with N not a multiple of the 16-row step."""
    n = {"one_bin": 3 * 65536, "sparse": 65536, "ragged": 100_007}[case]
    rng = np.random.RandomState(7)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    grad = (rng.randn(n) * 0.5).astype(np.float32)
    hess = (rng.rand(n) * 0.25 + 0.01).astype(np.float32)
    mask = (rng.rand(n) < 0.8).astype(np.float32)
    if case == "one_bin":
        bins = np.full((F, n), 3, np.uint8)
        ch = np.zeros(n, np.int8)
        wch = np.zeros((8, n), np.int8)
        wch[0], wch[1], wch[2] = -127, 127, 1
    else:
        bins = rng.randint(0, 256, (F, n)).astype(np.uint8)
        ch = rng.randint(0, hc.Q_LEAF_CHANNELS, n).astype(np.int8)
        if case == "sparse":
            ch[rng.rand(n) >= 0.05] = -1
        wch = rng.randint(-127, 128, (8, n)).astype(np.int8)
        wch[1] = np.abs(wch[1])
        wch[2] = rng.rand(n) < 0.8
    w = th.pack_weights(t(grad), t(hess), t(mask))
    return t(bins), t(wch), w, t(ch), 256


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["one_bin", "sparse", "ragged"])
def test_leaf_kernels_stress_match_plain_on_card(cuda_device, monkeypatch,
                                                 case):
    """Both leaf kernels (and, at 4096-row multiples, both packed forms on
    the low 16 bins) bit for bit their plain versions and identical
    across two launches."""
    bins, wch, w, ch, nb = _leaf_stress(case, cuda_device)
    n = bins.shape[1]
    runs = [(hc.build_histogram_leaves_q8, wch, ch, bins, nb, False),
            (hc.build_histogram_leaves, w,
             torch.where(ch < hc.LEAF_CHANNELS, ch, -1).to(torch.int8),
             bins, nb, False)]
    if n % 4096 == 0:
        b16 = th.pack_bins4(bins & 15)
        runs += [(fn, wts, c, b16, 16, True) for fn, wts, c, *_ in runs]
    for fn, wts, c, b, num_bins, packed in runs:
        plain = (hc.build_histogram_leaves_q8_plain
                 if fn is hc.build_histogram_leaves_q8
                 else hc.build_histogram_leaves_plain)
        name = plain.__name__
        monkeypatch.setattr(hc, name, None)      # must launch
        got = fn(b, wts, c, num_bins=num_bins, bins_packed=packed)
        again = fn(b, wts, c, num_bins=num_bins, bins_packed=packed)
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert torch.equal(got, again)
        assert torch.equal(got, plain(b, wts, c, num_bins=num_bins,
                                      bins_packed=packed))


# -- nibble-packed bins (max_bin <= 16) --------------------------------------

PACKED = ("hist_single_packed4", "hist_leaves_q8_packed4",
          "hist_leaves_packed4")
UINT8 = ("hist_single", "hist_leaves_q8", "hist_leaves")


def _run_packed(bins_p, grad, hess, mask, ch, num_bins):
    """The three packed forms on (F, N/2) packed bins: q8 leaves, exact
    leaves, single leaf."""
    wch = tq.quantize_wch(grad, hess, mask,
                          torch.tensor(0.01).to(bins_p.device),
                          torch.tensor(0.002).to(bins_p.device), gq_max=127,
                          hq_max=127)
    w = th.pack_weights(grad, hess, mask)
    h8 = hc.build_histogram_leaves_q8(bins_p, wch, ch, num_bins=num_bins,
                                      bins_packed=True)
    hx = hc.build_histogram_leaves(bins_p, w, ch, num_bins=num_bins,
                                   bins_packed=True)
    hs = hc.hist_single(bins_p, w, num_bins=num_bins, bins_packed=True)
    return wch, w, h8, hx, hs


def test_packed_forms_on_cpu_never_load_the_kernel_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CUDA library {name} loaded for CPU tensors")
    monkeypatch.setattr(cuda_lib, "library", refuse)
    before = dict(hc.LAUNCHES)
    bins, grad, hess, mask, ch, *_ = _inputs(8192, 16, "cpu")
    bins_p = th.pack_bins4(bins)
    wch, w, h8, hx, hs = _run_packed(bins_p, grad, hess, mask, ch, 16)
    assert hc.LAUNCHES == before
    assert torch.equal(h8, hc.build_histogram_leaves_q8(bins, wch, ch,
                                                        num_bins=16))
    assert torch.equal(hx, hc.build_histogram_leaves(bins, w, ch,
                                                     num_bins=16))
    assert torch.equal(hs, hc.hist_single(bins, w, num_bins=16))


@pytest.mark.gpu
@pytest.mark.parametrize("n,num_bins", [(65536, 16), (3 * 4096, 5)])
def test_packed_kernels_match_plain_on_card(cuda_device, monkeypatch, n,
                                            num_bins):
    bins, grad, hess, mask, ch, *_ = _inputs(n, num_bins, cuda_device)
    bins_p = th.pack_bins4(bins)
    for name in ("build_histogram_leaves_q8_plain",
                 "build_histogram_leaves_plain", "hist_single_plain"):
        monkeypatch.setattr(hc, name, None)   # must launch, never fall back
    before = dict(hc.LAUNCHES)
    wch, w, h8, hx, hs = _run_packed(bins_p, grad, hess, mask, ch, num_bins)
    again = _run_packed(bins_p, grad, hess, mask, ch, num_bins)[2:]
    torch.cuda.synchronize()
    assert all(hc.LAUNCHES[k] == before[k] + 2 for k in PACKED)
    assert all(hc.LAUNCHES[k] == before[k] for k in UINT8)
    monkeypatch.undo()
    for got, other in zip((h8, hx, hs), again):
        assert torch.equal(got, other)
    assert torch.equal(h8, hc.build_histogram_leaves_q8_plain(
        bins_p, wch, ch, num_bins=num_bins, bins_packed=True))
    assert torch.equal(hx, hc.build_histogram_leaves_plain(
        bins_p, w, ch, num_bins=num_bins, bins_packed=True))
    assert torch.equal(hs, hc.hist_single_plain(bins_p, w, num_bins=num_bins,
                                                bins_packed=True))


@pytest.mark.gpu
def test_pack4_training_on_card_matches_cpu(cuda_device):
    """max_bin=15 packs the bins; the quantized L2 model trained on the
    card through the packed leaf kernel equals the CPU's."""
    rng = np.random.RandomState(5)
    X = rng.randn(6000, F)
    y = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(6000)
    params = dict(objective="regression", num_leaves=15, verbosity=-1,
                  max_bin=15, use_quantized_grad=True,
                  stochastic_rounding=False, tpu_histogram_impl="pallas")
    on_cpu = lt.train(params, lt.Dataset(X, y), 5, device="cpu")
    hc.reset_launches()
    on_card = lt.train(params, lt.Dataset(X, y), 5, device=cuda_device)
    assert on_card._gbdt.learner.pack4
    assert hc.LAUNCHES["hist_leaves_q8_packed4"] > 0
    assert hc.LAUNCHES["hist_leaves_q8"] == 0
    assert on_card.model_to_string() == on_cpu.model_to_string()


# -- the redesigned single-leaf histogram and the in-place row update --------

def _rows_view(device, f, n, num_bins, seed, width=None, start=3,
               weights="random"):
    """A row-major segment ``P[start:start + n, :f].T`` (rows of ``width``
    bytes, an odd start) and its fixed-point weights: random, all zero,
    or every row in bin 0 of every feature with equal weights (skew)."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    width = width or f
    P = rng.randint(0, num_bins, (n + start + 5, width)).astype(np.uint8)
    grad = (rng.randn(n) * 0.5).astype(np.float32)
    hess = (rng.rand(n) * 0.25 + 0.01).astype(np.float32)
    mask = (rng.rand(n) < 0.8).astype(np.float32)
    if weights == "zero":
        mask[:] = 0.0
    elif weights == "skew":
        P[:] = 0
        grad[:], hess[:], mask[:] = -0.75, 0.25, 1.0
    w = th.pack_weights(t(grad), t(hess), t(mask))
    return t(P)[start:start + n, :f].t(), w


def _single_on_card(monkeypatch, bins, w, num_bins):
    monkeypatch.setattr(hc, "hist_single_plain", None)   # must launch
    before = hc.LAUNCHES["hist_single"]
    got = hc.hist_single(bins, w, num_bins=num_bins)
    again = hc.hist_single(bins, w, num_bins=num_bins)
    torch.cuda.synchronize()
    assert hc.LAUNCHES["hist_single"] == before + 2
    monkeypatch.undo()
    assert torch.equal(got, again)
    assert torch.equal(got, hc.hist_single_plain(bins, w, num_bins=num_bins))


@pytest.mark.gpu
@pytest.mark.parametrize("f", [1, 6, 7, 28, 29])
@pytest.mark.parametrize("n", [1, 4095, 4097, 100_003])
@pytest.mark.parametrize("num_bins", [2, 17, 256])
def test_hist_single_row_major_odd_starts_on_card(cuda_device, monkeypatch,
                                                  f, n, num_bins):
    bins, w = _rows_view(cuda_device, f, n, num_bins, seed=f + n)
    _single_on_card(monkeypatch, bins, w, num_bins)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["zero", "skew", "width 29", "features"])
def test_hist_single_edge_cases_on_card(cuda_device, monkeypatch, case):
    """All-zero weights; every row in one bin (the most contention);
    rows of an odd width (no word loads); a feature-major matrix at an
    odd column offset (no aligned 32-bit loads)."""
    if case == "features":
        rng = np.random.RandomState(4)
        full = torch.from_numpy(rng.randint(0, 256, (28, 100_010)).astype(
            np.uint8)).to(cuda_device)
        bins = full[:, 3:100_006]
        _, w = _rows_view(cuda_device, 28, 100_003, 256, seed=4)
    else:
        bins, w = _rows_view(cuda_device, 28, 100_003, 256, seed=5,
                             width=29 if case == "width 29" else None,
                             weights=case if case != "width 29"
                             else "random")
    _single_on_card(monkeypatch, bins, w, 256)


@pytest.mark.gpu
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", [65536, 100_002])
def test_row_update_in_place_on_card(cuda_device, monkeypatch, packed, n):
    """The row update and trial channels reading the (F, N) matrix in
    place (uint8, and packed at B=16), with a chained split and inactive
    splits whose feature is out of range: bit for bit the plain version
    and identical across two launches."""
    nb = 16 if packed else 256
    bins, *_, rl, tab = _inputs(n, nb, cuda_device, w=25, n_active=20)
    bins = bins if not packed else th.pack_bins4(bins)
    rng = np.random.RandomState(9)
    feats = torch.from_numpy(np.concatenate([
        rng.randint(0, F, 20), F + 1 + np.arange(5)]).astype(np.int32)).to(
            cuda_device)
    tab[4, 1] = tab[5, 0]
    targs = (tab[4], tab[0], tab[1], tab[2] > 0, tab[3] > 0, tab[6] > 0)
    kw = dict(feats=feats, bins_packed=packed)
    for name in ("wave_row_update_plain", "wave_trial_channels_plain"):
        monkeypatch.setattr(hc, name, None)   # must launch
    before = dict(hc.LAUNCHES)
    ru = [hc.wave_row_update(bins, rl, tab, **kw) for _ in range(2)]
    tr = [hc.wave_trial_channels(bins, rl, *targs, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert hc.LAUNCHES["wave_row_update"] == before["wave_row_update"] + 2
    assert hc.LAUNCHES["wave_trial_channels"] == \
        before["wave_trial_channels"] + 2
    monkeypatch.undo()
    want = hc.wave_row_update_plain(bins, rl, tab, **kw)
    for got in ru:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want_tr = hc.wave_trial_channels_plain(bins, rl, *targs, **kw)
    assert all(torch.equal(t_, want_tr) for t_ in tr)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 4097, 10_502_144])
def test_threefry_on_card_matches_cpu(cuda_device, n):
    """The threefry stream is integer arithmetic: the card draws the CPU's
    bits, for one tree's rows and for a wave's (W, F) node draws."""
    from lightgbm_tpu_torch.utils.random import fold_in, prng_key, uniform
    on_cpu = uniform(fold_in(prng_key(42), 3), (n,))
    on_card = uniform(fold_in(prng_key(42, cuda_device), 3), (n,))
    assert torch.equal(on_card.cpu(), on_cpu)
    ids = torch.arange(50) * 2 + 1
    node_cpu = uniform(fold_in(prng_key(7), ids), (28,))
    node_card = uniform(fold_in(prng_key(7, cuda_device),
                                ids.to(cuda_device)), (28,))
    assert torch.equal(node_card.cpu(), node_cpu)


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [
    dict(objective="binary"),
    dict(objective="regression", num_grad_quant_bins=254),
    dict(objective="multiclass", num_class=3),
    dict(objective="binary", feature_fraction_bynode=0.5, extra_trees=True),
])
def test_stochastic_quantized_training_on_card_matches_cpu(cuda_device,
                                                           extra):
    """Quantized training with stochastic rounding (the default) on the
    card writes the CPU's model text: the stream and the integer
    histograms are the same bits on both."""
    rng = np.random.RandomState(0)
    X = rng.randn(6000, F)
    z = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(6000)
    y = {"binary": (z > 0.5).astype(float),
         "multiclass": np.digitize(z, [-1.0, 1.0]).astype(float)}.get(
             extra["objective"], z)
    params = dict(num_leaves=15, verbosity=-1, use_quantized_grad=True,
                  **extra)
    on_cpu = lt.train(params, lt.Dataset(X, y), 3, device="cpu")
    on_card = lt.train(params, lt.Dataset(X, y), 3, device=cuda_device)
    assert on_card.model_to_string() == on_cpu.model_to_string()


def _ext_case(n, device, seed=3, w=25):
    """A (12, n) bundle-space bin matrix and a wave of numeric,
    categorical and bundled splits (the last two inactive, their column
    out of range), each split on a leaf of its own."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    nbins = np.array([255] * 4 + [3, 40, 255] + [31] * 5)
    bins = (rng.rand(12, n) * nbins[:, None]).astype(np.uint8)
    kind = np.arange(w) % 3                     # numeric, categorical, bundled
    cols = np.where(kind == 0, np.arange(w) % 4,
                    np.where(kind == 1, 4 + np.arange(w) % 3,
                             7 + np.arange(w) % 5))
    cols[w - 2:] = 12 + np.arange(2)
    member = np.zeros((w, 256), bool)
    for j in np.nonzero(kind == 1)[0]:
        member[j, :nbins[cols[j]]] = rng.rand(nbins[cols[j]]) < 0.4
    single = (kind != 2).astype(np.int32)
    off = np.where(kind == 2, 1 + 3 * (np.arange(w) % 10), 0)
    nb = np.where(kind == 2, 4, nbins[np.minimum(cols, 11)])
    dec = hc.split_decode(t(kind == 1), t(member), t(off), t(nb),
                          t(np.zeros(w, np.int32)), t(single))
    rl = t(rng.randint(0, 60, n).astype(np.int32))
    tab = t(np.stack([
        np.where(kind == 2, np.arange(w) % 3, rng.randint(0, 254, w)),
        np.where(kind == 0, 254, -1), rng.randint(0, 2, w),
        rng.randint(0, 2, w), rng.choice(60, w, replace=False),
        60 + np.arange(w), (np.arange(w) < w - 2).astype(int),
        np.zeros(w, int)]).astype(np.int32))
    return t(bins), rl, tab, t(cols.astype(np.int32)), dec


@pytest.mark.gpu
@pytest.mark.parametrize("n", [65536, 100_002, 10_502_144])
def test_row_update_ext_on_card(cuda_device, monkeypatch, n):
    """The row update's categorical / EFB form: bundled columns decoded and
    categorical splits decided by membership on the card, bit for bit the
    plain version and identical across two launches."""
    bins, rl, tab, cols, dec = _ext_case(n, cuda_device)
    monkeypatch.setattr(hc, "wave_row_update_plain", None)   # must launch
    before = hc.LAUNCHES["wave_row_update_ext"]
    got = [hc.wave_row_update(bins, rl, tab, feats=cols, decode=dec)
           for _ in range(2)]
    torch.cuda.synchronize()
    assert hc.LAUNCHES["wave_row_update_ext"] == before + 2
    monkeypatch.undo()
    want = hc.wave_row_update_plain(bins, rl, tab, feats=cols, decode=dec)
    for rl_k, ch_k in got:
        assert torch.equal(rl_k, want[0]) and torch.equal(ch_k, want[1])
    assert bool((want[1] >= 0).any()) and bool((want[0] != rl).any())


def _cat_efb_data(n=6000, seed=0):
    """Two numeric columns, categorical columns 2-4 (3, 40, 12 categories)
    and 8 exclusive indicator columns that EFB bundles."""
    rng = np.random.RandomState(seed)
    X = np.zeros((n, 13))
    X[:, :2] = rng.randn(n, 2)
    X[:, 2] = rng.randint(0, 3, n)
    X[:, 3] = np.minimum(rng.zipf(1.3, n) - 1, 39)
    X[:, 4] = rng.randint(0, 12, n)
    pick = rng.randint(0, 9, n)
    for j in range(8):
        m = pick == j + 1
        X[m, 5 + j] = rng.choice((1, 2), m.sum())
    z = (X[:, 0] + 0.8 * (X[:, 2] == 1) + rng.randn(40)[X[:, 3].astype(int)]
         + 0.6 * (X[:, 6] > 0) + 0.3 * rng.randn(n))
    return X, (z > 0.3).astype(float)


@pytest.mark.gpu
@pytest.mark.parametrize("extra,cats", [
    (dict(use_quantized_grad=True), [2, 3, 4]),
    (dict(use_quantized_grad=True, stochastic_rounding=False), "auto"),
    (dict(tree_grow_mode="partition"), [2, 3, 4]),
])
def test_categorical_and_efb_training_on_card_matches_cpu(cuda_device,
                                                          extra, cats):
    """Categorical features and EFB bundles on the card write the CPU's
    model text: quantized categorical with stochastic rounding, quantized
    EFB, and both on the partitioned grower."""
    X, y = _cat_efb_data()
    params = dict(objective="binary", num_leaves=15, verbosity=-1,
                  min_data_per_group=20, cat_smooth=5.0, **extra)
    on_cpu = lt.train(params, lt.Dataset(X, y, categorical_feature=cats), 3,
                      device="cpu")
    on_card = lt.train(params, lt.Dataset(X, y, categorical_feature=cats),
                       3, device=cuda_device)
    assert on_card._gbdt.train_set.efb is not None
    assert on_card.model_to_string() == on_cpu.model_to_string()


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [
    dict(use_quantized_grad=True, monotone_constraints=[1, -1, 0, 1, 0, 0],
         monotone_constraints_method="intermediate",
         interaction_constraints="[0,1,3],[2,4,5]"),
    dict(use_quantized_grad=True, path_smooth=2.0, cegb_penalty_split=0.01,
         cegb_penalty_feature_coupled=[2.0] * F,
         feature_contri=[1.0, 0.6, 1.0, 0.9, 1.0, 0.5], forced=True),
    dict(tree_grow_mode="partition", monotone_constraints=[1, -1, 0, 1, 0, 0],
         forced=True),
    dict(histogram_pool_size=0.1),      # no pool: the masked grower
], ids=["monotone_interaction", "penalties_forced", "partition",
        "masked"])
def test_split_options_on_card_match_cpu(cuda_device, tmp_path, extra):
    """The split and grower options on the card write the CPU's model
    text (chip_smoke.py phase 3's four configurations) at 6,001 rows, not
    a multiple of the 4096-row block: wave quantized with monotone
    intermediate and interaction constraints, wave quantized with
    smoothing, CEGB, feature_contri and forced splits (endgame on),
    partitioned exact with monotone basic and forced splits, and the
    masked grower."""
    import json
    rng = np.random.RandomState(0)
    X = rng.randn(6001, F)
    z = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + X[:, 3] + 0.1 * rng.randn(6001)
    params = dict(objective="binary", num_leaves=15, verbosity=-1, **extra)
    if params.pop("forced", False):
        path = tmp_path / "forced.json"
        path.write_text(json.dumps({
            "feature": 1, "threshold": 0.5,
            "left": {"feature": 0, "threshold": -0.3},
            "right": {"feature": 3, "threshold": 0.1}}))
        params["forcedsplits_filename"] = str(path)
    y = (z > 0.5).astype(float)
    on_cpu = lt.train(params, lt.Dataset(X, y), 3, device="cpu")
    on_card = lt.train(params, lt.Dataset(X, y), 3, device=cuda_device)
    assert on_card._gbdt.learner.grow_mode == on_cpu._gbdt.learner.grow_mode
    assert on_card.model_to_string() == on_cpu.model_to_string()


# -- the model-axis (lane) forms ---------------------------------------------

LANE_PLAINS = ("build_histogram_leaves_q8_lanes_plain",
               "build_histogram_leaves_lanes_plain", "hist_single_lanes_plain",
               "wave_row_update_lanes_plain", "wave_trial_channels_lanes_plain")


def _lane_inputs(lanes, n, num_bins, device, w=6):
    """L lanes' weights, channels, row->leaf vectors and split tables
    over one (F, n) bin matrix, and each lane's segment of its own
    row-major copy of it."""
    rng = np.random.RandomState(lanes)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    bins = t(rng.randint(0, num_bins, (F, n)).astype(np.uint8))
    grad = t((rng.randn(lanes, n) * 0.5).astype(np.float32))
    hess = t((rng.rand(lanes, n) * 0.25 + 0.01).astype(np.float32))
    mask = t((rng.rand(lanes, n) < 0.8).astype(np.float32))
    ch = t(rng.randint(-1, hc.Q_LEAF_CHANNELS, (lanes, n)).astype(np.int8))
    wch = torch.stack([tq.quantize_wch(
        grad[i], hess[i], mask[i], torch.tensor(0.01, device=device),
        torch.tensor(0.002, device=device), gq_max=127, hq_max=127)
        for i in range(lanes)])
    fx = [th.pack_weights(grad[i] * (i + 1), hess[i], mask[i])
          for i in range(lanes)]
    rl = t(rng.randint(0, 60, (lanes, n)).astype(np.int32))
    feats = t(rng.randint(0, F, (lanes, w)).astype(np.int32))
    tab = t(np.stack([np.stack([
        rng.randint(0, num_bins, w), np.where(rng.rand(w) < 0.5,
                                              num_bins - 1, -1),
        rng.randint(0, 2, w), rng.randint(0, 2, w),
        rng.choice(60, w, replace=False), 60 + np.arange(w),
        (rng.rand(w) < 0.8).astype(int), np.zeros(w, int)])
        for _ in range(lanes)]).astype(np.int32))
    rows = [bins.t().contiguous() for _ in range(lanes)]
    segs = [(i * 97 + 5, n - i * 1001) for i in range(lanes)]
    single = ([r[s:e].t() for r, (s, e) in zip(rows, segs)],
              [th.FxWeights(f.w[:, s:e], f.inv_scale)
               for f, (s, e) in zip(fx, segs)])
    return bins, wch, fx, ch, rl, feats, tab, single


def _run_lanes(bins, wch, fx, ch, rl, feats, tab, single, num_bins,
               packed=False):
    b = th.pack_bins4(bins) if packed else bins
    tabs = [hc.trial_tab(t[4], t[0], t[1], t[2] > 0, t[3] > 0, t[6] > 0)
            for t in tab]
    out = [hc.build_histogram_leaves_q8_lanes(b, wch, ch, num_bins=num_bins,
                                              bins_packed=packed),
           hc.build_histogram_leaves_lanes(
               b, fx, torch.where(ch < hc.LEAF_CHANNELS, ch, -1),
               num_bins=num_bins, bins_packed=packed),
           *hc.wave_row_update_lanes(b, rl, tab, feats=feats,
                                     bins_packed=packed),
           hc.wave_trial_channels_lanes(b, rl, tabs, feats=feats,
                                        bins_packed=packed)]
    if not packed:
        out.append(hc.hist_single_lanes(*single, num_bins=num_bins))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 3, 4])
@pytest.mark.parametrize("packed", [False, True])
def test_lane_kernels_match_plain_and_single_on_card(cuda_device,
                                                     monkeypatch, lanes,
                                                     packed):
    """Every model-axis kernel, one launch for all lanes, bitwise against
    its plain version and against L single launches; identical twice."""
    n, num_bins = 102_400, (16 if packed else 256)
    args = _lane_inputs(lanes, n, num_bins, cuda_device)
    if packed:
        args = (args[0] & 15,) + args[1:6] + (args[6].clone(),) + args[7:]
        args[6][:, 0] &= 15
        args[6][:, 1] = torch.where(args[6][:, 1] >= 0, 15, -1)
    for name in LANE_PLAINS:
        monkeypatch.setattr(hc, name, None)      # must launch
    before = dict(hc.LAUNCHES)
    got = _run_lanes(*args, num_bins, packed)
    again = _run_lanes(*args, num_bins, packed)
    torch.cuda.synchronize()
    monkeypatch.undo()
    suffix = "_packed4" if packed else ""
    for key in ("hist_leaves_q8_lanes" + suffix, "hist_leaves_lanes" + suffix,
                "wave_row_update_lanes", "wave_trial_channels_lanes") + \
            (() if packed else ("hist_single_lanes",)):
        assert hc.LAUNCHES[key] == before[key] + 2, key
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    bins, wch, fx, ch, rl, feats, tab, single = args
    b = th.pack_bins4(bins) if packed else bins
    chx = torch.where(ch < hc.LEAF_CHANNELS, ch, -1)
    assert torch.equal(got[0], hc.build_histogram_leaves_q8_lanes_plain(
        b, wch, ch, num_bins=num_bins, bins_packed=packed))
    assert torch.equal(got[1], hc.build_histogram_leaves_lanes_plain(
        b, fx, chx, num_bins=num_bins, bins_packed=packed))
    rl_p, ch_p = hc.wave_row_update_lanes_plain(b, rl, tab, feats=feats,
                                                bins_packed=packed)
    assert torch.equal(got[2], rl_p) and torch.equal(got[3], ch_p)
    if not packed:
        assert torch.equal(got[5], hc.hist_single_lanes_plain(
            *single, num_bins=num_bins))
    for i in range(lanes):
        assert torch.equal(got[0][i], hc.build_histogram_leaves_q8(
            b, wch[i], ch[i], num_bins=num_bins, bins_packed=packed))
        assert torch.equal(got[1][i], hc.build_histogram_leaves(
            b, fx[i], chx[i], num_bins=num_bins, bins_packed=packed))
        rl1, ch1 = hc.wave_row_update(b, rl[i], tab[i], feats=feats[i],
                                      bins_packed=packed)
        assert torch.equal(got[2][i], rl1) and torch.equal(got[3][i], ch1)
        t = tab[i]
        assert torch.equal(got[4][i], hc.wave_trial_channels(
            b, rl[i], t[4], t[0], t[1], t[2] > 0, t[3] > 0, t[6] > 0,
            feats=feats[i], bins_packed=packed))
        if not packed:
            assert torch.equal(got[5][i], hc.hist_single(
                single[0][i], single[1][i], num_bins=num_bins))


LEAF_MIXES = ("even", "empty lane", "heavy channel", "skewed bins")


def _leaf_lane_mix(lanes, mix, n, num_bins, device):
    """The leaf histograms' inputs for L lanes over one (F, n) matrix:
    ``even`` (every lane's rows spread over the 42 channels and -1),
    ``empty lane`` (lane L // 2 keeps no row), ``heavy channel`` (90% of
    lane 0's kept rows in channel 5), ``skewed bins`` (90% of each
    feature's codes on one bin)."""
    rng = np.random.RandomState(100 + lanes)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    codes = rng.randint(0, num_bins, (F, n))
    if mix == "skewed bins":
        hot = (np.arange(F) * 7919 % num_bins)[:, None]
        codes = np.where(rng.rand(F, n) < 0.9, hot, codes)
    ch = rng.randint(-1, hc.Q_LEAF_CHANNELS, (lanes, n))
    if mix == "empty lane":
        ch[lanes // 2] = -1
    elif mix == "heavy channel":
        ch[0] = np.where((ch[0] >= 0) & (rng.rand(n) < 0.9), 5, ch[0])
    grad = t((rng.randn(lanes, n) * 0.5).astype(np.float32))
    hess = t((rng.rand(lanes, n) * 0.25 + 0.01).astype(np.float32))
    mask = t((rng.rand(lanes, n) < 0.8).astype(np.float32))
    wch = [tq.quantize_wch(grad[i], hess[i], mask[i],
                           torch.tensor(0.01, device=device),
                           torch.tensor(0.002, device=device), gq_max=127,
                           hq_max=127) for i in range(lanes)]
    fx = [th.pack_weights(grad[i] * (i + 1), hess[i], mask[i])
          for i in range(lanes)]
    ch = t(ch.astype(np.int8))
    return (t(codes.astype(np.uint8)), wch, fx, list(ch.unbind(0)),
            [torch.where(c < hc.LEAF_CHANNELS, c, -1).to(torch.int8)
             for c in ch])


@pytest.mark.gpu
@pytest.mark.parametrize("mix", LEAF_MIXES)
@pytest.mark.parametrize("lanes", [1, 3, 4, 8])
@pytest.mark.parametrize("packed", [False, True])
def test_leaf_lanes_mixes_match_plain_and_single_on_card(
        cuda_device, monkeypatch, packed, lanes, mix):
    """``hist_leaves_q8_lanes`` and ``hist_leaves_fx_lanes`` (uint8 and
    packed) on even, empty-lane, heavy-channel and skewed-bin mixes: one
    launch for all lanes bitwise its plain version and each lane's single
    launch, identical twice (the blocks of lanes with no row in their
    channels skipped after the ``leaf_live_lanes`` pass; the exact form's
    f32 values through the one-pass ``fx_scale_lanes``, bitwise
    ``fx_to_f32``); each single form
    (``hist_leaves_{q8,fx}``, packed ``_p4``) bitwise its own plain
    version."""
    n, num_bins = 3 * 4096 * 25, (16 if packed else 256)
    bins, wch, fx, ch, chx = _leaf_lane_mix(lanes, mix, n, num_bins,
                                            cuda_device)
    b = th.pack_bins4(bins & 15) if packed else bins
    kw = dict(num_bins=num_bins, bins_packed=packed)
    sfx = "_packed4" if packed else ""
    forms = [(hc.build_histogram_leaves_q8_lanes,
              hc.build_histogram_leaves_q8, wch, ch,
              "build_histogram_leaves_q8", "hist_leaves_q8"),
             (hc.build_histogram_leaves_lanes, hc.build_histogram_leaves,
              fx, chx, "build_histogram_leaves", "hist_leaves")]
    for many, one, ws, chs, plain, key in forms:
        for name in (plain + "_plain", plain + "_lanes_plain"):
            monkeypatch.setattr(hc, name, None)      # must launch
        before = dict(hc.LAUNCHES)
        got, again = many(b, ws, chs, **kw), many(b, ws, chs, **kw)
        singles = [one(b, ws[i], chs[i], **kw) for i in range(lanes)]
        torch.cuda.synchronize()
        monkeypatch.undo()
        assert hc.LAUNCHES[key + "_lanes" + sfx] == \
            before[key + "_lanes" + sfx] + 2
        assert hc.LAUNCHES[key + sfx] == before[key + sfx] + lanes
        # each lanes call's live-channel pass
        assert hc.LAUNCHES["leaf_live_lanes"] == \
            before["leaf_live_lanes"] + 2
        if key == "hist_leaves":   # the lanes' one-pass f32 scale-back
            assert hc.LAUNCHES["fx_scale_lanes_u16"] == \
                before["fx_scale_lanes_u16"] + 2
        assert torch.equal(got, again)
        assert torch.equal(got, getattr(hc, plain + "_lanes_plain")(
            b, ws, chs, **kw))
        for i in range(lanes):
            assert torch.equal(got[i], singles[i])
            assert torch.equal(singles[i], getattr(hc, plain + "_plain")(
                b, ws[i], chs[i], **kw))
        if mix == "empty lane":
            assert not got[lanes // 2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("mix", LEAF_MIXES)
@pytest.mark.parametrize("lanes,n,offset", [(1, 4096, 0), (3, 50_001, 1),
                                            (4, 3 * 4096 * 25, 0),
                                            (8, 65_539, 3)])
@pytest.mark.parametrize("k", [hc.LEAF_CHANNELS, hc.Q_LEAF_CHANNELS])
def test_leaf_live_lanes_on_card(cuda_device, monkeypatch, k, lanes, n,
                                 offset, mix):
    """The leaf lanes forms' live-channel pass: bitwise its plain version
    on every mix, with 4-byte loads (aligned channels) and byte loads
    (channels ``offset`` bytes into their storage), row counts not a
    multiple of 4."""
    _, _, _, ch, _ = _leaf_lane_mix(lanes, mix, n + offset, 16, cuda_device)
    ch = [c[offset:] for c in ch]
    monkeypatch.setattr(hc, "leaf_live_lanes_plain", None)   # must launch
    before = hc.LAUNCHES["leaf_live_lanes"]
    got = hc.leaf_live_lanes(ch, num_channels=k)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert hc.LAUNCHES["leaf_live_lanes"] == before + 1
    want = hc.leaf_live_lanes_plain(ch, num_channels=k)
    assert torch.equal(got, want)
    if mix == "empty lane":
        assert not got[lanes // 2].any()


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [
    dict(use_quantized_grad=True, tpu_wave_size=4),
    dict(tree_grow_mode="partition"),
], ids=["quantized_wave", "partition"])
def test_train_many_on_card_matches_cpu(cuda_device, extra):
    """``train_many`` on the card writes the CPU's model text per model,
    and launches only model-axis forms."""
    rng = np.random.RandomState(0)
    X = rng.randn(6001, F)
    y = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(6001)
    params = dict(objective="regression", num_leaves=15, verbosity=-1,
                  **extra)
    variants = [{"lambda_l2": 0.0}, {"lambda_l2": 4.0}, {"lambda_l1": 0.5}]
    on_cpu = lt.train_many(params, lt.Dataset(X, y), 3, variants=variants,
                           device="cpu")
    hc.reset_launches()
    on_card = lt.train_many(params, lt.Dataset(X, y), 3, variants=variants,
                            device=cuda_device)
    single = [k for k, v in hc.LAUNCHES.items()
              if v and not k.endswith(("_lanes", "_lanes_packed4"))]
    assert sum(v for k, v in hc.LAUNCHES.items() if "_lanes" in k) > 0
    assert single in ([], ["hist_single", "hist_single_packed4"],
                      ["hist_single"], ["hist_single_packed4"])  # autotune
    for a, b in zip(on_cpu, on_card):
        assert a.model_to_string() == b.model_to_string()


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["exact", "quantized_stochastic",
                                  "quantized_pack4"])
def test_masked_lanes_draw_over_own_rows_on_card(cuda_device, mode):
    """Two lanes over one 20,000-row matrix on the card, each training on
    its own rows, grow the trees of standalone card runs on their
    compacted rows (the ramp at ``spec_subsample=4096`` gathers each
    lane's subsample from the shared matrix; stochastic rounding draws
    over the lane's rows); quantized, the CPU's trees too (exact f32
    scans differ between the card and the CPU in the last bits)."""
    from lightgbm_tpu_torch.dataset import pad_rows
    from lightgbm_tpu_torch.learner import lanes as kc
    from lightgbm_tpu_torch.learner.wave import make_wave_grow_fn
    from lightgbm_tpu_torch.ops import split as ts
    from lightgbm_tpu_torch.utils.random import host_key
    rng = np.random.RandomState(5)
    n, f, nb = 20_000, 6, 15
    bins = rng.randint(0, nb, (f, n)).astype(np.uint8)
    grad = ((bins[0] / nb - 0.5) * 3 + (bins[1] > 9) +
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

    def inputs(rows, compact, dev):
        m = len(rows) if compact else n
        b = np.zeros((f, pad_rows(m)), np.uint8)
        b[:, :m] = bins[:, rows] if compact else bins
        vec = np.zeros((3, b.shape[1]), np.float32)
        vec[:2, :m] = (grad[rows], hess[rows]) if compact else (grad, hess)
        vec[2, :m] = 1.0
        if not compact:
            vec[2] = 0.0
            vec[2, rows] = 1.0
        bt = torch.as_tensor(b, device=dev)
        return (th.pack_bins4(bt) if pack4 else bt,
                *torch.as_tensor(vec, device=dev).unbind(0),
                torch.full((f,), nb, dtype=torch.int32, device=dev),
                torch.zeros(f, dtype=torch.bool, device=dev),
                torch.ones(f, dtype=torch.bool, device=dev), host_key(3))

    own = [np.sort(rng.choice(n, 15_000, replace=False)),
           np.sort(rng.choice(n, 17_000, replace=False))]
    got = {}
    for dev in ("cpu", cuda_device):
        hc.reset_launches()
        got[dev] = kc.run_lanes([grow.gen(*inputs(r, False, dev),
                                          own_rows=torch.as_tensor(
                                              r, device=dev))
                                 for r in own])
    assert hc.LAUNCHES["wave_row_update_lanes"] > 0
    for rows, lane, cpu in zip(own, got[cuda_device], got["cpu"]):
        alone = grow(*inputs(rows, True, cuda_device))
        for name in alone._fields:
            a, b, c = (getattr(t, name) for t in (alone, lane, cpu))
            if name == "row_leaf":
                a, b, c = a[:len(rows)], b[rows], c[rows]
            if torch.is_tensor(a):
                assert torch.equal(a, b), name
                assert not quantized or torch.equal(a.cpu(), c), name
            else:
                assert a == b and (not quantized or a == c), name


def _variant_data(n=6000, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    z = 2 * X[:, 0] + np.sin(3 * X[:, 1]) + 0.1 * rng.randn(n)
    return X, (z > 0.5).astype(float)


def _logloss_fobj(preds, dataset):
    label = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-preds.astype(np.float64)))
    return p - label, p * (1.0 - p)


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [
    dict(boosting="goss", learning_rate=0.5),
    dict(boosting="dart", drop_rate=0.5, skip_drop=0.0),
    dict(boosting="dart", drop_rate=0.5, skip_drop=0.0,
         xgboost_dart_mode=True, objective="multiclass", num_class=3),
    dict(boosting="rf", bagging_fraction=0.6, bagging_freq=1,
         feature_fraction=0.8),
    dict(objective="none"),
], ids=["goss", "dart", "dart_multiclass", "rf", "fobj"])
def test_boosting_variants_on_card_match_cpu(cuda_device, extra):
    """Quantized GOSS, DART (its divisions by a weight divide on the card
    as on the CPU), RF (its averages too) and a custom objective write
    the CPU's model text on the card, with a valid set."""
    X, y = _variant_data()
    if extra.get("objective") == "multiclass":
        y = np.digitize(2 * X[:, 0], [-1.0, 1.0]).astype(float)
    params = dict(objective="binary", num_leaves=15, verbosity=-1,
                  use_quantized_grad=True)
    params.update(extra)
    fobj = _logloss_fobj if extra.get("objective") == "none" else None
    out = []
    for dev in ("cpu", cuda_device):
        d = lt.Dataset(X, y)
        v = lt.Dataset(X[:1000], y[:1000], reference=d)
        bst = lt.train(params, d, 5, valid_sets=[v], fobj=fobj, device=dev)
        out.append((bst.model_to_string(),
                    bst._gbdt.valid_scores[0].cpu().numpy()))
    assert out[1][0] == out[0][0]
    np.testing.assert_array_equal(out[1][1], out[0][1])


@pytest.mark.gpu
def test_linear_trees_on_card_match_cpu(cuda_device):
    """Linear trees: the f64 moment products differ between cuBLAS and
    the CPU in the last bits; predictions within 1e-5 of the scale."""
    X, y = _variant_data()
    params = dict(objective="regression", num_leaves=15, verbosity=-1,
                  linear_tree=True, linear_lambda=0.1)
    z = 2 * X[:, 0] + np.abs(X[:, 1]) * X[:, 1]
    raw = [lt.train(params, lt.Dataset(X, z), 5, device=dev).predict(X)
           for dev in ("cpu", cuda_device)]
    np.testing.assert_allclose(raw[1], raw[0], rtol=0,
                               atol=1e-5 * np.abs(raw[0]).max())


@pytest.mark.gpu
@pytest.mark.parametrize("boosting", ["goss", "dart"])
def test_goss_dart_lanes_on_card_match_standalone(cuda_device, boosting):
    """GOSS and DART lanes on the card write the text of standalone card
    runs, launching only model-axis forms (the autotune probe aside)."""
    X, y = _variant_data(6001)
    params = dict(objective="binary", num_leaves=15, verbosity=-1,
                  use_quantized_grad=True, boosting=boosting,
                  learning_rate=0.5, skip_drop=0.0)
    variants = ([{"top_rate": 0.2, "other_rate": 0.1},
                 {"top_rate": 0.3, "other_rate": 0.2}]
                if boosting == "goss" else
                [{"drop_rate": 0.2}, {"drop_rate": 0.6}])
    hc.reset_launches()
    mb = lt.train_many(params, lt.Dataset(X, y), 5, variants=variants,
                       device=cuda_device, strict=True)
    assert hc.LAUNCHES["hist_leaves_q8_lanes"] > 0
    for m, v in enumerate(variants):
        alone = lt.train({**params, **v}, lt.Dataset(X, y), 5,
                         device=cuda_device)
        assert mb[m].model_to_string() == alone.model_to_string()


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [1, 3])
def test_packed_single_lanes_on_card(cuda_device, monkeypatch, lanes):
    """The packed single-leaf model-axis form launches on the card, bitwise
    its plain version and L packed single launches, identical twice."""
    rng = np.random.RandomState(11)
    n = 3 * 4096
    packs = [th.pack_bins4(torch.from_numpy(
        rng.randint(0, 16, (F, n)).astype(np.uint8)).to(cuda_device))
        for _ in range(lanes)]
    ws = [th.pack_weights(*(torch.from_numpy(a.astype(np.float32))
                            .to(cuda_device) for a in
                            (rng.randn(n), rng.rand(n) + 0.1,
                             rng.rand(n) < 0.7)))
          for _ in range(lanes)]
    monkeypatch.setattr(hc, "hist_single_lanes_plain", None)   # must launch
    before = hc.LAUNCHES["hist_single_lanes_packed4"]
    got = hc.hist_single_lanes(packs, ws, num_bins=16, bins_packed=True)
    again = hc.hist_single_lanes(packs, ws, num_bins=16, bins_packed=True)
    monkeypatch.undo()
    assert hc.LAUNCHES["hist_single_lanes_packed4"] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, hc.hist_single_lanes_plain(
        [p.cpu() for p in packs], [th.FxWeights(w.w.cpu(), w.inv_scale.cpu())
                                   for w in ws], num_bins=16,
        bins_packed=True).to(cuda_device))
    for i in range(lanes):
        assert torch.equal(got[i], hc.hist_single(
            packs[i], ws[i], num_bins=16, bins_packed=True))


# -- checkpoint / resume, serving and explanation on the card -----------------

def _serve_data(n=8000, seed=3, cat=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, F)
    X[rng.rand(n, F) < 0.03] = np.nan
    if cat:
        X[:, 3] = rng.randint(0, 40, n)
    z = np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1]) ** 2
    if cat:
        z = z + (X[:, 3] % 3 == 0)
    return X, (z > 0.8).astype(float)


@pytest.mark.gpu
def test_resume_on_card_matches_uninterrupted(cuda_device, tmp_path):
    """3 rounds with checkpointing and a resume to 6 on the card write the
    text of 6 uninterrupted rounds (stochastic rounding, bagging at a
    period that does not divide the cut, by-node sampling)."""
    X, y = _serve_data()
    params = dict(objective="binary", num_leaves=31, verbosity=-1,
                  use_quantized_grad=True, bagging_fraction=0.8,
                  bagging_freq=2, feature_fraction_bynode=0.5)
    full = lt.train(params, lt.Dataset(X, y), 6, device=cuda_device)
    ck = str(tmp_path / "ck")
    lt.train({**params, "checkpoint_dir": ck}, lt.Dataset(X, y), 3,
             device=cuda_device)
    res = lt.train({**params, "checkpoint_dir": ck, "resume": "latest"},
                   lt.Dataset(X, y), 6, device=cuda_device)
    assert res.model_to_string() == full.model_to_string()


def _card_model(cuda_device, cat=False, **extra):
    X, y = _serve_data(cat=cat)
    params = dict(objective="binary", num_leaves=31, verbosity=-1,
                  use_quantized_grad=True, **extra)
    kw = {"categorical_feature": [3]} if cat else {}
    return lt.train(params, lt.Dataset(X, y, **kw), 8, device=cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("cat", [False, True], ids=["numeric", "categorical"])
def test_dense_serving_on_card_matches_walk(cuda_device, cat):
    """On the card ``auto`` serves the dense program with no counted
    fallback; its raw scores are within 1e-5 of the walk's, ``pred_leaf``
    is identical, and the predictor equals the walk at every bucket."""
    from lightgbm_tpu_torch.serve import compiler as sc
    text = _card_model(cuda_device, cat).model_to_string()
    X, _ = _serve_data(n=5000, seed=9, cat=cat)
    fb0 = sc.fallback_counts()
    b = {m: lt.Booster(model_str=text, params={"tpu_predict_compiler": m},
                       device=cuda_device) for m in ("auto", "walk")}
    dense, walk = (b[m].predict(X, raw_score=True) for m in ("auto", "walk"))
    np.testing.assert_allclose(dense, walk, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(b["auto"].predict(X, pred_leaf=True),
                                  b["walk"].predict(X, pred_leaf=True))
    pred = b["auto"].to_predictor()
    assert pred.info()["compiler"] == "dense"
    for n in (1, 8, 64, 512, 4096):
        np.testing.assert_allclose(pred.predict_raw(X[:n]), walk[:n],
                                   rtol=0, atol=1e-5)
    assert sc.fallback_counts() == fb0


@pytest.mark.gpu
@pytest.mark.parametrize("linear", [False, True], ids=["plain", "linear"])
def test_dense_predictions_ignore_tf32(cuda_device, linear):
    """``allow_tf32`` and ``set_float32_matmul_precision`` set by a
    caller cannot change a dense prediction: every product of real
    values stays out of TF32."""
    if linear:
        X, _ = _serve_data()
        z = 2 * np.nan_to_num(X[:, 0]) + np.nan_to_num(X[:, 1])
        bst = lt.train(dict(objective="regression", num_leaves=15,
                            verbosity=-1, linear_tree=True),
                       lt.Dataset(X, z), 4, device=cuda_device)
    else:
        bst = _card_model(cuda_device)
    bst = lt.Booster(model_str=bst.model_to_string(),
                     params={"tpu_predict_compiler": "dense"},
                     device=cuda_device)
    X, _ = _serve_data(n=3000, seed=11)
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        want = bst.predict(X, raw_score=True)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("medium")
        got = bst.predict(X, raw_score=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep[0]
        torch.set_float32_matmul_precision(keep[1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
def test_pred_contrib_on_card(cuda_device):
    """Dense TreeSHAP on the card is within rtol 1e-4 of the f64 host
    walk, its additivity check holds, and no explain fallback is
    counted."""
    from lightgbm_tpu_torch.explain import compiler as ec
    from lightgbm_tpu_torch.models.shap import predict_contrib
    bst = _card_model(cuda_device, cat=True)
    X, _ = _serve_data(n=700, seed=12, cat=True)
    fb0 = ec.explain_fallback_counts()
    got = bst.predict(X, pred_contrib=True)
    want = predict_contrib(bst._gbdt, X.astype(np.float32))
    assert ec.explain_fallback_counts() == fb0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())
    raw = bst.predict(X, raw_score=True)
    np.testing.assert_allclose(got.sum(axis=1), raw, rtol=1e-4, atol=1e-4)


# -- uint16 bins (max_bin > 255) ----------------------------------------------

U16_KERNELS = ("hist_single_u16", "hist_leaves_q8_u16", "hist_leaves_u16",
               "leaf_partition", "wave_row_update_u16",
               "wave_row_update_ext_u16", "wave_trial_channels_u16")


def _u16_case(device, n, num_bins, seed=3, w=25):
    """uint16 bins (F, n) with every code of [0, num_bins) possible and the
    top code set on a run of rows, a row-major (n, F + 3) copy read as its
    segment view, weights, channels, and a row-update table whose
    thresholds and NaN bins lie past 255."""
    rng = np.random.RandomState(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    b = rng.randint(0, num_bins, (F, n)).astype(np.uint16)
    b[:, :97] = num_bins - 1
    b[F - 1] %= 256     # the categorical split's feature: 256 bins
    P = np.zeros((n + 5, F + 3), np.uint16)
    P[3:3 + n, :F] = b.T
    grad = t((rng.randn(n) * 0.5).astype(np.float32))
    hess = t((rng.rand(n) * 0.25 + 0.01).astype(np.float32))
    mask = t((rng.rand(n) < 0.8).astype(np.float32))
    ch = t(rng.randint(-1, hc.LEAF_CHANNELS, n).astype(np.int8))
    rl = t(rng.randint(0, 60, n).astype(np.int32))
    tab = np.stack([
        rng.randint(0, num_bins, w), np.where(rng.rand(w) < 0.5,
                                              num_bins - 1, -1),
        rng.randint(0, 2, w), rng.randint(0, 2, w),
        rng.choice(60, w, replace=False), 60 + np.arange(w),
        (np.arange(w) < w - 3).astype(int), np.zeros(w, int)])
    tab[4, 1] = tab[5, 0]
    feats = np.concatenate([rng.randint(0, F, w - 3), F + 1 + np.arange(3)])
    feats[2] = F - 1
    return (t(b), t(P)[3:3 + n, :F].t(), grad, hess, mask, ch, rl,
            t(tab.astype(np.int32)), t(feats.astype(np.int32)))


def _u16_channels(device, n, mix, seed=4, k=hc.LEAF_CHANNELS):
    """(n,) int8 leaf channels: ``uniform`` over [-1, k), ``skewed`` (of
    the 60% kept, 90% in channel 3, the rest in channels c % 4 != 1 below
    k, so several empty) or ``none`` (no kept row)."""
    rng = np.random.RandomState(seed)
    ch = np.full(n, -1, np.int8)
    if mix == "uniform":
        ch = rng.randint(-1, k, n).astype(np.int8)
    elif mix == "skewed":
        kept = rng.rand(n) < 0.6
        heavy = rng.rand(n) < 0.9
        ch[kept & heavy] = 3
        light = kept & ~heavy
        ch[light] = rng.choice([c for c in range(k)
                                if c % 4 != 1 and c != 3], int(light.sum()))
    return torch.from_numpy(ch).to(device)


@pytest.mark.gpu
@pytest.mark.parametrize("n,num_bins,mix", [
    pytest.param(65536, 1024, "uniform", id="65536-1024"),
    pytest.param(100_003, 1024, "uniform", id="100003-1024"),
    pytest.param(65536, 20_000, "uniform", id="65536-20000"),
    pytest.param(100_003, 65_535, "uniform", id="100003-65535"),
    pytest.param(65536, 257, "uniform", id="65536-257"),
    pytest.param(100_003, 1024, "skewed", id="100003-1024-skewed"),
    pytest.param(65536, 65_535, "skewed", id="65536-65535-skewed"),
    pytest.param(65536, 1024, "none", id="65536-1024-no-kept-row")])
def test_u16_kernels_match_plain_on_card(cuda_device, monkeypatch, n,
                                         num_bins, mix):
    """Every uint16 form bit for bit its plain version and identical across
    two launches; 20,000 and 65,535 bins run the bin-tile axis of all
    three histograms; the leaf forms also on a skewed mix and one with no
    kept row."""
    bins, rows, grad, hess, mask, ch, rl, tab, feats = _u16_case(
        cuda_device, n, num_bins)
    if mix != "uniform":
        ch = _u16_channels(cuda_device, n, mix)
    assert bins.dtype == torch.uint16
    wch = tq.quantize_wch(grad, hess, mask,
                          torch.tensor(0.01, device=cuda_device),
                          torch.tensor(0.002, device=cuda_device),
                          gq_max=127, hq_max=127)
    w = th.pack_weights(grad, hess, mask)
    is_cat = torch.zeros((tab.shape[1],), dtype=torch.bool,
                         device=cuda_device)
    is_cat[2] = True   # a categorical split over bins < 256
    member = torch.zeros((tab.shape[1], 256), dtype=torch.bool,
                         device=cuda_device)
    member[2, ::3] = True
    z = torch.zeros_like(feats)
    dec = hc.split_decode(is_cat, member, z, z + num_bins, z,
                          torch.ones_like(feats))
    targs = (tab[4], tab[0], tab[1], tab[2] > 0, tab[3] > 0, tab[6] > 0)

    def run():
        return (hc.hist_single(bins, w, num_bins=num_bins),
                hc.hist_single(rows, w, num_bins=num_bins),
                hc.build_histogram_leaves_q8(bins, wch, ch,
                                             num_bins=num_bins),
                hc.build_histogram_leaves(bins, w, ch, num_bins=num_bins),
                hc.wave_row_update(bins, rl, tab, feats=feats),
                hc.wave_row_update(bins, rl, tab, feats=feats, decode=dec),
                hc.wave_trial_channels(bins, rl, *targs, feats=feats))

    for name in ("hist_single_plain", "build_histogram_leaves_q8_plain",
                 "build_histogram_leaves_plain", "wave_row_update_plain",
                 "wave_trial_channels_plain"):
        monkeypatch.setattr(hc, name, None)   # must launch
    before = dict(hc.LAUNCHES)
    got, again = run(), run()
    torch.cuda.synchronize()
    assert all(hc.LAUNCHES[k] > before[k] for k in U16_KERNELS)
    assert hc.LAUNCHES["hist_single"] == before["hist_single"]
    monkeypatch.undo()
    want = (hc.hist_single_plain(bins, w, num_bins=num_bins),
            hc.hist_single_plain(rows, w, num_bins=num_bins),
            hc.build_histogram_leaves_q8_plain(bins, wch, ch,
                                               num_bins=num_bins),
            hc.build_histogram_leaves_plain(bins, w, ch, num_bins=num_bins),
            hc.wave_row_update_plain(bins, rl, tab, feats=feats),
            hc.wave_row_update_plain(bins, rl, tab, feats=feats,
                                     decode=dec),
            hc.wave_trial_channels_plain(bins, rl, *targs, feats=feats))
    names = ("single", "single rows", "q8", "fx", "row update rl",
             "row update ch", "ext rl", "ext ch", "trial")
    flat = lambda xs: [t_ for x in xs for t_ in
                       (x if isinstance(x, tuple) else (x,))]
    for name, a, b, c in zip(names, flat(got), flat(again), flat(want)):
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name
    assert int(want[0][:F - 1, num_bins - 1, 2].min()) > 0   # the top code


# the partition's edge sizes, (rows, row blocks) with T the scatter's tile
# rows (hc.part_tile_rows): odd, below one tile, a tile's multiple and
# one off either side of it over 2 blocks (channels spanning tiles and
# blocks), one block; None takes the default blocks
PART_SIZES = {"odd": lambda t: (100_003, None),
              "small": lambda t: (1000, None),
              "tile-1": lambda t: (t - 1, None),
              "3 tiles-1": lambda t: (3 * t - 1, 2),
              "3 tiles": lambda t: (3 * t, 2),
              "3 tiles+1": lambda t: (3 * t + 1, 2),
              "one block": lambda t: (5 * t + 7, 1)}


def _part_weights(device, n, q8, seed=8):
    rng = np.random.RandomState(seed)
    if q8:
        return torch.from_numpy(rng.randint(-128, 128, (8, n)).astype(
            np.int8)).to(device)
    return th.pack_weights(torch.randn(n), torch.rand(n),
                           (torch.rand(n) < 0.8).float()).w.to(device)


def _assert_same_list(got, want):
    """Records and plan (offsets, slots, slot table) equal."""
    m = int(want.offsets[-1])
    assert int(got.offsets[-1]) == m
    assert torch.equal(got.records[:m].cpu(), want.records[:m].cpu())
    for a, b in zip(got[1:], want[1:]):
        assert torch.equal(a.cpu(), b.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("k", [None, 1, 64])
@pytest.mark.parametrize("size", list(PART_SIZES))
@pytest.mark.parametrize("mix", ["uniform", "skewed", "none"])
@pytest.mark.parametrize("q8", [True, False])
def test_leaf_partition_matches_plain_on_card(cuda_device, mix, q8, size, k):
    """The channel partition's records and plan (offsets, slots, slot
    table) equal its plain version's (a stable argsort), identical across
    two launches: at N odd, below one tile, a tile multiple and one off
    it, in one block, and at K = 1, the form's K and 64."""
    k = k or (hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS)
    n, blocks = PART_SIZES[size](hc.part_tile_rows(q8))
    ch = _u16_channels(cuda_device, n, mix, k=k)
    w = _part_weights(cuda_device, n, q8)
    sms = hc._sm_count(torch.device(cuda_device))
    geo = hc.list_geometry(sms, F, n, 1024, k, q8)
    blocks = blocks or geo.part_blocks
    before = hc.LAUNCHES["leaf_partition"]
    runs = [hc.leaf_partition(ch, w, num_channels=k, slots=geo.slots,
                              part_blocks=blocks) for _ in range(2)]
    torch.cuda.synchronize()
    assert hc.LAUNCHES["leaf_partition"] == before + 2
    want = hc.leaf_partition_plain(ch.cpu(), w.cpu(), num_channels=k,
                                   slots=geo.slots)
    for rl in runs:
        _assert_same_list(rl, want)
    if mix == "none":
        assert not int(runs[0].offsets[-1])
        assert (runs[0].table == -1).all()


def _check_lane_partitions(device, lanes):
    """``leaf_partition_lanes`` over lanes of different mixes in one
    launch at the partition's edge sizes and K = 1, 42 and 64: each lane
    its plain version's and its single partition's list, identical across
    two launches."""
    mixes = ("uniform", "skewed", "none", "uniform")
    for q8 in (True, False):
        for size in ("odd", "small", "3 tiles+1", "one block"):
            n, blocks = PART_SIZES[size](hc.part_tile_rows(q8))
            for k in (1, hc.Q_LEAF_CHANNELS, 64):
                chs = [_u16_channels(device, n, mixes[i % 4], seed=i, k=k)
                       for i in range(lanes)]
                ws = [_part_weights(device, n, q8, seed=i)
                      for i in range(lanes)]
                slots = 3 * k
                part = blocks or hc._part_blocks(
                    hc._sm_count(torch.device(device)), n, lanes)
                runs = [hc.leaf_partition_lanes(
                    chs, ws, num_channels=k, slots=slots, part_blocks=part)
                    for _ in range(2)]
                torch.cuda.synchronize()
                for i in range(lanes):
                    want = hc.leaf_partition_plain(
                        chs[i].cpu(), ws[i].cpu(), num_channels=k,
                        slots=slots)
                    one = hc.leaf_partition(chs[i], ws[i], num_channels=k,
                                            slots=slots)
                    for rl in (runs[0][i], runs[1][i], one):
                        _assert_same_list(rl, want)


def _u16_single_case(device, layout, n, num_bins, case):
    """One leaf's uint16 bins for ``hist_single_u16`` and its weights: a
    row-major segment ``P[3:3 + n, :F].T`` of rows F + 2 codes wide
    (ROWS), or a feature-major (F, n) matrix, contiguous or at an odd
    column offset (``odd start``: no aligned 64-bit loads) (FEATS).
    ``one row``: a weighted one-row leaf; ``zero``: every weight zero;
    ``skew``: every row in bin B - 1 (the
    last tile's block, a peer of every other block of its cluster: the
    DSM atomics' worst case) with equal weights."""
    rng = np.random.RandomState(num_bins % 97 + n % 13)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    P = rng.randint(0, num_bins, (n + 8, F + 2)).astype(np.uint16)
    grad = (rng.randn(n) * 0.5).astype(np.float32)
    hess = (rng.rand(n) * 0.25 + 0.01).astype(np.float32)
    mask = (rng.rand(n) < 0.8).astype(np.float32)
    if case == "zero":
        mask[:] = 0.0
    elif case == "one row":
        mask[:] = 1.0
    elif case == "skew":
        P[:] = num_bins - 1
        grad[:], hess[:], mask[:] = -0.75, 0.25, 1.0
    w = th.pack_weights(t(grad), t(hess), t(mask))
    if layout == "rows":
        return t(P)[3:3 + n, :F].t(), w
    if case == "odd start":
        return t(P[:, :F].T)[:, 3:3 + n], w
    bins = torch.empty((F, n), dtype=torch.uint16, device=device)
    return bins.copy_(t(P[3:3 + n, :F].T)), w   # strides (n, 1), n = 1 too


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["random", "odd start", "one row", "zero",
                                  "skew"])
@pytest.mark.parametrize("layout", ["rows", "features"])
@pytest.mark.parametrize("num_bins", [1024, 11_622, 16_384, 65_535])
def test_hist_single_u16_clusters_match_plain_on_card(
        cuda_device, monkeypatch, num_bins, layout, case):
    """The uint16 single-leaf form's thread-block clusters (one block a
    cluster at 1024 bins, the bin tiles of a feature group past 11,621) bit
    for bit the plain version and identical across two launches: row-major
    segments at odd starts, the feature-major matrix the partitioned and
    the masked grower pass (contiguous and at an odd column offset), a
    one-row segment, all-zero weights and every row in one bin."""
    n = 1 if case == "one row" else 100_003
    bins, w = _u16_single_case(cuda_device, layout, n, num_bins, case)
    assert bins.dtype == torch.uint16
    monkeypatch.setattr(hc, "hist_single_plain", None)   # must launch
    before = hc.LAUNCHES["hist_single_u16"]
    got = hc.hist_single(bins, w, num_bins=num_bins)
    again = hc.hist_single(bins, w, num_bins=num_bins)
    torch.cuda.synchronize()
    assert hc.LAUNCHES["hist_single_u16"] == before + 2
    monkeypatch.undo()
    assert torch.equal(got, again)
    want = hc.hist_single_plain(bins, w, num_bins=num_bins)
    assert torch.equal(got, want)
    if case == "skew":
        assert int(want[:, num_bins - 1, 2].min()) == n


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [
    dict(tree_grow_mode="wave", use_quantized_grad=True,
         stochastic_rounding=False),
    dict(tree_grow_mode="wave", use_quantized_grad=True),
    dict(tree_grow_mode="auto")])
def test_u16_training_on_card_matches_cpu(cuda_device, extra):
    """max_bin=1023 on the card grows the CPU's model: the quantized wave
    grower (uint16 leaf kernels and row update) and the partitioned one
    (uint16 single-leaf kernel)."""
    rng = np.random.RandomState(5)
    X = rng.randn(20000, F)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.8).astype(float)
    params = dict(objective="binary", num_leaves=15, verbosity=-1,
                  max_bin=1023, **extra)
    on_cpu = lt.train(params, lt.Dataset(X, y), 4, device="cpu")
    before = dict(hc.LAUNCHES)
    on_card = lt.train(params, lt.Dataset(X, y), 4, device=cuda_device)
    torch.cuda.synchronize()
    used = (("hist_leaves_q8_u16", "leaf_partition", "wave_row_update_u16")
            if extra["tree_grow_mode"] == "wave" else ("hist_single_u16",))
    assert all(hc.LAUNCHES[k] > before[k] for k in used)
    assert on_card.model_to_string() == on_cpu.model_to_string()


# -- the model-axis uint16 forms ---------------------------------------------

def _hard_single_lanes(device, num_bins, layout):
    """Four lanes of the single-leaf form's hard cases: a long segment, an
    empty one, one of 17 rows (shorter than one block's share) and one
    whose codes crowd 90% onto one bin per feature; codes at or past B
    (the top uint8 code at B=200, 65,535 at B=1024 and 65,535); int64
    weights whose sums carry across the 32-bit boundary (low words of all
    ones), negative ones, and ones near the 61-bit fixed-point headroom
    (``ops/histogram.py`` ``_FX_HEADROOM_BITS``) whose sums wrap mod
    2^64, as the plain version's do; the count row 0/1."""
    rng = np.random.RandomState(num_bins % 211)
    n, f = 200_003, 5
    dt = np.uint8 if num_bins <= 256 else np.uint16
    top = 255 if dt == np.uint8 else 65_535
    codes = rng.randint(0, top + 1, (f, n))
    codes[:, rng.rand(n) < 0.5] %= num_bins
    skew = np.where(rng.rand(f, n) < 0.9,
                    (np.arange(f) * 7919 % num_bins)[:, None], codes)
    segs = [(3, n - 3), (50, 50), (1_001, 1_018), (7, 120_007)]
    mats = [codes, codes, codes, skew]
    c = (rng.rand(n) < 0.8).astype(np.int64)
    head = 1 << (61 - 18)
    kinds = [rng.randint(1, 1 << 20, n) * (1 << 32) - 1,
             -rng.randint(1, 9, n),
             rng.randint(-head, head, n),
             rng.randint(-(1 << 62), 1 << 62, n)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    bins, ws = [], []
    for lane, ((s, e), m) in enumerate(zip(segs, mats)):
        g = kinds[lane] * c
        h = rng.randint(0, head, n) * c
        w = th.FxWeights(t(np.stack([g, h, c])[:, s:e]),
                         torch.ones(3, dtype=torch.float64, device=device))
        mat = t(m.astype(dt))
        bins.append(mat.t().contiguous()[s:e].t() if layout == "rows"
                    else mat[:, s:e])
        ws.append(w)
    return bins, ws


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["rows", "features"])
@pytest.mark.parametrize("num_bins", [200, 1024, 16_383, 65_535])
def test_single_lanes_hard_mixes_on_card(cuda_device, monkeypatch, num_bins,
                                        layout):
    """``hist_single_lanes`` (uint8 at B=200, its uint16 form at one tile
    and past it, where remote adds go through DSM and L2) on
    :func:`_hard_single_lanes`' lanes: one launch, bitwise its plain
    version and each lane's single launch, identical twice; the empty
    lane's histogram zero."""
    bins, ws = _hard_single_lanes(cuda_device, num_bins, layout)
    key = "hist_single_lanes" + ("_u16" if num_bins > 256 else "")
    monkeypatch.setattr(hc, "hist_single_lanes_plain", None)   # must launch
    monkeypatch.setattr(hc, "hist_single_plain", None)
    before = hc.LAUNCHES[key]
    got = hc.hist_single_lanes(bins, ws, num_bins=num_bins)
    again = hc.hist_single_lanes(bins, ws, num_bins=num_bins)
    singles = [hc.hist_single(b, w, num_bins=num_bins)
               for b, w in zip(bins, ws)]
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert hc.LAUNCHES[key] == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, hc.hist_single_lanes_plain(bins, ws,
                                                       num_bins=num_bins))
    for lane, one in enumerate(singles):
        assert torch.equal(got[lane], one), lane
    assert not got[1].any() and got[0].any() and got[3].any()


U16_LANE_PLAINS = LANE_PLAINS + ("leaf_partition_lanes_plain",)
U16_LANE_KERNELS = ("hist_leaves_q8_lanes_u16", "hist_leaves_lanes_u16",
                    "leaf_partition_lanes", "wave_row_update_lanes_u16",
                    "wave_row_update_ext_lanes_u16",
                    "wave_trial_channels_lanes_u16", "hist_single_lanes_u16")


def _u16_lanes(device, lanes, n, num_bins, empty):
    """``_lane_inputs`` over uint16 codes (thresholds and NaN bins past
    255, the top code on a run of rows), each lane's categorical decode
    (its splits of the last feature, whose codes stay below 256: the
    membership's 256 bins), and each lane's segment of its own row-major
    copy, lane ``empty``'s (if any) segment of no row."""
    bins, wch, fx, ch, rl, feats, tab, _ = _lane_inputs(lanes, n, 256,
                                                        device)
    rng = np.random.RandomState(lanes + num_bins % 89)
    b = rng.randint(0, num_bins, (F, n)).astype(np.uint16)
    b[:, :97] = num_bins - 1
    b[F - 1] %= 256
    bins = torch.from_numpy(b).to(device)
    feats = feats.clone()
    feats[:, 2] = F - 1
    tab = tab.clone()
    tab[:, 0] = torch.from_numpy(rng.randint(
        0, num_bins, tuple(tab[:, 0].shape)).astype(np.int32)).to(device)
    tab[:, 1] = torch.where(tab[:, 1] >= 0, num_bins - 1, -1)
    w = tab.shape[2]
    decs = []
    for _ in range(lanes):
        z = torch.zeros(w, dtype=torch.int32, device=device)
        decs.append(hc.split_decode(
            feats[len(decs)] == F - 1,
            torch.from_numpy(rng.rand(w, 256) < 0.4).to(device), z,
            z + num_bins, z, z + 1))
    P = [bins.t().contiguous() for _ in range(lanes)]
    segs = [(i * 97 + 5, n - i * 1001) for i in range(lanes)]
    if empty is not None:
        segs[empty] = (50, 50)
    single = ([p[s:e].t() for p, (s, e) in zip(P, segs)],
              [th.FxWeights(f.w[:, s:e], f.inv_scale)
               for f, (s, e) in zip(fx, segs)])
    feats_major = ([bins] * lanes, fx)
    return bins, wch, fx, ch, rl, feats, tab, decs, single, feats_major


@pytest.mark.gpu
@pytest.mark.parametrize("num_bins", [1024, 65_535])
@pytest.mark.parametrize("lanes", [1, 4])
def test_u16_lane_kernels_match_plain_and_single_on_card(
        cuda_device, monkeypatch, num_bins, lanes):
    """Every uint16 model-axis form, one launch for all lanes (the leaf
    forms: one partition launch and one histogram launch), bitwise its
    plain version and L single launches, identical twice; the single-leaf
    form over row-major segments with one empty lane (its clusters walk
    no row but reach every cluster barrier) and over the shared
    feature-major matrix; the lanes' partitions record for record each
    lane's own, and at the partition's edge sizes and channel counts over
    lanes of different mixes (:func:`_check_lane_partitions`)."""
    n = 100_003
    (bins, wch, fx, ch, rl, feats, tab, decs, single,
     fmaj) = _u16_lanes(cuda_device, lanes, n, num_bins,
                        empty=lanes - 1 if lanes > 1 else None)
    chx = torch.where(ch < hc.LEAF_CHANNELS, ch, -1)
    tabs = [hc.trial_tab(t[4], t[0], t[1], t[2] > 0, t[3] > 0, t[6] > 0)
            for t in tab]
    sms = hc._sm_count(torch.device(cuda_device))
    geo = hc.list_geometry(sms, F, n, num_bins, hc.Q_LEAF_CHANNELS, True)

    def run():
        return (hc.build_histogram_leaves_q8_lanes(bins, wch, ch,
                                                   num_bins=num_bins),
                hc.build_histogram_leaves_lanes(bins, fx, chx,
                                                num_bins=num_bins),
                *hc.wave_row_update_lanes(bins, rl, tab, feats=feats),
                *hc.wave_row_update_lanes(bins, rl, tab, feats=feats,
                                          decode=decs),
                hc.wave_trial_channels_lanes(bins, rl, tabs, feats=feats),
                hc.hist_single_lanes(*single, num_bins=num_bins),
                hc.hist_single_lanes(*fmaj, num_bins=num_bins))

    for name in U16_LANE_PLAINS:
        monkeypatch.setattr(hc, name, None)      # must launch
    before = dict(hc.LAUNCHES)
    got, again = run(), run()
    parts = hc.leaf_partition_lanes(ch, wch, num_channels=hc.Q_LEAF_CHANNELS,
                                    slots=geo.slots,
                                    part_blocks=hc._part_blocks(sms, n, lanes))
    torch.cuda.synchronize()
    monkeypatch.undo()
    launched = {k: hc.LAUNCHES[k] - before[k] for k in hc.LAUNCHES
                if hc.LAUNCHES[k] != before[k]}
    want_launches = {
        "hist_leaves_q8_lanes_u16": 2, "hist_leaves_lanes_u16": 2,
        "leaf_partition_lanes": 5, "wave_row_update_lanes_u16": 2,
        "wave_row_update_ext_lanes_u16": 2,
        "wave_trial_channels_lanes_u16": 2, "hist_single_lanes_u16": 4}
    if not hc.list_owner(num_bins, False, True):
        want_launches["fx_scale_lanes_u16"] = 2   # slot mode's scale-back
    assert launched == want_launches
    for x, y in zip(got, again):
        assert torch.equal(x, y)
    want = (hc.build_histogram_leaves_q8_lanes_plain(bins, wch, ch,
                                                     num_bins=num_bins),
            hc.build_histogram_leaves_lanes_plain(bins, fx, chx,
                                                  num_bins=num_bins),
            *hc.wave_row_update_lanes_plain(bins, rl, tab, feats=feats),
            *hc.wave_row_update_lanes_plain(bins, rl, tab, feats=feats,
                                            decode=decs),
            hc.wave_trial_channels_lanes_plain(bins, rl, tabs, feats=feats),
            hc.hist_single_lanes_plain(*single, num_bins=num_bins),
            hc.hist_single_lanes_plain(*fmaj, num_bins=num_bins))
    for i, (x, y) in enumerate(zip(got, want)):
        assert torch.equal(x, y), i
    if lanes > 1:
        assert not got[7][lanes - 1].any()
    for i in range(lanes):
        assert torch.equal(got[0][i], hc.build_histogram_leaves_q8(
            bins, wch[i], ch[i], num_bins=num_bins))
        assert torch.equal(got[1][i], hc.build_histogram_leaves(
            bins, fx[i], chx[i], num_bins=num_bins))
        rl1, ch1 = hc.wave_row_update(bins, rl[i], tab[i], feats=feats[i])
        assert torch.equal(got[2][i], rl1) and torch.equal(got[3][i], ch1)
        rl1, ch1 = hc.wave_row_update(bins, rl[i], tab[i], feats=feats[i],
                                      decode=decs[i])
        assert torch.equal(got[4][i], rl1) and torch.equal(got[5][i], ch1)
        t = tab[i]
        assert torch.equal(got[6][i], hc.wave_trial_channels(
            bins, rl[i], t[4], t[0], t[1], t[2] > 0, t[3] > 0, t[6] > 0,
            feats=feats[i]))
        assert torch.equal(got[7][i], hc.hist_single(
            single[0][i], single[1][i], num_bins=num_bins))
        assert torch.equal(got[8][i], hc.hist_single(
            bins, fx[i], num_bins=num_bins))
        one = hc.leaf_partition(ch[i], wch[i],
                                num_channels=hc.Q_LEAF_CHANNELS,
                                slots=geo.slots, part_blocks=geo.part_blocks)
        m = int(one.offsets[-1])
        assert torch.equal(parts[i].records[:m], one.records[:m])
        for a, b in zip(parts[i][1:], one[1:]):
            assert torch.equal(a, b)
    _check_lane_partitions(cuda_device, lanes)


def _fx_lane_mix(device, lanes, n, mix):
    """Each lane's exact-form channels: ``even`` (``_u16_channels``'
    uniform, a seed a lane), ``skewed`` (90% of the kept rows in channel
    3, several channels empty) or ``one empty`` (uniform, channel 7 of
    every lane empty)."""
    chs = []
    for i in range(lanes):
        c = _u16_channels(device, n, "skewed" if mix == "skewed"
                          else "uniform", seed=40 + i)
        if mix == "one empty":
            c = torch.where(c == 7, torch.full_like(c, -1), c)
        chs.append(c.contiguous())
    return chs


@pytest.mark.gpu
@pytest.mark.parametrize("mix", ["even", "skewed", "one empty"])
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("num_bins", [1024, 11_623, 65_535])
def test_fx_leaf_owner_mode_on_card(cuda_device, monkeypatch, num_bins,
                                    lanes, mix):
    """The exact uint16 leaf forms in both modes: slot mode at 1024 bins
    (int64 sums, then ``fx_scale_lanes``), owner mode past one tile (each
    channel's clusters write its f32 values whole, no scale-back launch),
    on an even, a skewed and a one-empty-channel mix.  The lanes form in
    each launch order (a launch a lane, one launch lane-major or
    feature-major) is bitwise its plain version and each lane's single
    form, identical twice; the single form's ``raw=True`` still returns
    the int64 sums."""
    n = 100_003
    bins = _u16_case(cuda_device, n, num_bins)[0]
    fx = []
    for i in range(lanes):
        rng = np.random.RandomState(60 + i)
        t = lambda a: torch.from_numpy(a).to(cuda_device)
        fx.append(th.pack_weights(
            t((rng.randn(n) * (i + 1)).astype(np.float32)),
            t((rng.rand(n) * 0.25 + 0.01).astype(np.float32)),
            t((rng.rand(n) < 0.8).astype(np.float32))))
    chs = _fx_lane_mix(cuda_device, lanes, n, mix)
    owner = hc.list_owner(num_bins, False, True)
    assert owner == (num_bins > 11_622)
    want = hc.build_histogram_leaves_lanes_plain(bins, fx, chs,
                                                 num_bins=num_bins)
    real = hc.list_lane_order
    monkeypatch.setattr(hc, "build_histogram_leaves_lanes_plain", None)
    monkeypatch.setattr(hc, "build_histogram_leaves_plain", None)
    for order in (hc.LIST_LAUNCH_PER_LANE, hc.LIST_LANE_MAJOR,
                  hc.LIST_FEATURE_MAJOR, None):
        if order is not None:
            monkeypatch.setattr(hc, "list_lane_order", lambda geo: order)
        else:
            monkeypatch.setattr(hc, "list_lane_order", real)
        before = dict(hc.LAUNCHES)
        got = hc.build_histogram_leaves_lanes(bins, fx, chs,
                                              num_bins=num_bins)
        again = hc.build_histogram_leaves_lanes(bins, fx, chs,
                                                num_bins=num_bins)
        torch.cuda.synchronize()
        assert hc.LAUNCHES["hist_leaves_lanes_u16"] - \
            before["hist_leaves_lanes_u16"] == 2
        assert hc.LAUNCHES["fx_scale_lanes_u16"] - \
            before["fx_scale_lanes_u16"] == (0 if owner else 2)
        assert got.dtype == torch.float32
        assert torch.equal(got, again), order
        assert torch.equal(got, want), order
    for i in range(lanes):
        one = hc.build_histogram_leaves(bins, fx[i], chs[i],
                                        num_bins=num_bins)
        assert one.dtype == torch.float32
        assert torch.equal(one, want[i])
        raw = hc.build_histogram_leaves(bins, fx[i], chs[i],
                                        num_bins=num_bins, raw=True)
        assert raw.dtype == torch.int64
        assert torch.equal(th.fx_to_f32(raw, fx[i].inv_scale), want[i])
    monkeypatch.undo()
    assert torch.equal(raw, hc.build_histogram_leaves_plain(
        bins, fx[-1], chs[-1], num_bins=num_bins, raw=True))
    if mix == "one empty":
        assert not want[:, 7].any()


@pytest.mark.gpu
@pytest.mark.parametrize("mix", ["even", "skewed", "one empty"])
@pytest.mark.parametrize("lanes", [1, 4])
@pytest.mark.parametrize("num_bins", [1024, 19_371, 65_535])
def test_q8_leaf_lanes_orders_on_card(cuda_device, monkeypatch, num_bins,
                                      lanes, mix):
    """The quantized uint16 leaf forms at one bin tile (1024), at the
    first two-tile shape (19,371: its clusters' peers add through
    distributed shared memory) and at 4 tiles (65,535), on an even, a
    skewed and a one-empty-channel mix with extreme weights (every g
    -128 or 127): the lanes form in each launch order (a launch a lane,
    one launch lane-major or feature-major, and the package's own) is one
    partition and one histogram launch a call, bitwise its plain version
    and each lane's single form, identical twice."""
    n = 100_003
    bins = _u16_case(cuda_device, n, num_bins)[0]
    assert hc.leaf_bin_tile(num_bins, True)[1] == {
        1024: 1, 19_371: 2, 65_535: 4}[num_bins]
    wch, chs = [], []
    for i in range(lanes):
        rng = np.random.RandomState(80 + i)
        w = rng.randint(-128, 128, (8, n)).astype(np.int8)
        w[0] = np.where(rng.rand(n) < 0.5, -128, 127)
        w[2] = rng.rand(n) < 0.8
        wch.append(torch.from_numpy(w).to(cuda_device))
        c = _u16_channels(cuda_device, n, "skewed" if mix == "skewed"
                          else "uniform", seed=90 + i,
                          k=hc.Q_LEAF_CHANNELS)
        if mix == "one empty":
            c = torch.where(c == 7, torch.full_like(c, -1), c)
        chs.append(c.contiguous())
    want = hc.build_histogram_leaves_q8_lanes_plain(bins, wch, chs,
                                                    num_bins=num_bins)
    real = hc.list_lane_order
    monkeypatch.setattr(hc, "build_histogram_leaves_q8_lanes_plain", None)
    monkeypatch.setattr(hc, "build_histogram_leaves_q8_plain", None)
    monkeypatch.setattr(hc, "leaf_partition_lanes_plain", None)
    for order in (hc.LIST_LAUNCH_PER_LANE, hc.LIST_LANE_MAJOR,
                  hc.LIST_FEATURE_MAJOR, None):
        monkeypatch.setattr(hc, "list_lane_order", real if order is None
                            else lambda geo, o=order: o)
        before = dict(hc.LAUNCHES)
        got = hc.build_histogram_leaves_q8_lanes(bins, wch, chs,
                                                 num_bins=num_bins)
        again = hc.build_histogram_leaves_q8_lanes(bins, wch, chs,
                                                   num_bins=num_bins)
        torch.cuda.synchronize()
        launched = {k: hc.LAUNCHES[k] - before[k] for k in hc.LAUNCHES
                    if hc.LAUNCHES[k] != before[k]}
        assert launched == {"hist_leaves_q8_lanes_u16": 2,
                            "leaf_partition_lanes": 2}, order
        assert got.dtype == torch.int32
        assert torch.equal(got, again), order
        assert torch.equal(got, want), order
    for i in range(lanes):
        assert torch.equal(hc.build_histogram_leaves_q8(
            bins, wch[i], chs[i], num_bins=num_bins), want[i])
    monkeypatch.undo()
    if mix == "one empty":
        assert not want[:, 7].any()


@pytest.mark.gpu
def test_u16_leaf_kernels_hold_no_compare_and_swap_loop(cuda_device):
    """The uint16 leaf histogram's instantiations (``hist_list_kernel``:
    q8 and fx, slot and owner mode, one bin tile and clusters) add with
    native instructions.  Their SASS holds no global atomic that returns a
    value (``ATOMG``: slot mode flushes with ``red.global``, owner mode
    with stores), and no compare-and-swap loop (``ATOMS.CAST.SPIN``, what
    a 64-bit shared ``atomicAdd`` compiles to on sm_90a) but the one
    ptxas puts behind each 64-bit DSM reduction past one tile (a generic
    ``ATOM.E.ADD.64``, native on a peer's window, the loop for the
    block's own): one loop per such reduction, none at one tile."""
    cuobjdump = os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump")
    if not os.path.exists(cuobjdump):
        pytest.skip("needs cuobjdump beside nvcc")
    cuda_lib.build_all(("hist_leaves_u16",))
    sass = subprocess.run([cuobjdump, "-sass",
                           cuda_lib._lib_path("hist_leaves_u16")],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout.splitlines()
    heads = [i for i, x in enumerate(sass) if "Function :" in x]
    bodies = {sass[i].split("Function :")[1].strip():
              "\n".join(sass[i:heads[j + 1] if j + 1 < len(heads)
                             else len(sass)])
              for j, i in enumerate(heads)}
    kernels = {k: v for k, v in bodies.items() if "hist_list_kernel" in k}
    assert len(kernels) == 6, sorted(bodies)
    for name, code in kernels.items():
        # <W, Owner, CL>: int8 (q8) or long long (fx), past one tile
        tiles = re.search(r"hist_list_kernelI[ax]Lb[01]ELb1E", name)
        spins = len(re.findall(r"\bATOMS\.CAST\.SPIN", code))
        wide = len(re.findall(r"\bATOM\.E\.ADD\.64\b", code))
        assert spins == (wide if tiles else 0), name
        assert wide > 0 or not tiles, name
        assert "ATOMG" not in code, name
        assert re.search(r"\bATOMS\.ADD\b", code), name


@pytest.mark.gpu
def test_fx_scale_lanes_on_card(cuda_device):
    """The slot mode's scale-back kernel: bitwise ``fx_to_f32`` on the
    card's sums next to f32's rounding ties and large ones, each lane its
    own scales, and ``torch.mul`` into an f32 output (one PyTorch call of
    the same function, ``chip_smoke.py``'s yardstick)."""
    rng = np.random.RandomState(75)
    lanes, m = 3, 3 * 40_001
    h = rng.randint(-(1 << 62), 1 << 62, (lanes, m), dtype=np.int64)
    h[:, :9] = [(1 << 25) + 2, (1 << 25) + 6, -(1 << 25) - 2,
                (1 << 53) + 1, (1 << 60) + (1 << 36), 0, 1, -1,
                (1 << 40) + (1 << 16)]
    h = torch.from_numpy(h.reshape(lanes, -1, 3)).to(cuda_device)
    scale = torch.tensor([[2.0 ** -40, 2.0 ** -37, 1.0],
                          [2.0 ** -61, 2.0 ** -3, 1.0],
                          [2.0 ** 5, 2.0 ** -55, 1.0]], dtype=torch.float64,
                         device=cuda_device)
    before = hc.LAUNCHES["fx_scale_lanes_u16"]
    got = hc.fx_scale_lanes(h, scale)
    torch.cuda.synchronize()
    assert hc.LAUNCHES["fx_scale_lanes_u16"] == before + 1
    want = th.fx_to_f32(h, scale)
    assert torch.equal(got, want)
    lib = torch.empty_like(want)
    torch.mul(h, scale[:, None, :], out=lib)
    assert torch.equal(lib, want)
    assert torch.equal(hc.fx_scale_lanes(h.cpu(), scale.cpu()), want.cpu())


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [
    dict(tree_grow_mode="wave", use_quantized_grad=True),
    dict(tree_grow_mode="wave"),
    dict(tree_grow_mode="auto")], ids=["quantized_wave", "exact_wave",
                                       "auto"])
def test_u16_train_many_on_card_matches_train(cuda_device, extra):
    """``train_many`` at max_bin=1023 on the card writes each model's
    standalone card ``train()`` text, launching the uint16 model-axis
    forms and no single form (but the autotune probe's)."""
    rng = np.random.RandomState(6)
    X = rng.randn(20000, F)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.8).astype(float)
    params = dict(objective="binary", num_leaves=15, verbosity=-1,
                  max_bin=1023, **extra)
    variants = [{"lambda_l2": 0.0}, {"lambda_l2": 4.0}, {"lambda_l1": 0.5}]
    hc.reset_launches()
    mb = lt.train_many(params, lt.Dataset(X, y), 3, variants=variants,
                       device=cuda_device)
    torch.cuda.synchronize()
    lanes = {k for k, v in hc.LAUNCHES.items() if v and "_lanes" in k}
    single = {k for k, v in hc.LAUNCHES.items()
              if v and "_lanes" not in k}
    assert mb.batched_indices == [0, 1, 2]
    assert lanes >= ({"hist_single_lanes_u16"} if extra["tree_grow_mode"] ==
                     "auto" else {"leaf_partition_lanes",
                                  "wave_row_update_lanes_u16"})
    assert all(k.endswith("_u16") or k == "leaf_partition_lanes"
               for k in lanes)
    assert single <= {"hist_single", "hist_single_packed4"}   # autotune
    for m, v in enumerate(variants):
        ref = lt.train({**params, **v}, lt.Dataset(X, y), 3,
                       device=cuda_device)
        assert mb[m].model_to_string() == ref.model_to_string()


# -- chunked ingest and the C API -------------------------------------------

_CHUNK_P = dict(objective="binary", num_leaves=15, verbosity=-1,
                use_quantized_grad=True, stochastic_rounding=False,
                tree_grow_mode="wave", tpu_speculative_ramp=False,
                tpu_exact_endgame=False, max_bin=63)


def _chunk_data():
    rng = np.random.RandomState(9)
    X = rng.randn(20000, F)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.8).astype(float)
    return X, y


def _streamed(X, y, device, **kw):
    from lightgbm_tpu_torch.ingest import (ArraySource, StreamedDataset,
                                           train_streamed)
    # 8192-row chunks: three of them, the last short
    sd = StreamedDataset(ArraySource(X, y, chunk_rows=8192),
                         params=_CHUNK_P)
    return train_streamed(_CHUNK_P, sd, 4, device=device, **kw)


@pytest.mark.gpu
def test_streamed_on_card_matches_cpu(cuda_device):
    """Chunked quantized training on the card (three chunks through the
    side-stream ring) writes the CPU's text and the in-core run's; the
    chunks went through the leaf-histogram and row-update kernels."""
    X, y = _chunk_data()
    on_cpu = _streamed(X, y, "cpu")
    before = dict(hc.LAUNCHES)
    on_card = _streamed(X, y, cuda_device)
    torch.cuda.synchronize()
    assert hc.LAUNCHES["hist_leaves_q8"] > before["hist_leaves_q8"]
    assert hc.LAUNCHES["wave_row_update"] > before["wave_row_update"]
    assert hc.LAUNCHES["hist_single"] == before["hist_single"]
    assert on_card.model_to_string() == on_cpu.model_to_string()
    incore = lt.train(_CHUNK_P, lt.Dataset(X, y), 4, device=cuda_device)
    assert on_card.model_to_string() == incore.model_to_string()


@pytest.mark.gpu
def test_profiled_ring_matches_in_core_and_frees_its_buffers(cuda_device):
    """The side-stream ring with CUDA events around every upload wait
    grows the trees of the in-core run, whose binned matrix uploads once
    and synchronously; the Booster keeps the ring's numbers and none of
    its device buffers."""
    X, y = _chunk_data()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    ring = _streamed(X, y, cuda_device, ring_profile=True)
    torch.cuda.synchronize()
    kept = torch.cuda.memory_allocated() - before
    incore = lt.train(_CHUNK_P, lt.Dataset(X, y), 4, device=cuda_device)
    assert ring.model_to_string() == incore.model_to_string()
    stats = ring._ingest_stats
    assert stats["pass_s"] > 0 and 0.0 <= stats["wait_share"] <= 1.0
    assert stats["h2d_bytes"] >= 4 * len(X) * (F + 12)
    # the ring's two device slots (bins, three f32 lanes, uint8 row_leaf)
    ring_bytes = 2 * 8192 * (F + 12 + 1)
    assert kept < ring_bytes, kept


@pytest.mark.gpu
def test_capi_training_round_trip_on_card(cuda_device, tmp_path):
    """The C API trains on the card by default and writes the text
    ``train`` writes on the card; a model loaded from its file predicts
    on the card (no device named) what the trained booster predicts."""
    from lightgbm_tpu_torch import capi
    X, y = _chunk_data()
    params = "objective=binary num_leaves=15 verbosity=-1"
    _, dh = capi.LGBM_DatasetCreateFromMat(X, params, label=y)
    _, bh = capi.LGBM_BoosterCreate(dh, params)
    assert capi._get(bh).device.type == "cuda"
    for _ in range(4):
        capi.LGBM_BoosterUpdateOneIter(bh)
    _, text = capi.LGBM_BoosterSaveModelToString(bh)
    kv = dict(t.split("=") for t in params.split())
    ref = lt.train(kv, lt.Dataset(X, y, params=kv), 4, device=cuda_device)
    assert text == ref.model_to_string()
    path = str(tmp_path / "m.txt")
    capi.LGBM_BoosterSaveModel(bh, path)
    _, lh = capi.LGBM_BoosterCreateFromModelfile(path)
    _, got = capi.LGBM_BoosterPredictForMat(lh, X)
    assert capi._get(lh).device.type == "cuda"
    np.testing.assert_array_equal(got,
                                  capi.LGBM_BoosterPredictForMat(bh, X)[1])


# -- the serving tier on the card ---------------------------------------------

def _serve_model(tmp_path, rounds, publish=False):
    rng = np.random.RandomState(5)
    X = rng.randn(20_000, F).astype(np.float32)
    y = (X[:, 0] + X[:, 1] ** 2 > 0.8).astype(np.float64)
    p = {"objective": "binary", "num_leaves": 31, "verbosity": -1,
         "use_quantized_grad": True}
    if publish:
        p.update(publish_dir=str(tmp_path / "journal"), publish_every=1)
    bst = lt.train(p, lt.Dataset(X, y), rounds)
    path = str(tmp_path / "model.txt")
    bst.save_model(path)
    return X, bst, path


@pytest.mark.gpu
def test_prediction_server_on_card_matches_booster(cuda_device, tmp_path):
    """``PredictionServer`` on the card answers /predict bitwise as an
    in-process ``Booster.predict`` on the card; /healthz names the
    card."""
    import http.client
    import json
    from lightgbm_tpu_torch.serve import ModelRegistry, PredictionServer
    X, _, path = _serve_model(tmp_path, 4)
    ref = lt.Booster(model_file=path)
    reg = ModelRegistry()
    reg.load("m", path)
    srv = PredictionServer(reg, port=0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        for n in (1, 64, 4096):
            conn.request("POST", "/predict",
                         json.dumps({"rows": X[:n].tolist()}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200, body
            np.testing.assert_array_equal(
                np.asarray(body["predictions"], np.float32),
                ref.predict(X[:n]).astype(np.float32))
        conn.request("GET", "/healthz")
        health = json.loads(conn.getresponse().read())
        assert health["status"] == "ok"
        assert health["device_name"] == torch.cuda.get_device_name(0)
    finally:
        srv.shutdown()


@pytest.mark.gpu
def test_delta_replay_on_card_keeps_compile_keys(cuda_device, tmp_path):
    """A journal replayed through ``apply_delta`` inside the shard
    padding's envelope adds no compile key, and each round answers
    bitwise as a cold load of the same round."""
    from lightgbm_tpu_torch.publish import DeltaJournal
    from lightgbm_tpu_torch.serve import ModelRegistry
    from lightgbm_tpu_torch.serve.predictor import compile_key_count
    X, _, path = _serve_model(tmp_path, 4, publish=True)
    j = DeltaJournal(str(tmp_path / "journal"))
    base, r0 = j.base_entry()
    reg = ModelRegistry()
    reg.load("m", base, shard=4)
    for rec in j.records_after(r0):
        keys = compile_key_count()
        assert reg.apply_delta("m", rec)["mode"] == "extend"
        got = reg.get("m").predict(X[:4096])
        assert compile_key_count() == keys
        cold = ModelRegistry()
        cold.load("c", path, warmup=False, num_iteration=rec.round,
                  shard=4)
        np.testing.assert_array_equal(got, cold.get("c").predict(X[:4096]))


@pytest.mark.gpu
def test_stacked_zoo_batch_on_card_matches_tenants(cuda_device, tmp_path):
    """Four same-shape tenants in a ``ModelZoo`` on the card: each lane
    of a stacked batch is bitwise its tenant's own predictor."""
    from lightgbm_tpu_torch.serve import CompiledPredictor, ModelZoo
    rng = np.random.RandomState(6)
    X = rng.randn(20_000, F).astype(np.float32)
    paths = []
    for s in range(4):
        y = (X[:, s % F] + 0.3 * rng.randn(len(X)) > 0).astype(np.float64)
        p = {"objective": "binary", "num_leaves": 31, "verbosity": -1}
        path = str(tmp_path / f"t{s}.txt")
        lt.train(p, lt.Dataset(X, y), 3).save_model(path)
        paths.append(path)
    zoo = ModelZoo(batching=True, max_wait_ms=1.0)
    try:
        for s, path in enumerate(paths):
            zoo.load(f"t{s}", path)
        assert sorted(sum(zoo.stack_membership().values(), [])) == \
            [f"t{s}" for s in range(4)]
        for s, path in enumerate(paths):
            np.testing.assert_array_equal(
                zoo.predict(f"t{s}", X[:4096]),
                CompiledPredictor(path).predict(X[:4096]))
    finally:
        zoo.close()


@pytest.mark.gpu
def test_fleet_of_two_workers_on_card_matches_booster(cuda_device, tmp_path):
    """A 2-worker ``FleetSupervisor`` on the card (each worker its own
    CUDA context, the dispatcher none): /predict through the dispatcher
    answers bitwise as an in-process ``Booster.predict`` on the card,
    and both workers serve."""
    import http.client
    import json
    import os
    from lightgbm_tpu_torch.serve import FleetSupervisor
    X, _, path = _serve_model(tmp_path, 4)
    ref = lt.Booster(model_file=path)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    fleet = FleetSupervisor(
        [path], workers=2, worker_env={"PYTHONPATH": repo},
        probe_interval_s=0.25, startup_timeout_s=180.0,
        run_dir=str(tmp_path / "fleet-run")).start()
    try:
        conn = http.client.HTTPConnection(fleet.host, fleet.port,
                                          timeout=120)
        for n in (1, 64, 4096, 1, 64, 4096):
            conn.request("POST", "/predict",
                         json.dumps({"rows": X[:n].tolist()}),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            body = json.loads(resp.read())
            assert resp.status == 200, body
            np.testing.assert_array_equal(
                np.asarray(body["predictions"], np.float32),
                ref.predict(X[:n]).astype(np.float32))
        conn.request("GET", "/models")
        models = json.loads(conn.getresponse().read())
        assert all(models[w]["model"]["device"].startswith("cuda")
                   for w in ("w0", "w1")), models
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert all(stats[w]["model"]["requests"] > 0
                   for w in ("w0", "w1")), stats
    finally:
        fleet.shutdown()


_DP_WORKER = """
import sys
import numpy as np
import torch
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import lightgbm_tpu_torch as lt
from lightgbm_tpu_torch.ops import histogram_cuda as hc
lt.distributed.init(coordinator_address="127.0.0.1:" + port,
                    num_processes=2, process_id=rank, local_device_ids=[0],
                    backend="gloo")
X, y, params = {data}()
hc.reset_launches()
bst = lt.train(params, lt.Dataset(X, y), 3)
with open(f"{{out}}/dp_{{rank}}.txt", "w") as fh:
    fh.write(bst.model_to_string())
assert hc.LAUNCHES["hist_leaves_q8"] > 0 and hc.LAUNCHES["wave_row_update"] > 0
lt.distributed.shutdown()
"""


def _dp_headline_job():
    """The quantized headline job (255 leaves, 255 bins, round-half-up)
    on 200,000 rows: (X, y, params)."""
    rng = np.random.RandomState(7)
    X = rng.randn(200_000, 28).astype(np.float32)
    z = X[:, 0] * X[:, 3] + np.sin(2 * X[:, 5]) - 0.5 * X[:, 9]
    y = (z + 0.5 * rng.randn(200_000) > 0).astype(np.float32)
    params = dict(objective="binary", num_leaves=255, max_bin=255,
                  verbosity=-1, tree_learner="data", tree_grow_mode="wave",
                  use_quantized_grad=True, stochastic_rounding=False,
                  num_grad_quant_bins=254, quant_train_renew_leaf=True)
    return X, y, params


@pytest.mark.gpu
def test_two_ranks_on_card_match_single_process(cuda_device, tmp_path):
    """Two ranks share the card over gloo (NCCL refuses two ranks on one
    device) and train the quantized headline job data-parallel: their
    text is the single-process card run's (the kernels are built first,
    so the ranks do not race on nvcc)."""
    import os
    import socket
    import subprocess
    import sys
    cuda_lib.build_all()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "rank.py"
    script.write_text(_DP_WORKER.format(
        data="__import__('test_torch_gpu')._dp_headline_job"))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = str(s.getsockname()[1])
    s.close()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [repo, os.path.join(repo, "tests")]))
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port,
                               str(tmp_path)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0].decode())
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("a rank on the card hung")
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    X, y, params = _dp_headline_job()
    single = lt.train(params, lt.Dataset(X, y), 3, device=cuda_device)
    texts = [(tmp_path / f"dp_{r}.txt").read_text() for r in range(2)]
    assert texts[0] == texts[1] == single.model_to_string()
