"""Dispatch of the port's kernel wrappers by tensor device.

A CPU tensor takes the plain PyTorch version and never loads the CUDA
library; a CUDA tensor launches the hand-written kernel and never calls
the plain version.  The tests marked ``gpu`` need the card and skip
elsewhere; this file imports neither ``jax`` nor ``lightgbm_tpu``, so it
runs on the card as it is:

    python -m pytest -m gpu --noconftest tests/test_torch_gpu.py
"""

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
