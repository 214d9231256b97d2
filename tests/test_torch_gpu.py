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
