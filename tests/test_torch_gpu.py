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
from lightgbm_tpu_torch.ops import histogram_cuda as hc
from lightgbm_tpu_torch.ops import quantize as tq

F = 6
PLAINS = ("build_histogram_leaves_q8_plain", "build_histogram_leaves_plain",
          "wave_row_update_plain")


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
    w = hc.pack_weights(grad, hess, mask)
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
    assert all(hc.LAUNCHES[k] > before[k] for k in hc.LAUNCHES)
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
