"""The wave row update and trial channels reading the split columns in
place, held against the JAX package's Pallas kernels (interpret mode).

The port's wrappers take the grower's whole bin matrix, uint8 ``(F, N)``
or nibble-packed ``(F, N/2)``, with each split's feature (``feats=``);
the reference takes the gathered ``(W, N)`` columns, which these tests
gather (and unpack) for the JAX side.  On the CPU the wrappers run their
plain versions, which the CUDA kernel is held against on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).  Integer work: every
result must match bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.ops import histogram_pallas as hp
from lightgbm_tpu_torch.ops import histogram as th
from lightgbm_tpu_torch.ops import histogram_cuda as hc

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

F = 9
N = 8192
LEAVES = 60


def _case(seed, w, num_bins, n_active):
    """Bins (F, N), split features (the inactive ones out of range), the
    rows' leaves and an (8, W) table whose split 1 takes the leaf split 0
    sends rows to (a chained split)."""
    rng = np.random.RandomState(seed)
    bins = rng.randint(0, num_bins, (F, N)).astype(np.uint8)
    feats = rng.randint(0, F, w).astype(np.int32)
    feats[n_active:] = F + 3 + np.arange(w - n_active)
    rl = rng.randint(0, LEAVES, N).astype(np.int32)
    tab = np.stack([
        rng.randint(0, num_bins, w),
        np.where(rng.rand(w) < 0.5, num_bins - 1, -1),
        rng.randint(0, 2, w), rng.randint(0, 2, w),
        rng.choice(LEAVES, w, replace=False), LEAVES + np.arange(w),
        (np.arange(w) < n_active).astype(int),
        np.zeros(w, int)]).astype(np.int32)
    if w > 1:
        tab[4, 1] = tab[5, 0]
    return bins, feats, rl, tab


def _gathered(bins, feats):
    """The reference's (W, N) winning columns (inactive splits read a
    clamped feature; their column is never used)."""
    return bins[np.clip(feats, 0, F - 1)]


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


# (W, num_bins, active splits, packed): packed bins hold at most 16 bins
CASES = [(w, nb, act, packed) for w in (1, 7, 25, 42)
         for nb, act in ((256, None), (16, None), (16, 3))
         for packed in (False, True) if nb <= 16 or not packed]


@pytest.mark.parametrize("w,num_bins,n_active,packed", CASES)
def test_row_update_in_place_matches_reference(w, num_bins, n_active,
                                               packed):
    bins, feats, rl, tab = _case(11 + w, w, num_bins, n_active or w)
    rl_r, ch_r = hp.wave_row_update_pallas(
        jnp.asarray(_gathered(bins, feats)), jnp.asarray(rl),
        jnp.asarray(tab), interpret=True)
    b_in = th.pack_bins4(_t(bins)) if packed else _t(bins)
    rl_t, ch_t = hc.wave_row_update(b_in, _t(rl), _t(tab), feats=_t(feats),
                                    bins_packed=packed)
    np.testing.assert_array_equal(rl_t.numpy(), np.asarray(rl_r))
    np.testing.assert_array_equal(ch_t.numpy(), np.asarray(ch_r))
    if w > 1:   # the chained split caught rows split 0 moved
        assert ((rl == tab[4, 0]) & (np.asarray(ch_r) == 1)).any()


@pytest.mark.parametrize("w,num_bins,n_active,packed", CASES)
def test_trial_channels_in_place_match_reference(w, num_bins, n_active,
                                                 packed):
    bins, feats, rl, tab = _case(29 + w, w, num_bins, n_active or w)
    args = (tab[4], tab[0], tab[1], tab[2].astype(bool),
            tab[3].astype(bool), tab[6].astype(bool))
    ref = hp.wave_trial_channels_pallas(
        jnp.asarray(_gathered(bins, feats)), jnp.asarray(rl),
        *map(jnp.asarray, args), interpret=True)
    b_in = th.pack_bins4(_t(bins)) if packed else _t(bins)
    got = hc.wave_trial_channels(b_in, _t(rl), *map(_t, args),
                                 feats=_t(feats), bins_packed=packed)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_in_place_equals_gathered_form():
    """The in-place call and the reference signature's gathered call give
    the same rows and channels, packed and not."""
    bins, feats, rl, tab = _case(3, 25, 16, 20)
    want = hc.wave_row_update(_t(_gathered(bins, feats)), _t(rl), _t(tab))
    for b_in, packed in ((_t(bins), False), (th.pack_bins4(_t(bins)), True)):
        got = hc.wave_row_update(b_in, _t(rl), _t(tab), feats=_t(feats),
                                 bins_packed=packed)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_row_update_checks_arguments():
    bins = torch.zeros((F, N), dtype=torch.uint8)
    rl = torch.zeros(N, dtype=torch.int32)
    tab = torch.zeros((8, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="one column per split"):
        hc.wave_row_update(bins, rl, tab)            # F columns, 4 splits
    with pytest.raises(TypeError):
        hc.wave_row_update(bins, rl, tab, feats=torch.zeros(4))
    with pytest.raises(ValueError):
        hc.wave_row_update(bins, rl, tab,
                           feats=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):                  # packed is (F, N/2)
        hc.wave_row_update(bins, rl, tab,
                           feats=torch.zeros(4, dtype=torch.int32),
                           bins_packed=True)
    with pytest.raises(ValueError, match="even row count"):
        hc.wave_row_update(bins[:, :N // 2], rl[:N - 1], tab,
                           feats=torch.zeros(4, dtype=torch.int32),
                           bins_packed=True)
