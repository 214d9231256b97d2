"""The port's threefry stream (``lightgbm_tpu_torch/utils/random.py``)
held bit for bit against ``jax.random`` (jax's default threefry2x32
implementation with ``jax_threefry_partitionable``).

``prng_key``, ``fold_in`` and ``uniform`` must give jax's bits for the
seeds the reference's ``Config`` accepts (negative and >= 2^31 included),
for the fold-in data the growers use, and for every draw shape the port
makes: one tree's rows, a wave's (W, F) node draws, a ranking (Q, M)
gamma draw.  A draw of n values is the first n of any longer draw from the
same key, so the port's row padding moves no value.
"""

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from lightgbm_tpu_torch.utils.random import (fold_in, host_key, prng_key,
                                             threefry2x32, uniform)

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

SEEDS = [0, 1, 42, 2 ** 31 - 1, -1, -5, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5,
         2 ** 40, -2 ** 31 - 1, 2 ** 63 - 1]
DATA = [0, 1, 7, 2 ** 31]
SHAPES = [(1,), (7,), (4097,), (5, 28), (13, 24)]


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32).astype(np.int64)


def _jkey(seed, *data):
    k = jax.random.PRNGKey(seed)
    for d in data:
        k = jax.random.fold_in(k, d)
    return k


def _tkey(seed, *data):
    k = prng_key(seed)
    for d in data:
        k = fold_in(k, d)
    return k


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches_jax(seed):
    np.testing.assert_array_equal(prng_key(seed).numpy(),
                                  _bits(jax.random.PRNGKey(seed)))


def test_prng_key_overflow_like_jax():
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(2 ** 64 - 1)
    with pytest.raises(OverflowError):
        prng_key(2 ** 64 - 1)


@pytest.mark.parametrize("seed", [0, 42, 2 ** 31 - 1, -1])
@pytest.mark.parametrize("data", DATA)
def test_fold_in_matches_jax(seed, data):
    np.testing.assert_array_equal(_tkey(seed, data).numpy(),
                                  _bits(_jkey(seed, data)))


def test_fold_in_refuses_data_outside_uint32():
    with pytest.raises(OverflowError):
        fold_in(prng_key(0), -1)
    with pytest.raises(OverflowError):
        fold_in(prng_key(0), 2 ** 32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed,data", [(0, 0), (42, 1), (7, 2 ** 31)])
def test_uniform_matches_jax(shape, seed, data):
    got = uniform(_tkey(seed, data), shape)
    want = jax.random.uniform(_jkey(seed, data), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_uniform_large_draw_matches_jax():
    """2^20 + 3 values: past a power of two, one tree's rows."""
    n = 2 ** 20 + 3
    got = uniform(_tkey(3, 1), (n,))
    want = jax.random.uniform(_jkey(3, 1), (n,))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))


def test_uniform_prefix_property():
    """uniform(k, (n,)) is the head of uniform(k, (m,)) for m > n, in jax
    and in the port: the port's row padding moves no draw."""
    k = _tkey(11, 5)
    short, long_ = uniform(k, (10,)), uniform(k, (4096 * 3,))
    np.testing.assert_array_equal(short.numpy(), long_[:10].numpy())
    jk = _jkey(11, 5)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(jk, (10,))),
        np.asarray(jax.random.uniform(jk, (13,)))[:10])


def test_batched_keys_match_one_key_at_a_time():
    """One call over a wave's node ids equals jax's per-node draws (the
    reference vmaps ``uniform(fold_in(key, id), (F,))``)."""
    ids = torch.tensor([2 * 255, 0, 1, 6, 7, 40, 41])
    base = prng_key(9)
    got = uniform(fold_in(base, ids), (28,))
    assert tuple(got.shape) == (7, 28)
    jbase = jax.random.PRNGKey(9)
    for i, node in enumerate(ids.tolist()):
        want = jax.random.uniform(jax.random.fold_in(jbase, node), (28,))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 42, -1, 2 ** 32 + 5])
def test_host_keys_match_device_keys(seed):
    """A host key (two Python ints: the growers' per-tree keys, folded
    without a device op) gives the device key's bits at every step."""
    hk, dk = host_key(seed), prng_key(seed)
    assert list(hk) == dk.tolist()
    for d in (3, 2 ** 31):
        hk, dk = fold_in(hk, d), fold_in(dk, d)
        assert isinstance(hk, tuple) and list(hk) == dk.tolist()
    np.testing.assert_array_equal(uniform(hk, (4097,), "cpu").numpy(),
                                  uniform(dk, (4097,)).numpy())
    ids = torch.tensor([0, 5, 510])
    np.testing.assert_array_equal(fold_in(hk, ids).numpy(),
                                  fold_in(dk, ids).numpy())
    with pytest.raises(OverflowError):
        host_key(2 ** 64)


def test_threefry_known_answer():
    """The Threefry-2x32 (20 rounds) known-answer vector of the Random123
    suite, which jax's own tests check too: key (0x13198a2e, 0x03707344),
    counter (0x243f6a88, 0x85a308d3)."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)
    a, b = threefry2x32(t(0x13198A2E), t(0x03707344), t(0x243F6A88),
                        t(0x85A308D3))
    assert (int(a), int(b)) == (0xC4923A9C, 0x483DF7A0)


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(-2 ** 63, 2 ** 63 - 1),
       data=st.integers(0, 2 ** 32 - 1), n=st.integers(1, 300))
def test_stream_matches_jax_property(seed, data, n):
    got = uniform(_tkey(seed, data), (n,))
    want = jax.random.uniform(_jkey(seed, data), (n,))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want).view(np.uint32))
