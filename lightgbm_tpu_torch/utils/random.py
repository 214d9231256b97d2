"""Deterministic RNG helpers (reference include/LightGBM/utils/random.h —
a seeded LCG used for bagging/feature sampling).  Host-side sampling uses
numpy Generators seeded per (seed, iteration) so results are reproducible
regardless of call order; device-side sampling draws from the threefry
stream of ``jax.random``, reproduced here bit for bit.

The numpy half is a copy of ``lightgbm_tpu/utils/random.py``.  The device
half (:func:`threefry2x32`, :func:`prng_key`, :func:`host_key`,
:func:`fold_in`, :func:`uniform`) is the counter-based Threefry-2x32 hash
of jax 0.9's default PRNG (``jax/_src/prng.py``: ``threefry_seed``,
``threefry_fold_in`` and the partitionable ``threefry_random_bits``;
``jax/_src/random.py`` ``_uniform``) as integer tensor ops on the draw's
device:

* a key is an int64 tensor of shape (..., 2) holding two uint32 words, so
  one call folds in or draws for a whole batch of keys (a wave's nodes),
  or a host key, a tuple of two Python ints: the per-tree keys are
  folded on the host, so only the draws themselves reach the device;
* uint32 words live in int64 and are masked to 32 bits after every add
  and shift: ``torch.uint32`` has few CUDA kernels, and int64 shifts of a
  non-negative value are logical;
* a draw of shape ``shape`` hashes the flat 64-bit index of every element
  (hi word, lo word) and xors the two output words, so a draw of (n,) is
  the first n values of any longer draw from the same key: row padding
  never moves a value.

Integer ops are exact on every device, so the CPU and the card give the
same bits as ``jax.random`` (``tests/test_torch_rng.py``).
"""

from __future__ import annotations

import numpy as np
import torch


def host_rng(seed: int, stream: int = 0,
             model: int = 0) -> np.random.Generator:
    """Philox generator keyed on (seed, stream[, model]).

    ``model`` joins the key as an independent Philox key word so a
    multi-model training batch (lightgbm_tpu/multitrain/) can derive
    decorrelated per-model streams from one base seed as a PURE function
    of (seed, stream, model) — no sequential state.  ``model=0`` keys the
    generator exactly like the historical 1-word form (Philox pads the
    key with zero words), so every existing single-model stream — and a
    ``train_many`` batch of one — is bit-identical to before."""
    key = (seed & 0xFFFFFFFF) + (stream << 32)
    return np.random.Generator(np.random.Philox(
        key=key if model == 0 else (key, model)))


def model_stream_seed(seed: int, model: int) -> int:
    """Derive a per-model 32-bit seed from a base seed as a pure function
    of (seed, model) — used by ``train_many(replicas=M)`` to materialize
    per-model bagging/quantization seeds INTO the variant params, so the
    standalone counterpart ``train(params_m)`` reproduces model m
    bit-for-bit.  Model 0 keeps the base seed."""
    if model == 0:
        return int(seed)
    return int(host_rng(seed, stream=0x5EED, model=model)
               .integers(0, 1 << 31))


def sample_indices(n: int, k: int, seed: int, stream: int = 0) -> np.ndarray:
    """Sample k of n indices without replacement, sorted (reference
    Random::Sample used by bagging/feature_fraction)."""
    rng = host_rng(seed, stream)
    if k >= n:
        return np.arange(n, dtype=np.int32)
    return np.sort(rng.choice(n, size=k, replace=False)).astype(np.int32)


# Seeds whose derived streams are part of the training trajectory: every
# sampler above (and the jax.random fold_in sites in models/gbdt.py /
# boosting.py) keys its generator on (one of these seeds, iteration), so
# a checkpoint needs no opaque generator blobs — the seeds plus the
# iteration counter ARE the RNG state, and restoring them reproduces the
# bagging / feature-fraction / extra-trees / dropout / quantization
# streams bit-for-bit.
CHECKPOINT_SEED_KEYS = ("seed", "bagging_seed", "feature_fraction_seed",
                       "extra_seed", "drop_seed")


def rng_checkpoint_state(config) -> dict:
    """The RNG state a checkpoint must carry (see CHECKPOINT_SEED_KEYS).

    Checked — not merely recorded — on resume: a changed seed silently
    forks the sampling trajectory, so restore fails loudly instead."""
    return {k: int(getattr(config, k)) for k in CHECKPOINT_SEED_KEYS}


# -- threefry2x32 on torch tensors -----------------------------------------

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) of the counter words (x1, x2)
    under the key words (k1, k2): int64 tensors holding uint32 values, or
    Python ints, broadcast together.  Returns the two output words (jax
    ``_threefry2x32_lowering``)."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    a = (x1 + ks[0]) & _M32
    b = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & _M32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & _M32
        b = (b + (ks[(i + 2) % 3] + (i + 1))) & _M32
    return a, b


def _check_seed(seed) -> int:
    seed = int(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError(f"seed {seed} does not fit in int64")
    return seed & _M32


def prng_key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as a (2,) int64 tensor: the words
    (seed >> 32, seed & 0xFFFFFFFF) of the seed as jax sees it.  With
    jax's default 32-bit integers the high word is 0 and a seed is taken
    modulo 2^32 (-1 -> 0xFFFFFFFF, 2^32 + 5 -> 5); a seed outside the
    int64 range raises OverflowError, as jax does."""
    return torch.tensor([0, _check_seed(seed)], dtype=torch.int64,
                        device=device)


def host_key(seed: int) -> tuple:
    """:func:`prng_key` as a host key, a tuple of two Python ints.
    Folding an int into a host key runs on the host and costs the device
    nothing; the growers' per-tree keys are host keys."""
    return (0, _check_seed(seed))


def fold_in(key, data):
    """``jax.random.fold_in(key, data)``.  ``key`` is a host key (a tuple
    of two ints) or a batch of keys (..., 2) in an int64 tensor; ``data``
    an int in [0, 2^32) or an integer tensor broadcasting against
    ``key[..., 0]`` (one datum per key).  Returns the keys
    ``threefry2x32(key, (0, data))``: a host key for a host key and an int,
    else a (..., 2) tensor on the tensor's device."""
    if isinstance(data, torch.Tensor):
        d = data.to(dtype=torch.int64) & _M32
    else:
        d = int(data)
        if not 0 <= d <= _M32:
            raise OverflowError(f"fold_in data {d} is out of bounds for "
                                "uint32")
    if isinstance(key, tuple):
        a, b = threefry2x32(key[0], key[1], 0, d)
        if not isinstance(d, torch.Tensor):
            return (a, b)
    else:
        if not isinstance(d, torch.Tensor):
            d = torch.full((), d, dtype=torch.int64, device=key.device)
        d = d.to(key.device)
        a, b = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (f32 in [0, 1)) for a host key,
    drawn on ``device``, or for a batch of keys (..., 2) in a tensor,
    drawn on its device: returns (..., *shape).  The mantissa is the top
    23 bits of ``bits1 ^ bits2`` under an exponent of 1, minus 1.0."""
    shape = tuple(int(s) for s in (shape if isinstance(shape, (tuple, list))
                                   else (shape,)))
    count = 1
    for s in shape:
        count *= s
    if isinstance(key, tuple):
        k1, k2, lead = key[0], key[1], ()
    else:
        device = key.device
        k1, k2 = key[..., 0].unsqueeze(-1), key[..., 1].unsqueeze(-1)
        lead = tuple(key.shape[:-1])
    idx = torch.arange(count, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(k1, k2, idx >> 32, idx & _M32)
    bits = (b1 ^ b2) >> 9 | 0x3F800000
    out = bits.to(torch.int32).view(torch.float32) - 1.0
    return out.reshape(lead + shape)
