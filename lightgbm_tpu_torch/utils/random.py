"""Deterministic RNG helpers (reference include/LightGBM/utils/random.h —
a seeded LCG used for bagging/feature sampling).  Host-side sampling uses
numpy Generators seeded per (seed, iteration) so results are reproducible
regardless of call order; device-side sampling uses jax.random keys.

Copy of ``lightgbm_tpu/utils/random.py`` (numpy only) kept inside the PyTorch port so
the port never imports the JAX package."""

from __future__ import annotations

import numpy as np


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
