"""The PyTorch port's partitioned grower held against the JAX package.

``lightgbm_tpu_torch.learner.partitioned`` and
``lightgbm_tpu.learner.partitioned`` grow one tree from the same seeded
numpy inputs; the JAX side runs its single-leaf Pallas kernel in
interpret mode.  The same tree structure and the same ``row_leaf`` are
required; values agree within rtol=1e-5 (the reference sums bf16 hi+lo
weights in f32, the port 64-bit fixed point).

The rest is the port of ``tests/test_partition_chunks.py``: walking the
recorded tree must reproduce ``row_leaf`` exactly, and leaf counts must
equal the partition's in-bag row counts, here at a size where leaf
segments hold thousands of rows.  The port keeps no chunk constants, so
the reference's multi-chunk cross-check becomes a row-order one: the same
rows in another order grow the same tree.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.learner.partitioned import \
    make_partitioned_grow_fn as jax_grow_fn
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.learner.partitioned import make_partitioned_grow_fn
from lightgbm_tpu_torch.models.tree import DEFAULT_LEFT_MASK
from lightgbm_tpu_torch.ops import split as ts

# many small tensor ops per test and several test processes: one
# intra-op thread each (faster than a pool per process here)
torch.set_num_threads(1)

F = 5
N = 8192


def _t(a):
    return torch.from_numpy(np.array(a, order="C", copy=True))


def _inputs(seed=0, n=N, nb=32, nan_feature=True):
    rng = np.random.RandomState(seed)
    X = rng.randint(0, nb - 1, (n, F)).astype(np.uint8)
    if nan_feature:   # feature 4 carries a NaN bin (its last bin)
        X[rng.rand(n) < 0.1, 4] = nb - 1
    logit = (X[:, 0] / nb - 0.5) * 3 + (X[:, 1] > 20) - 0.5 + \
        (X[:, 4] == nb - 1) * 0.8
    y = (logit + rng.randn(n) * 0.5 > 0).astype(np.float32)
    grad = (0.5 - y + 0.1 * rng.randn(n)).astype(np.float32)
    hess = (0.2 + 0.05 * rng.rand(n)).astype(np.float32)
    return X, grad, hess


def _port_grow(X, grad, hess, mask, nb, leaves, max_depth=-1, min_data=5):
    sp = ts.SplitParams(min_data_in_leaf=min_data, any_cat=False)
    grow = make_partitioned_grow_fn(num_leaves=leaves, num_features=F,
                                    max_bins=nb, max_depth=max_depth,
                                    split_params=sp)
    has_nan = torch.zeros(F, dtype=torch.bool)
    has_nan[4] = True
    return grow(_t(X), _t(grad), _t(hess), _t(mask),
                torch.full((F,), nb, dtype=torch.int32), has_nan,
                torch.ones(F, dtype=torch.bool))


@pytest.mark.parametrize("leaves,max_depth,bagged", [(12, -1, False),
                                                     (9, 3, True)])
def test_partitioned_tree_matches_jax_grower(leaves, max_depth, bagged):
    nb = 32
    X, grad, hess = _inputs()
    rng = np.random.RandomState(1)
    mask = ((rng.rand(N) < 0.7) if bagged else np.ones(N)).astype(np.float32)
    has_nan = np.zeros(F, bool)
    has_nan[4] = True
    sp_ref = js.SplitParams(min_data_in_leaf=5, any_cat=False)
    ref = jax_grow_fn(num_leaves=leaves, num_features=F, max_bins=nb,
                      max_depth=max_depth, split_params=sp_ref,
                      hist_impl="pallas", interpret=True)(
        jnp.asarray(X), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(mask), jnp.full((F,), nb, jnp.int32),
        jnp.zeros((F,), bool), jnp.asarray(has_nan),
        jnp.zeros((F,), jnp.int32), jnp.zeros((F,), jnp.float32),
        jnp.zeros((2, 2), jnp.uint32), (), jnp.ones((F,), bool))
    got = _port_grow(X, grad, hess, mask, nb, leaves, max_depth)
    assert got.num_leaves == int(ref.num_leaves)
    assert got.hist_passes == int(ref.hist_passes) == 0
    for name in ("split_feature", "threshold_bin", "nan_bin",
                 "decision_type", "left_child", "right_child", "row_leaf",
                 "leaf_count", "internal_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    for name in ("leaf_value", "leaf_weight", "internal_value",
                 "internal_weight", "split_gain"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    # one read of the best leaf and one of the left count per split, the
    # read that stops growth, and pack_weights' two maxima
    splits = got.num_leaves - 1
    assert got.host_syncs == 2 + 2 * splits + (splits < leaves - 1)


def _walk_all(X, g):
    sf = g.split_feature.numpy()
    tb = g.threshold_bin.numpy()
    nanb = g.nan_bin.numpy()
    dl = (g.decision_type.numpy() & DEFAULT_LEFT_MASK) != 0
    lch = g.left_child.numpy()
    rch = g.right_child.numpy()

    def walk(row):
        node = 0
        while True:
            b = row[sf[node]]
            left = dl[node] if b == nanb[node] else b <= tb[node]
            nxt = lch[node] if left else rch[node]
            if nxt < 0:
                return -nxt - 1
            node = nxt

    return np.array([walk(r) for r in X])


def test_partition_matches_tree_walk():
    n = 20000
    X, grad, hess = _inputs(seed=2, n=n, nb=16)
    g = _port_grow(X, grad, hess, np.ones(n, np.float32), 16, leaves=10)
    rl = g.row_leaf.numpy()
    assert (g.nan_bin.numpy()[:g.num_leaves - 1] >= 0).any()  # NaN routed
    np.testing.assert_array_equal(_walk_all(X, g), rl)
    # leaf_count (from histogram sums) must equal the actual partition
    cnt = collections.Counter(rl.tolist())
    lc = g.leaf_count.numpy()
    assert g.num_leaves == 10
    for leaf, c in cnt.items():
        assert abs(lc[leaf] - c) <= 0.5


def test_partition_with_bagging():
    n = 20000
    X, grad, hess = _inputs(seed=3, n=n, nb=16)
    bag = (np.random.RandomState(3).rand(n) < 0.7).astype(np.float32)
    g = _port_grow(X, grad, hess, bag, 16, leaves=10)
    rl = g.row_leaf.numpy()
    np.testing.assert_array_equal(_walk_all(X, g), rl)
    # in-bag counts per leaf match the histogram counts
    lc = g.leaf_count.numpy()
    for leaf in range(g.num_leaves):
        assert abs(float(bag[rl == leaf].sum()) - lc[leaf]) <= 0.5


def test_partition_is_row_order_free():
    """The same rows in another order grow the same tree, with every row
    in the same leaf: segment layout does not leak into growth."""
    n = 20000
    X, grad, hess = _inputs(seed=4, n=n, nb=16)
    perm = np.random.RandomState(4).permutation(n)
    ones = np.ones(n, np.float32)
    a = _port_grow(X, grad, hess, ones, 16, leaves=12)
    b = _port_grow(X[perm], grad[perm], hess[perm], ones, 16, leaves=12)
    for name in ("split_feature", "threshold_bin", "left_child",
                 "right_child", "leaf_value", "leaf_weight", "split_gain"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    np.testing.assert_array_equal(a.row_leaf.numpy()[perm],
                                  b.row_leaf.numpy())


@pytest.mark.parametrize("delta", [-1, 0, 1])
@pytest.mark.parametrize("leaves,features,bins", [(255, 28, 256),
                                                  (31, 6, 64)])
def test_pool_budget_picks_the_reference_grower(leaves, features, bins,
                                                delta):
    """``hist_pool_fits`` decides as the reference's does at the
    ``histogram_pool_size`` budget and one leaf beside it (the budget
    counts the reference's f32 pool); ``pool_bytes`` is what the port
    really holds: int64 sums on the partitioned grower, twice the f32
    bytes."""
    from lightgbm_tpu.config import Config as JConfig
    from lightgbm_tpu.learner.serial import hist_pool_fits as ref_fits
    from lightgbm_tpu_torch.config import Config
    from lightgbm_tpu_torch.learner.serial import hist_pool_fits, pool_bytes
    f32_pool = leaves * features * bins * 3 * 4
    mb = f32_pool / (1 << 20)            # the budget sits at the pool
    params = dict(num_leaves=leaves + delta, histogram_pool_size=mb)
    cfg, jcfg = Config(params), JConfig(params)
    assert hist_pool_fits(cfg, features, bins) == \
        ref_fits(jcfg, features, bins) == (delta <= 0)
    assert pool_bytes(cfg, features, bins, "partition") == \
        2 * pool_bytes(cfg, features, bins, "wave") == \
        2 * (leaves + delta) * features * bins * 3 * 4
