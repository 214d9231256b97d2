#!/usr/bin/env python3
"""Per-bin gains of the W = 2 smoothing + monotone case, port against the
JAX package (the strict ``xfail`` of tests/test_torch_options.py
``test_smoothing_combined_within_fma_rounding[monotone_w2]``).

    JAX_PLATFORMS=cpu python scripts/torch_w2_smoothing_dump.py

1. Trains the test's configuration (31 leaves, W = 2, path smoothing,
   basic monotone bounds, quantized, 3 rounds) in both packages and
   prints every split gain that differs.
2. Captures the port's children scan that makes the first differing
   node and runs the reference's jitted scan (single leaf, and vmapped
   over the 2W children) on the same inputs.
3. Runs a copy of the reference's scan that also returns its per-bin
   NaN-right and NaN-left gain planes, and counts how many per-bin gains
   of the port's scan differ from them with each smoothing blend of the
   NaN-left direction ("own", the port's, and "parent").
4. Trains the port again with the NaN-left blend switched to "parent"
   and prints the gains that differ then.
5. Runs that copy vmapped over the 2W children in one jit, as the
   grower's children scan is, and classifies each NaN-left gain where
   the two blends differ by which blend the reference's value matches,
   against its flat index (child, feature, bin) in the fused loop: the
   vector body against the scalar remainder, and the lane, for vectors
   of 4, 8 and 16 floats.

Runs on the CPU in a minute or two; imports both packages, like the
tests.
"""

import importlib.util
import os
import sys
import tempfile

import numpy as np
import torch

import jax
import jax.numpy as jnp
import lightgbm_tpu as lgb
import lightgbm_tpu_torch as lt
from lightgbm_tpu.learner.serial import local_best_candidate
from lightgbm_tpu.ops import split as js
from lightgbm_tpu_torch.learner import wave as tw
from lightgbm_tpu_torch.ops import split as ts

torch.set_num_threads(1)

N, F = 3000, 6
MONO = [1, -1, 0, 1, 0, 0]
PARAMS = dict(objective="binary", num_leaves=31, max_bin=63, verbosity=-1,
              tpu_histogram_impl="pallas", tree_grow_mode="wave",
              use_quantized_grad=True, stochastic_rounding=False,
              path_smooth=2.0, monotone_constraints=MONO, tpu_wave_size=2)


def data():
    rng = np.random.RandomState(0)
    X = rng.randn(N, F)
    X[rng.rand(N, F) < 0.05] = np.nan
    x0, x1 = np.nan_to_num(X[:, 0]), np.nan_to_num(X[:, 1])
    y = (x0 + x1 ** 2 + 0.5 * np.nan_to_num(X[:, 3]) + 0.3 * rng.randn(N)
         > 0.8).astype(float)
    return X, y


def gains(text):
    return [b.split("split_gain=")[1].split("\n")[0].split()
            for b in text.split("Tree=")[1:]]


def diff(ref_text, port_text):
    out = []
    for t, (a, b) in enumerate(zip(gains(ref_text), gains(port_text))):
        out += [(t, j, u, v) for j, (u, v) in enumerate(zip(a, b)) if u != v]
    return out


def reference_planes_module():
    """The reference's split.py with ``_best_split_impl`` returning its
    (F, B) NaN-right and NaN-left gain planes, loaded from a temp file."""
    src = open(js.__file__).read()
    end = "    gain_l = jnp.where(hn_f, gain_l, NEG_INF)\n"
    i = src.index(end) + len(end)
    src = src[:i] + "    return gain_r, gain_l\n" + src[i:]
    src = src.replace("from ..", "from lightgbm_tpu.").replace(
        "from .", "from lightgbm_tpu.ops.")
    path = os.path.join(tempfile.mkdtemp(), "ref_split_planes.py")
    with open(path, "w") as fh:
        fh.write(src)
    spec = importlib.util.spec_from_file_location("ref_split_planes", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def with_left_blend(blend):
    """Patch the port's pair gain so the NaN-left direction blends with
    ``blend`` (the port passes "own" only there); returns the undo."""
    orig = ts._pair_gain_fn

    def patched(params, po, mn, mx):
        pair = orig(params, po, mn, mx)

        def pair_gain(lg, lh, lc, rg, rh, rc, l2, blend_fused="parent",
                      gain_fused="linear"):
            if blend_fused == "own":
                blend_fused = blend
            return pair(lg, lh, lc, rg, rh, rc, l2, blend_fused, gain_fused)
        return pair_gain
    ts._pair_gain_fn = patched
    return lambda: setattr(ts, "_pair_gain_fn", orig)


def main():
    X, y = data()
    ref_text = lgb.train(PARAMS, lgb.Dataset(X, y), 3).model_to_string()
    calls = []
    real = tw.local_best_candidates

    def record(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out
    tw.local_best_candidates = record
    try:
        port_text = lt.train(PARAMS, lt.Dataset(X, y), 3,
                             device="cpu").model_to_string()
    finally:
        tw.local_best_candidates = real
    d = diff(ref_text, port_text)
    print("split gains apart (tree, node, reference, port):")
    for row in d:
        print("  ", row)
    t, j, _, port_gain = d[0]
    hit = [c for c in calls
           if np.any(c[2][0].numpy() == np.float32(float(port_gain)))]
    (hist, sums, nb, hn, fms, sp_t, *_), k, out = hit[-1]
    c = int(np.nonzero(out[0].numpy() == np.float32(float(port_gain)))[0][0])
    sp = js.SplitParams(**{f: getattr(sp_t, f) for f in js.SplitParams._fields
                           if hasattr(sp_t, f)})
    J = lambda a: jnp.asarray(np.asarray(a))   # noqa: E731
    ic = jnp.zeros((F,), bool)

    def one(h, s_, bnd, dep, po, fm_):
        return local_best_candidate(h, s_, J(nb), ic, J(hn), fm_, sp,
                                    J(k["monotone"]), bnd, dep, None, None,
                                    po)
    ref = jax.jit(jax.vmap(one))(J(hist), J(sums), J(k["bound"]),
                                 J(k["depth"]), J(k["parent_out"]), J(fms))
    print(f"children scan of node {j} of tree {t} (child {c} of "
          f"{hist.shape[0]}): port gains {out[0].numpy()}, default left "
          f"{out[3].numpy()}; the reference's jitted scan on the same "
          f"inputs {np.asarray(ref[0])}, default left {np.asarray(ref[3])}")

    planes = reference_planes_module()
    fn = jax.jit(planes._best_split_impl, static_argnums=(5,))
    spp = planes.SplitParams(**sp._asdict())
    ref_planes = []
    for ci in range(hist.shape[0]):
        ref_planes.append([np.asarray(p) for p in fn(
            J(hist[ci]), J(sums[ci]), J(nb), ic, J(hn), spp,
            J(k["monotone"]), J(k["bound"][ci]), J(k["depth"][ci]), None,
            None, J(k["parent_out"][ci]))])
    gr, gl = ref_planes[c]
    print(f"reference planes at child {c}, feature {int(out[1][c])}, bin "
          f"{int(out[2][c])}: NaN-right {gr[out[1][c], out[2][c]]:.9g}, "
          f"NaN-left {gl[out[1][c], out[2][c]]:.9g}")
    classify_left_blend(planes, hist, sums, nb, hn, sp, sp_t, k)
    for blend in ("own", "parent"):
        undo = with_left_blend(blend)
        try:
            apart = 0
            for ci in range(hist.shape[0]):
                pr, pl = ts_planes(hist[ci], sums[ci], nb, hn, sp_t, k, ci)
                apart += int((pr != ref_planes[ci][0]).sum() +
                             (pl != ref_planes[ci][1]).sum())
            text = lt.train(PARAMS, lt.Dataset(X, y), 3,
                            device="cpu").model_to_string()
        finally:
            undo()
        print(f'NaN-left blend "{blend}": {apart} per-bin gains of the '
              f"{2 * hist.shape[0] * hist.shape[1] * hist.shape[2]} apart "
              f"from the reference's planes; split gains apart in the "
              f"grower: {diff(ref_text, text)}")


def classify_left_blend(planes, hist, sums, nb, hn, sp, sp_t, k):
    """Step 5: the reference's NaN-left planes from one vmapped jit over
    the children, against the port's under each blend."""
    J = lambda a: jnp.asarray(np.asarray(a))   # noqa: E731
    ic = jnp.zeros((F,), bool)
    spp = planes.SplitParams(**sp._asdict())

    def one(h, s_, bnd, dep, po):
        return planes._best_split_impl(h, s_, J(nb), ic, J(hn), spp,
                                       J(k["monotone"]), bnd, dep, None,
                                       None, po)
    _, ref_l = jax.jit(jax.vmap(one))(J(hist), J(sums), J(k["bound"]),
                                      J(k["depth"]), J(k["parent_out"]))
    ref_l = np.asarray(ref_l)
    port = {}
    for blend in ("own", "parent"):
        undo = with_left_blend(blend)
        try:
            port[blend] = np.stack([ts_planes(hist[ci], sums[ci], nb, hn,
                                              sp_t, k, ci)[1]
                                    for ci in range(hist.shape[0])])
        finally:
            undo()
    differ = port["own"] != port["parent"]
    own = differ & (ref_l == port["own"])
    par = differ & (ref_l == port["parent"])
    other = differ & ~own & ~par
    same_apart = int(((ref_l != port["own"]) & ~differ).sum())
    flat = np.arange(ref_l.size).reshape(ref_l.shape)
    print(f"step 5, one vmapped jit over {hist.shape[0]} children "
          f"({ref_l.size} NaN-left gains): the blends differ at "
          f"{int(differ.sum())}; the reference matches own at "
          f"{int(own.sum())}, parent at {int(par.sum())}, neither at "
          f"{int(other.sum())}; {same_apart} apart where the blends agree")
    for name, sel in (("own", own), ("parent", par)):
        idx = flat[sel]
        print(f"  {name}: (child, feature, bin) "
              f"{[tuple(int(v) for v in np.unravel_index(i, ref_l.shape)) for i in idx[:24]]}")
        for v in (4, 8, 16):
            body = ref_l.size // v * v
            for axis_len, axis_name in ((ref_l.size, "flat"),
                                        (ref_l.shape[-1], "bin")):
                pos = idx if axis_name == "flat" else idx % axis_len
                tail = int((pos >= (axis_len // v * v)).sum())
                lanes = np.bincount(pos % v, minlength=v)
                print(f"    vectors of {v}, by {axis_name} index: "
                      f"{tail} in the remainder past {axis_len // v * v} "
                      f"(of {axis_len}); per lane {lanes.tolist()}")
            del body
    return own, par


def ts_planes(h, s_, nb, hn, sp_t, k, ci):
    """The port scan's (F, B) NaN-right and NaN-left gain planes: its
    ``best_split_per_feature`` with ``torch.argmax`` recording them."""
    seen = []
    orig = torch.argmax

    def spy(x, dim=None, **kw):
        if dim == -1 and x.dim() == 2:
            seen.append(x.numpy().copy())
        return orig(x, dim=dim, **kw)
    torch.argmax = spy
    try:
        T = lambda a: torch.as_tensor(np.asarray(a))   # noqa: E731
        ts.best_split_per_feature(
            T(h), T(s_), T(nb), T(hn), sp_t, monotone=T(k["monotone"]),
            bound=T(k["bound"][ci]), depth=T(k["depth"][ci]),
            parent_out=T(k["parent_out"][ci]))
    finally:
        torch.argmax = orig
    return seen[0], seen[1]


if __name__ == "__main__":
    sys.exit(main())
