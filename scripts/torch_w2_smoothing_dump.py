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
6. Taps every scan site of the reference's wave grower: a copy of the
   JAX package in a temporary directory, whose ``ops/split.py`` hands
   each scan's inputs and (F, B) NaN-right and NaN-left gain planes to a
   host callback (``jax.debug.callback``) and keys its jitted scan by
   the site, and whose ``learner/wave.py`` names the site (its line in
   the original file) before each scan.  A subprocess trains the test's
   configuration with that copy; its model text must equal the
   reference's (the taps change no rounding).  Each tapped scan is then
   run through the port's scan with each NaN-left blend on the same
   inputs, and the NaN-left gains where the blends differ are
   classified per site by which blend the reference's value matches;
   every product choice of the NaN-left gain (blend x the children's
   gain) is counted against the reference's finite NaN-left gains, and
   every choice of the port's recompute of the chosen bins' NaN-left
   gains (blend x children's gain x the parent gain of the shift)
   against the reference's gathered values there, by feature.  (The
   taps are unordered callbacks: a scan's place in its vmapped batch is
   not known.)  Last, the port trains with the children scans' square
   rule at W = 2 too and prints the split gains still apart.

Runs on the CPU in a few minutes; imports both packages, like the
tests:

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/torch_w2_smoothing_dump.py
"""

import importlib.util
import os
import pickle
import shutil
import subprocess
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


def with_left_blend(blend, gain=None):
    """Patch the port's pair gain so the NaN-left direction blends with
    ``blend`` (the port passes "own" only there) and, with ``gain``,
    fuses that product of its children's gains; returns the undo."""
    orig = ts._pair_gain_fn

    def patched(params, po, mn, mx):
        pair = orig(params, po, mn, mx)

        def pair_gain(lg, lh, lc, rg, rh, rc, l2, blend_fused="parent",
                      gain_fused="linear"):
            if blend_fused == "own":
                blend_fused = blend
                gain_fused = gain or gain_fused
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
    classify_sites(ref_text, sp_t)


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


_TAP_SPLIT = """

# -- scan taps (scripts/torch_w2_smoothing_dump.py step 6) --
import numpy as _np_tap
_SITE = [None]
TAPS = []


def _set_site(site):
    _SITE[0] = site


def _tap_host(site, *xs):
    TAPS.append((site, [_np_tap.asarray(x) for x in xs]))


def _tap(*xs):
    xs = [jnp.zeros((0,), jnp.float32) if x is None else x for x in xs]
    jax.debug.callback(functools.partial(_tap_host, _SITE[0]), *xs)


def _best_split_site(hist, parent_sum, num_bins, is_cat, has_nan, params,
                     monotone, bound, depth, cegb_penalty, gain_scale,
                     parent_out, rand_bins, site):
    return _best_split_impl(hist, parent_sum, num_bins, is_cat, has_nan,
                            params, monotone, bound, depth, cegb_penalty,
                            gain_scale, parent_out, rand_bins)


_best_split_jit = functools.partial(
    jax.jit, static_argnames=("params", "site"))(_best_split_site)
"""


def tapped_copy(root):
    """The JAX package copied under ``root`` with the scan taps of step
    6; returns the number of wave.py scan sites named."""
    src = os.path.dirname(lgb.__file__)
    dst = os.path.join(root, "lightgbm_tpu")
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("__pycache__"))
    path = os.path.join(dst, "ops", "split.py")
    text = open(path).read()
    end = "    use_left = best_l_gain > best_r_gain\n"
    text = text.replace(end, end + "    _tap(hist, parent_sum, num_bins, "
                        "has_nan, monotone, bound, depth, parent_out, "
                        "gain_r, gain_l, best_l_bin, best_l_gain, "
                        "best_r_gain)\n", 1)
    text = text.replace("gain_scale, parent_out, rand_bins)\n    return "
                        "_best_split_impl", "gain_scale, parent_out, "
                        "rand_bins, site=_SITE[0])\n    return "
                        "_best_split_impl", 1)
    open(path, "w").write(text + _TAP_SPLIT)
    path = os.path.join(dst, "learner", "wave.py")
    lines = open(path).read().split("\n")
    named = 0
    for i, ln in enumerate(lines):
        if "many_candidates(" in ln and "def many_candidates" not in ln:
            lines[i] = ln.replace("many_candidates(",
                                  f"(_split_tap_site('wave.py:{i + 1}') or "
                                  "many_candidates)(", 1)
            named += 1
        elif "cand = strat.leaf_candidates(" in ln:
            lines[i] = ln.replace("strat.leaf_candidates(",
                                  f"(_split_tap_site('wave.py:{i + 1} root')"
                                  " or strat.leaf_candidates)(", 1)
            named += 1
    text = "\n".join(lines).replace(
        "from .serial import CommStrategy, GrownTree, local_best_candidate\n",
        "from .serial import CommStrategy, GrownTree, local_best_candidate\n"
        "from ..ops.split import _set_site as _split_tap_site\n", 1)
    open(path, "w").write(text)
    return named


def tap_child(out):
    """Step 6's subprocess: train with the tapped copy (first on the
    path), pickle the model text and the taps."""
    from lightgbm_tpu.ops import split as tapped
    X, y = data()
    text = lgb.train(PARAMS, lgb.Dataset(X, y), 3).model_to_string()
    with open(out, "wb") as fh:
        pickle.dump((text, tapped.TAPS), fh)


def classify_sites(ref_text, sp_t):
    """Step 6 (see the head of this file)."""
    root = tempfile.mkdtemp()
    named = tapped_copy(root)
    out = os.path.join(root, "taps.pkl")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]))
    subprocess.run([sys.executable, os.path.abspath(__file__), "--tap-child",
                    out], env=env, check=True)
    with open(out, "rb") as fh:
        text, taps = pickle.load(fh)
    print(f"step 6: {named} scan sites named in the copy's wave.py; "
          f"{len(taps)} scans tapped; the tapped copy's text "
          f"{'equals' if text == ref_text else 'DIFFERS FROM'} the "
          f"reference's")
    sites = {}
    for site, (h, s_, nb, hn, mono, bnd, dep, po, ref_r, ref_l, lbin,
               lgain, rgain) in taps:
        kw = dict(monotone=mono, bound=bnd, depth=dep, parent_out=po)
        planes = {}
        for blend in ("own", "parent"):
            undo = with_left_blend(blend)
            try:
                planes[blend] = ts_planes(h, s_, nb, hn, sp_t, kw, None)
            finally:
                undo()
        own_l, par_l = planes["own"][1], planes["parent"][1]
        differ = own_l != par_l
        row = sites.setdefault(site, dict(scans=0, differ=0, own=0,
                                         parent=0, neither=0, right=0,
                                         agree_apart=0, scans_mixed=0))
        row["scans"] += 1
        row["differ"] += int(differ.sum())
        o = int((differ & (ref_l == own_l)).sum())
        p = int((differ & (ref_l == par_l)).sum())
        row["own"] += o
        row["parent"] += p
        row["neither"] += int((differ & (ref_l != own_l) &
                               (ref_l != par_l)).sum())
        row["right"] += int((planes["own"][0] != ref_r).sum())
        row["agree_apart"] += int(((ref_l != own_l) & ~differ).sum())
        row["scans_mixed"] += int(o > 0 and p > 0)
        # the chosen bins' NaN-left gains (the reference's gather after
        # the argmax): equal to its plane there, and matched by which
        # product choice of the port's recompute (blend, children's gain,
        # the parent gain of the shift)
        fin_b = lgain > -1e29
        at = lambda pl: np.take_along_axis(pl, lbin[:, None], 1)[:, 0]  # noqa
        row["chosen"] = row.get("chosen", 0) + int(fin_b.sum())
        row["chosen_is_plane"] = row.get("chosen_is_plane", 0) + int(
            (fin_b & (at(ref_l) == lgain)).sum())
        for blend in ("own", "parent"):
            for gain in ("linear", "square"):
                for par in ("square", "linear"):
                    undo = with_left_blend(blend, gain)
                    try:
                        pl = ts_chosen(h, s_, nb, hn, sp_t, kw,
                                       par == "linear")
                    finally:
                        undo()
                    key3 = f"chosen {blend}/{gain}/{par}"
                    hit = fin_b & (at(pl) == lgain)
                    row[key3] = row.get(key3, 0) + int(hit.sum())
                    # by feature: where in the (F,) gather the choice holds
                    byf = row.setdefault("by feature " + key3,
                                         np.zeros((2, len(lgain)), int))
                    byf[0] += fin_b
                    byf[1] += hit
        # every product choice of the NaN-left gain: the finite gains it
        # matches exactly
        fin = np.isfinite(ref_l) & (ref_l > -1e29)
        row["finite"] = row.get("finite", 0) + int(fin.sum())
        for blend in ("own", "parent"):
            for gain in ("linear", "square"):
                undo = with_left_blend(blend, gain)
                try:
                    pl = ts_planes(h, s_, nb, hn, sp_t, kw, None)[1]
                finally:
                    undo()
                key2 = f"{blend}/{gain}"
                row[key2] = row.get(key2, 0) + int((fin & (pl == ref_l))
                                                   .sum())
    print("  site: scans, NaN-left gains where the blends differ, the "
          "reference matching own / parent / neither, scans with both; "
          "NaN-right gains apart; NaN-left gains apart where the blends "
          "agree")
    for site, r in sorted(sites.items()):
        print(f"  {site}: {r['scans']} scans, {r['differ']} differ, own "
              f"{r['own']} / parent {r['parent']} / neither "
              f"{r['neither']}, {r['scans_mixed']} mixed; right apart "
              f"{r['right']}; apart where equal {r['agree_apart']}; of "
              f"{r['finite']} finite NaN-left gains, matched by blend/"
              f"gain product: " + ", ".join(
                  f"{b}/{g} {r[b + '/' + g]}" for b in ("own", "parent")
                  for g in ("linear", "square")))
        print(f"    chosen bins: {r['chosen']} finite, "
              f"{r['chosen_is_plane']} equal to the plane there; matched "
              "by recompute blend/children/parent: " + ", ".join(
                  f"{k[7:]} {v}" for k, v in r.items()
                  if k.startswith("chosen ")))
        for k, v in r.items():
            if k.startswith("by feature chosen own/linear/square") or \
                    k.startswith("by feature chosen own/square/square"):
                print(f"      {k[18:]} by feature (finite, matched): "
                      f"{v[0].tolist()}, {v[1].tolist()}")
    # the plane rule mirrored alone: the children scans' NaN-left gains
    # fuse the square term at W = 2 too
    was = tw.MONOTONE_SMOOTH_NAN_LEFT_SQUARE
    tw.MONOTONE_SMOOTH_NAN_LEFT_SQUARE = was | {PARAMS["tpu_wave_size"]}
    try:
        X, y = data()
        text = lt.train(PARAMS, lt.Dataset(X, y), 3,
                        device="cpu").model_to_string()
    finally:
        tw.MONOTONE_SMOOTH_NAN_LEFT_SQUARE = was
    d = diff(ref_text, text)
    print(f"  the square rule at W = {PARAMS['tpu_wave_size']} too: "
          f"{len(d)} split gains apart in the grower: {d}")
    return sites


def ts_chosen(h, s_, nb, hn, sp_t, k, refused):
    """The NaN-left plane the port's scan takes its chosen bins' gains
    from (after its recompute with ``nan_left_refused``): the second
    ``_at_bin`` call's plane."""
    seen = []
    orig = ts._at_bin

    def spy(x, idx):
        seen.append(x.numpy().copy())
        return orig(x, idx)
    ts._at_bin = spy
    try:
        T = lambda a: torch.as_tensor(np.asarray(a))   # noqa: E731
        ts.best_split_per_feature(
            T(h), T(s_), T(nb), T(hn), sp_t, monotone=T(k["monotone"]),
            bound=T(k["bound"]), depth=T(k["depth"]),
            parent_out=T(k["parent_out"]), nan_left_refused=refused)
    finally:
        ts._at_bin = orig
    return seen[1]


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
        pick = (lambda a: a) if ci is None else (lambda a: a[ci])
        ts.best_split_per_feature(
            T(h), T(s_), T(nb), T(hn), sp_t, monotone=T(k["monotone"]),
            bound=T(pick(k["bound"])), depth=T(pick(k["depth"])),
            parent_out=T(pick(k["parent_out"])))
    finally:
        torch.argmax = orig
    return seen[0], seen[1]


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tap-child"]:
        sys.exit(tap_child(sys.argv[2]))
    sys.exit(main())
