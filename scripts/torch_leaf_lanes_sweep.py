#!/usr/bin/env python3
"""Sweep of the leaf-channel histograms of ``csrc/hist_leaves.cu`` on one
CUDA card: the model-axis forms and the single forms.

    python3 scripts/torch_leaf_lanes_sweep.py [--parent DIR] [--rows N]
        [--reps 9] [--lanes 4,8] [--mixes even,empty,heavy,skewed]
        [--packing uint8,packed]
        [--variants new,other,probe,scan,chunks,rounds,skip,groups]
        [--check] [--out FILE]

Times ``hist_leaves_q8_lanes`` and ``hist_leaves_fx_lanes`` (the whole
wrappers: the exact form with its f32 scale-back) and the single forms
``hist_leaves_q8`` and ``hist_leaves_fx`` at ``chip_smoke.py`` phase 12a's
shape: F=28, N=10,502,144, each lane its own gradients (80% of the rows
in the bag) and channels (half of the rows in one of the 42 channels;
the exact form keeps channels below 25), uint8 codes at B=256 or
nibble-packed at B=16, L=4 and 8 lanes.  Mixes: ``even`` (phase 12a's),
``empty`` (lane 1 keeps no row), ``heavy`` (90% of lane 0's kept rows in
channel 5) and ``skewed`` (90% of each feature's codes on one bin).
On the ``empty`` mix also the lanes form over the live lanes only and
the empty lane's single launch; beside each lanes form of the change its
live-channel pass (``leaf_live_lanes``) alone.
Beside each lanes form: its L single launches, one ``index_add_`` of the
same sums over lanes x channels (the library yardstick; the port never
calls it) and the bound (each input byte once at 3.35 TB/s); beside each
single form (lane 0's inputs): its ``index_add_``.

Variants of the change, every result but the probe's checked bitwise
against the plain version:

* ``new``: the package's source as the package builds it;
* ``other``: ``scripts/hist_leaves_variants.cu`` with
  ``-DLEAF_VARIANT=1``, the other add form of each kernel (64-bit words
  through a generic address);
* ``probe``: the same file with ``-DLEAF_VARIANT=2``, every row queued
  and its weights and bins loaded but nothing added (wrong sums, timed
  only);
* ``scan``: ``-DLEAF_VARIANT=3``, every row queued and nothing loaded or
  added (the channel scan's cost; timed only);
* ``chunks``: ``new`` with the lanes' row chunks searched up to 1 and 4
  times the single form's (``LEAF_LANE_CHUNKS``, the build's 2);
* ``rounds``: ``new`` with the lanes' chunks for at least 0 (no floor)
  and 8 rounds of the resident blocks (``LEAF_LANE_ROUNDS``, the build's
  4);
* ``skip``: ``new`` with no live-channel pass, every block working (the
  flags all 1);
* ``groups``: ``new`` on the even mix with each (channels, features)
  group a block can hold (``leaf_groups``) in turn;
* ``parent`` (with ``--parent DIR``, an unpacked parent checkout: ``mkdir
  -p build/parent && git archive <commit> | tar -x -C build/parent``):
  the parent's own package in its own processes.

The trees run in separate processes in the order parent, change, change,
parent.  ``--check`` runs every variant once at 1,048,576 rows (bitwise,
no timing) and prints, for each build, the atomic and reduction opcodes
of each instantiation of its kernel (the package's ``hist_leaves_kernel``,
the variants' ``hist_leaves_variant_kernel``; ``cuobjdump -sass``) and
the SASS around the package build's first shared add and first flush
reduction of each, so that a reader sees which compare-and-swap loops
(``ATOMS.CAST.SPIN.64``) are left.  Prints every line with the card's
name and power limit and writes them all as JSON to ``--out`` (default
``build/leaf_lanes_sweep.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

import _sweep_common as common

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 28
HBM = 3.35e12
SOURCE = os.path.join("lightgbm_tpu_torch", "csrc", "hist_leaves.cu")
VARIANTS_SOURCE = os.path.join("scripts", "hist_leaves_variants.cu")
# variant -> (its source, the extra nvcc flags of its build)
BUILDS = {"new": (SOURCE, ()),
          "other": (VARIANTS_SOURCE, ("-DLEAF_VARIANT=1",)),
          "probe": (VARIANTS_SOURCE, ("-DLEAF_VARIANT=2",)),
          "scan": (VARIANTS_SOURCE, ("-DLEAF_VARIANT=3",))}
CHUNKS = (1, 4)   # LEAF_LANE_CHUNKS beside the build's
ROUNDS = (0, 8)   # LEAF_LANE_ROUNDS beside the build's (0: no floor)
# each form's kernel instantiation, by the end of its mangled name
KERNELS = {"q8": "IaLb0", "q8_p4": "IaLb1", "fx": "IxLb0", "fx_p4": "IxLb1"}


def build_variants(names) -> dict:
    """{variant: shared library}, one ``nvcc`` per build, all started
    together."""
    out_dir = os.path.join(HERE, "build", "leaf_sweep")
    built = common.build({
        name: (os.path.join(HERE, BUILDS[name][0]), BUILDS[name][1],
               os.path.join(out_dir, f"libhl_{name}.so")) for name in names})
    for name, (_, report) in built.items():
        print(f"built {name}: ptxas\n" + "\n".join(
            "  " + re.sub(r"_Z\w*?hist_leaves_\w*?kernel(\w{5})\w*", r"\1",
                          x.strip())
            for x in report.splitlines()
            if re.search(r"entry function|registers|spill", x)),
            flush=True)
    return {name: path for name, (path, _) in built.items()}


def sass_report(path: str, kernel: str, excerpts: bool) -> str:
    """The atomic and reduction opcodes of each form's instantiation of
    ``kernel``; with ``excerpts`` the SASS around its first shared add and
    its first flush reduction."""
    lines = common.sass(path)
    out = []
    for form, suffix in KERNELS.items():
        body = common.kernel_body(lines, kernel + suffix)
        if body is None:
            out.append(f"  {form}: (no {kernel}{suffix})")
            continue
        out.append(f"  {form}: {common.op_counts(body)}")
        if not excerpts:
            continue
        for what, pat in (("first shared add", r"\bATOMS?\.|\bATOM\.E"),
                          ("first flush reduction",
                           r"\bREDG?\.|\bATOMG?\.E\.ADD.*GPU")):
            code = common.excerpt(body, pat)
            out.append(f"    {what}:" + ("\n" + "\n".join(
                "      " + x for x in code.splitlines()) if code else
                " none"))
    return "\n".join(out)


def make_inputs(torch, gen, dev, n, lanes, mix):
    """(F, n) uint8 codes at B=256 and each lane's (wch, fx weights,
    channels), as phase 12a draws them, with the mix applied."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.ops import quantize as tq
    bins = torch.randint(0, 256, (F, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    if mix == "skewed":
        hot = ((torch.arange(F, device=dev) * 7919) % 256).to(torch.uint8)
        keep = torch.rand((F, n), generator=gen, device=dev) < 0.9
        bins = torch.where(keep, hot.unsqueeze(1), bins)
    out = []
    for lane in range(lanes):
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
        mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
        ch = torch.randint(0, hc.Q_LEAF_CHANNELS, (n,), generator=gen,
                           device=dev, dtype=torch.int8)
        keep = torch.rand(n, generator=gen, device=dev) < 0.5
        if mix == "empty" and lane == 1:
            keep[:] = False
        if mix == "heavy" and lane == 0:
            heavy = torch.rand(n, generator=gen, device=dev) < 0.9
            ch = torch.where(heavy, torch.full_like(ch, 5), ch)
        ch = torch.where(keep, ch, torch.full_like(ch, -1)).contiguous()
        wch = tq.quantize_wch(grad, hess, mask, (grad * mask).abs().max() /
                              127, (hess * mask).max() / 127, gq_max=127,
                              hq_max=127)
        out.append((wch, th.pack_weights(grad, hess, mask), ch))
    return bins, out


def library_call(torch, bins, w3s, chs, k, nb, dtype):
    """One ``index_add_`` over lanes x channels of the lanes' kept rows."""
    idx, upd = [], []
    for lane, (w3, ch) in enumerate(zip(w3s, chs)):
        rows = torch.nonzero((ch >= 0) & (ch < k)).squeeze(1)
        idx.append((((ch[rows].long() + lane * k).unsqueeze(0) * F +
                     torch.arange(F, device=bins.device).unsqueeze(1)) * nb +
                    bins[:, rows].long()).reshape(-1))
        upd.append(w3[:3, rows].to(dtype).t().unsqueeze(0)
                   .expand(F, -1, -1).reshape(-1, 3))
    idx, upd = torch.cat(idx), torch.cat(upd).contiguous()
    size = len(w3s) * k * F * nb

    def call():
        o = torch.zeros((size, 3), dtype=dtype, device=bins.device)
        o.index_add_(0, idx, upd)
        return o
    return call


def worker(args) -> list:
    """Every case of this tree: its variants (the change) or its package
    as it is (a parent), each checked bitwise and timed."""
    import torch
    from lightgbm_tpu_torch.ops import cuda_lib
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    dev = torch.device("cuda")
    card = common.card_name()
    tree = args.tree
    # the change's exact lanes form scales back with hist_leaves_u16.cu's
    # fx_scale_lanes
    cuda_lib.build_all(("hist_leaves",) if tree == "parent" else
                       ("hist_leaves", "hist_leaves_u16"))
    if tree == "parent":
        libs = {"parent": cuda_lib._lib_path("hist_leaves")}
    else:
        libs = build_variants([v for v in BUILDS if v in args.variants])
    if args.check:
        for name, path in libs.items():
            kernel = ("hist_leaves_kernel" if name in ("new", "parent")
                      else "hist_leaves_variant_kernel")
            print(f"[{card}] SASS {name}:\n" +
                  sass_report(path, kernel, name in ("new", "parent")),
                  flush=True)
    n = args.rows
    reps = 1 if args.check else args.reps
    rows_out = []

    def put(case, what, ms, **extra):
        rows_out.append(dict(tree=tree, case=case, what=what, ms=ms,
                             card=card, **extra))
        print(f"[{card}] {tree} {case} {what}: "
              + ("checked" if ms is None else f"{ms:.3f} ms"), flush=True)

    def patched(case, fn, want, label, attr, value):
        """``new`` checked and timed with ``hc.<attr>`` set to ``value``."""
        real = getattr(hc, attr)
        setattr(hc, attr, value)
        try:
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"new, {label} {case}: differs from "
                                     "the plain version")
            put(case, f"new, {label}", None if args.check
                else common.time_ms(torch, fn, reps))
        finally:
            setattr(hc, attr, real)

    def no_skip(table, chs, k):   # every block works, no flag pass
        return torch.ones((len(chs), k), dtype=torch.int32, device=dev)

    def run_variants(case, fn, want, lanes_form, groups=()):
        for name, path in libs.items():
            common.use_library("hist_leaves", path)
            got = fn()
            torch.cuda.synchronize()
            if name not in ("probe", "scan") and not torch.equal(got, want):
                err = float((got.double() - want.double()).abs().max())
                raise AssertionError(f"{tree} {name} {case}: differs from "
                                     f"the plain version (max abs err "
                                     f"{err})")
            put(case, name,
                None if args.check else common.time_ms(torch, fn, reps))
        if "new" not in libs:
            return
        common.use_library("hist_leaves", libs["new"])
        if lanes_form and "chunks" in args.variants:
            for c in CHUNKS:
                patched(case, fn, want, f"chunks x{c}", "LEAF_LANE_CHUNKS", c)
        if lanes_form and "rounds" in args.variants:
            for r in ROUNDS:
                patched(case, fn, want, f"rounds floor {r}",
                        "LEAF_LANE_ROUNDS", r)
        if lanes_form and "skip" in args.variants:
            patched(case, fn, want, "no skip", "_live_lanes", no_skip)
        for cg, fg in groups:
            patched(case, fn, want, f"group {cg}x{fg}", "leaf_groups",
                    lambda *a, g=(cg, fg): [g])

    gen = torch.Generator(device=dev)
    for mix in args.mixes:
        for lanes in args.lanes:
            gen.manual_seed(2300 + 17 * args.mixes.index(mix) + lanes)
            bins, lane_in = make_inputs(torch, gen, dev, n, lanes, mix)
            for packing in args.packing:
                packed = packing == "packed"
                nb = 16 if packed else 256
                codes = bins & 15 if packed else bins
                b = th.pack_bins4(codes) if packed else bins
                kw = dict(num_bins=nb, bins_packed=packed)
                for q8 in (True, False):
                    k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
                    ws = [x[0] if q8 else x[1] for x in lane_in]
                    chs = [x[2] if q8 else
                           torch.where(x[2] < k, x[2], -1).contiguous()
                           for x in lane_in]
                    many = (hc.build_histogram_leaves_q8_lanes if q8
                            else hc.build_histogram_leaves_lanes)
                    one = (hc.build_histogram_leaves_q8 if q8
                           else hc.build_histogram_leaves)
                    plain = (hc.build_histogram_leaves_q8_lanes_plain if q8
                             else hc.build_histogram_leaves_lanes_plain)
                    form = ("q8" if q8 else "fx") + ("_p4" if packed else "")
                    case = f"{form} {mix} L={lanes}"
                    want = plain(b, ws, chs, **kw)
                    # every (channels, features) group a block can hold,
                    # on the even mix
                    groups = (hc.leaf_groups(F, nb, k, q8)
                              if "groups" in args.variants and
                              mix == "even" and tree != "parent" else ())
                    run_variants(case + " lanes",
                                 lambda: many(b, ws, chs, **kw), want, True,
                                 groups)
                    if tree != "parent":
                        live = hc.leaf_live_lanes(chs, num_channels=k)
                        if not torch.equal(live, hc.leaf_live_lanes_plain(
                                chs, num_channels=k)):
                            raise AssertionError(f"leaf_live_lanes {case}: "
                                                 "differs from the plain "
                                                 "version")
                        put(case + " lanes", "the live flags alone",
                            None if args.check else common.time_ms(
                                torch, lambda: hc.leaf_live_lanes(
                                    chs, num_channels=k), reps))
                    if not args.check:
                        put(case + " lanes", f"{lanes} single launches",
                            common.time_ms(torch, lambda: [
                                one(b, ws[i], chs[i], **kw)
                                for i in range(lanes)], reps))
                        if mix == "empty":   # lane 1 keeps no row
                            live = [i for i in range(lanes) if i != 1]
                            put(case + " lanes", "the live lanes only",
                                common.time_ms(torch, lambda: many(
                                    b, [ws[i] for i in live],
                                    [chs[i] for i in live], **kw), reps))
                            put(case + " lanes", "the empty lane's single "
                                "launch", common.time_ms(
                                    torch, lambda: one(b, ws[1], chs[1],
                                                       **kw), reps))
                    # the single form on lane 0's inputs, at the first L
                    if lanes == args.lanes[0]:
                        run_variants(f"{form} {mix} single",
                                     lambda: one(b, ws[0], chs[0], **kw),
                                     want[0], False, groups)
                    del want
                    if args.check or tree == "parent":
                        continue
                    w3s = [w if q8 else w.w for w in ws]
                    dtype = torch.int32 if q8 else torch.int64
                    lib = library_call(torch, codes, w3s, chs, k, nb, dtype)
                    put(case + " lanes", "index_add_",
                        common.time_ms(torch, lib, reps))
                    live = [(c >= 0) & (c < k) for c in chs]
                    active = sum(int(x.sum()) for x in live)
                    anyl = torch.stack(live).any(dim=0)
                    if packed:
                        anyl = anyl.view(-1, 2).any(dim=1)
                    nbytes = (lanes * n + active * (3 if q8 else 24) +
                              F * int(anyl.sum()) +
                              lanes * k * F * nb * 3 * (4 if q8 else 8))
                    put(case + " lanes", "bound", nbytes / HBM * 1e3,
                        bytes=nbytes)
                    del lib
                    if lanes == args.lanes[0]:
                        lib = library_call(torch, codes, w3s[:1], chs[:1],
                                           k, nb, dtype)
                        put(f"{form} {mix} single", "index_add_",
                            common.time_ms(torch, lib, reps))
                        n0 = int(live[0].sum())
                        nbytes = (n + n0 * (3 if q8 else 24) +
                                  F * int(live[0].sum() if not packed else
                                          live[0].view(-1, 2).any(dim=1)
                                          .sum()) +
                                  k * F * nb * 3 * (4 if q8 else 8))
                        put(f"{form} {mix} single", "bound",
                            nbytes / HBM * 1e3, bytes=nbytes)
                        del lib
                    del live, anyl
                    torch.cuda.empty_cache()
                del b, codes
            del bins, lane_in
            torch.cuda.empty_cache()
    return rows_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="an unpacked parent checkout to time beside")
    ap.add_argument("--rows", type=int, default=10_502_144)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--lanes", default="4,8")
    ap.add_argument("--mixes", default="even,empty,heavy,skewed")
    ap.add_argument("--packing", default="uint8,packed")
    ap.add_argument("--variants",
                    default="new,other,probe,scan,chunks,rounds,skip")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        HERE, "build", "leaf_lanes_sweep.json"))
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.lanes = [int(x) for x in args.lanes.split(",")]
    args.mixes = args.mixes.split(",")
    args.packing = args.packing.split(",")
    args.variants = args.variants.split(",")
    if args.check:
        args.rows = min(args.rows, 1 << 20)
    if args.tree is not None:
        # a worker: this tree's package, its rows as JSON on stdout's last
        # line
        sys.path.insert(0, args.root)
        rows = worker(args)
        print(json.dumps(rows))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the sweep runs on the card", file=sys.stderr)
        return 1
    card = common.card_name()
    print(f"card: {card}", flush=True)
    trees = [("change", HERE)]
    if args.parent:
        parent = os.path.abspath(args.parent)
        trees = [("parent", parent), ("change", HERE), ("change", HERE),
                 ("parent", parent)]
        if args.check:
            trees = trees[:2]
    every = common.run_trees(
        __file__, trees,
        ["--rows", str(args.rows), "--reps", str(args.reps), "--lanes",
         ",".join(map(str, args.lanes)), "--mixes", ",".join(args.mixes),
         "--packing", ",".join(args.packing), "--variants",
         ",".join(args.variants)] + (["--check"] if args.check else []))
    if every is None:
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=card, rows=args.rows, features=F, results=every),
                  fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
