#!/usr/bin/env python3
"""Sweep of the uint16 leaf histograms (``csrc/hist_leaves_u16.cu``) on one
CUDA card: the model-axis forms and the single forms.

    python3 scripts/torch_u16_lanes_sweep.py [--parent DIR] [--rows N]
        [--lanes 4] [--reps 9] [--bins 1024,65535]
        [--mixes even,hot,skewed,empty] [--forms q8,fx]
        [--variants new,orders,probe,records,parent adds,unmerged,listed]
        [--check] [--out FILE]

The data are ``chip_smoke.py`` phase 12f's: F=28, N=10,502,144 rows of
uniform uint16 codes at B=1024 and 65,535, L lanes each with its own
gradients (80% of the rows in the bag) and channels.  Mixes: ``even``
(half the rows in one of the 42 q8 channels, the exact form keeping
those below 25), ``hot`` (``even`` over codes of which 90% of each
feature's sit on one bin), ``skewed`` (phase 15a's channels: of the kept
half, 90% in channel 3 and the rest in channels c % 4 != 1) and
``empty`` (``even`` with channel 7 unlisted).

Each case times the whole wrappers: ``build_histogram_leaves_q8_lanes``
(``hist_leaves_q8_lanes_u16``) and ``build_histogram_leaves_lanes``
(``hist_leaves_lanes_u16``: owner mode past one bin tile, else slot mode
with its one-pass scale-back), each with its channel partition, beside
the L single wrappers one after the other and lane 0's single wrapper
(``hist_leaves_q8_u16``, ``hist_leaves_fx_u16``), then the lanes form
again.  Variants of the change, each result of ``new``, ``orders``,
``listed`` and ``unmerged`` checked bitwise against the L single
wrappers (and, with ``--check``, these against the plain version):

* ``new``: the package's source as the package builds it, in its own
  launch order (``histogram_cuda.list_lane_order``);
* ``orders``: ``new`` in each launch order: a launch a lane, one launch
  lane-major, one launch feature-major;
* ``probe``: ``scripts/hist_leaves_u16_variants.cu`` with
  ``-DU16_VARIANT=1``: every record and its codes loaded, nothing added
  (wrong sums, timed only);
* ``records``: the same file with ``-DU16_VARIANT=2``: every record
  loaded, no code (timed only);
* ``parent adds``: ``-DU16_VARIANT=3``, the parent's 64-bit generic
  atomics in the new walk (q8's sums wrong: timed only);
* ``listed`` (q8): ``-DU16_VARIANT=4``, the partition also writes each
  listed row's codes in list order (a (L, F, N) uint16 buffer the sweep
  allocates, its GiB logged), which the histogram reads coalesced;
* ``unmerged``: ``-DU16_VARIANT=5``, the package's adds without warp
  merging;
* ``parent`` (with ``--parent DIR``, an unpacked parent checkout: ``mkdir
  -p build/parent && git archive <commit> | tar -x -C build/parent``):
  the parent's own package in its own processes.

The change's default also logs its device split (``torch.profiler``, ms
a call by kernel) and its peak device memory above the inputs, and
beside it one ``index_add_`` of the same sums over lanes x channels (the
library yardstick; the port never calls it) and the bound (each input
byte once, the output once, at 3.35 TB/s).

The trees run in separate processes in the order parent, change, change,
parent.  ``--check`` runs every variant once at 1,048,576 rows (bitwise,
no timing; against the plain version too) and prints, for each build,
the atomic and reduction opcodes of every instantiation of its
histogram kernel (``cuobjdump -sass``; the package's
``hist_list_kernel``, the variants' ``variant_kernel``) and the SASS around
the package build's first shared add and first flush reduction.  Prints
every line with the card's name and power limit and writes them all as
JSON to ``--out`` (default ``build/u16_lanes_sweep.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import sys

import _sweep_common as common

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F = 28
HBM = 3.35e12
VARIANTS_SOURCE = os.path.join("scripts", "hist_leaves_u16_variants.cu")
# variant of the variants file -> (its U16_VARIANT, the forms it runs,
# whether its sums are checked)
VARIANTS = {"probe": (1, ("q8", "fx"), False),
            "records": (2, ("q8", "fx"), False),
            "parent adds": (3, ("q8", "fx"), False),
            "listed": (4, ("q8",), True),
            "unmerged": (5, ("q8", "fx"), True)}
ORDERS = (("a launch a lane", 0), ("lane-major", 1), ("feature-major", 2))
KERNELS = ("hist_list_kernel", "variant_kernel")


def build_variants(names) -> dict:
    """{variant: shared library}, one ``nvcc`` per build, all started
    together."""
    out_dir = os.path.join(HERE, "build", "u16_sweep")
    built = common.build({
        name: (os.path.join(HERE, VARIANTS_SOURCE),
               (f"-DU16_VARIANT={VARIANTS[name][0]}",),
               os.path.join(out_dir, f"libhl16_{VARIANTS[name][0]}.so"))
        for name in names})
    for name, (_, report) in built.items():
        print(f"built {name}: ptxas\n" + "\n".join(
            "  " + x.strip() for x in report.splitlines()
            if re.search(r"registers|spill", x)), flush=True)
    return {name: path for name, (path, _) in built.items()}


def sass_report(path: str, excerpts: bool) -> str:
    """The atomic and reduction opcodes of every instantiation of the
    build's histogram kernel; with ``excerpts`` the SASS around each one's
    first shared add and first flush reduction."""
    lines = common.sass(path)
    starts = [i for i, x in enumerate(lines) if "Function :" in x]
    out = []
    for at, i in enumerate(starts):
        name = lines[i].split("Function :")[1].strip()
        if not any(k in name for k in KERNELS):
            continue
        body = lines[i:starts[at + 1] if at + 1 < len(starts)
                     else len(lines)]
        out.append(f"  {name}: {common.op_counts(body)}")
        if not excerpts:
            continue
        for what, pat in (("first shared add", r"\bATOMS\.|\bRED\.|\bATOM\."),
                          ("first flush reduction", r"\bREDG\.|\bATOMG\.")):
            code = common.excerpt(body, pat)
            out.append(f"    {what}:" + ("\n" + "\n".join(
                "      " + x for x in code.splitlines()) if code else
                " none"))
    return "\n".join(out) if out else "  (no histogram kernel)"


def make_inputs(torch, gen, dev, n, lanes, nb, mix):
    """(F, n) uint16 codes below ``nb`` and each lane's (wch, fx weights,
    q8 channels, exact channels) with the mix applied."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.ops import quantize as tq
    kq, kx = hc.Q_LEAF_CHANNELS, hc.LEAF_CHANNELS
    v = torch.randint(0, nb, (F, n), generator=gen, device=dev,
                      dtype=torch.int32)
    if mix == "hot":   # 90% of each feature's codes on one bin
        hot = (torch.arange(F, device=dev, dtype=torch.int32) * 7919) % nb
        v = torch.where(torch.rand((F, n), generator=gen, device=dev) < 0.9,
                        hot.unsqueeze(1), v)
    bins = torch.where(v >= 32768, v - 65536, v).to(torch.int16).view(
        torch.uint16)
    del v
    out = []
    for _ in range(lanes):
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
        mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
        ch = torch.randint(0, kq, (n,), generator=gen, device=dev,
                           dtype=torch.int8)
        keep = torch.rand(n, generator=gen, device=dev) < 0.5
        if mix == "skewed":
            heavy = torch.rand(n, generator=gen, device=dev) < 0.9
            light = torch.tensor([c for c in range(kq)
                                  if c % 4 != 1 and c != 3],
                                 dtype=torch.int8, device=dev)
            pick = light[torch.randint(0, len(light), (n,), generator=gen,
                                       device=dev)]
            ch = torch.where(heavy, torch.full_like(ch, 3), pick)
        if mix == "empty":
            keep &= ch != 7
        chq = torch.where(keep, ch, torch.full_like(ch, -1)).contiguous()
        chx = torch.where(chq < kx, chq, torch.full_like(chq, -1))
        wch = tq.quantize_wch(grad, hess, mask, (grad * mask).abs().max() /
                              127, (hess * mask).max() / 127, gq_max=127,
                              hq_max=127)
        out.append((wch, th.pack_weights(grad, hess, mask), chq,
                    chx.contiguous()))
    return bins, out


def library_call(torch, wide, w3s, chs, k, nb, dtype):
    """One ``index_add_`` over lanes x channels of the lanes' kept rows
    (``wide``: the codes as int32)."""
    idx, upd = [], []
    for lane, (w3, ch) in enumerate(zip(w3s, chs)):
        rows = torch.nonzero((ch >= 0) & (ch < k)).squeeze(1)
        idx.append((((ch[rows].long() + lane * k).unsqueeze(0) * F +
                     torch.arange(F, device=wide.device).unsqueeze(1)) * nb +
                    wide[:, rows].long()).reshape(-1))
        upd.append(w3[:3, rows].to(dtype).t().unsqueeze(0)
                   .expand(F, -1, -1).reshape(-1, 3))
    idx, upd = torch.cat(idx), torch.cat(upd).contiguous()
    size = len(w3s) * k * F * nb

    def call():
        o = torch.zeros((size, 3), dtype=dtype, device=wide.device)
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
    change = tree != "parent"
    cuda_lib.build_all(("hist_leaves_u16",))
    package = cuda_lib._lib_path("hist_leaves_u16")
    variants = (build_variants([v for v in VARIANTS if v in args.variants])
                if change else {})
    if args.check:
        for name, path in [(tree, package), *variants.items()]:
            print(f"[{card}] SASS {name}:\n" +
                  sass_report(path, name == tree), flush=True)
    n, lanes = args.rows, args.lanes
    reps = 1 if args.check else args.reps
    rows_out = []

    def put(case, what, ms, **extra):
        rows_out.append(dict(tree=tree, case=case, what=what, ms=ms,
                             card=card, **extra))
        more = "".join(f", {a} {b}" for a, b in extra.items())
        print(f"[{card}] {tree} {case} {what}: "
              + ("checked" if ms is None else f"{ms:.3f} ms") + more,
              flush=True)

    def timed(fn):
        return None if args.check else common.time_ms(torch, fn, reps)

    real_order = hc.list_lane_order
    gen = torch.Generator(device=dev)
    for nb in args.bins:
        for mix in args.mixes:
            gen.manual_seed(2400 + nb % 97 + 7 * args.mixes.index(mix))
            bins, lane_in = make_inputs(torch, gen, dev, n, lanes, nb, mix)
            for form in args.forms:
                q8 = form == "q8"
                k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
                ws = [x[0] if q8 else x[1] for x in lane_in]
                chs = [x[2] if q8 else x[3] for x in lane_in]
                many = (hc.build_histogram_leaves_q8_lanes if q8
                        else hc.build_histogram_leaves_lanes)
                one = (hc.build_histogram_leaves_q8 if q8
                       else hc.build_histogram_leaves)
                case = f"{form} B={nb} {mix}"

                def lanes_fn():
                    return many(bins, ws, chs, num_bins=nb)

                want = torch.stack([one(bins, w, c, num_bins=nb)
                                    for w, c in zip(ws, chs)])
                if args.check:
                    plain = (hc.build_histogram_leaves_q8_lanes_plain if q8
                             else hc.build_histogram_leaves_lanes_plain)
                    if not torch.equal(plain(bins, ws, chs, num_bins=nb),
                                       want):
                        raise AssertionError(f"{tree} {case}: single "
                                             "launches differ from plain")
                if not torch.equal(lanes_fn(), want):
                    raise AssertionError(f"{tree} {case}: lanes form differs "
                                         "from its single launches")
                own = {o: w for w, o in ORDERS}[real_order(None)]
                label = f"new ({own})" if change else "parent"
                put(case + f" L={lanes}", label, timed(lanes_fn))
                put(case + f" L={lanes}", f"{lanes} single launches",
                    timed(lambda: [one(bins, w, c, num_bins=nb)
                                   for w, c in zip(ws, chs)]))
                put(case + " single", label.split(" ")[0],
                    timed(lambda: one(bins, ws[0], chs[0], num_bins=nb)))
                # the lanes form once more, after the other launches: a
                # process's first timing of a case can read apart
                put(case + f" L={lanes}", label + ", again",
                    timed(lanes_fn))
                if not change:
                    del want
                    continue
                if "orders" in args.variants:
                    for what, order in ORDERS:
                        hc.list_lane_order = lambda geo, o=order: o
                        try:
                            if not torch.equal(lanes_fn(), want):
                                raise AssertionError(f"{case} {what} differs")
                            put(case + f" L={lanes}", f"new, {what}",
                                timed(lanes_fn))
                        finally:
                            hc.list_lane_order = real_order
                for name, path in variants.items():
                    number, forms, checked = VARIANTS[name]
                    if form not in forms:
                        continue
                    common.use_library("hist_leaves_u16", path)
                    codes = None
                    if number == 4:   # the listed codes' buffer
                        codes = torch.empty((lanes, F, n), dtype=torch.uint16,
                                            device=dev)
                        cuda_lib._LIBS["hist_leaves_u16"].set_listed_codes(
                            ctypes.c_void_p(bins.data_ptr()), F,
                            ctypes.c_void_p(codes.data_ptr()))
                    try:
                        for what, fn, ref in (
                                (f" L={lanes}", lanes_fn, want),
                                (" single", lambda: one(
                                    bins, ws[0], chs[0], num_bins=nb),
                                 want[0])):
                            if checked and not torch.equal(fn(), ref):
                                raise AssertionError(f"{case}{what} {name} "
                                                     "differs")
                            put(case + what, name, timed(fn),
                                **({} if codes is None else dict(
                                    codes_gib=round(codes.numel() * 2 /
                                                    2 ** 30, 4))))
                    finally:
                        common.use_library("hist_leaves_u16", package)
                        del codes
                del want
                if args.check:
                    continue
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                m0 = torch.cuda.memory_allocated()
                lanes_fn()
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - m0) / 2 ** 30
                sys.path.insert(0, HERE)
                import chip_smoke as cs
                split = cs.device_split(lanes_fn)
                put(case + f" L={lanes}", "new, device split",
                    sum(split.values()), peak_gib=round(peak, 4),
                    split={a: round(b, 4) for a, b in split.items()})
                wide = th.widen_bins(bins)
                w3s = [w if q8 else w.w for w in ws]
                live = [(c >= 0) & (c < k) for c in chs]
                active = sum(int(x.sum()) for x in live)
                anyl = int(torch.stack(live).any(dim=0).sum())
                lib = library_call(torch, wide, w3s, chs, k, nb, torch.int64)
                put(case + f" L={lanes}", "index_add_",
                    common.time_ms(torch, lib, reps))
                del lib
                lib = library_call(torch, wide, w3s[:1], chs[:1], k, nb,
                                   torch.int64)
                put(case + " single", "index_add_",
                    common.time_ms(torch, lib, reps))
                del lib, wide
                # each input byte once (channels, the kept rows' weights
                # and codes), the int32 / f32 output once
                for what, lw, act, rows in (
                        (f" L={lanes}", lanes, active, anyl),
                        (" single", 1, int(live[0].sum()),
                         int(live[0].sum()))):
                    nbytes = (lw * n + act * (3 if q8 else 24) +
                              2 * F * rows + lw * k * F * nb * 12)
                    put(case + what, "bound", nbytes / HBM * 1e3,
                        bytes=nbytes)
                del live
                torch.cuda.empty_cache()
            del bins, lane_in
            torch.cuda.empty_cache()
    return rows_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="an unpacked parent checkout to time beside")
    ap.add_argument("--rows", type=int, default=10_502_144)
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--bins", default="1024,65535")
    ap.add_argument("--mixes", default="even,hot,skewed,empty")
    ap.add_argument("--forms", default="q8,fx")
    ap.add_argument("--variants",
                    default="new,orders,probe,records,parent adds,unmerged")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        HERE, "build", "u16_lanes_sweep.json"))
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.bins = [int(x) for x in args.bins.split(",")]
    args.mixes = args.mixes.split(",")
    args.forms = args.forms.split(",")
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
        ["--rows", str(args.rows), "--lanes", str(args.lanes), "--reps",
         str(args.reps), "--bins", ",".join(map(str, args.bins)),
         "--mixes", ",".join(args.mixes), "--forms", ",".join(args.forms),
         "--variants", ",".join(args.variants)] +
        (["--check"] if args.check else []))
    if every is None:
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=card, rows=args.rows, lanes=args.lanes,
                       features=F, results=every), fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
