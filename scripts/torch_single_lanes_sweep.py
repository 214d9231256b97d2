#!/usr/bin/env python3
"""Sweep of the single-leaf histograms' model-axis forms on one CUDA card.

    python3 scripts/torch_single_lanes_sweep.py [--parent DIR] [--rows N]
        [--reps 9] [--bins 256,1024,16383,65535] [--layouts rows,features]
        [--mixes even,skewed,empty,short] [--check] [--out FILE]

Times ``hist_single_lanes`` (uint8 codes at B=256) and its uint16 form
(``hist_single_lanes_u16``, B=1024, 16,383 and 65,535) of
``csrc/hist_single.cu`` at ``chip_smoke.py`` phase 12a's shape: F=28,
N=10,502,144, L=4 lanes of segments N, N/2, 50,003 and N/5 of per-lane
row-major copies (ROWS, the partitioned grower's layout) or of one shared
feature-major matrix (FEATS), each lane its own fixed-point weights (80%
of the rows in the bag).  Mixes: ``even`` (uniform codes), ``skewed`` (90%
of each feature's codes on one bin), ``empty`` (the third lane empty) and
``short`` (the third lane 3,001 rows, shorter than one item).  Beside
each: the L single launches (``hist_single``), one int64 ``index_add_``
over lanes x features (the library yardstick; the port never calls it)
and the bound (bytes once at 3.35 TB/s).  Also the single forms at their
own shapes: ``hist_single`` at the partitioned root (ROWS, B=256) and
``hist_single_u16`` FEATS and ROWS at B=1024 and 65,535.

Variants, every result checked bitwise against the plain version:

* ``new``: the package's source as the package builds it (native shared
  adds: a generic 64-bit atomic for uint8 codes, 32-bit halves for
  uint16; the work-item grid; past one bin tile the remote adds half
  through DSM reductions and half through L2);
* ``ring`` and ``ship``: ``scripts/hist_single_variants.cu``, which
  includes the package's source and adds two designs that lost on the
  card: ``ring``, the uint8 one-tile forms' rows brought into shared
  memory by a ring of bulk asynchronous copies (``hist_single_ring``,
  timed on the uint8 cases), and ``ship``, past one tile the remote adds
  staged in the owners' shared memory and added there in bulk each round
  (``hist_single_ship``, timed past one tile);
* ``new`` at one tile with its lanes' items cut for 1, 2 and 4 rounds of
  the resident blocks (``, N rounds``; the build's 1 for uint8 codes, 4
  for uint16);
* ``new`` past one tile with 0, 4, 12 and 15 of the cluster's 15 other
  blocks reached through DSM (``, N DSM peers``; the build's 8);
* ``parent`` (with ``--parent DIR``, an unpacked parent checkout: ``mkdir
  -p build/parent && git archive <commit> | tar -x -C build/parent``): the
  parent's own package in its own processes (the parent of the native
  adds has the 64-bit shared ``atomicAdd``, a compare-and-swap loop).

The trees run in separate processes in the order parent, change, change,
parent (the change's variants in each change process), so that a drift
of the card shows.  ``--check`` runs every variant once at 1,048,576 rows
(bitwise, no timing) with the SASS of each build's atomics
(``cuobjdump``: shared 32-bit atomics, compare-and-swap loops, generic
and global atomics) and the package build's first 64-bit add of the
uint8 and uint16 ROWS kernels.  Prints every line with the card's name and power
limit and writes them all as JSON to ``--out`` (default
``build/single_lanes_sweep.json``).
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
LANES = 4
# variant -> its source: the package's, or the sweep's copy of the
# designs that lost (ring on the uint8 cases, ship past one tile)
SOURCES = {"new": os.path.join("lightgbm_tpu_torch", "csrc",
                               "hist_single.cu"),
           "lost": os.path.join("scripts", "hist_single_variants.cu")}
VARIANTS = ("new", "ring", "ship")
# past one tile, the build's body with another count of DSM peers (the
# rest of a block's remote adds through L2)
PEERS = (0, 4, 12, 15)
# at one tile, the build's body with its lanes' items cut for 1, 2 and 4
# rounds of the resident blocks (``SINGLE_LANE_ROUNDS``)
ROUNDS = (1, 2, 4)
HBM = 3.35e12


def build_variants(root: str, names) -> dict:
    """{variant: shared library}: ``new`` from the package's source, ``ring``
    and ``ship`` from ``scripts/hist_single_variants.cu``, one ``nvcc`` per
    source, all started together."""
    out_dir = os.path.join(root, "build", "sweep")
    srcs = sorted({"new" if name == "new" else "lost" for name in names})
    built = common.build({src: (os.path.join(root, SOURCES[src]), (),
                                os.path.join(out_dir, f"libhs_{src}.so"))
                          for src in srcs})
    for src, (_, report) in built.items():
        regs = re.findall(r"Compiling entry function '(\w+)'.*?Used (\d+) "
                          r"registers", report, re.S)
        spills = re.findall(r"(\d+) bytes spill stores", report)
        print(f"built {src}: " + ", ".join(
            f"{re.sub(r'^_Z.*?hist_single_', '', k)[:24]} {r} regs"
            f" {s} B spilled" for (k, r), s in zip(regs, spills)),
            flush=True)
    return {name: built["new" if name == "new" else "lost"][0]
            for name in names}


def sass_excerpt(path: str, kernel: str, op: str, around: int = 10) -> str:
    """The SASS lines around the first ``op`` in ``kernel``."""
    body = common.kernel_body(common.sass(path), kernel) or []
    return (common.excerpt(body, re.escape(op), around, around)
            or f"(no {op} in {kernel})")


def with_peers(hc, peers):
    """``lane_single_items`` and ``single_geometry`` with ``peers`` DSM
    peers past one tile, for the sweep's routing variants."""
    real_items, real_geo = hc.lane_single_items, hc.single_geometry

    def items(*a, **k):
        geo, it = real_items(*a, **k)
        return (geo._replace(peers=peers) if geo.cluster > 1 else geo), it

    def single(*a, **k):
        geo = real_geo(*a, **k)
        return geo._replace(peers=peers) if geo.cluster > 1 else geo
    return (real_items, real_geo), (items, single)


def make_codes(torch, gen, dev, n, nb, mix):
    """(F, n) codes: uniform, or 90% of each feature's on one bin."""
    v = torch.randint(0, nb, (F, n), generator=gen, device=dev,
                      dtype=torch.int32)
    if mix == "skewed":
        hot = (torch.arange(F, device=dev, dtype=torch.int32) * 7919) % nb
        keep = torch.rand((F, n), generator=gen, device=dev) < 0.9
        v = torch.where(keep, hot.unsqueeze(1), v)
    if nb <= 256:
        return v.to(torch.uint8)
    return torch.where(v >= 32768, v - 65536, v).to(torch.int16).view(
        torch.uint16)


def segments(n, mix):
    segs = [(0, n), (n // 4, n // 2), (12_345, 50_003), (n // 3, n // 5)]
    if mix == "empty":
        segs[2] = (12_345, 0)
    elif mix == "short":
        segs[2] = (12_345, 3_001)
    return segs


def library_call(torch, bins_of, ws, nb, dev):
    """One int64 ``index_add_`` over lanes x features of the lanes' rows
    in the bag."""
    idx, upd = [], []
    for lane, (b, w) in enumerate(zip(bins_of, ws)):
        act = torch.nonzero((w != 0).any(dim=0)).squeeze(1)
        if b.dtype == torch.uint16:   # indexed through an int16 view
            codes = b.view(torch.int16)[:, act].to(torch.int64) & 0xFFFF
        else:
            codes = b[:, act].to(torch.int64)
        idx.append(((lane * F + torch.arange(F, device=dev).unsqueeze(1)) *
                    nb + codes).reshape(-1))
        upd.append(w[:, act].t().unsqueeze(0).expand(F, -1, -1)
                   .reshape(-1, 3))
    idx, upd = torch.cat(idx), torch.cat(upd).contiguous()

    def call():
        o = torch.zeros((len(ws) * F * nb, 3), dtype=torch.int64,
                        device=dev)
        o.index_add_(0, idx, upd)
        return o
    return call, int(idx.numel() // F)


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
    cuda_lib.build_all(("hist_single",))
    libs = ({"parent": None} if tree == "parent" else
            build_variants(HERE, [v for v in VARIANTS
                                  if v in args.variants]))
    if args.check and tree == "parent":
        lib_path = cuda_lib._lib_path("hist_single")
        print(f"[{card}] SASS parent: "
              f"{common.op_counts(common.sass(lib_path))}", flush=True)
    if args.check and tree != "parent":
        for name, path in libs.items():
            print(f"[{card}] SASS {name}: "
                  f"{common.op_counts(common.sass(path))}", flush=True)
        if "new" in libs:
            for kernel, what, op in (
                    ("hist_single_rowsIh", "uint8 add", "ATOM.E.ADD.64"),
                    ("hist_single_rowsIt", "uint16 own add", "ATOMS.ADD"),
                    ("hist_single_rowsIt", "uint16 DSM reduction",
                     "ATOM.E.ADD.64")):
                print(f"[{card}] SASS new, {kernel[:-2]}'s first {what} "
                      f"({op}):\n" + sass_excerpt(libs["new"], kernel, op),
                      flush=True)
    n = args.rows
    reps = 1 if args.check else args.reps
    rows_out = []

    def put(case, what, ms, **extra):
        rows_out.append(dict(tree=tree, case=case, what=what, ms=ms,
                             card=card, **extra))
        print(f"[{card}] {tree} {case} {what}: "
              + ("checked" if ms is None else f"{ms:.3f} ms"), flush=True)

    def run_variants(case, fn, want, past_tile):
        for name, path in libs.items():
            if name == "ship" and not past_tile:
                continue   # the build's own body at one tile
            if name == "ring" and (past_tile or nb > 256):
                continue   # the uint8 forms' only
            if path is not None:
                common.use_library("hist_single", path)
            got = fn()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                err = float((got.double() - want.double()).abs().max())
                raise AssertionError(f"{tree} {name} {case}: differs from "
                                     f"the plain version (max abs err "
                                     f"{err})")
            put(case, name,
                None if args.check else common.time_ms(torch, fn, reps))
        if not past_tile and tree != "parent" and "new" in libs and \
                "lanes" in case:
            common.use_library("hist_single", libs["new"])
            real_rounds = hc.SINGLE_LANE_ROUNDS
            for k in ROUNDS:
                hc.SINGLE_LANE_ROUNDS = {False: k, True: k}
                try:
                    got = fn()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"new, {k} rounds {case}: "
                                             "differs from the plain "
                                             "version")
                    put(case, f"new, {k} rounds", None if args.check
                        else common.time_ms(torch, fn, reps))
                finally:
                    hc.SINGLE_LANE_ROUNDS = real_rounds
        if past_tile and tree != "parent" and "new" in libs:
            common.use_library("hist_single", libs["new"])
            real, fake = with_peers(hc, 0)
            for peers in PEERS:
                _, fake = with_peers(hc, peers)
                hc.lane_single_items, hc.single_geometry = fake
                try:
                    got = fn()
                    torch.cuda.synchronize()
                    if not torch.equal(got, want):
                        raise AssertionError(f"new, {peers} DSM peers "
                                             f"{case}: differs from the "
                                             "plain version")
                    put(case, f"new, {peers} DSM peers", None if args.check
                        else common.time_ms(torch, fn, reps))
                finally:
                    hc.lane_single_items, hc.single_geometry = real
        if libs.get("new"):
            common.use_library("hist_single", libs["new"])

    gen = torch.Generator(device=dev)
    for nb in args.bins:
        for mix in args.mixes:
            gen.manual_seed(1000 + nb % 997 + 17 * args.mixes.index(mix))
            codes = make_codes(torch, gen, dev, n, nb, mix)
            segs = segments(n, mix)
            ws = []
            for s, c in segs:
                grad = torch.randn(n, generator=gen, device=dev) * 0.5
                hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
                mask = (torch.rand(n, generator=gen, device=dev) < 0.8
                        ).float()
                w = th.pack_weights(grad, hess, mask)
                ws.append(th.FxWeights(w.w[:, s:s + c], w.inv_scale))
            for layout in args.layouts:
                if layout == "rows":
                    P = [codes.t().contiguous() for _ in segs]
                    sb = [p[s:s + c].t() for p, (s, c) in zip(P, segs)]
                else:
                    P = None
                    sb = [codes[:, s:s + c] for s, c in segs]
                case = f"B={nb} {layout} {mix}"
                want = hc.hist_single_lanes_plain(sb, ws, num_bins=nb)
                run_variants(case + " lanes",
                             lambda: hc.hist_single_lanes(sb, ws,
                                                          num_bins=nb),
                             want, nb > 11_621)
                if not args.check:
                    put(case + " lanes", "4 single launches", common.time_ms(
                        torch, lambda: [hc.hist_single(b, w, num_bins=nb)
                                        for b, w in zip(sb, ws)], reps))
                    if tree != "parent":
                        lib, act = library_call(torch, sb,
                                                [w.w for w in ws], nb, dev)
                        put(case + " lanes", "index_add_",
                            common.time_ms(torch, lib, reps))
                        nbytes = (sum(24.0 * c for _, c in segs) +
                                  codes.element_size() * F * act +
                                  LANES * F * nb * 24)
                        put(case + " lanes", "bound", nbytes / HBM * 1e3,
                            bytes=nbytes)
                        del lib
                # the single forms at their own shapes: lane 0 (N rows)
                if mix == "even" and (nb, layout) in (
                        (256, "rows"), (1024, "rows"), (1024, "features"),
                        (65_535, "rows"), (65_535, "features")):
                    one = hc.hist_single_plain(sb[0], ws[0], num_bins=nb)
                    run_variants(case + " single",
                                 lambda: hc.hist_single(sb[0], ws[0],
                                                        num_bins=nb),
                                 one, nb > 11_621)
                del P, sb, want
                torch.cuda.empty_cache()
            del codes, ws
            torch.cuda.empty_cache()
    return rows_out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None,
                    help="an unpacked parent checkout to time beside")
    ap.add_argument("--rows", type=int, default=10_502_144)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--bins", default="256,1024,16383,65535")
    ap.add_argument("--layouts", default="rows,features")
    ap.add_argument("--mixes", default="even,skewed,empty,short")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--out", default=os.path.join(
        HERE, "build", "single_lanes_sweep.json"))
    ap.add_argument("--tree", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--root", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    args.bins = [int(x) for x in args.bins.split(",")]
    args.layouts = args.layouts.split(",")
    args.mixes = args.mixes.split(",")
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
        trees = trees[:2] if args.parent else trees
    every = common.run_trees(
        __file__, trees,
        ["--rows", str(args.rows), "--reps", str(args.reps), "--bins",
         ",".join(map(str, args.bins)), "--layouts", ",".join(args.layouts),
         "--mixes", ",".join(args.mixes), "--variants",
         ",".join(args.variants)] + (["--check"] if args.check else []))
    if every is None:
        return 1
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=card, rows=args.rows, lanes=LANES, features=F,
                       results=every), fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
