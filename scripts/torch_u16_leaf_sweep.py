#!/usr/bin/env python3
"""Sweep of the uint16 histograms' geometry on one CUDA card.

    python3 scripts/torch_u16_leaf_sweep.py [--rows 10502144] [--reps 9]
                                            [--forms leaf,single,tree]
                                            [--tree-rows 2097152]
                                            [--tree-bins 65535,...]
                                            [--tree-variants 1]
                                            [--profile] [--out FILE]

``--forms`` picks the sweeps (``leaf``, ``single``, ``tree``; the first
two by default).

The single-leaf form (``single``, ``csrc/hist_single.cu``
``hist_single_u16``): F=28, 80% of the rows weighted, at B=1024, 4096,
16,384 and 65,535; the ROWS layout on segments of N, N/2, N/16 and
50,003 rows of a row-major matrix, starting at row 1, and on N rows
whose last feature's codes lie below 256 (phase 15a's rows); the FEATS
layout (the partitioned and masked growers' feature-major columns) on
all N rows of both.  It first prints the clusters resident at once
(``histogram_cuda.single_resident``: cudaOccupancyMaxActiveClusters).
For each segment it times (``chip_smoke.time_ms``) the wrapper at
``single_shape``'s pick, at clusters of two features past one bin tile,
at the fewest tiles, at each other cluster size of 1, 2, 4, 6, 8, 12
and 16 blocks that fits, and at the pick with other DSM peer counts
(``_single_variants``), each with ``single_fill`` and
``single_chunks``' row chunks and set by replacing ``single_geometry``
for the call; every launch's histogram must equal the plain version's
bit for bit.  On N rows it also times the int64 ``index_add_`` of the
same sums.

One partitioned tree (``tree``): ``chip_smoke.py``'s Higgs-shaped rows
(2,097,152 by default, ``--tree-rows``) binned at each ``--tree-bins``
(65,535 by default), the partitioned grower (exact, 255 leaves) for 4
rounds: each round's wall time (synchronized), the median of rounds 2
and 3, the host time a launch of the ``hist_single`` wrapper and of its
geometry over rounds 2 and 3, and from ``torch.profiler`` over the last
round (whose wall time the profiler inflates) the device time of every
kernel and ``hist_single``'s share of it.  ``--tree-variants K`` runs
the tree once for each of the first K launches of the sweep above
(``single_shape`` replaced for the run).  It uses only the public entry
points, so a copy of this file times an older checkout as well (there
once, at that checkout's own geometry).

The leaf forms (``leaf``): the data are ``chip_smoke.py`` phase 15a's
(F=28, B=1024 and 65,535, half the rows in one of 42 channels, the
exact form's the first 25 of them).  For each form it times (CUDA
events behind a spinning kernel, ``chip_smoke.time_ms``) the channel
partition (``leaf_partition``) and the wrapper (partition, output
zeroing and the histogram over the list) at ``list_geometry``'s pick,
then the wrapper at the six largest features-per-block counts that fit
and 1-6 and 8 slots a channel, each launch's geometry set by replacing
``list_geometry`` for the call; every geometry's histogram must equal
the plain version's bit for bit.
``--profile`` prints each kernel's device time in one call of the
wrapper at the pick (``torch.profiler``).  Prints one line per timing
and writes them all as JSON to ``--out`` (default
``chiprun_out/u16_leaf_sweep.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _data(torch, gen, dev, n, nb):
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.ops import quantize as tq
    f = cs.NUM_FEATURES
    bins = cs._u16_codes(torch, gen, dev, (f, n), nb)
    grad = torch.randn(n, generator=gen, device=dev) * 0.5
    hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
    mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
    w = th.pack_weights(grad, hess, mask)
    chq = torch.randint(0, hc.Q_LEAF_CHANNELS, (n,), generator=gen,
                        device=dev, dtype=torch.int8)
    keep = torch.rand(n, generator=gen, device=dev) < 0.5
    chq = torch.where(keep, chq, torch.full_like(chq, -1)).contiguous()
    che = torch.where(chq < hc.LEAF_CHANNELS, chq,
                      torch.full_like(chq, -1)).contiguous()
    wch = tq.quantize_wch(grad, hess, mask,
                          (grad * mask).abs().max() / 127,
                          (hess * mask).max() / 127, gq_max=127, hq_max=127)
    return bins, w, wch, chq, che


def _profile(torch, fn, label):
    """Device time of each kernel of one ``fn()`` (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or getattr(
            e, "cuda_time_total", 0)
        if t:
            print(f"  [{label}] {e.key[:60]}: {t / 1e3:.4f} ms x{e.count}",
                  flush=True)


SINGLE_BINS = (1024, 4096, 16_384, 65_535)
SINGLE_CLUSTERS = (1, 2, 4, 6, 8, 12, 16)


def _single_variants(sms, f, nb, layout):
    """The launches the single-form sweep weighs at B=nb, without their
    row chunks: ``single_shape``'s pick; past one bin tile, clusters of
    one feature in the pick's tiles and in the fewest tiles; then each
    other size of ``SINGLE_CLUSTERS`` (a multiple of the pick's tiles:
    that many feature slices of the pick's; else, from the fewest tiles
    up, that many tiles of one feature), half its blocks DSM peers; then
    the pick with no DSM peer, one fewer, one more and all."""
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    shape = hc.single_shape(sms, f, nb, layout)
    t = shape.tiles
    least = hc.single_bin_tile(nb)[1]
    out = [("pick", shape)]

    def tiled(k):
        bt = -(-nb // k)
        smem = (bt | 1) * hc.SINGLE_BIN_BYTES
        return shape._replace(
            bt=bt, tiles=k, cluster=k, peers=hc.single_peers(k), fg=1,
            f_groups=f, smem=smem,
            threads=hc.LEAF_THREADS // hc._single_per_sm(smem))

    if t > 1:
        out.append((f"clusters of 1 feature, {t} tiles", tiled(t)))
        if least < t:
            out.append((f"clusters of 1 feature, {least} tiles",
                        tiled(least)))
    for c in SINGLE_CLUSTERS:
        if c == shape.cluster or t > 1 and c in (t, least):
            continue   # the pick, or listed above
        if c % t == 0:
            out.append((f"cluster {c}, {t} tile(s)", shape._replace(
                cluster=c, f_groups=-(-f // (c // t * shape.fg)),
                peers=hc.single_peers(c))))
        elif c >= least:
            out.append((f"cluster {c}, {c} tiles", tiled(c)))
    cs = shape.cluster
    out += [(f"pick, peers {p}", shape._replace(peers=p))
            for p in sorted({0, shape.peers - 1, shape.peers + 1, cs - 1})
            if cs > 1 and 0 <= p < cs and p != shape.peers]
    return out


def _single_sweep(torch, gen, dev, n, reps, profile, rows_out):
    """The single-leaf form's sweep (see the head of this file)."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    f = cs.NUM_FEATURES
    sms = hc._sm_count(dev)
    pick = hc.single_geometry
    # the clusters resident at once (cudaOccupancyMaxActiveClusters) of
    # blocks of one bin tile of 10,923 bins, one an SM
    got = [hc.single_resident(sms, c, 1, 10_923, "rows")
           for c in range(1, hc.SINGLE_MAX_CLUSTER + 1)]
    print(f"resident clusters of 1..{hc.SINGLE_MAX_CLUSTER} blocks: {got}",
          flush=True)
    rows_out.append(dict(form="resident", clusters=got))
    grad = torch.randn(n + 1, generator=gen, device=dev) * 0.5
    hess = torch.rand(n + 1, generator=gen, device=dev) * 0.25 + 0.01
    mask = (torch.rand(n + 1, generator=gen, device=dev) < 0.8).float()
    for nb in SINGLE_BINS:
        P = cs._u16_codes(torch, gen, dev, (n + 1, f), nb)
        # phase 15a's rows: the last feature's codes below 256
        P15 = P.clone()
        P15[:, f - 1] = cs._u16_codes(torch, gen, dev, (n + 1,), 256)
        segs = [("rows", n, P[1:].t())]
        for m in (n // 2, n // 16, 50_003):
            segs.append(("rows", m, P[1:1 + m].t()))
        segs.append(("rows, last < 256", n, P15[1:].t()))
        segs.append(("features", n, P[1:].t().contiguous()))
        segs.append(("features, last < 256", n, P15[1:].t().contiguous()))
        for tag, m, bins in segs:
            layout = tag.split(",")[0]
            w = th.pack_weights(grad[1:1 + m], hess[1:1 + m],
                                mask[1:1 + m])
            want = hc.hist_single_plain(bins, w, num_bins=nb)
            run = lambda: hc.hist_single(bins, w, num_bins=nb)
            for what, shape in _single_variants(sms, f, nb, layout):
                if not hc.single_resident(sms, shape.cluster, shape.fg,
                                          shape.bt, layout):
                    print(f"hist_single_u16 B={nb} {what}: no cluster "
                          "fits the card", flush=True)
                    continue
                geo = hc.single_chunks(hc.single_fill(sms, shape, layout),
                                       m)
                hc.single_geometry = lambda *a, g=geo: g
                try:
                    exact = (torch.equal(run(), want) and
                             torch.equal(run(), want))
                    t = cs.time_ms(run, reps)
                finally:
                    hc.single_geometry = pick
                resident = hc.single_resident(sms, geo.cluster, geo.fg,
                                              geo.bt, layout)
                rows_out.append(dict(
                    form="hist_single_u16", B=nb, rows=m, layout=tag,
                    what=what, geo=geo._asdict(), resident=resident, ms=t,
                    exact=exact))
                print(f"hist_single_u16 B={nb} {tag} n={m} {what}: "
                      f"{t:.3f} ms at {tuple(geo)} ({resident} resident), "
                      f"exact {exact}", flush=True)
                if not exact:
                    return 1
            if m == n:   # the int64 index_add_ of the same sums
                wide = th.widen_bins(bins)
                act = (w.w != 0).any(dim=0)
                ch1 = torch.where(act, 0, -1).to(torch.int8)
                call = cs._library_hist(torch, wide, w.w, ch1, 1, nb,
                                        torch.int64)
                t = cs.time_ms(call, reps)
                rows_out.append(dict(form="index_add_", B=nb, rows=m,
                                     layout=tag, ms=t))
                print(f"index_add_ B={nb} {tag} n={m}: {t:.3f} ms",
                      flush=True)
                del wide, call
            if profile and m == n:
                _profile(torch, run, f"hist_single_u16 B={nb} {tag}")
            del want, w
        del P, P15, segs
        torch.cuda.empty_cache()
    return 0


TREE_ROUNDS = 4     # the first builds; the last is profiled


def _tree_run(torch, rows, seed, max_bin, variants):
    """The ``tree`` form (see the head of this file) at ``max_bin``, once
    a geometry of ``variants`` (``single_shape`` replaced for the run);
    returns their records."""
    import time

    import numpy as np

    import lightgbm_tpu_torch as lt
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_tpu_torch.learner import serial
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    X, y, _ = cs.higgs_like(rows, seed)
    t0 = time.perf_counter()
    ds = lt.Dataset(X, y, params={"max_bin": max_bin})
    ds.construct()
    bin_s = time.perf_counter() - t0
    f = int(ds.X_binned.shape[1])
    nb = int(max(ds.num_bins_per_feature))
    params = cs.mode_params("partition", max_bin)
    wrapper, geometry = hc.hist_single, hc.single_geometry
    shapes = ([("pick", None)] if not hasattr(hc, "single_shape") else
              _single_variants(hc._sm_count(torch.device("cuda")), f, nb,
                               "features")[:variants])
    recs = []
    for what, shape in shapes:
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        ticks = []
        host = dict(on=False, wrapper=0.0, geometry=0.0, wrapper_n=0,
                    geometry_n=0)

        def timed(fn, key):
            def call(*a, **k):
                if not host["on"]:
                    return fn(*a, **k)
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    host[key] += time.perf_counter() - t
                    host[key + "_n"] += 1
            return call

        def tick(env):
            torch.cuda.synchronize()
            ticks.append(time.perf_counter())
            # rounds 2 .. TREE_ROUNDS - 1 count the wrapper's host time
            host["on"] = 1 <= len(ticks) < TREE_ROUNDS - 1
            if len(ticks) == TREE_ROUNDS - 1:
                prof.start()
            elif len(ticks) == TREE_ROUNDS:
                prof.stop()

        saved = getattr(hc, "single_shape", None)
        if shape is not None:
            hc.single_shape = lambda *a, s=shape: s
        if hasattr(geometry, "cache_clear"):
            geometry.cache_clear()
        # the growers call the wrapper as hc.hist_single (the partitioned
        # one) or by the name learner/serial.py imports (the masked one)
        hc.hist_single = serial.hist_single = timed(wrapper, "wrapper")
        hc.single_geometry = timed(geometry, "geometry")
        hc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            lt.train(params, ds, TREE_ROUNDS, callbacks=[tick])
        finally:
            hc.hist_single = serial.hist_single = wrapper
            hc.single_geometry = geometry
            if saved is not None:
                hc.single_shape = saved
            if hasattr(geometry, "cache_clear"):
                geometry.cache_clear()
        walls = np.diff([t0] + ticks).tolist()
        kernels = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", 0) or getattr(
                e, "cuda_time_total", 0)
            if t and e.device_type.name == "CUDA":
                kernels[e.key] = (t / 1e3, e.count)
        device = sum(t for t, _ in kernels.values())
        single = sum(t for k, (t, _) in kernels.items()
                     if "hist_single" in k)
        rec = dict(form="tree", what=what, rows=rows, max_bin=max_bin,
                   num_bins=nb, binning_s=bin_s, round_s=walls,
                   steady_s=float(np.median(walls[1:-1])),
                   launches=dict(hc.LAUNCHES), device_ms=device,
                   hist_single_ms=single,
                   hist_single_share=single / device if device else None,
                   host_launches=host["wrapper_n"],
                   host_wrapper_us=1e6 * host["wrapper"] / max(
                       host["wrapper_n"], 1),
                   host_geometry_us=1e6 * host["geometry"] / max(
                       host["geometry_n"], 1),
                   geo=None if shape is None else shape._asdict(),
                   kernels={k: v for k, v in sorted(
                       kernels.items(), key=lambda kv: -kv[1][0])[:12]})
        print(f"tree [{what}]: {rows} rows at max_bin={max_bin} ({nb} bins "
              f"at most, binned in {bin_s:.1f} s); rounds "
              f"{['%.3f' % w for w in walls]} s, steady "
              f"{rec['steady_s']:.3f} s (rounds 2-{TREE_ROUNDS - 1}); round "
              f"{TREE_ROUNDS}, profiled: device {device:.1f} ms, "
              f"hist_single {single:.1f} ms "
              f"({100 * single / max(device, 1e-9):.1f}%); host a launch "
              f"(rounds 2-{TREE_ROUNDS - 1}, {host['wrapper_n']} launches): "
              f"wrapper {rec['host_wrapper_us']:.1f} us, geometry "
              f"{rec['host_geometry_us']:.1f} us", flush=True)
        for k, (t, c) in list(rec["kernels"].items())[:4]:
            print(f"  {k[:70]}: {t:.2f} ms x{c}", flush=True)
        recs.append(rec)
    return recs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_502_144)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--seed", type=int, default=15)
    ap.add_argument("--forms", default="leaf,single")
    ap.add_argument("--tree-rows", type=int, default=2_097_152)
    ap.add_argument("--tree-bins", default="65535")
    ap.add_argument("--tree-variants", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "u16_leaf_sweep.json"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.ops import cuda_lib
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(card, flush=True)
    cuda_lib.build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    n, f = args.rows, cs.NUM_FEATURES
    sms = hc._sm_count(dev)
    pick = hc.list_geometry
    rows = []
    forms = args.forms.split(",")
    if "tree" in forms:
        for mb in args.tree_bins.split(","):
            rows += _tree_run(torch, args.tree_rows, args.seed, int(mb),
                              args.tree_variants)
    if "single" in forms and _single_sweep(torch, gen, dev, n, args.reps,
                                           args.profile, rows):
        return 1
    for nb in (cs.U16_BINS if "leaf" in forms else ()):
        bins, w, wch, chq, che = _data(torch, gen, dev, n, nb)
        forms = (("hist_leaves_u16", w.w, che, hc.LEAF_CHANNELS, False),
                 ("hist_leaves_q8_u16", wch, chq, hc.Q_LEAF_CHANNELS, True))
        for key, wt, ch, k, q8 in forms:
            if q8:
                run = lambda: hc.build_histogram_leaves_q8(
                    bins, wch, chq, num_bins=nb)
                plain = hc.build_histogram_leaves_q8_plain(
                    bins, wch, chq, num_bins=nb)
            else:
                run = lambda: hc.build_histogram_leaves(
                    bins, w, che, num_bins=nb, raw=True)
                plain = hc.build_histogram_leaves_plain(
                    bins, w, che, num_bins=nb, raw=True)
            geo = pick(sms, f, n, nb, k, q8)
            part_ms = cs.time_ms(
                lambda: hc.leaf_partition(ch, wt, num_channels=k,
                                          slots=geo.slots,
                                          part_blocks=geo.part_blocks),
                args.reps)
            ms = cs.time_ms(run, args.reps)
            rows.append(dict(form=key, B=nb, what="pick", geo=geo._asdict(),
                             ms=ms, partition_ms=part_ms))
            print(f"{key} B={nb}: wrapper {ms:.3f} ms at {tuple(geo)}; "
                  f"partition {part_ms:.3f} ms", flush=True)
            if args.profile:
                _profile(torch, run, f"{key} B={nb}")
            m0 = geo.slots // k
            most = hc.BLOCK_SMEM // hc._pair_bytes(geo.bt, q8)
            fgs = sorted({-(-f // g) for g in range(1, f + 1)
                          if -(-f // g) <= most}, reverse=True)[:6]
            for fg in fgs:
                for m in (1, 2, 3, 4, 5, 6, 8):
                    slots = k * max(m, -(-hc.list_slots_least(n, q8) // k))
                    f_groups = -(-f // fg)
                    g = geo._replace(fg=fg, f_groups=f_groups, slots=slots,
                                     blocks=f_groups * geo.tiles * (slots + k),
                                     smem=fg * hc._pair_bytes(geo.bt, q8))
                    hc.list_geometry = lambda *a, g=g, **k: g
                    try:
                        exact = torch.equal(run(), plain)
                        t = cs.time_ms(run, args.reps)
                    finally:
                        hc.list_geometry = pick
                    rows.append(dict(form=key, B=nb, fg=fg, slots=slots,
                                     blocks=g.blocks, ms=t, exact=exact,
                                     pick=(fg, m) == (geo.fg, m0)))
                    print(f"{key} B={nb} fg={fg} slots={slots} "
                          f"({g.blocks} blocks): wrapper {t:.3f} ms, "
                          f"exact {exact}", flush=True)
                    if not exact:
                        return 1
            del plain
            torch.cuda.empty_cache()
        del bins, w, wch, chq, che
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(dict(card=card, rows=args.rows, timings=rows), fh, indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
