#!/usr/bin/env python3
"""Sweep of the uint16 leaf histograms' geometry on one CUDA card.

    python3 scripts/torch_u16_leaf_sweep.py [--rows 10502144] [--reps 9]
                                            [--profile] [--out FILE]

The data are ``chip_smoke.py`` phase 15a's (F=28, B=1024 and 65,535,
half the rows in one of 42 channels, the exact form's the first 25 of
them).  For each form it times (CUDA events behind a spinning kernel,
``chip_smoke.time_ms``) the channel partition (``leaf_partition``) and
the wrapper (partition, output zeroing and the histogram over the list)
at ``list_geometry``'s pick, then the wrapper at the six largest
features-per-block counts that fit and 1-6 and 8 slots a channel, each
launch's geometry set by replacing ``list_geometry`` for the call; every
geometry's histogram must equal the plain version's bit for bit.
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_502_144)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--seed", type=int, default=15)
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
    for nb in cs.U16_BINS:
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
                    hc.list_geometry = lambda *a, g=g: g
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
