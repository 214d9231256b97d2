#!/usr/bin/env python3
"""Sweep of the uint16 model-axis (lane) histograms on one CUDA card.

    python3 scripts/torch_u16_lanes_sweep.py [--rows 10502144] [--lanes 4]
                                             [--reps 9] [--out FILE]
                                             [--parts leaf,fx]

The data are ``chip_smoke.py`` phase 12f's: F=28, L lanes with their own
gradients and channels (half the rows in one of 42 channels, the exact
form's the first 25 of them) over one shared uint16 bin matrix, at
B=1024 and 65,535.  Times are CUDA events behind a spinning kernel
(``chip_smoke.time_ms``), medians of ``--reps``.

The leaf forms (``csrc/hist_leaves_u16.cu``): for each of q8 and fx, the
L single wrappers one after the other (each its own partition and
histogram), the lanes' partition alone against L single partitions, and
the lanes wrapper (one partition launch, then a histogram launch a
lane), its histograms equal to the single wrappers' bit for bit.

The exact lanes form's modes and launch orders (``fx``): at each B, on
three mixes of each lane's exact-form channels (``even``, the above;
``skewed``, chip_smoke.py phase 15a's: of the kept half, 90% in channel 3
and the rest in channels c % 4 != 1, six channels empty; ``one empty``,
``even`` with channel 7 unlisted), over the uniform matrix and over phase
12f's (the last feature's codes below 256),
``build_histogram_leaves_lanes`` with ``list_owner`` and
``list_lane_order`` set to each variant: owner mode (past one bin tile) and
slot mode with the one-pass scale-back (``fx_scale_lanes``), each a launch
a lane, one launch lane-major and one launch feature-major; slot mode with
the three torch passes of ``fx_to_f32`` a launch a lane (the design before
owner mode); past one tile lane 0's single form in owner mode and in slot
mode; every variant bitwise the first and L single wrappers; beside them
the L single wrappers and one int64 ``index_add_`` over lanes x channels
(the library yardstick). Each variant's device split (``torch.profiler``,
ms a call by kernel) and peak device memory above the inputs are logged.

The single-leaf lanes form (``hist_single_lanes_u16``) has its own sweep,
``scripts/torch_single_lanes_sweep.py``.

Prints one line per timing with the card's name and power limit, and
writes them all as JSON to ``--out`` (default
``build/u16_lanes_sweep.json``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def _leaf_sweep(torch, gen, dev, n, lanes, reps, card, rows_out):
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.ops import quantize as tq
    f = cs.NUM_FEATURES
    sms = hc._sm_count(dev)
    for nb in cs.U16_BINS:
        bins = cs._u16_codes(torch, gen, dev, (f, n), nb)
        data = []
        for _ in range(lanes):
            grad = torch.randn(n, generator=gen, device=dev) * 0.5
            hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
            mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
            ch = torch.randint(0, hc.Q_LEAF_CHANNELS, (n,), generator=gen,
                               device=dev, dtype=torch.int8)
            keep = torch.rand(n, generator=gen, device=dev) < 0.5
            ch = torch.where(keep, ch, torch.full_like(ch, -1)).contiguous()
            wch = tq.quantize_wch(grad, hess, mask,
                                  (grad * mask).abs().max() / 127,
                                  (hess * mask).max() / 127, gq_max=127,
                                  hq_max=127)
            data.append((wch, th.pack_weights(grad, hess, mask), ch))
        for q8 in (True, False):
            k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
            ws = [x[0] if q8 else x[1] for x in data]
            chs = [x[2] if q8 else torch.where(x[2] < k, x[2], -1)
                   .contiguous() for x in data]
            one = (hc.build_histogram_leaves_q8 if q8
                   else hc.build_histogram_leaves)
            want = torch.stack([one(bins, w, c, num_bins=nb)
                                for w, c in zip(ws, chs)])
            tag = f"{'q8' if q8 else 'fx'} B={nb}"

            def put(what, ms):
                rows_out.append(dict(form=tag, what=what, ms=ms))
                print(f"[{card}] {tag} L={lanes} {what}: {ms:.3f} ms",
                      flush=True)
            put("single launches", cs.time_ms(
                lambda: [one(bins, w, c, num_bins=nb)
                         for w, c in zip(ws, chs)],
                reps))
            geo = hc.list_geometry(sms, f, n, nb, k, q8)
            w3 = [w if q8 else w.w for w in ws]
            put("lanes partition", cs.time_ms(
                lambda: hc.leaf_partition_lanes(
                    chs, w3, num_channels=k, slots=geo.slots,
                    part_blocks=hc._part_blocks(sms, n, lanes)), reps))
            put("single partitions", cs.time_ms(
                lambda: [hc.leaf_partition(c, w, num_channels=k,
                                           slots=geo.slots,
                                           part_blocks=geo.part_blocks)
                         for c, w in zip(chs, w3)], reps))
            many = (hc.build_histogram_leaves_q8_lanes if q8
                    else hc.build_histogram_leaves_lanes)
            if not torch.equal(many(bins, ws, chs, num_bins=nb), want):
                raise AssertionError(f"{tag} lanes form differs")
            put("lanes form", cs.time_ms(
                lambda: many(bins, ws, chs, num_bins=nb), reps))
            del ws, chs, want
            torch.cuda.empty_cache()
        del bins, data
        torch.cuda.empty_cache()


def _fx_sweep(torch, gen, dev, n, lanes, reps, card, rows_out):
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    f, k = cs.NUM_FEATURES, hc.LEAF_CHANNELS
    real_owner, real_order = hc.list_owner, hc.list_lane_order
    real_scale = hc.fx_scale_lanes
    orders = (("a launch a lane", hc.LIST_LAUNCH_PER_LANE),
              ("one launch, lane-major", hc.LIST_LANE_MAJOR),
              ("one launch, feature-major", hc.LIST_FEATURE_MAJOR))

    def variant(owner, order, torch_scale=False, single=False):
        def run():
            hc.list_owner = lambda nb_, q8, f32: owner and real_owner(
                nb_, q8, f32)
            hc.list_lane_order = lambda geo: order
            if torch_scale:
                hc.fx_scale_lanes = th.fx_to_f32
            try:
                if single:
                    return hc.build_histogram_leaves(bins, ws[0], chs[0],
                                                     num_bins=nb)
                return hc.build_histogram_leaves_lanes(bins, ws, chs,
                                                       num_bins=nb)
            finally:
                hc.list_owner, hc.list_lane_order = real_owner, real_order
                hc.fx_scale_lanes = real_scale
        return run

    for nb, low in [(nb_, low_) for low_ in (False, True)
                    for nb_ in cs.U16_BINS]:
        bins = cs._u16_codes(torch, gen, dev, (f, n), nb)
        if low:
            # phase 12f's matrix: the last feature's codes below 256
            bins.view(torch.int16)[f - 1].copy_(
                cs._u16_codes(torch, gen, dev, (n,), 256).view(torch.int16))
        wide = th.widen_bins(bins)
        ws, mixes = [], {"even": [], "skewed": [], "one empty": []}
        light = torch.tensor([x for x in range(k) if x % 4 != 1 and x != 3],
                             dtype=torch.int8, device=dev)
        for _ in range(lanes):
            grad = torch.randn(n, generator=gen, device=dev) * 0.5
            hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
            mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
            ws.append(th.pack_weights(grad, hess, mask))
            ch = torch.randint(0, hc.Q_LEAF_CHANNELS, (n,), generator=gen,
                               device=dev, dtype=torch.int8)
            keep = torch.rand(n, generator=gen, device=dev) < 0.5
            even = torch.where(keep & (ch < k), ch, -1).to(torch.int8)
            heavy = torch.rand(n, generator=gen, device=dev) < 0.9
            pick = light[torch.randint(0, len(light), (n,), generator=gen,
                                       device=dev)]
            mixes["even"].append(even.contiguous())
            mixes["skewed"].append(torch.where(
                keep, torch.where(heavy, 3, pick), -1).to(torch.int8)
                .contiguous())
            mixes["one empty"].append(torch.where(even == 7, -1, even)
                                      .to(torch.int8).contiguous())
            del grad, hess, mask, ch, keep, even, heavy, pick
        owner_ok = real_owner(nb, False, True)
        for mix, chs in mixes.items():
            tag = f"fx B={nb}{' last feature 256 codes' if low else ''} {mix}"

            def put(what, ms, **kv):
                rows_out.append(dict(form=tag, what=what, ms=ms, **kv))
                extra = "".join(f", {a} {b}" for a, b in kv.items())
                print(f"[{card}] {tag} L={lanes} {what}: {ms:.3f} ms{extra}",
                      flush=True)
            runs = [("slot, torch fx_to_f32, a launch a lane",
                     variant(False, hc.LIST_LAUNCH_PER_LANE, True))]
            runs += [(f"slot, fused scale-back, {w}", variant(False, o))
                     for w, o in orders]
            if owner_ok:
                runs += [(f"owner, {w}", variant(True, o))
                         for w, o in orders]
            want = runs[0][1]()
            if owner_ok:
                one = variant(False, 0, single=True)
                if not torch.equal(one(), want[0]):
                    raise AssertionError(f"{tag} single form differs")
                put("lane 0's single form, slot, torch fx_to_f32",
                    cs.time_ms(one, reps))
                one = variant(True, 0, single=True)
                if not torch.equal(one(), want[0]):
                    raise AssertionError(f"{tag} single form differs")
                put("lane 0's single form, owner", cs.time_ms(one, reps))
            for i, c in enumerate(chs):
                one = hc.build_histogram_leaves(bins, ws[i], c, num_bins=nb)
                if not torch.equal(one, want[i]):
                    raise AssertionError(f"{tag} lane {i} differs from its "
                                         "single wrapper")
            put("single wrappers", cs.time_ms(
                lambda: [hc.build_histogram_leaves(bins, w, c, num_bins=nb)
                         for w, c in zip(ws, chs)], reps))
            for what, run in runs:
                if not torch.equal(run(), want):
                    raise AssertionError(f"{tag} {what} differs")
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                m0 = torch.cuda.memory_allocated()
                run()
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - m0) / 2 ** 30
                split = cs.device_split(run)
                put(what, cs.time_ms(run, reps), peak_gib=round(peak, 4),
                    split={a: round(b, 4) for a, b in split.items()})
            del want
            lib = cs._lane_library(torch, wide, [w.w for w in ws], chs, k,
                                   nb, torch.int64)
            put("library: one int64 index_add_", cs.time_ms(lib, reps))
            del lib
            torch.cuda.empty_cache()
        del bins, wide, ws, mixes
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=10_502_144)
    ap.add_argument("--lanes", type=int, default=cs.LANES)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "u16_lanes_sweep.json"))
    ap.add_argument("--parts", default="leaf,fx",
                    help="comma-separated sweeps to run: leaf, fx")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    import torch
    if not torch.cuda.is_available():
        print("torch_u16_lanes_sweep: no CUDA device", file=sys.stderr)
        return 2
    from lightgbm_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    card = cs.card_line()
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    rows = []
    for name, fn in (("leaf", _leaf_sweep), ("fx", _fx_sweep)):
        if name in parts:
            fn(torch, gen, dev, args.rows, args.lanes, args.reps, card, rows)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "rows": args.rows, "lanes": args.lanes,
                   "timings": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
