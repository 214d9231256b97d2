#!/usr/bin/env python3
"""Sweep of the uint16 model-axis (lane) histograms on one CUDA card.

    python3 scripts/torch_u16_lanes_sweep.py [--rows 10502144] [--lanes 4]
                                             [--reps 9] [--out FILE]

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

The single-leaf form (``csrc/hist_single.cu`` ``hist_single_lanes_u16``)
on phase 12a's segments (N, N/2, 50,003, N/5) of per-lane row-major
copies (ROWS) and of the shared feature-major matrix (FEATS): L single
launches against the lanes form at ``lane_single_u16_geometry`` (each
lane's rows a block its single launch's) and at one chunk length for
every lane sized for all the lanes' rows as one segment, each equal to
the plain version's bit for bit.

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


def _single_sweep(torch, gen, dev, n, lanes, reps, card, rows_out):
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    f = cs.NUM_FEATURES
    sms = hc._sm_count(dev)
    segs = [(0, n), (n // 4, n // 2), (12_345, 50_003),
            (n // 3, n // 5)][:lanes]
    real = hc.lane_single_u16_geometry

    def one_length(sms_, f_, rows, nb, layout):
        """One chunk length for every lane, sized for all the lanes' rows
        as one segment."""
        geo = hc.single_chunks(hc.single_shape(sms_, f_, nb, layout),
                               max(1, sum(rows)))
        cs_ = geo.cluster
        return (geo._replace(chunks=cs_ * max(1, -(-max(rows) //
                                                   (cs_ * geo.chunk_rows)))),
                tuple(geo.chunk_rows for _ in rows))
    for nb in cs.U16_BINS:
        bins = cs._u16_codes(torch, gen, dev, (f, n), nb)
        P16 = [bins.view(torch.int16).t().contiguous() for _ in segs]
        ws = []
        for s, c in segs:
            grad = torch.randn(n, generator=gen, device=dev) * 0.5
            hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
            mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
            w = th.pack_weights(grad, hess, mask)
            ws.append(th.FxWeights(w.w[:, s:s + c], w.inv_scale))
        for layout in ("rows", "features"):
            sb = ([p[s:s + c].view(torch.uint16).t()
                   for p, (s, c) in zip(P16, segs)] if layout == "rows"
                  else [bins[:, s:s + c] for s, c in segs])
            want = torch.stack([hc.hist_single(b, w, num_bins=nb)
                                for b, w in zip(sb, ws)])
            tag = f"hist_single_lanes_u16 {layout} B={nb}"

            def put(what, ms):
                rows_out.append(dict(form=tag, what=what, ms=ms))
                print(f"[{card}] {tag} L={len(segs)} {what}: {ms:.3f} ms",
                      flush=True)
            put("single launches", cs.time_ms(
                lambda: [hc.hist_single(b, w, num_bins=nb)
                         for b, w in zip(sb, ws)], reps))
            for what, geo_fn in (("lanes form, each lane's rows a block",
                                  real),
                                 ("lanes form, one rows a block", one_length)):
                hc.lane_single_u16_geometry = geo_fn
                try:
                    got = hc.hist_single_lanes(sb, ws, num_bins=nb)
                    if not torch.equal(got, want):
                        raise AssertionError(f"{tag} {what} differs")
                    put(what, cs.time_ms(
                        lambda: hc.hist_single_lanes(sb, ws, num_bins=nb),
                        reps))
                finally:
                    hc.lane_single_u16_geometry = real
            g, per = real(sms, f, [c for _, c in segs], nb, layout)
            print(f"  {tag}: clusters of {g.cluster}, {g.f_groups} groups, "
                  f"{g.chunks // g.cluster} along the rows at most, rows a "
                  f"block {list(per)}", flush=True)
            del sb, want
        del bins, P16, ws
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=10_502_144)
    ap.add_argument("--lanes", type=int, default=cs.LANES)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "u16_lanes_sweep.json"))
    args = ap.parse_args()
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
    _leaf_sweep(torch, gen, dev, args.rows, args.lanes, args.reps, card,
                rows)
    _single_sweep(torch, gen, dev, args.rows, args.lanes, args.reps, card,
                  rows)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "rows": args.rows, "lanes": args.lanes,
                   "timings": rows}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
