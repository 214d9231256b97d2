#!/usr/bin/env python3
"""The channel partition (``leaf_partition``, ``leaf_partition_lanes``)
timed on one CUDA card, with each of its kernels' device time.

    python3 scripts/torch_partition_sweep.py [--root DIR] [--lib SO]
                                             [--tag NAME] [--rows 10502144]
                                             [--reps 15] [--out FILE]

The data are ``chip_smoke.py`` phase 15a's: N rows and its three channel
mixes (``_u16_mixes``: today's, a skewed one, none kept), the q8 form's
int8 weights (K=42) and the exact form's int64 fixed-point weights
(K=25); and phase 12f's four lanes of q8 channels and weights (each lane
its own mix of today's kind), plus four lanes of different mixes (today,
skewed, none, today).  Each case runs at the chunk slots of B=1024 and
of B=65,535 (``list_geometry``), with the package's default row blocks.

For each case: the records and plan against the plain version (a stable
argsort) and identical across two launches; the median device time of
the wrapper over ``--reps`` runs (``chip_smoke.time_ms``: CUDA events
behind a spinning kernel); each kernel's device time a call
(``chip_smoke.device_split``: ``torch.profiler`` over 5 calls); the
bound (each input byte once, each record once, as ``chip_smoke.py``'s);
and the library yardstick, one stable ``torch.sort`` of the channels.

``--root`` runs the ``lightgbm_tpu_torch`` of another checkout (an
unpacked parent commit: ``git archive HEAD | tar -x -C build/parent``),
so that two versions compare in one chip call, each in its own process,
in turns (parent, change, change, parent).  ``--lib`` loads another
build of ``csrc/hist_leaves_u16.cu`` (a variant compiled with ``nvcc``
and ``ops/cuda_lib.py``'s flags) in place of the package's.  Prints one
line per case with the card's name and power limit, and writes them all
as JSON to ``--out`` (default ``build/partition_sweep.json``).
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 4


def _helpers():
    """This checkout's ``chip_smoke`` (timing, mixes, bounds), whichever
    package ``--root`` puts first on the path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--lib", default=None)
    ap.add_argument("--tag", default=None)
    ap.add_argument("--rows", type=int, default=10_502_144)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "partition_sweep.json"))
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    cs = _helpers()
    from lightgbm_tpu_torch.ops import cuda_lib
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.ops import quantize as tq
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.lib:
        cuda_lib._LIBS["hist_leaves_u16"] = ctypes.CDLL(
            os.path.abspath(args.lib))
    tag = args.tag or os.path.basename(root.rstrip("/"))
    card = cs.card_line()
    print(f"[{card}] {tag}: {hc.__file__}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = args.rows
    sms = hc._sm_count(dev)
    kq, kx = hc.Q_LEAF_CHANNELS, hc.LEAF_CHANNELS

    def weights():
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
        mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
        wch = tq.quantize_wch(grad, hess, mask,
                              (grad * mask).abs().max() / 127,
                              (hess * mask).max() / 127, gq_max=127,
                              hq_max=127)
        return wch, th.pack_weights(grad, hess, mask).w

    wch, wfx = weights()
    mixes = cs._u16_mixes(torch, gen, dev, n)
    lane_w = [weights()[0] for _ in range(LANES)]
    lane_today = [cs._u16_mixes(torch, gen, dev, n)[0][1]
                  for _ in range(LANES)]
    lane_mixed = [lane_today[0], mixes[1][1], mixes[2][1], lane_today[-1]]
    rows = []

    def case(form, mix, nb, run, plain, nbytes, library):
        got, again = run(), run()
        torch.cuda.synchronize()
        want = plain()
        if not isinstance(want, list):
            got, again, want = [got], [again], [want]
        for a, b, c in zip(got, again, want):
            for x, y, z in zip(cs._listed(a), cs._listed(b),
                               cs._listed(c)):
                if not (torch.equal(x, y) and torch.equal(x, z)):
                    raise AssertionError(f"{form} {mix} B={nb} differs from "
                                         "its plain version or itself")
        del got, again, want
        row = dict(tree=tag, form=form, mix=mix, num_bins=nb,
                   ms=cs.time_ms(run, args.reps),
                   bound_ms=cs.bound_ms(nbytes, 0.0)[0],
                   split=cs.device_split(run))
        lib = ""
        if library is not None:
            row["library_ms"] = cs.time_ms(library, args.reps)
            lib = f", torch.sort {row['library_ms']:.3f} ms"
        rows.append(row)
        print(f"[{card}] {tag} {form} {mix} B={nb}: {row['ms']:.4f} ms "
              f"(bound {row['bound_ms']:.4f}{lib}); device ms a call: "
              f"{cs.split_text(row['split'])}", flush=True)

    for nb in cs.U16_BINS:
        first = nb == cs.U16_BINS[0]
        geo_q = hc.list_geometry(sms, cs.NUM_FEATURES, n, nb, kq, True)
        geo_x = hc.list_geometry(sms, cs.NUM_FEATURES, n, nb, kx, False)
        for mix, chq, chx in mixes:
            for form, k, c, w_, geo, rec_bytes, w_bytes in (
                    ("q8", kq, chq, wch, geo_q, 8, 3),
                    ("fx", kx, chx, wfx, geo_x, 32, 24)):
                kept = int((c >= 0).sum())
                case(form, mix, nb,
                     lambda c=c, w_=w_, k=k, geo=geo: hc.leaf_partition(
                         c, w_, num_channels=k, slots=geo.slots),
                     lambda c=c, w_=w_, k=k, geo=geo:
                     hc.leaf_partition_plain(c, w_, num_channels=k,
                                             slots=geo.slots),
                     n + kept * (w_bytes + rec_bytes) + 4 * (4 * k + 1),
                     (lambda c=c: torch.sort(c, stable=True))
                     if mix == "today" and first else None)
        for mix, chs in (("today", lane_today), ("mixed", lane_mixed)):
            active = sum(int((c >= 0).sum()) for c in chs)
            stack = torch.stack(chs)
            case(f"lanes L={LANES}", mix, nb,
                 lambda c=chs: hc.leaf_partition_lanes(
                     c, lane_w, num_channels=kq, slots=geo_q.slots),
                 lambda c=chs: hc.leaf_partition_lanes_plain(
                     c, lane_w, num_channels=kq, slots=geo_q.slots),
                 LANES * n + active * (3 + 8) + LANES * 4 * (4 * kq + 1),
                 (lambda: torch.sort(stack, dim=1, stable=True))
                 if mix == "today" and first else None)
            del stack
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump({"card": card, "rows": n, "lanes": LANES,
                   "reps": args.reps, "cases": rows}, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
