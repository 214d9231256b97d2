#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--rows 10500000] [--rounds 10]
                          [--pack-rounds 5] [--test-rows 500000]
                          [--profile] [--out-dir DIR]

Phases (any failure exits non-zero and prints no result line):

1. environment: the card's name and power limit (``nvidia-smi``), then the
   build of every CUDA kernel from ``lightgbm_tpu_torch/csrc`` (one
   ``nvcc`` per source, all started together);
2. every kernel's wrapper against its plain PyTorch version on the card,
   at the main path's shape (F=28, B=256, W=25/42, N = the padded training
   rows) and at one ragged shape (N not a multiple of the row block,
   B=17, fewer than W active splits); quantized histogram, row update and
   trial channels bit for bit, the exact histogram bit for bit against its
   plain version, identical across two runs, and within rtol=1e-4 of an
   f32 ``index_add_``; the single-leaf histogram bit for bit and identical
   across two runs at three shapes (the main path's row-major rows read
   in place at full N and as a half-N segment; ragged N with B=17; the
   leaf-renewal column F=1, B=256); the three nibble-packed forms
   (``bins_packed=True``) bit for bit and identical across two runs at
   the main path's width with B=16 and at a ragged shape (3 row blocks,
   B=5, 10 of the W channels used); times beside the bound, the plain
   version and the library call, and for the packed forms the uint8 form
   at the same B=16 shape; the four leaf-channel forms again, bit for bit
   and identical across two runs, on a skewed mix (every row in one of 3
   channels and 4 bins) and a late wave's (5% of the rows in a channel),
   each timed beside its ``index_add_``;
3. small models trained on the card against the same models trained on
   the CPU (plain versions): quantized L2 model text identical at
   max_bin=255 and at max_bin=15 (packed bins), partitioned binary model
   text identical (failing that, partitioned predictions within 1e-5 and
   the first differing field named), exact binary wave predictions within
   1e-5;
4. the wave path at full width on synthetic rows shaped like the Higgs
   configuration of BASELINE.md (28 features, max_bin=255,
   num_leaves=255, learning_rate=0.1, binary): ``train`` in exact and in
   quantized mode, save, reload, predict a held-out set; the reloaded
   model must predict identically, and every wave kernel's launch count
   must have risen during training;
5. the partitioned path (``tree_grow_mode=partition``, exact) on the same
   rows for 3 rounds: seconds, host syncs per tree and held-out AUC per
   round, save, reload, predict; the single-leaf kernel must have
   launched;
6. 2 rounds of quantized wave training with ``quant_train_renew_leaf`` on
   the same rows: the single-leaf kernel must launch again;
7. the packed wave path: the same rows binned at max_bin=15, exact and
   quantized for ``--pack-rounds`` rounds (iterations/s, held-out AUC,
   the bytes of the bin matrix on the card, save/reload/predict); the
   packed leaf kernels must launch and the uint8 ones must not; then 3
   rounds of each mode with ``tpu_hist_pack4=false``, printing their rate
   and whether their trees equal the packed run's (information only);
8. the histogram autotuner (``tpu_histogram_impl=auto``, 140,000 rows at
   max_bin=15, 2 rounds, cache file under ``--out-dir``): the probe must
   launch both single-leaf forms, log both times and the winner and write
   the cache; with the in-process cache cleared, training again must read
   the winner from disk and launch no probe; both trainings must run the
   leaf-kernel form the winner names.

Each training path runs with the launch counts set to 0 just before it
and read just after; a kernel of the path that did not launch fails the
run.

``--profile`` adds, per wave mode (exact and quantized at max_bin=255 and
15) and for the partitioned grower, one boosting iteration under
``torch.profiler``; for the wave modes, one more iteration whose
leaf-channel launches are recorded: the share of each launch's rows in a
channel, and the whole set of launches replayed at every group of
channels x features a block can hold against the group the geometry
picks (written to ``leaf_traffic_<mode>.json`` under ``--out-dir``).

The last two lines of standard output are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory without the package beside it, the script exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_OPS_PER_S = 67e12           # H100 SXM non-tensor f32 peak
NUM_FEATURES = 28
MAX_BIN = 255
NUM_LEAVES = 255

PACK_MAX_BIN = 15                # the packed configuration's max_bin
PACK_BINS = 16                   # B of the packed kernels at the main shape
AUTOTUNE_ROWS = 140_000          # 3.92M binned cells, under the 2^22 gate

KERNELS = {
    "hist_single": ("lightgbm_tpu_torch/csrc/hist_single.cu",
                    "lightgbm_tpu/ops/histogram_pallas.py:471"),
    "hist_single_packed4": ("lightgbm_tpu_torch/csrc/hist_single.cu",
                            "lightgbm_tpu/ops/histogram_pallas.py:327"),
    "hist_leaves_q8": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                       "lightgbm_tpu/ops/histogram_pallas.py:1030"),
    "hist_leaves_q8_packed4": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                               "lightgbm_tpu/ops/histogram_pallas.py:670"),
    "hist_leaves": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                    "lightgbm_tpu/ops/histogram_pallas.py:852"),
    "hist_leaves_packed4": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                            "lightgbm_tpu/ops/histogram_pallas.py:670"),
    "wave_row_update": ("lightgbm_tpu_torch/csrc/row_update.cu",
                        "lightgbm_tpu/ops/histogram_pallas.py:1280"),
    "wave_trial_channels": ("lightgbm_tpu_torch/csrc/row_update.cu",
                            "lightgbm_tpu/ops/histogram_pallas.py:1314"),
}

WAVE_KERNELS = ("hist_leaves_q8", "hist_leaves", "wave_row_update",
                "wave_trial_channels")
PARTITION_ROUNDS = 3
RENEW_ROUNDS = 2


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


# -- timing ----------------------------------------------------------------

def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(nbytes: float, ops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# -- phase 2: kernels against their plain versions ----------------------------

def _hist_case(torch, gen, dev, f, n, num_bins, k, active=0.5):
    bins = torch.randint(0, num_bins, (f, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    grad = torch.randn(n, generator=gen, device=dev) * 0.5
    hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
    mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
    ch = torch.randint(0, k, (n,), generator=gen, device=dev,
                       dtype=torch.int8)
    keep = torch.rand(n, generator=gen, device=dev) < active
    ch = torch.where(keep, ch, torch.full_like(ch, -1)).contiguous()
    return bins, grad, hess, mask, ch


def _library_hist(torch, bins, w3, ch, k, num_bins, dtype):
    """One ``index_add_`` of a precomputed flat (channel, feature, bin)
    index: the library yardstick (the port never calls it)."""
    f = bins.shape[0]
    rows = torch.nonzero((ch >= 0) & (ch < k)).squeeze(1)
    idx = ((ch[rows].long().unsqueeze(0) * f +
            torch.arange(f, device=bins.device).unsqueeze(1)) * num_bins +
           bins[:, rows].long()).reshape(-1)
    upd = w3[:3, rows].to(dtype).t().unsqueeze(0).expand(f, -1, -1)
    upd = upd.reshape(-1, 3).contiguous()

    def call():
        out = torch.zeros((k * f * num_bins, 3), dtype=dtype,
                          device=bins.device)
        out.index_add_(0, idx, upd)
        return out.view(k, f, num_bins, 3)
    return call


def _row_case(torch, gen, dev, w, n, num_bins, num_leaves, n_active):
    cols = torch.randint(0, num_bins, (w, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    rl = torch.randint(0, num_leaves, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    i32 = torch.int32
    leaves = torch.randperm(num_leaves, generator=gen, device=dev)[:w]
    nan_bin = torch.where(torch.rand(w, generator=gen, device=dev) < 0.5,
                          torch.full((w,), num_bins - 1, device=dev),
                          torch.full((w,), -1, device=dev))
    act = torch.zeros(w, dtype=i32, device=dev)
    act[:n_active] = 1
    rows = [torch.randint(0, num_bins, (w,), generator=gen, device=dev),
            nan_bin,
            torch.randint(0, 2, (w,), generator=gen, device=dev),
            torch.randint(0, 2, (w,), generator=gen, device=dev),
            leaves, num_leaves + torch.arange(w, device=dev), act,
            torch.zeros(w, device=dev)]
    tab = torch.stack([r.to(i32) for r in rows])
    return cols, rl, tab.contiguous()


def _row_work(torch, cols, rl, tab, write_rl: bool):
    """(bytes, operations) a row update needs on these inputs: row->leaf in
    (and out), the channel out and the table, plus one column byte and a
    few compares and selects for every (row, active split) pair whose
    running leaf matches as the splits apply in order."""
    n, w = rl.shape[0], tab.shape[1]
    run = rl.clone()
    need = 0
    for j in range(w):
        hit = (run == tab[4, j]) & (tab[6, j] > 0)
        need += int(hit.sum())
        if write_rl:
            col = cols[j].to(torch.int32)
            go_left = torch.where(col == tab[1, j], tab[2, j],
                                  (col <= tab[0, j]).to(torch.int32))
            run = torch.where(hit & (go_left == 0), tab[5, j], run)
    nbytes = 4.0 * n + need + n + 32.0 * w + (4.0 * n if write_rl else 0.0)
    return nbytes, 6.0 * need + n


def kernel_phase(card: str, n_main: int, reps: int, seed: int) -> dict:
    import torch
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.ops import quantize as tq

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    f = NUM_FEATURES
    rec = {}

    def q8_weights(grad, hess, mask):
        gs = (grad * mask).abs().max() / 127
        hs = (hess * mask).max() / 127
        return tq.quantize_wch(grad, hess, mask, gs, hs, gq_max=127,
                               hq_max=127)

    shapes = [("main", n_main, 256, None), ("ragged", 1_000_003, 17, 10)]
    for tag, n, nb, n_act in shapes:
        # ---- quantized histogram: bitwise ----
        k = hc.Q_LEAF_CHANNELS
        bins, grad, hess, mask, ch = _hist_case(torch, gen, dev, f, n, nb, k)
        wch = q8_weights(grad, hess, mask)
        got = hc.build_histogram_leaves_q8(bins, wch, ch, num_bins=nb)
        again = hc.build_histogram_leaves_q8(bins, wch, ch, num_bins=nb)
        torch.cuda.synchronize()
        want = hc.build_histogram_leaves_q8_plain(bins, wch, ch, num_bins=nb)
        err = float((got.long() - want.long()).abs().max())
        if not torch.equal(got, again):
            raise AssertionError(f"hist_leaves_q8 [{tag}] differs between "
                                 "two runs")
        if not torch.equal(got, want):
            raise AssertionError(f"hist_leaves_q8 [{tag}] differs from its "
                                 f"plain version (max abs err {err})")
        log(f"kernel hist_leaves_q8 [{tag} F={f} N={n} B={nb} K={k}]: "
            "bitwise equal to plain, identical across two runs")
        if tag == "main":
            active = int(((ch >= 0) & (ch < k)).sum())
            nbytes = n + active * (f + 3) + k * f * nb * 3 * 4
            b_ms, b_by = bound_ms(nbytes, 3.0 * f * active)
            lib = _library_hist(torch, bins, wch, ch, k, nb, torch.int32)
            rec["hist_leaves_q8"] = dict(
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                ms=time_ms(lambda: hc.build_histogram_leaves_q8(
                    bins, wch, ch, num_bins=nb), reps),
                plain_ms=time_ms(lambda: hc.build_histogram_leaves_q8_plain(
                    bins, wch, ch, num_bins=nb), 3),
                library_ms=time_ms(lib, reps))
            del lib
        del wch, got, again, want

        # ---- exact histogram: bitwise vs plain, deterministic ----
        k = hc.LEAF_CHANNELS
        ch = torch.where(ch < k, ch, torch.full_like(ch, -1)).contiguous()
        w = th.pack_weights(grad, hess, mask)
        got = hc.build_histogram_leaves(bins, w, ch, num_bins=nb)
        again = hc.build_histogram_leaves(bins, w, ch, num_bins=nb)
        torch.cuda.synchronize()
        want = hc.build_histogram_leaves_plain(bins, w, ch, num_bins=nb)
        err = float((got - want).abs().max())
        if not torch.equal(got, again):
            raise AssertionError(f"hist_leaves [{tag}] differs between two "
                                 "runs")
        if not torch.equal(got, want):
            raise AssertionError(f"hist_leaves [{tag}] differs from its "
                                 f"plain version (max abs err {err})")
        w3 = torch.stack([grad * mask, hess * mask, (mask > 0).float()])
        lib = _library_hist(torch, bins, w3, ch, k, nb, torch.float32)
        ref = lib()
        if not torch.equal(got[..., 2], ref[..., 2]):
            raise AssertionError(f"hist_leaves [{tag}] counts differ from "
                                 "the f32 index_add_")
        for c in (0, 1):
            scale = float(ref[..., c].abs().max())
            torch.testing.assert_close(got[..., c], ref[..., c], rtol=1e-4,
                                       atol=1e-5 * scale)
        log(f"kernel hist_leaves [{tag} F={f} N={n} B={nb} K={k}]: bitwise "
            "equal to plain, identical across two runs, within rtol=1e-4 "
            "of an f32 index_add_ (counts exact)")
        if tag == "main":
            active = int(((ch >= 0) & (ch < k)).sum())
            nbytes = n + active * (f + 24) + k * f * nb * 3 * 4
            b_ms, b_by = bound_ms(nbytes, 3.0 * f * active)
            rec["hist_leaves"] = dict(
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                ms=time_ms(lambda: hc.build_histogram_leaves(
                    bins, w, ch, num_bins=nb), reps),
                plain_ms=time_ms(lambda: hc.build_histogram_leaves_plain(
                    bins, w, ch, num_bins=nb), 3),
                library_ms=time_ms(lib, reps))
        del lib, ref, w, w3, got, again, want, bins, grad, hess, mask, ch
        torch.cuda.empty_cache()

        # ---- row update and trial channels: bitwise ----
        for wn in (hc.LEAF_CHANNELS, hc.Q_LEAF_CHANNELS):
            cols, rl, tab = _row_case(torch, gen, dev, wn, n, nb, NUM_LEAVES,
                                      n_act or wn)
            rl_k, ch_k = hc.wave_row_update(cols, rl, tab)
            torch.cuda.synchronize()
            rl_p, ch_p = hc.wave_row_update_plain(cols, rl, tab)
            if not (torch.equal(rl_k, rl_p) and torch.equal(ch_k, ch_p)):
                raise AssertionError(f"wave_row_update [{tag} W={wn}] "
                                     "differs from its plain version")
            targs = (tab[4], tab[0], tab[1], tab[2] > 0, tab[3] > 0,
                     tab[6] > 0)
            tr_k = hc.wave_trial_channels(cols, rl, *targs)
            torch.cuda.synchronize()
            tr_p = hc.wave_trial_channels_plain(cols, rl, *targs)
            if not torch.equal(tr_k, tr_p):
                raise AssertionError(f"wave_trial_channels [{tag} W={wn}] "
                                     "differs from its plain version")
            log(f"kernel wave_row_update, wave_trial_channels [{tag} W={wn} "
                f"N={n} active={n_act or wn}]: bitwise equal to plain")
            if tag == "main" and wn == hc.LEAF_CHANNELS:
                for name, fn, plain, write_rl in (
                        ("wave_row_update",
                         lambda: hc.wave_row_update(cols, rl, tab),
                         lambda: hc.wave_row_update_plain(cols, rl, tab),
                         True),
                        ("wave_trial_channels",
                         lambda: hc.wave_trial_channels(cols, rl, *targs),
                         lambda: hc.wave_trial_channels_plain(cols, rl,
                                                              *targs),
                         False)):
                    b_ms, b_by = bound_ms(*_row_work(torch, cols, rl, tab,
                                                     write_rl))
                    rec[name] = dict(max_abs_err=0.0, bound_ms=b_ms,
                                     bound_by=b_by, ms=time_ms(fn, reps),
                                     plain_ms=time_ms(plain, 3),
                                     library_ms=None)
            del cols, rl, tab, rl_k, ch_k, rl_p, ch_p, tr_k, tr_p
        torch.cuda.empty_cache()

    rec["hist_single"] = single_leaf_phase(torch, gen, dev, n_main, reps)
    rec.update(packed_phase(torch, gen, dev, n_main, reps))
    leaf_stress_phase(torch, gen, dev, card, n_main, reps)

    for name, r in rec.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        u8 = (f", uint8 form at B={PACK_BINS} {r['uint8_ms']:.3f} ms"
              if "uint8_ms" in r else "")
        log(f"[{card}] {name} @ N={n_main}: kernel {r['ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.3f} ms, library {lib}{u8}")
    return rec


def packed_phase(torch, gen, dev, n_main: int, reps: int) -> dict:
    """The three nibble-packed kernels against their plain versions, bit
    for bit and identical across two runs, at the main path's width
    (F=28, B=16, N = the padded training rows, half the rows in a channel)
    and at a ragged shape (3 row blocks, B=5, 10 of the W channels used);
    at the main width, each timed beside its bound, its plain version, one
    ``index_add_`` on the unpacked bins and its uint8 form at B=16."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.ops import quantize as tq
    f = NUM_FEATURES
    rec = {}
    for tag, n, nb, k_act in (("main", n_main, PACK_BINS, None),
                              ("ragged", 3 * 4096, 5, 10)):
        bins = torch.randint(0, nb, (f, n), generator=gen, device=dev,
                             dtype=torch.uint8)
        packed = th.pack_bins4(bins)
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
        mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
        keep = torch.rand(n, generator=gen, device=dev) < 0.5
        gs = (grad * mask).abs().max() / 127
        hs = (hess * mask).max() / 127
        wch = tq.quantize_wch(grad, hess, mask, gs, hs, gq_max=127,
                              hq_max=127)
        w = th.pack_weights(grad, hess, mask)
        cases = []
        for name, k, wts in (("hist_leaves_q8_packed4", hc.Q_LEAF_CHANNELS,
                              wch),
                             ("hist_leaves_packed4", hc.LEAF_CHANNELS, w)):
            ch = torch.randint(0, k_act or k, (n,), generator=gen,
                               device=dev, dtype=torch.int8)
            ch = torch.where(keep, ch, torch.full_like(ch, -1)).contiguous()
            leaf = (hc.build_histogram_leaves_q8 if k == hc.Q_LEAF_CHANNELS
                    else hc.build_histogram_leaves)
            plain = (hc.build_histogram_leaves_q8_plain
                     if k == hc.Q_LEAF_CHANNELS
                     else hc.build_histogram_leaves_plain)
            cases.append((name, k, ch, wts,
                          lambda b, p, leaf=leaf, wts=wts, ch=ch: leaf(
                              b, wts, ch, num_bins=nb, bins_packed=p),
                          lambda plain=plain, wts=wts, ch=ch: plain(
                              packed, wts, ch, num_bins=nb,
                              bins_packed=True)))
        cases.append(("hist_single_packed4", 1, None, w,
                      lambda b, p: hc.hist_single(b, w, num_bins=nb,
                                                  bins_packed=p),
                      lambda: hc.hist_single_plain(packed, w, num_bins=nb,
                                                   bins_packed=True)))
        for name, k, ch, wts, run, plain in cases:
            before = dict(hc.LAUNCHES)
            got = run(packed, True)
            again = run(packed, True)
            torch.cuda.synchronize()
            if hc.LAUNCHES[name] != before[name] + 2:
                raise AssertionError(f"{name} [{tag}]: the packed kernel "
                                     "did not launch")
            want = plain()
            err = float((got.double() - want.double()).abs().max())
            if not torch.equal(got, again):
                raise AssertionError(f"{name} [{tag}] differs between two "
                                     "runs")
            if not torch.equal(got, want):
                raise AssertionError(f"{name} [{tag}] differs from its "
                                     f"plain version (max abs err {err})")
            log(f"kernel {name} [{tag} F={f} N={n} B={nb} K={k}"
                f"{'' if k_act is None else f' active channels {k_act}'}]: "
                "bitwise equal to plain, identical across two runs")
            if tag != "main":
                continue
            # bytes: the channel of every row (leaf forms) or the 24
            # weight bytes of every row (single leaf), the weights of
            # rows that add, the F bin bytes of every byte pair holding
            # such a row, the output
            if ch is None:
                live = (wts.w != 0).any(dim=0)
                wbytes, out_b = 24.0 * n, f * nb * 24
            else:
                live = (ch >= 0) & (ch < k)
                wsz = 3 if name == "hist_leaves_q8_packed4" else 24
                wbytes, out_b = n + wsz * float(live.sum()), k * f * nb * 12
            active = int(live.sum())
            pairs = int(live.view(-1, 2).any(dim=1).sum())
            b_ms, b_by = bound_ms(wbytes + f * pairs + out_b,
                                  3.0 * f * active)
            if ch is None:
                rows = torch.nonzero(live).squeeze(1)
                idx = (torch.arange(f, device=dev).unsqueeze(1) * nb +
                       bins[:, rows].long()).reshape(-1)
                upd = wts.w[:, rows].t().unsqueeze(0).expand(f, -1, -1)
                upd = upd.reshape(-1, 3).contiguous()

                def lib(idx=idx, upd=upd):
                    o = torch.zeros((f * nb, 3), dtype=torch.int64,
                                    device=dev)
                    o.index_add_(0, idx, upd)
                    return o
            else:
                w3 = wts if k == hc.Q_LEAF_CHANNELS else wts.w
                lib = _library_hist(torch, bins, w3, ch, k, nb,
                                    torch.int32 if k == hc.Q_LEAF_CHANNELS
                                    else torch.int64)
            rec[name] = dict(
                max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                ms=time_ms(lambda: run(packed, True), reps),
                plain_ms=time_ms(plain, 3), library_ms=time_ms(lib, reps),
                uint8_ms=time_ms(lambda: run(bins, False), reps))
            del lib
        del bins, packed, grad, hess, mask, keep, wch, w, cases
        torch.cuda.empty_cache()
    return rec


def leaf_stress_phase(torch, gen, dev, card, n_main: int, reps: int) -> None:
    """The four leaf-channel forms at the main path's width on two more row
    mixes: ``skewed`` (every row in one of 3 channels and one of 4 bins of
    every feature: the most contention, and the largest per-bin sums of
    the q8 kernel's packed (g, h)) and ``5% active`` (a late wave: 5% of
    the rows in a channel); each bit for bit its plain version and
    identical across two runs, timed beside one ``index_add_`` of the same
    sums (uint8 forms at B=256, packed at B=16)."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.ops import quantize as tq
    f, n = NUM_FEATURES, n_main
    grad = torch.randn(n, generator=gen, device=dev) * 0.5
    hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
    mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
    wch = tq.quantize_wch(grad, hess, mask, (grad * mask).abs().max() / 127,
                          (hess * mask).max() / 127, gq_max=127, hq_max=127)
    w = th.pack_weights(grad, hess, mask)
    for mix in ("skewed", "5% active"):
        for nb, packed in ((256, False), (PACK_BINS, True)):
            hi = 4 if mix == "skewed" else nb
            bins = torch.randint(0, hi, (f, n), generator=gen, device=dev,
                                 dtype=torch.uint8)
            b_in = th.pack_bins4(bins) if packed else bins
            for q8 in (True, False):
                k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
                if mix == "skewed":
                    ch = torch.randint(0, 3, (n,), generator=gen, device=dev,
                                       dtype=torch.int8)
                else:
                    ch = torch.randint(0, k, (n,), generator=gen, device=dev,
                                       dtype=torch.int8)
                    keep = torch.rand(n, generator=gen, device=dev) < 0.05
                    ch = torch.where(keep, ch, torch.full_like(ch, -1))
                ch = ch.contiguous()
                run = (hc.build_histogram_leaves_q8 if q8
                       else hc.build_histogram_leaves)
                plain = (hc.build_histogram_leaves_q8_plain if q8
                         else hc.build_histogram_leaves_plain)
                wts = wch if q8 else w
                name = (("hist_leaves_q8" if q8 else "hist_leaves") +
                        ("_packed4" if packed else ""))
                before = hc.LAUNCHES[name]
                got = run(b_in, wts, ch, num_bins=nb, bins_packed=packed)
                again = run(b_in, wts, ch, num_bins=nb, bins_packed=packed)
                torch.cuda.synchronize()
                if hc.LAUNCHES[name] != before + 2:
                    raise AssertionError(f"{name} [{mix}] did not launch")
                want = plain(b_in, wts, ch, num_bins=nb, bins_packed=packed)
                if not torch.equal(got, again):
                    raise AssertionError(f"{name} [{mix}] differs between "
                                         "two runs")
                if not torch.equal(got, want):
                    err = float((got.double() - want.double()).abs().max())
                    raise AssertionError(f"{name} [{mix}] differs from its "
                                         f"plain version (max abs err {err})")
                del got, again, want
                lib = _library_hist(torch, bins, wch if q8 else w.w, ch, k,
                                    nb, torch.int32 if q8 else torch.int64)
                ms = time_ms(lambda: run(b_in, wts, ch, num_bins=nb,
                                         bins_packed=packed), reps)
                lib_ms = time_ms(lib, reps)
                del lib
                torch.cuda.empty_cache()
                log(f"kernel {name} [{mix} F={f} N={n} B={nb} K={k}]: "
                    "bitwise equal to plain, identical across two runs")
                log(f"[{card}] {name} [{mix}] @ N={n}: kernel {ms:.3f} ms, "
                    f"library {lib_ms:.3f} ms ({lib_ms / ms:.2f}x)")
            del bins, b_in
    del grad, hess, mask, wch, w
    torch.cuda.empty_cache()


def single_leaf_phase(torch, gen, dev, n_main: int, reps: int) -> dict:
    """``hist_single`` against its plain version, bit for bit and across
    two runs, at the shapes its callers give it; timed at the partitioned
    grower's root pass (the full padded rows, row-major, read in place)."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    f = NUM_FEATURES
    out = None
    cases = [("main, row-major rows, full N", f, n_main, 256, "rows", 0,
              n_main),
             ("main, row-major segment, half N", f, n_main, 256, "rows",
              n_main // 4, n_main // 2),
             ("ragged", f, 1_000_003, 17, "features", 0, 1_000_003),
             ("renew column", 1, n_main, 256, "features", 0, n_main)]
    for tag, nf, n, nb, layout, s0, cnt in cases:
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
        mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
        w = th.pack_weights(grad, hess, mask)
        if layout == "rows":
            P = torch.randint(0, nb, (n, nf), generator=gen, device=dev,
                              dtype=torch.uint8)
            bins = P[s0:s0 + cnt].t()
        else:
            bins = torch.randint(0, nb, (nf, n), generator=gen, device=dev,
                                 dtype=torch.uint8)
        wv = th.FxWeights(w.w[:, s0:s0 + cnt], w.inv_scale)
        got = hc.hist_single(bins, wv, num_bins=nb)
        again = hc.hist_single(bins, wv, num_bins=nb)
        torch.cuda.synchronize()
        want = hc.hist_single_plain(bins, wv, num_bins=nb)
        err = float((got - want).abs().max())
        if not torch.equal(got, again):
            raise AssertionError(f"hist_single [{tag}] differs between two "
                                 "runs")
        if not torch.equal(got, want):
            raise AssertionError(f"hist_single [{tag}] differs from its "
                                 f"plain version (max abs err {err})")
        log(f"kernel hist_single [{tag}: F={nf} N={cnt} B={nb} strides "
            f"{tuple(bins.stride())}]: bitwise equal to plain, identical "
            "across two runs")
        if out is None:
            # bytes: every row's 24 weight bytes, the bins of rows whose
            # weights are not all zero, the (F, B, 3) int64 output
            active = int((wv.w != 0).any(dim=0).sum())
            nbytes = 24.0 * cnt + nf * active + nf * nb * 24
            b_ms, b_by = bound_ms(nbytes, 3.0 * nf * active)
            rows = torch.nonzero((wv.w != 0).any(dim=0)).squeeze(1)
            idx = (torch.arange(nf, device=dev).unsqueeze(1) * nb +
                   bins[:, rows].long()).reshape(-1)
            upd = wv.w[:, rows].t().unsqueeze(0).expand(nf, -1, -1)
            upd = upd.reshape(-1, 3).contiguous()

            def lib():
                o = torch.zeros((nf * nb, 3), dtype=torch.int64, device=dev)
                o.index_add_(0, idx, upd)
                return o
            if not torch.equal(lib().view(nf, nb, 3), want):
                raise AssertionError("hist_single: the index_add_ yardstick "
                                     "computes other sums")
            out = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                       ms=time_ms(lambda: hc.hist_single(
                           bins, wv, num_bins=nb), reps),
                       plain_ms=time_ms(lambda: hc.hist_single_plain(
                           bins, wv, num_bins=nb), 3),
                       library_ms=time_ms(lib, reps))
            del idx, upd, rows, lib
        else:
            out["max_abs_err"] = max(out["max_abs_err"], err)
        del got, again, want, bins, w, wv, grad, hess, mask
        torch.cuda.empty_cache()
    return out


# -- phases 3 to 6: training -------------------------------------------------

def higgs_like(n: int, seed: int):
    """Synthetic rows shaped like the Higgs benchmark (BASELINE.md): 21
    low-level kinematic columns (skewed momenta, angles, b-tags) and 7
    high-level nonlinear combinations, a binary label drawn from a
    nonlinear logit; 1% NaN in two columns exercises the NaN bins."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, NUM_FEATURES), dtype=np.float32)
    pt = [0, 3, 5, 9, 13, 17]
    X[:, pt] = np.exp(0.5 * X[:, pt])
    for c in (8, 12, 16, 20):                       # b-tag levels
        X[:, c] = np.floor(np.clip(X[:, c] + 1.0, 0.0, 2.99))
    X[:, 21] = X[:, 0] * X[:, 3] + X[:, 5]
    X[:, 22] = np.sqrt(X[:, 9] * X[:, 13]) + 0.3 * X[:, 22]
    X[:, 23] = np.abs(X[:, 1] - X[:, 6]) + 0.2 * X[:, 23]
    X[:, 24] = X[:, 17] * np.cos(X[:, 2]) + 0.5 * X[:, 24]
    X[:, 25] = np.log1p(X[:, 0] + X[:, 9]) + 0.1 * X[:, 25]
    X[:, 26] = X[:, 21] - X[:, 22] + 0.5 * X[:, 26]
    X[:, 27] = X[:, 23] * X[:, 8] + 0.5 * X[:, 27]
    logit = (0.8 * X[:, 21] - 0.6 * X[:, 22] + 0.9 * np.sin(2.0 * X[:, 23])
             + 0.4 * X[:, 25] * X[:, 12] - 0.5 * X[:, 27] + 0.3 * X[:, 4]
             - 0.5)
    y = (rng.random(n, dtype=np.float32) <
         1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    for c in (4, 10):
        X[rng.random(n) < 0.01, c] = np.nan
    return X, y, logit.astype(np.float32)


def auc(y: np.ndarray, p: np.ndarray) -> float:
    """Rank AUC with ties at their average rank."""
    order = np.argsort(p, kind="mergesort")
    ps, ys = p[order], y[order]
    _, first, counts = np.unique(ps, return_index=True, return_counts=True)
    ranks = np.repeat(first + (counts + 1) / 2.0, counts)
    npos = float(ys.sum())
    nneg = len(ys) - npos
    return float((ranks[ys > 0].sum() - npos * (npos + 1) / 2) /
                 (npos * nneg))


def small_check(lt, seed: int) -> None:
    """The same small model on the card and on the CPU."""
    X, y, logit = higgs_like(20_000, seed + 1)
    base = dict(num_leaves=31, max_bin=MAX_BIN, verbosity=-1,
                stochastic_rounding=False)
    pq = dict(base, objective="regression", use_quantized_grad=True)
    a = lt.train(pq, lt.Dataset(X, logit), 3, device="cuda")
    b = lt.train(pq, lt.Dataset(X, logit), 3, device="cpu")
    if a.model_to_string() != b.model_to_string():
        raise AssertionError("quantized L2 model trained on the card differs "
                             "from the one trained on the CPU")
    p4 = dict(pq, max_bin=PACK_MAX_BIN, tpu_histogram_impl="pallas")
    a = lt.train(p4, lt.Dataset(X, logit), 3, device="cuda")
    b = lt.train(p4, lt.Dataset(X, logit), 3, device="cpu")
    if not (a._gbdt.learner.pack4 and b._gbdt.learner.pack4):
        raise AssertionError(f"max_bin={PACK_MAX_BIN} did not pack the bins")
    if a.model_to_string() != b.model_to_string():
        raise AssertionError(f"quantized L2 model at max_bin={PACK_MAX_BIN} "
                             "(packed bins) trained on the card differs "
                             "from the one trained on the CPU")
    pe = dict(base, objective="binary", use_quantized_grad=False)
    a = lt.train(pe, lt.Dataset(X, y), 3, device="cuda")
    b = lt.train(pe, lt.Dataset(X, y), 3, device="cpu")
    pa, pb = a.predict(X), b.predict(X)
    err = float(np.abs(pa - pb).max())
    if not (np.all(np.isfinite(pa)) and err <= 1e-5):
        raise AssertionError(f"exact binary model on the card predicts "
                             f"{err} away from the CPU's")
    pp = dict(pe, tree_grow_mode="partition")
    a = lt.train(pp, lt.Dataset(X, y), 3, device="cuda")
    b = lt.train(pp, lt.Dataset(X, y), 3, device="cpu")
    sa, sb = a.model_to_string(), b.model_to_string()
    if sa == sb:
        part = "partitioned binary model text identical"
    else:
        first = next(la.split("=", 1)[0] for la, lb in
                     zip(sa.splitlines(), sb.splitlines()) if la != lb)
        perr = float(np.abs(a.predict(X) - b.predict(X)).max())
        log(f"partitioned binary model text differs from the CPU's, first "
            f"in field {first!r}; predictions within {perr:.3g}")
        if not perr <= 1e-5:
            raise AssertionError(f"partitioned binary model on the card "
                                 f"predicts {perr} away from the CPU's")
        part = f"partitioned binary predictions within {perr:.3g}"
    log(f"small models (20000x{NUM_FEATURES}, 31 leaves, 3 rounds): "
        f"quantized L2 model text identical on card and CPU, at "
        f"max_bin={MAX_BIN} and at max_bin={PACK_MAX_BIN} with packed bins; "
        f"{part}; exact binary wave predictions within {err:.3g}")


def mode_params(mode: str, max_bin: int = MAX_BIN, **extra) -> dict:
    """exact / quantized wave, partition (exact), renew (quantized wave
    with leaf renewal)."""
    return dict(objective="binary", num_leaves=NUM_LEAVES, max_bin=max_bin,
                learning_rate=0.1, verbosity=-1, **extra,
                use_quantized_grad=mode in ("quantized", "renew"),
                quant_train_renew_leaf=(mode == "renew"),
                tree_grow_mode=("partition" if mode == "partition"
                                else "wave"),
                stochastic_rounding=False)


def train_mode(lt, torch, card, ds, Xte, yte, mode, rounds, out_dir,
               tag="", **extra):
    """Train ``mode`` on ``ds`` for ``rounds`` rounds, print its rate and
    launches, save, reload and predict the held-out rows; returns the
    booster."""
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    params = mode_params(mode, **extra)
    mode = mode + tag
    before = dict(hc.LAUNCHES)
    ticks, syncs = [], []

    def tick(env):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())
        syncs.append(env.model._gbdt.last_host_syncs)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, rounds, callbacks=[tick])
    total = ticks[-1] - t0
    first = ticks[0] - t0
    steady = ((len(ticks) - 1) / (ticks[-1] - ticks[0])
              if len(ticks) > 1 else float("nan"))
    per_mode = {k: hc.LAUNCHES[k] - before[k] for k in hc.LAUNCHES}
    per_tree = {k: round(v / max(len(ticks), 1), 2)
                for k, v in per_mode.items()}
    log(f"[{card}] train {mode}: {len(ticks)} rounds in {total:.3f} s "
        f"(first {first:.3f} s), steady {steady:.4f} iterations/s; "
        f"launches {json.dumps(per_mode)}, per tree {json.dumps(per_tree)}")
    if mode == "partition":
        for k in range(len(ticks)):
            secs = ticks[k] - (ticks[k - 1] if k else t0)
            a_k = auc(yte, bst.predict(Xte, num_iteration=k + 1))
            log(f"[{card}] partition round {k + 1}: {secs:.3f} s, "
                f"{syncs[k]} host syncs in the tree, held-out AUC {a_k:.6f}")
            if not a_k > 0.6:
                raise AssertionError(f"partition round {k + 1}: held-out "
                                     f"AUC {a_k} is no better than chance")
    if bst.num_trees() != rounds:
        raise AssertionError(f"{mode}: {bst.num_trees()} trees, expected "
                             f"{rounds}")

    path = os.path.join(out_dir, f"model_{mode}.txt")
    bst.save_model(path)
    again = lt.Booster(model_file=path)
    t1 = time.perf_counter()
    p = bst.predict(Xte)
    t_pred = time.perf_counter() - t1
    p2 = again.predict(Xte)
    if p.shape != (len(Xte),) or not np.all(np.isfinite(p)):
        raise AssertionError(f"{mode}: predictions not finite or of wrong "
                             "shape")
    if not np.array_equal(p, p2):
        raise AssertionError(f"{mode}: the reloaded model predicts "
                             "differently")
    a = auc(yte, p)
    log(f"[{card}] {mode}: held-out AUC {a:.6f} over {len(Xte)} rows "
        f"(reloaded model identical); predict {t_pred:.3f} s")
    if not a > 0.6:
        raise AssertionError(f"{mode}: held-out AUC {a} is no better than "
                             "chance")
    return bst


def tree_blocks(text: str) -> list:
    """The ``Tree=`` blocks of a model text, without the parameters."""
    body = text.split("end of trees")[0]
    return ["Tree=" + b for b in body.split("Tree=")[1:]]


def packed_path(lt, torch, card, Xtr, ytr, Xte, yte, rounds, out_dir,
                profile):
    """The wave path at max_bin=15: exact and quantized with packed bins,
    then ``rounds_off`` rounds of each with ``tpu_hist_pack4=false`` on the
    same data (information only: the ramp's subsample strides over row
    pairs when packed and over rows when not, so the trees may differ).
    ``profile`` adds one profiled iteration of each packed mode."""
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    t0 = time.perf_counter()
    ds = lt.Dataset(Xtr, ytr, params={"max_bin": PACK_MAX_BIN})
    ds.construct()
    log(f"packed path data: max_bin={PACK_MAX_BIN}, binned in "
        f"{time.perf_counter() - t0:.1f} s")
    hc.reset_launches()
    packed = {}
    for mode in ("exact", "quantized"):
        packed[mode] = train_mode(lt, torch, card, ds, Xte, yte, mode,
                                  rounds, out_dir, tag="_pack4",
                                  max_bin=PACK_MAX_BIN)
    got = dict(hc.LAUNCHES)
    gb = packed["exact"]._gbdt
    X_T = gb.X_T
    n_pad = X_T.shape[1] * 2
    log(f"packed path launches: {json.dumps(got)}; bin matrix on the card "
        f"{tuple(X_T.shape)} {X_T.dtype}, {X_T.numel() * X_T.element_size()} "
        f"bytes (uint8 bins would take {NUM_FEATURES * n_pad} bytes); peak "
        f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not gb.learner.pack4 or X_T.shape[1] * 2 != n_pad:
        raise AssertionError("the packed path did not keep packed bins")
    need = ("hist_leaves_packed4", "hist_leaves_q8_packed4",
            "wave_row_update", "wave_trial_channels")
    missing = [k for k in need if got[k] <= 0]
    uint8 = [k for k in ("hist_leaves", "hist_leaves_q8") if got[k] != 0]
    if missing or uint8:
        raise AssertionError(f"packed path: kernels not launched {missing}, "
                             f"uint8 leaf kernels launched {uint8}")
    launches = dict(got)
    rounds_off = min(rounds, 3)
    hc.reset_launches()
    for mode in ("exact", "quantized"):
        off = train_mode(lt, torch, card, ds, Xte, yte, mode, rounds_off,
                         out_dir, tag="_pack4_off", max_bin=PACK_MAX_BIN,
                         tpu_hist_pack4=False)
        same = (tree_blocks(off.model_to_string()) ==
                tree_blocks(packed[mode].model_to_string(
                    num_iteration=rounds_off)))
        log(f"[{card}] {mode} at max_bin={PACK_MAX_BIN}, tpu_hist_pack4="
            f"false: first {rounds_off} trees "
            f"{'equal' if same else 'differ from'} the packed run's "
            "(information: the ramp's subsample differs by design)")
    for k, v in hc.LAUNCHES.items():
        launches[k] += v
    if profile:
        for mode in ("exact", "quantized"):
            profile_iteration(lt, torch, card, ds,
                              mode_params(mode, max_bin=PACK_MAX_BIN),
                              mode + "_pack4", out_dir)
    return launches


def autotune_phase(lt, torch, card, seed: int, out_dir: str) -> dict:
    """``tpu_histogram_impl=auto`` on a small packed-eligible dataset: the
    probe times both single-leaf forms, logs them and the winner, and
    writes the cache; with the in-process cache cleared, a second training
    reads the winner from disk and probes nothing.  Both trainings run the
    leaf-kernel form the winner names."""
    from lightgbm_tpu_torch.learner import autotune
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.utils.log import register_log_callback
    path = os.path.join(out_dir, "hist_autotune.json")
    if os.path.exists(path):
        os.remove(path)
    os.environ["LGBM_TPU_TORCH_AUTOTUNE_CACHE"] = path
    X, y, _ = higgs_like(AUTOTUNE_ROWS, seed + 2)
    ds = lt.Dataset(X, y, params={"max_bin": PACK_MAX_BIN})
    params = dict(objective="binary", num_leaves=63, max_bin=PACK_MAX_BIN,
                  verbosity=1, metric_freq=0, tpu_histogram_impl="auto")
    launches = {k: 0 for k in hc.LAUNCHES}
    winner = None
    for attempt in ("probe", "from disk"):
        # a fresh process, as far as the autotuner can tell
        autotune._CACHE.clear()
        autotune._DISK_LOADED.clear()
        lines = []
        hc.reset_launches()
        register_log_callback(lines.append)
        try:
            bst = lt.train(params, ds, 2)
        finally:
            register_log_callback(None)
        got = dict(hc.LAUNCHES)
        said = [ln.strip() for ln in lines if "histogram autotune" in ln]
        log(f"[{card}] autotune {attempt}: {said}; launches "
            f"{json.dumps(got)}")
        if len(said) != 1:
            raise AssertionError(f"autotune {attempt}: expected one "
                                 f"autotune line, got {said}")
        pack4 = bst._gbdt.learner.pack4
        if attempt == "probe":
            if not (got["hist_single"] > 0 and
                    got["hist_single_packed4"] > 0):
                raise AssertionError("the autotune probe did not launch "
                                     "both single-leaf forms")
            if not ("pallas=" in said[0] and "pallas:packed4=" in said[0]):
                raise AssertionError("the probe did not log both times")
            winner = said[0].rsplit("-> ", 1)[1]
            with open(path) as fh:
                stored = json.load(fh)["winners"]
            key = (f"cuda/{AUTOTUNE_ROWS}x{NUM_FEATURES}x"
                   f"{bst._gbdt.max_bins}/pallas,pallas:packed4")
            if stored.get(key) != winner:
                raise AssertionError(f"cache {stored} lacks {key} -> "
                                     f"{winner}")
        else:
            if "cached winner" not in said[0] or winner not in said[0]:
                raise AssertionError(f"the winner did not come from disk: "
                                     f"{said[0]}")
            if got["hist_single"] or got["hist_single_packed4"]:
                raise AssertionError("a probe kernel launched although the "
                                     "winner was on disk")
        want = "hist_leaves_packed4" if winner == "pallas:packed4" \
            else "hist_leaves"
        other = "hist_leaves" if want == "hist_leaves_packed4" \
            else "hist_leaves_packed4"
        if pack4 != (winner == "pallas:packed4") or not got[want] or \
                got[other]:
            raise AssertionError(f"autotune {attempt}: training ran "
                                 f"{json.dumps(got)} for winner {winner}")
        for k, v in got.items():
            launches[k] += v
    del os.environ["LGBM_TPU_TORCH_AUTOTUNE_CACHE"]
    log(f"[{card}] autotune at ({AUTOTUNE_ROWS}, {NUM_FEATURES}, "
        f"max_bin={PACK_MAX_BIN}): winner {winner}, written to and read "
        "back from the disk cache; training ran its leaf-kernel form")
    return launches


def profile_iteration(lt, torch, card, ds, params, mode, out_dir) -> None:
    """One boosting iteration under ``torch.profiler``: device time by
    kernel and the device's busy share, written under ``out_dir``."""
    from torch.profiler import ProfilerActivity, profile
    bst = lt.Booster(params=params, train_set=ds)
    bst.update()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bst.update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    with open(os.path.join(out_dir, f"profile_{mode}.txt"), "w") as fh:
        fh.write(f"{card}\nwall {wall:.6f} s\n{table}\n")
    from torch.autograd import DeviceType

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))
    # device-side entries only: the host ops' own rows repeat their kernels
    kern = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kern) / 1e6
    top = sorted(kern, key=lambda e: -dev_us(e))
    dtoh = sum(e.count for e in kern if "DtoH" in e.key)
    log(f"[{card}] profile {mode}: one iteration {wall:.4f} s wall, device "
        f"busy {busy:.4f} s ({100 * busy / wall:.1f}%), "
        f"{sum(e.count for e in kern)} device operations, {dtoh} "
        f"device-to-host copies (grower's own count "
        f"{bst._gbdt.last_host_syncs}, -1 = not counted)")
    for e in top[:8]:
        log(f"    {e.key[:60]:60s} {dev_us(e) / 1e3:9.3f} ms  x{e.count}")
    if mode != "partition":
        leaf_traffic(torch, card, bst, mode, out_dir)


def leaf_traffic(torch, card, bst, mode, out_dir, reps=5) -> None:
    """The leaf-channel launches of one more boosting iteration of ``bst``:
    each launch's rows and share of rows in a channel, then all of them
    replayed (CUDA events, median of ``reps``) at every group of
    ``leaf_groups`` (forced one at a time) and at the groups
    ``leaf_geometry`` picks for each launch."""
    from lightgbm_tpu_torch.learner import wave
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    calls = []
    real = {name: getattr(wave, name) for name in
            ("build_histogram_leaves", "build_histogram_leaves_q8")}

    def recorder(fn):
        def call(bins, w, ch, **kw):
            calls.append((fn, bins, w, ch.clone(), kw))
            return fn(bins, w, ch, **kw)
        return call
    try:
        for name, fn in real.items():
            setattr(wave, name, recorder(fn))
        bst.update()
    finally:
        for name, fn in real.items():
            setattr(wave, name, fn)
    torch.cuda.synchronize()
    fn0, bins0, _, _, kw0 = calls[0]
    q8 = fn0 is hc.build_histogram_leaves_q8
    k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
    rows = [c.shape[0] for _, _, _, c, _ in calls]
    active = [int(((c >= 0) & (c < k)).sum()) for _, _, _, c, _ in calls]
    share = np.array(active) / np.array(rows)
    f, nb = bins0.shape[0], kw0["num_bins"]
    packed = kw0.get("bins_packed", False)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def replay():
        for fn, bins, w, ch, kw in calls:
            fn(bins, w, ch, **kw)
    times = {}
    groups = hc.leaf_groups
    try:
        for g in groups(f, nb, k, q8):
            hc.leaf_groups = lambda *a, g=g: [g]
            times[g] = time_ms(replay, reps)
    finally:
        hc.leaf_groups = groups
    rule_ms = time_ms(replay, reps)
    picks = sorted({hc.leaf_geometry(sms, f, n, nb, k, q8, packed)[:2]
                    for n in rows})
    best = min(times, key=times.get)
    log(f"[{card}] leaf traffic {mode}: {len(calls)} launches of "
        f"{max(rows)} rows or fewer, share of rows in a channel min "
        f"{share.min():.4f}, median {np.median(share):.4f}, mean "
        f"{share.mean():.4f}, max {share.max():.4f}, all launches "
        f"{sum(active) / sum(rows):.4f}; replayed {rule_ms:.3f} ms at the "
        f"geometry's groups {picks}, fastest group {best} "
        f"{times[best]:.3f} ms")
    log("    " + ", ".join(f"{cg}x{fg} {t:.3f}"
                           for (cg, fg), t in times.items()))
    with open(os.path.join(out_dir, f"leaf_traffic_{mode}.json"), "w") as fh:
        json.dump({"card": card, "rows": rows, "active": active,
                   "groups_ms": {f"{cg}x{fg}": t
                                 for (cg, fg), t in times.items()},
                   "rule_ms": rule_ms,
                   "rule_groups": [list(p) for p in picks]}, fh)
    del calls
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=10_500_000,
                    help="training rows of the main path (Higgs: 10.5M)")
    ap.add_argument("--test-rows", type=int, default=500_000)
    ap.add_argument("--rounds", type=int, default=10,
                    help="boosting rounds per mode")
    ap.add_argument("--pack-rounds", type=int, default=5,
                    help="boosting rounds per mode on the packed path")
    ap.add_argument("--reps", type=int, default=10,
                    help="timed runs per kernel")
    ap.add_argument("--profile", action="store_true",
                    help="also profile one iteration per mode")
    ap.add_argument("--out-dir", default=os.path.join("build", "smoke"),
                    help="where models, the build log and profiles go "
                         "(relative to the checkout)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); nothing run", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "lightgbm_tpu_torch")):
        print("chip_smoke: lightgbm_tpu_torch/ is not beside this script; "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import lightgbm_tpu_torch as lt
    from lightgbm_tpu_torch.ops import cuda_lib
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    if not os.path.abspath(lt.__file__).startswith(HERE + os.sep):
        raise RuntimeError(f"imported {lt.__file__}, not this checkout's "
                           "package")
    out_dir = os.path.join(HERE, args.out_dir)
    os.makedirs(out_dir, exist_ok=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: environment and build ----
    t_start = time.perf_counter()

    def stamp(what: str) -> None:
        log(f"[{time.perf_counter() - t_start:.1f} s] {what} done")
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}; device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    built = cuda_lib.build_all()
    log(f"build: {len(built)} of {len(cuda_lib.SOURCES)} kernel sources "
        f"compiled in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    with open(os.path.join(out_dir, "build.log"), "w") as fh:
        for name, (secs, report) in cuda_lib.BUILD_LOG.items():
            fh.write(f"== csrc/{name}.cu ({secs:.1f} s)\n{report}\n")
            for line in report.splitlines():
                if "registers" in line or "Compiling entry" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # ---- phase 2: kernels against plain ----
    from lightgbm_tpu_torch.dataset import pad_rows
    n_pad = pad_rows(args.rows)
    rec = kernel_phase(card, n_pad, args.reps, args.seed)
    stamp("phase 2, kernels")

    # ---- phase 3: the same small model on card and CPU ----
    small_check(lt, args.seed)
    stamp("phase 3, card vs CPU")

    # ---- phase 4: the main path ----
    t0 = time.perf_counter()
    X, y, _ = higgs_like(args.rows + args.test_rows, args.seed)
    Xtr, ytr = X[:args.rows], y[:args.rows]
    Xte, yte = X[args.rows:], y[args.rows:]
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(Xtr, ytr, params={"max_bin": MAX_BIN})
    ds.construct()
    ds.device_bins(torch.device("cuda"))
    torch.cuda.synchronize()
    log(f"main path data: {args.rows} training rows x {NUM_FEATURES} "
        f"features (Higgs has 10500000), {args.test_rows} held out; "
        f"generated in {t_gen:.1f} s, binned and moved to the card in "
        f"{time.perf_counter() - t0:.1f} s")
    if args.rows < 10_500_000:
        log(f"main path cut: rows only, 10500000 -> {args.rows}")
    stamp("main path data")

    # ---- phases 4-6: each path with the launch counts from 0 ----
    launches = {k: 0 for k in hc.LAUNCHES}
    paths = [("wave (exact, quantized)", ("exact", "quantized"),
              args.rounds, WAVE_KERNELS),
             ("partition", ("partition",), PARTITION_ROUNDS,
              ("hist_single",)),
             ("renew", ("renew",), RENEW_ROUNDS,
              ("hist_single", "hist_leaves_q8", "wave_row_update"))]
    if args.rounds < 10:
        log(f"cut: wave path rounds only, 10 -> {args.rounds} per mode")
    log(f"cut: partition path rounds only, Higgs' 500 -> "
        f"{PARTITION_ROUNDS}; renew path {RENEW_ROUNDS} rounds")
    for name, modes, rounds, needs in paths:
        torch.cuda.reset_peak_memory_stats()
        hc.reset_launches()
        for mode in modes:
            train_mode(lt, torch, card, ds, Xte, yte, mode, rounds, out_dir)
        got = dict(hc.LAUNCHES)
        log(f"{name} path launches: {json.dumps(got)}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        missing = [k for k in needs if got[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched by the {name} path: "
                                 f"{missing}")
        for k, v in got.items():
            launches[k] += v
        stamp(f"{name} path")
    if args.profile:
        for mode in ("exact", "quantized", "partition"):
            profile_iteration(lt, torch, card, ds, mode_params(mode), mode,
                              out_dir)
    del ds
    torch.cuda.empty_cache()

    # ---- phase 7: the packed wave path at full width ----
    torch.cuda.reset_peak_memory_stats()
    if args.pack_rounds < 5:
        log(f"cut: packed path rounds only, 5 -> {args.pack_rounds} per "
            "mode")
    for k, v in packed_path(lt, torch, card, Xtr, ytr, Xte, yte,
                            args.pack_rounds, out_dir, args.profile).items():
        launches[k] += v
    stamp("phase 7, packed path")

    # ---- phase 8: the histogram autotuner ----
    for k, v in autotune_phase(lt, torch, card, args.seed, out_dir).items():
        launches[k] += v
    stamp("phase 8, autotune")


    kernels = []
    for name, (source, replaces) in KERNELS.items():
        r = rec[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
