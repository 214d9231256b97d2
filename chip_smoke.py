#!/usr/bin/env python3
"""Smoke run of lightgbm_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed 0] [--rows 10500000] [--rounds 10]
                          [--test-rows 500000] [--profile] [--out-dir DIR]

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
   f32 ``index_add_``; times beside the bound and the library call;
3. a small model trained on the card against the same model trained on
   the CPU (plain versions): quantized L2 model text identical, exact
   binary predictions within 1e-5;
4. the main path at full width on synthetic rows shaped like the Higgs
   configuration of BASELINE.md (28 features, max_bin=255,
   num_leaves=255, learning_rate=0.1, binary): ``train`` in exact and in
   quantized mode, save, reload, predict a held-out set; the reloaded
   model must predict identically, and every kernel's launch count must
   have risen during training.

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

KERNELS = {
    "hist_leaves_q8": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                       "lightgbm_tpu/ops/histogram_pallas.py:1030"),
    "hist_leaves": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                    "lightgbm_tpu/ops/histogram_pallas.py:852"),
    "wave_row_update": ("lightgbm_tpu_torch/csrc/row_update.cu",
                        "lightgbm_tpu/ops/histogram_pallas.py:1280"),
    "wave_trial_channels": ("lightgbm_tpu_torch/csrc/row_update.cu",
                            "lightgbm_tpu/ops/histogram_pallas.py:1314"),
}


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
        torch.cuda.synchronize()
        want = hc.build_histogram_leaves_q8_plain(bins, wch, ch, num_bins=nb)
        err = float((got.long() - want.long()).abs().max())
        if not torch.equal(got, want):
            raise AssertionError(f"hist_leaves_q8 [{tag}] differs from its "
                                 f"plain version (max abs err {err})")
        log(f"kernel hist_leaves_q8 [{tag} F={f} N={n} B={nb} K={k}]: "
            "bitwise equal to plain")
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
        del wch, got, want

        # ---- exact histogram: bitwise vs plain, deterministic ----
        k = hc.LEAF_CHANNELS
        ch = torch.where(ch < k, ch, torch.full_like(ch, -1)).contiguous()
        w = hc.pack_weights(grad, hess, mask)
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

    for name, r in rec.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        log(f"[{card}] {name} @ N={n_main}: kernel {r['ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.3f} ms, library {lib}")
    return rec


# -- phases 3 and 4: training -----------------------------------------------

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
    pe = dict(base, objective="binary", use_quantized_grad=False)
    a = lt.train(pe, lt.Dataset(X, y), 3, device="cuda")
    b = lt.train(pe, lt.Dataset(X, y), 3, device="cpu")
    pa, pb = a.predict(X), b.predict(X)
    err = float(np.abs(pa - pb).max())
    if not (np.all(np.isfinite(pa)) and err <= 1e-5):
        raise AssertionError(f"exact binary model on the card predicts "
                             f"{err} away from the CPU's")
    log(f"small model (20000x{NUM_FEATURES}, 31 leaves, 3 rounds): "
        "quantized L2 model text identical on card and CPU; exact binary "
        f"predictions within {err:.3g}")


def train_mode(lt, torch, card, ds, Xte, yte, mode, rounds, out_dir):
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    params = dict(objective="binary", num_leaves=NUM_LEAVES, max_bin=MAX_BIN,
                  learning_rate=0.1, verbosity=-1,
                  use_quantized_grad=(mode == "quantized"),
                  stochastic_rounding=False)
    before = dict(hc.LAUNCHES)
    ticks = []

    def tick(env):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())

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
    return per_mode


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
    log(f"[{card}] profile {mode}: one iteration {wall:.4f} s wall, device "
        f"busy {busy:.4f} s ({100 * busy / wall:.1f}%), "
        f"{sum(e.count for e in kern)} device operations")
    for e in top[:8]:
        log(f"    {e.key[:60]:60s} {dev_us(e) / 1e3:9.3f} ms  x{e.count}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rows", type=int, default=10_500_000,
                    help="training rows of the main path (Higgs: 10.5M)")
    ap.add_argument("--test-rows", type=int, default=500_000)
    ap.add_argument("--rounds", type=int, default=10,
                    help="boosting rounds per mode")
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

    # ---- phase 3: the same small model on card and CPU ----
    small_check(lt, args.seed)

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

    torch.cuda.reset_peak_memory_stats()
    hc.reset_launches()
    for mode in ("exact", "quantized"):
        train_mode(lt, torch, card, ds, Xte, yte, mode, args.rounds, out_dir)
    launches = dict(hc.LAUNCHES)
    log(f"main path launches: {json.dumps(launches)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the main path: "
                             f"{missing}")
    if args.profile:
        for mode in ("exact", "quantized"):
            params = dict(objective="binary", num_leaves=NUM_LEAVES,
                          max_bin=MAX_BIN, learning_rate=0.1, verbosity=-1,
                          use_quantized_grad=(mode == "quantized"),
                          stochastic_rounding=False)
            profile_iteration(lt, torch, card, ds, params, mode, out_dir)

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
