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
   B=17, fewer than W active splits); quantized histogram bit for bit;
   row update and trial channels bit for bit and identical across two
   runs, reading the (F, N) bin matrix in place (uint8, and nibble-packed
   at B=16) and on the reference's gathered (W, N) columns, with a chained
   split and inactive splits whose feature is out of range; the exact
   histogram bit for bit against its plain version, identical across two
   runs, and within rtol=1e-4 of an f32 ``index_add_``; the single-leaf
   histogram bit for bit and identical across two runs at six shapes (the
   main path's row-major rows read in place at full N, as a half-N
   segment and as a 50,003-row segment at an odd start; 100,003 rows of
   width 29, unaligned; ragged N with B=17 feature-major; the
   leaf-renewal column F=1, B=256); the three nibble-packed forms
   (``bins_packed=True``) bit for bit and identical across two runs at
   the main path's width with B=16 and at a ragged shape (3 row blocks,
   B=5, 10 of the W channels used); times beside the bound, the plain
   version and the library call, and for the packed forms the uint8 form
   at the same B=16 shape; the four leaf-channel forms again, bit for bit
   and identical across two runs, on a skewed mix (every row in one of 3
   channels and 4 bins) and a late wave's (5% of the rows in a channel),
   each timed beside its ``index_add_``; the row update's categorical /
   EFB form (``wave_row_update_ext``) bit for bit and identical across
   two runs at the main path's N and W=25, over a (32, N) bundle-space
   matrix and a wave that mixes numeric, categorical (membership) and
   bundled (decoded) splits, timed beside its bound, its plain version
   and the numeric form on the same rows; and the threefry stream
   (``utils/random.py``, plain integer ops, not a kernel) bit for bit
   against the CPU's at the main path's N and at a (W, F) node draw;
3. small models trained on the card against the same models trained on
   the CPU (plain versions): quantized L2 model text identical at
   max_bin=255 and at max_bin=15 (packed bins), partitioned binary model
   text identical (failing that, partitioned predictions within 1e-5 and
   the first differing field named), exact binary wave predictions within
   1e-5; on 10,000 of those rows, with stochastic rounding on,
   quantized binary, quantized 3-class multiclass and quantized binary with
   ``feature_fraction_bynode=0.5, extra_trees=true`` model text
   identical, and L1 with its percentile leaf renewal identical (failing
   that, predictions within 1e-5 and the first differing field named);
   and model text identical for three more: categorical quantized with
   stochastic rounding (28 numeric + 3, 40, 1,000-category columns),
   EFB quantized from a CSR matrix (8 dense + 240 indicator columns), and
   categorical + EFB on the partitioned grower (exact); and for the
   split options at 15 leaves: wave quantized with monotone intermediate
   + interaction constraints, wave quantized with smoothing + CEGB
   split / coupled + ``feature_contri`` + forced splits (endgame on),
   partitioned exact with monotone basic + forced splits, and the
   masked grower (exact, no histogram pool);
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
   leaf-kernel form the winner names;
9. the training surface at full width, on the main path's rows: (a)
   ``bench.py``'s headline configuration (255 leaves, 255 bins, lr 0.1,
   ``use_quantized_grad``, 254 levels, stochastic rounding,
   ``quant_train_renew_leaf``) for ``--rounds`` rounds: iterations/s,
   held-out AUC, save/reload/predict; the q8 leaf kernel, the row update
   and the single-leaf kernel (renewal) must launch; (b) 3-class softmax
   (labels cut at the logit's terciles), quantized with stochastic
   rounding, ``--mc-rounds`` rounds: iterations/s, held-out
   multi_logloss, (N, 3) predictions, reload identical; the leaf kernels
   must launch for each of the 3 class trees of every round;
10. the dataset features at full width: (a) the main path's rows plus
   three Zipf-skewed categorical columns of 3, 40 and 1,000 categories
   entering the logit (one-vs-rest, sorted subsets and the bin cap),
   255 leaves: the headline configuration for ``--rounds`` rounds, exact
   mode for 3 and the partitioned grower for 2 (iterations/s, held-out
   AUC, categorical nodes, launches; the q8 / exact leaf kernels, the
   row update's categorical form and ``hist_single`` must launch); (b) a
   ``scipy.sparse.csr_matrix`` of 2,097,152 rows (cut from 10.5M for
   host set-up time): 8 ``higgs_like`` columns and 240 indicator columns
   in 24 mutually exclusive groups of 10 (values 1-3, each group set in
   30% of the rows), bundled into at most half as many device columns
   (G printed), quantized and exact wave training for 5 rounds each;
11. the split and grower options on the main path's binned rows (run
   after phase 9, while they are on the card): (a) the headline
   configuration with monotone +1, -1, +1, -1 constraints on four
   high-level columns (intermediate) and interaction constraints in two
   groups, 5 rounds; (b) quantized wave with ``path_smooth``, CEGB split
   and coupled penalties, ``feature_contri`` and a 3-level forced-split
   JSON, 5 rounds; (c) exact wave with lazy CEGB, 3 rounds; (d) the
   partitioned grower with monotone basic bounds and the forced splits,
   2 rounds; (e) the masked grower (``histogram_pool_size=16``), 2
   rounds.  Each checks held-out AUC and its kernels' launches; (a) and
   (d) predictions monotone along each constrained column over 1,000
   held-out rows x 32 grid points, (a) no root-to-leaf path mixing two
   interaction groups, (b) and (d) every tree opening with the forced
   splits, (e) at least a root pass and 2 ``hist_single`` passes per
   split;
12. multi-model training, after phase 11 on the main path's binned rows:
   (a) every model-axis kernel form (``*_lanes``: both leaf histograms at
   the main shape and packed at B=16, the row update in its numeric and
   categorical / EFB forms and its trial form at W=42, the single-leaf
   histogram over four lanes' row-major segments of different lengths,
   and its packed form over 4 lanes of N/2 rows sharing one
   nibble-packed matrix)
   at L=4 lanes with their own gradients, channels and tables, bit for
   bit against its plain version and against 4 single launches and
   identical across two runs, the one launch timed against the 4 single
   launches beside the bound, the plain version and one ``index_add_``
   over lanes x channels; (b) ``train_many`` of the headline
   configuration with ``lambda_l2`` 0, 1, 4, 16 for 3 rounds: models 0
   and 3 write the text of a standalone ``train()``, model-rounds/s
   against the standalone rate, model-axis launches per iteration
   against 4 x the standalone's single launches; (c) ``cv``, 4 folds of
   1,048,576 rows, 3 rounds, of the headline configuration (stochastic
   rounding and the speculative ramp on, drawing over each fold's rows)
   and of the exact wave with the ramp off, on rows binned beforehand:
   each time the batched fast path's metric history equals the per-fold
   loop's, both timed; (d)
   partitioned lanes, 2 variants, 2 rounds, text equal to ``train()``;
   (e) 2 variants for 1 round at 1,048,576 rows on packed bins (quantized
   and exact) and with a categorical column, text equal to ``train()``.
   Every batch runs with the counts set to 0 and must launch its
   model-axis forms and no single form; the histogram autotune probe's
   single launches are counted apart;
13. the boosting variants and the rest of the training surface, after
   phase 12 on the main path's binned rows, each part with the counts
   set to 0, its kernels' launches asserted, its iterations/s and a
   held-out AUC above 0.6: (a) GOSS on the headline configuration
   (top_rate 0.2, other_rate 0.1, learning_rate 0.25, 8 rounds; at least
   4 sampled iterations, the active-row share and the host ms of each
   draw); (b) DART on the headline configuration (drop_rate 0.1, 8
   rounds; drops per iteration, the bytes of the prediction cache); (c)
   RF on the exact wave (bag 0.632 every round, feature_fraction 0.8, 8
   rounds; save, reload, predict identically); (d) linear trees on the
   exact wave (5 rounds; the raw matrix's bytes on the card, the moment
   pass's ms per tree, linear leaves per tree); (e) a custom objective
   (binary logloss in numpy) and metric (AUC), quantized, 5 rounds, and
   the same run at 300,000 rows on the card and the CPU with identical
   text; (f) on (a)'s model: ``pred_leaf`` over the held-out rows (the
   leaf values at the indices sum to the raw score), ``pred_early_stop``,
   ``rollback_one_iter`` then one round, ``refit`` onto the held-out
   rows; (g) ``train_many`` of GOSS x 4 (rate sweep, learning_rate 0.5)
   and DART x 4 (drop-rate sweep), 6 rounds: one group each, models 0
   and 3 write the text of ``train()``, only model-axis forms launch.

Each training path runs with the launch counts set to 0 just before it
and read just after; a kernel of the path that did not launch fails the
run.

``--profile`` adds, per wave mode (exact and quantized at max_bin=255 and
15), for the partitioned grower, for phase 9's headline configuration
with stochastic rounding and again with round-half-up, and for the
headline configuration on phase 10a's categorical rows, one boosting
iteration under ``torch.profiler``; for the wave modes, one more iteration whose
leaf-channel launches are recorded: the share of each launch's rows in a
channel, and the whole set of launches replayed at every group of
channels x features a block can hold against the group the geometry
picks (written to ``leaf_traffic_<mode>.json`` under ``--out-dir``), and
the share of each row update's rows whose leaf an active split takes;
for the partitioned grower, one more iteration's single-leaf launches
recorded (rows, start row, strides), replayed at the geometry's rule and
timed one launch at a time (``single_traffic_partition.json``).

The last two lines of standard output are the per-kernel JSON record and
``{"ok": true, "device": {...}}``.  Without a CUDA device, or run from a
directory without the package beside it, the script exits non-zero.
"""

from __future__ import annotations

import argparse
import collections
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
    # the categorical / EFB form of the row update, which also takes the
    # reference's XLA fallback (lightgbm_tpu/learner/wave.py:1341-1420)
    "wave_row_update_ext": ("lightgbm_tpu_torch/csrc/row_update.cu",
                            "lightgbm_tpu/ops/histogram_pallas.py:1280"),
}

WAVE_KERNELS = ("hist_leaves_q8", "hist_leaves", "wave_row_update",
                "wave_trial_channels")
PARTITION_ROUNDS = 3
RENEW_ROUNDS = 2
W_CHILDREN = 84                  # a quantized wave's 2 x 42 children
MC_CLASSES = 3
CAT_CARDS = (3, 40, 1000)        # phase 10a's categorical columns
CAT_EXACT_ROUNDS = 3
CAT_PARTITION_ROUNDS = 2
EFB_ROWS = 2_097_152             # phase 10b, cut from 10.5M for set-up time
EFB_DENSE = (21, 22, 23, 25, 12, 27, 4, 0)   # higgs_like columns kept
EFB_GROUPS, EFB_GROUP_SIZE = 24, 10
EFB_ROUNDS = 5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


# -- timing ----------------------------------------------------------------

SPIN_CYCLES = 20_000_000         # ~10 ms of a spinning kernel


def time_ms(fn, reps: int, spin: int = SPIN_CYCLES) -> float:
    """Median device time of ``fn`` over ``reps`` runs (CUDA events), after
    one warm-up run.  A spinning kernel runs ahead of each timed run, so
    the host has queued all of ``fn``'s launches before the first event
    fires: the events time the device, not the host's enqueue."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
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
    """A (F, n) bin matrix, each split's feature (random), the
    rows' leaves and a table of w splits (the first ``n_active`` active,
    the rest with a feature out of range, which must never be read)."""
    bins = torch.randint(0, num_bins, (NUM_FEATURES, n), generator=gen,
                         device=dev, dtype=torch.uint8)
    feats = torch.randperm(NUM_FEATURES * 4, generator=gen,
                           device=dev)[:w] % NUM_FEATURES
    feats = feats.to(torch.int32)
    feats[n_active:] = NUM_FEATURES + 7
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
    tab = torch.stack([r.to(i32) for r in rows]).contiguous()
    if w > 1:   # a later split catches the rows an earlier one moved
        tab[4, 1] = tab[5, 0]
    return bins, feats.contiguous(), rl, tab


def _row_work(torch, cols, rl, tab, write_rl: bool, seen=None, feats=None):
    """(bytes, operations) a row update needs on these inputs: row->leaf in
    (and out), the channel out, the table and the split features, plus
    one column byte and a few compares and selects for every (row, active
    split) pair whose running leaf matches as the splits apply in order
    (``cols``: the splits' gathered uint8 columns).  With ``seen``, an
    (F, N) bool map of bin bytes, and the splits' ``feats``, the column
    bytes are marked there instead of counted, so that the lanes of one
    shared matrix count each byte once (the caller adds ``seen.sum()``)."""
    n, w = rl.shape[0], tab.shape[1]
    run = rl.clone()
    hits = 0
    for j in range(w):
        hit = (run == tab[4, j]) & (tab[6, j] > 0)
        hits += int(hit.sum())
        if seen is not None:
            seen[int(feats[j])] |= hit
        if write_rl:
            col = cols[j].to(torch.int32)
            go_left = torch.where(col == tab[1, j], tab[2, j],
                                  (col <= tab[0, j]).to(torch.int32))
            run = torch.where(hit & (go_left == 0), tab[5, j], run)
    need = hits if seen is None else 0
    nbytes = 4.0 * n + need + n + 36.0 * w + (4.0 * n if write_rl else 0.0)
    return nbytes, 6.0 * hits + n


def _row_forms(torch, hc, bins, feats, rl, tab, packed):
    """The row update and the trial channels on (bins, feats) in place,
    each with its plain version: [(name, kernel call, plain call)]."""
    targs = (tab[4], tab[0], tab[1], tab[2] > 0, tab[3] > 0, tab[6] > 0)
    kw = dict(feats=feats, bins_packed=packed)
    return [("wave_row_update",
             lambda: hc.wave_row_update(bins, rl, tab, **kw),
             lambda: hc.wave_row_update_plain(bins, rl, tab, **kw)),
            ("wave_trial_channels",
             lambda: hc.wave_trial_channels(bins, rl, *targs, **kw),
             lambda: hc.wave_trial_channels_plain(bins, rl, *targs, **kw))]


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

        # ---- row update and trial channels: bitwise, in place ----
        for wn in (hc.LEAF_CHANNELS, hc.Q_LEAF_CHANNELS):
            n_on = n_act or wn
            bins, feats, rl, tab = _row_case(torch, gen, dev, wn, n, nb,
                                             NUM_LEAVES, n_on)
            p16 = th.pack_bins4(bins[:, :n - n % 2] & 15)
            tab16 = tab.clone()
            tab16[0] &= 15
            tab16[1] = torch.where(tab16[1] >= 0, 15, -1)
            # the reference's signature: the gathered (W, N) columns
            cols = bins.index_select(0, feats.long().clamp(0, NUM_FEATURES
                                                           - 1))
            cases = [("uint8, in place", bins, feats, rl, tab, False),
                     ("uint8, gathered columns", cols, None, rl, tab, False),
                     ("packed, in place", p16, feats, rl[:n - n % 2], tab16,
                      True)]
            runs = {}
            for form, b_in, f_in, rl_in, tab_in, packed in cases:
                for name, run, plain in _row_forms(torch, hc, b_in, f_in,
                                                   rl_in, tab_in, packed):
                    before = hc.LAUNCHES[name]
                    got, again = run(), run()
                    torch.cuda.synchronize()
                    if hc.LAUNCHES[name] != before + 2:
                        raise AssertionError(f"{name} [{tag} {form}] did "
                                             "not launch")
                    want = plain()
                    if name == "wave_trial_channels":
                        got, again, want = (got,), (again,), (want,)
                    for x, y, z in zip(got, again, want):
                        if not torch.equal(x, y):
                            raise AssertionError(f"{name} [{tag} {form} "
                                                 f"W={wn}] differs between "
                                                 "two runs")
                        if not torch.equal(x, z):
                            raise AssertionError(f"{name} [{tag} {form} "
                                                 f"W={wn}] differs from its "
                                                 "plain version")
                    runs[form, name] = (run, plain)
                log(f"kernel wave_row_update, wave_trial_channels [{tag} "
                    f"{form} W={wn} N={rl_in.shape[0]} active={n_on}]: "
                    "bitwise equal to plain, identical across two runs")
            if tag == "main" and wn == hc.LEAF_CHANNELS:
                for name in ("wave_row_update", "wave_trial_channels"):
                    run, plain = runs["uint8, in place", name]
                    b_ms, b_by = bound_ms(*_row_work(
                        torch, cols, rl, tab, name == "wave_row_update"))
                    rec[name] = dict(
                        max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                        ms=time_ms(run, reps), plain_ms=time_ms(plain, 3),
                        library_ms=None,
                        packed_ms=time_ms(runs["packed, in place", name][0],
                                          reps))
            del bins, feats, rl, tab, p16, tab16, cols, cases, runs
        torch.cuda.empty_cache()

    rec["wave_row_update_ext"] = ext_row_phase(torch, gen, dev, n_main, reps)
    rec["hist_single"] = single_leaf_phase(torch, gen, dev, n_main, reps)
    rec.update(packed_phase(torch, gen, dev, n_main, reps))
    leaf_stress_phase(torch, gen, dev, card, n_main, reps)

    for name, r in rec.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        u8 = (f", uint8 form at B={PACK_BINS} {r['uint8_ms']:.3f} ms"
              if "uint8_ms" in r else "")
        if "packed_ms" in r:
            u8 = f", packed in place {r['packed_ms']:.3f} ms"
        if "numeric_ms" in r:
            u8 = (f", the numeric form on the same rows "
                  f"{r['numeric_ms']:.3f} ms")
        log(f"[{card}] {name} @ N={n_main}: kernel {r['ms']:.3f} ms, "
            f"bound {r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.3f} ms, library {lib}{u8}")
    return rec


def ext_row_phase(torch, gen, dev, n: int, reps: int) -> dict:
    """The row update's categorical / EFB form against its plain version,
    bit for bit and identical across two runs, at the main path's N and
    W=25 over a wave that mixes numeric, categorical and bundled splits:
    a (32, N) bin matrix of 8 numeric columns (255 bins), 3 categorical
    ones (3, 40 and 255 bins) and 21 bundles of ten 4-bin features each
    (31 bundle bins); 9 numeric splits, 8 categorical ones (random member
    bins), 6 bundled ones and 2 inactive ones whose column is out of
    range.  Split leaves are distinct and no split takes a leaf another
    creates (the grower's waves under categorical features or EFB).
    Timed beside its bound, its plain version and the numeric form on the
    same rows and table."""
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    i32 = torch.int32
    g_cols, w = 32, hc.LEAF_CHANNELS
    nbins = torch.tensor([255] * 8 + [3, 40, 255] + [31] * 21, device=dev)
    bins = (torch.rand((g_cols, n), generator=gen, device=dev) *
            nbins.unsqueeze(1)).to(torch.uint8)
    kind = [0] * 9 + [1] * 8 + [2] * 6 + [0] * 2     # numeric, cat, bundled
    cols, is_cat, off, nb, dft, single, thr = [], [], [], [], [], [], []
    member = torch.zeros((w, 256), dtype=torch.bool, device=dev)
    for j, k in enumerate(kind):
        if k == 0:
            c = j % 8
            cols.append(c if j < 23 else g_cols + 5 + j)
            is_cat.append(0), off.append(0), nb.append(255), dft.append(0)
            single.append(1), thr.append(int(torch.randint(
                0, 254, (1,), generator=gen, device=dev)))
        elif k == 1:
            c = 8 + j % 3
            card = int(nbins[c])
            member[j, :card] = torch.rand(card, generator=gen,
                                          device=dev) < 0.4
            cols.append(c), is_cat.append(1), off.append(0)
            nb.append(card), dft.append(0), single.append(1), thr.append(0)
        else:
            c = 11 + (j * 3) % 21
            feat_in_bundle = j % 10
            cols.append(c), is_cat.append(0)
            off.append(1 + 3 * feat_in_bundle), nb.append(4)
            dft.append(0), single.append(0), thr.append(j % 3)
    t = lambda a: torch.tensor(a, dtype=i32, device=dev)
    leaves = torch.randperm(NUM_LEAVES, generator=gen, device=dev)[:w]
    act = t([1] * 23 + [0] * 2)
    nan_bin = torch.where(t(kind) == 0, 254, -1).to(i32)
    tab = torch.stack([
        t(thr), nan_bin,
        torch.randint(0, 2, (w,), generator=gen, device=dev).to(i32),
        torch.randint(0, 2, (w,), generator=gen, device=dev).to(i32),
        leaves.to(i32), (NUM_LEAVES + torch.arange(w, device=dev)).to(i32),
        act, torch.zeros(w, dtype=i32, device=dev)]).contiguous()
    feats = t(cols)
    rl = torch.randint(0, NUM_LEAVES, (n,), generator=gen, device=dev,
                       dtype=i32)
    dec = hc.split_decode(t(is_cat), member, t(off), t(nb), t(dft),
                          t(single))

    def run():
        return hc.wave_row_update(bins, rl, tab, feats=feats, decode=dec)

    def plain():
        return hc.wave_row_update_plain(bins, rl, tab, feats=feats,
                                        decode=dec)

    before = hc.LAUNCHES["wave_row_update_ext"]
    got, again = run(), run()
    torch.cuda.synchronize()
    if hc.LAUNCHES["wave_row_update_ext"] != before + 2:
        raise AssertionError("wave_row_update_ext did not launch")
    want = plain()
    for x, y, z in zip(got, again, want):
        if not torch.equal(x, y):
            raise AssertionError("wave_row_update_ext differs between two "
                                 "runs")
        if not torch.equal(x, z):
            raise AssertionError("wave_row_update_ext differs from its plain "
                                 "version")
    moved = int((got[0] != rl).sum())
    in_ch = int((got[1] >= 0).sum())
    # bytes: row->leaf in and out, the channel out, the tables, and one
    # column byte for every row an active split takes
    hits = int(((rl.unsqueeze(0) == tab[4].unsqueeze(1)) &
                (tab[6] > 0).unsqueeze(1)).sum())
    b_ms, b_by = bound_ms(9.0 * n + hits + w * (36 + 20 + 32), 10.0 * hits + n)
    log(f"kernel wave_row_update_ext [main W={w} N={n}: 9 numeric, 8 "
        f"categorical, 6 bundled, 2 inactive splits; {hits} rows in a "
        f"split leaf, {moved} moved right, {in_ch} in a channel]: bitwise "
        "equal to plain, identical across two runs")
    numeric = lambda: hc.wave_row_update(bins, rl, tab, feats=feats)
    return dict(max_abs_err=0.0, bound_ms=b_ms, bound_by=b_by,
                ms=time_ms(run, reps), plain_ms=time_ms(plain, 3),
                library_ms=None, numeric_ms=time_ms(numeric, reps))


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
    two runs, at the shapes its callers give it (row-major segments read
    in place: the root, half N, a short one at an odd start, rows of an
    odd width; feature-major ragged; the renewal column); timed at the
    partitioned grower's root pass (the full padded rows, row-major)."""
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    f = NUM_FEATURES
    out = None
    cases = [("main, row-major rows, full N", f, n_main, 256, "rows", 0,
              n_main),
             ("main, row-major segment, half N", f, n_main, 256, "rows",
              n_main // 4, n_main // 2),
             ("short row-major segment, odd start", f, n_main, 256, "rows",
              12_345, 50_003),
             ("unaligned rows of width 29", f, 1_000_003, 256, "rows29",
              777, 100_003),
             ("ragged", f, 1_000_003, 17, "features", 0, 1_000_003),
             ("renew column", 1, n_main, 256, "features", 0, n_main)]
    for tag, nf, n, nb, layout, s0, cnt in cases:
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
        mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
        w = th.pack_weights(grad, hess, mask)
        if layout.startswith("rows"):
            width = nf + 1 if layout == "rows29" else nf
            P = torch.randint(0, nb, (n, width), generator=gen, device=dev,
                              dtype=torch.uint8)
            bins = P[s0:s0 + cnt, :nf].t()
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


def rng_phase(card: str, n_main: int) -> None:
    """The threefry stream on the card against the CPU's, bit for bit, at
    the main path's rows (one tree's stochastic rounding draw) and at a
    (W, F) by-node draw over a wave's children (``W_CHILDREN`` node ids).
    Integer ops are exact on both, so any difference is a bug."""
    import torch
    from lightgbm_tpu_torch.utils.random import (fold_in, host_key,
                                                 prng_key, uniform)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    # the rounding draw as training makes it: a host key, drawn on the card
    row_key = fold_in(fold_in(host_key(7), 3), 0)
    rows_card = uniform(row_key, (n_main,), dev)
    ids = torch.arange(W_CHILDREN, dtype=torch.int64) * 2 + 1
    node_card = uniform(fold_in(prng_key(11, dev), ids.to(dev)),
                        (NUM_FEATURES,))
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t0
    rows_cpu = uniform(row_key, (n_main,), "cpu")
    node_cpu = uniform(fold_in(prng_key(11), ids), (NUM_FEATURES,))
    if not (torch.equal(rows_card.cpu(), rows_cpu) and
            torch.equal(node_card.cpu(), node_cpu)):
        raise AssertionError("the threefry stream on the card differs from "
                             "the CPU's")
    log(f"[{card}] threefry: ({n_main},) row draw and ({W_CHILDREN}, "
        f"{NUM_FEATURES}) node draw bitwise equal to the CPU's "
        f"({t_card:.3f} s on the card, first call)")


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


def cat_columns(n: int, seed: int, logit: np.ndarray):
    """Phase 10a's categorical columns: one per ``CAT_CARDS`` entry
    (3, 40 and 1,000 categories), Zipf-skewed, each entering the logit
    with a random effect per category.  Returns the (n, 3) float32
    columns and the new logit."""
    rng = np.random.default_rng(seed + 11)
    cols = np.empty((n, len(CAT_CARDS)), np.float32)
    z = logit.astype(np.float32)
    for i, card in enumerate(CAT_CARDS):
        v = (rng.zipf(1.3, n) - 1) % card
        cols[:, i] = v
        z = z + (0.6 * rng.standard_normal(card)).astype(np.float32)[v]
    return cols, z


def draw_labels(z: np.ndarray, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return (rng.random(len(z), dtype=np.float32) <
            1.0 / (1.0 + np.exp(-z))).astype(np.float32)


def efb_csr(n: int, seed: int):
    """Phase 10b's data as a ``scipy.sparse.csr_matrix``: the 8
    ``higgs_like`` columns ``EFB_DENSE`` and ``EFB_GROUPS`` groups of
    ``EFB_GROUP_SIZE`` mutually exclusive indicator columns (a group sets
    one of its columns, to 1, 2 or 3, in 30% of the rows), each value
    entering the logit.  Returns (matrix, labels)."""
    import scipy.sparse as sps
    X, _, logit = higgs_like(n, seed)
    nd = len(EFB_DENSE)
    rng = np.random.default_rng(seed + 13)
    rows = [np.repeat(np.arange(n), nd)]
    cols = [np.tile(np.arange(nd), n)]
    vals = [X[:, list(EFB_DENSE)].ravel()]
    del X
    z = logit
    for g in range(EFB_GROUPS):
        on = np.nonzero(rng.random(n) < 0.3)[0]
        k = rng.integers(0, EFB_GROUP_SIZE, len(on))
        v = rng.integers(1, 4, len(on))
        rows.append(on)
        cols.append(nd + g * EFB_GROUP_SIZE + k)
        vals.append(v.astype(np.float32))
        eff = (0.3 * rng.standard_normal((EFB_GROUP_SIZE, 3))).astype(
            np.float32)
        z[on] += eff[k, v - 1]
    mat = sps.csr_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, nd + EFB_GROUPS * EFB_GROUP_SIZE))
    return mat, draw_labels(z, seed + 14)


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


# phase 3's and phase 11's split options on the Higgs-shaped columns: four
# of the seven high-level columns constrained +1, -1, +1, -1, interaction
# groups splitting the columns in two, and forced splits three levels
# deep (BFS order: root, its children, their children)
MONO_COLS = (21, 22, 23, 25)
MONO_SIGNS = (1, -1, 1, -1)
IC_GROUPS = ([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 21, 22, 23, 25],
             [14, 15, 16, 17, 18, 19, 20, 24, 26, 27])
FORCED = {"feature": 21, "threshold": 1.0,
          "left": {"feature": 23, "threshold": 0.8,
                   "left": {"feature": 25, "threshold": 0.5},
                   "right": {"feature": 22, "threshold": 1.2}},
          "right": {"feature": 22, "threshold": 1.5,
                    "left": {"feature": 27, "threshold": 0.0},
                    "right": {"feature": 26, "threshold": 0.0}}}
FORCED_FEATURES = [21, 23, 22, 25, 22, 27, 26]      # the nodes in BFS order
OPTION_ROUNDS = {"11a": 5, "11b": 5, "11c": 3, "11d": 2, "11e": 2}
MASKED_POOL_MB = 16     # the 255 x 28 x 256 f32 pool takes 22 MB


def option_params(out_dir: str, part: str) -> dict:
    """The split options of phase 3's and phase 11's parts: monotone
    intermediate + interaction constraints (a), smoothing + CEGB split and
    coupled penalties + feature_contri + forced splits (b), lazy CEGB (c),
    monotone basic + forced splits (d), no pool: the masked grower (e)."""
    mono = [0] * NUM_FEATURES
    for c, sgn in zip(MONO_COLS, MONO_SIGNS):
        mono[c] = sgn
    forced = os.path.join(out_dir, "forced_splits.json")
    with open(forced, "w") as fh:
        json.dump(FORCED, fh)
    contri = [1.0] * NUM_FEATURES
    for c in (0, 3, 5, 9, 13, 17):
        contri[c] = 0.7
    return {
        "a": dict(monotone_constraints=mono,
                  monotone_constraints_method="intermediate",
                  interaction_constraints=",".join(
                      str(g).replace(" ", "") for g in IC_GROUPS)),
        "b": dict(path_smooth=10.0, cegb_penalty_split=1e-6,
                  cegb_penalty_feature_coupled=[5.0] * NUM_FEATURES,
                  feature_contri=contri, forcedsplits_filename=forced),
        "c": dict(cegb_penalty_feature_lazy=[1e-7 * (1 + c % 4)
                                             for c in range(NUM_FEATURES)]),
        "d": dict(monotone_constraints=mono, forcedsplits_filename=forced),
        "e": dict(histogram_pool_size=MASKED_POOL_MB),
    }[part]


def small_check(lt, seed: int, out_dir: str) -> None:
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
    # the slice's new paths on the first 10,000 rows: the CPU half of each
    # pair is most of this phase's time
    X, y, logit = X[:10_000], y[:10_000], logit[:10_000]
    y3 = np.digitize(logit, np.quantile(logit, [1 / 3, 2 / 3])) \
        .astype(np.float32)
    ps = dict(base, use_quantized_grad=True, stochastic_rounding=True)
    for what, params, label in (
            ("stochastic quantized binary", dict(ps, objective="binary"), y),
            ("stochastic quantized 3-class multiclass",
             dict(ps, objective="multiclass", num_class=MC_CLASSES), y3),
            ("stochastic quantized binary, bynode 0.5 + extra-trees",
             dict(ps, objective="binary", feature_fraction_bynode=0.5,
                  extra_trees=True), y)):
        a = lt.train(params, lt.Dataset(X, label), 3, device="cuda")
        b = lt.train(params, lt.Dataset(X, label), 3, device="cpu")
        if a.model_to_string() != b.model_to_string():
            raise AssertionError(f"{what} model trained on the card differs "
                                 "from the one trained on the CPU")
    p1 = dict(base, objective="regression_l1")
    a = lt.train(p1, lt.Dataset(X, logit), 3, device="cuda")
    b = lt.train(p1, lt.Dataset(X, logit), 3, device="cpu")
    sa, sb = a.model_to_string(), b.model_to_string()
    if sa == sb:
        l1 = "L1 with leaf renewal model text identical"
    else:
        first = next(la.split("=", 1)[0] for la, lb in
                     zip(sa.splitlines(), sb.splitlines()) if la != lb)
        l1err = float(np.abs(a.predict(X) - b.predict(X)).max())
        log(f"L1 model text differs from the CPU's, first in field "
            f"{first!r}; predictions within {l1err:.3g}")
        if not l1err <= 1e-5:
            raise AssertionError(f"L1 model on the card predicts {l1err} "
                                 "away from the CPU's")
        l1 = f"L1 with leaf renewal predictions within {l1err:.3g}"
    log(f"small models (10000x{NUM_FEATURES}, 31 leaves, 3 rounds), "
        f"stochastic rounding on: quantized binary, 3-class multiclass and "
        f"binary with bynode sampling and extra-trees model text identical "
        f"on card and CPU; {l1}")
    # categorical features and EFB bundles on 10,000 rows
    cats, z = cat_columns(len(X), seed, logit)
    yc = draw_labels(z, seed + 3)
    Xc = np.concatenate([X, cats], axis=1)
    cat_idx = list(range(NUM_FEATURES, NUM_FEATURES + len(CAT_CARDS)))
    mat, ye = efb_csr(10_000, seed + 5)
    both = np.concatenate([np.asarray(mat.todense()), cats], axis=1)
    both_idx = list(range(mat.shape[1], both.shape[1]))
    yb = draw_labels(z + 0.5 * np.nan_to_num(both[:, 0]), seed + 4)
    for what, params, data, label, cidx in (
            ("categorical quantized (stochastic rounding)",
             dict(ps, objective="binary"), Xc, yc, cat_idx),
            ("EFB quantized (CSR input)",
             dict(base, objective="binary", use_quantized_grad=True), mat,
             ye, "auto"),
            ("categorical + EFB partitioned (exact)",
             dict(base, objective="binary", tree_grow_mode="partition"),
             both, yb, both_idx)):
        a = lt.train(params, lt.Dataset(data, label, categorical_feature=cidx),
                     3, device="cuda")
        b = lt.train(params, lt.Dataset(data, label, categorical_feature=cidx),
                     3, device="cpu")
        sa, sb = a.model_to_string(), b.model_to_string()
        if cidx != "auto" and "num_cat=0\n" in sa and \
                sa.count("num_cat=0\n") == sa.count("num_cat="):
            raise AssertionError(f"{what}: no categorical split")
        if "EFB" in what and a._gbdt.train_set.efb is None:
            raise AssertionError(f"{what}: nothing bundled")
        if sa != sb:
            first = next(la.split("=", 1)[0] for la, lb in
                         zip(sa.splitlines(), sb.splitlines()) if la != lb)
            raise AssertionError(f"{what} model trained on the card differs "
                                 f"from the one trained on the CPU, first "
                                 f"in field {first!r}")
    log(f"small models (10000 rows, 31 leaves, 3 rounds): categorical "
        f"quantized with stochastic rounding ({NUM_FEATURES} numeric + "
        f"{len(CAT_CARDS)} categorical columns), EFB quantized from CSR "
        f"({mat.shape[1]} columns) and categorical + EFB partitioned model "
        f"text identical on card and CPU")
    # the split options on 10,000 rows and 15 leaves (the CPU half of each
    # pair is most of the time); the masked grower's pool budget is cut
    # with the leaves (15 x 28 x 256 f32 bins take 1.3 MB)
    base = dict(base, num_leaves=15)
    pq = dict(base, objective="binary", use_quantized_grad=True)
    for what, params, mode in (
            ("wave quantized, monotone intermediate + interaction",
             dict(pq, **option_params(out_dir, "a")), "wave"),
            ("wave quantized, smoothing + CEGB split/coupled + "
             "feature_contri + forced splits",
             dict(pq, **option_params(out_dir, "b")), "wave"),
            ("partitioned exact, monotone basic + forced splits",
             dict(base, objective="binary", tree_grow_mode="partition",
                  **option_params(out_dir, "d")), "partition"),
            ("masked exact", dict(base, objective="binary",
                                  histogram_pool_size=1), "masked")):
        a = lt.train(params, lt.Dataset(X, y), 3, device="cuda")
        b = lt.train(params, lt.Dataset(X, y), 3, device="cpu")
        if a._gbdt.learner.grow_mode != mode:
            raise AssertionError(f"{what}: trained on the "
                                 f"{a._gbdt.learner.grow_mode} grower")
        sa, sb = a.model_to_string(), b.model_to_string()
        if sa != sb:
            first = next(la.split("=", 1)[0] for la, lb in
                         zip(sa.splitlines(), sb.splitlines()) if la != lb)
            raise AssertionError(f"{what} model trained on the card differs "
                                 f"from the one trained on the CPU, first "
                                 f"in field {first!r}")
    log("small models (10000 rows, 15 leaves, 3 rounds): wave quantized "
        "with monotone intermediate + interaction constraints, wave "
        "quantized with smoothing + CEGB + feature_contri + forced splits "
        "(endgame on), partitioned exact with monotone basic + forced "
        "splits and the masked grower model text identical on card and CPU")


def mode_params(mode: str, max_bin: int = MAX_BIN, **extra) -> dict:
    """exact / quantized wave, partition (exact), renew (quantized wave
    with leaf renewal), each with round-half-up; headline (``bench.py``'s:
    254 levels, stochastic rounding, leaf renewal)."""
    head = mode == "headline"
    return dict(objective="binary", num_leaves=NUM_LEAVES, max_bin=max_bin,
                learning_rate=0.1, verbosity=-1, min_data_in_leaf=20,
                **extra,
                use_quantized_grad=mode in ("quantized", "renew", "headline"),
                quant_train_renew_leaf=mode in ("renew", "headline"),
                num_grad_quant_bins=254 if head else 4,
                tree_grow_mode=("partition" if mode == "partition"
                                else "wave"),
                stochastic_rounding=head)


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
    if p.shape != (Xte.shape[0],) or not np.all(np.isfinite(p)):
        raise AssertionError(f"{mode}: predictions not finite or of wrong "
                             "shape")
    if not np.array_equal(p, p2):
        raise AssertionError(f"{mode}: the reloaded model predicts "
                             "differently")
    a = auc(yte, p)
    log(f"[{card}] {mode}: held-out AUC {a:.6f} over {Xte.shape[0]} rows "
        f"(reloaded model identical); predict {t_pred:.3f} s")
    if not a > 0.6:
        raise AssertionError(f"{mode}: held-out AUC {a} is no better than "
                             "chance")
    return bst


def surface_phase(lt, torch, card, ds, Xte, yte, logit_tr, logit_te,
                  rounds: int, mc_rounds: int, out_dir: str,
                  profile: bool) -> dict:
    """Phase 9: ``bench.py``'s headline configuration, then 3-class softmax,
    on the main path's binned rows; returns the launches of both."""
    import copy
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    launches = {k: 0 for k in hc.LAUNCHES}

    # (a) the headline configuration
    torch.cuda.reset_peak_memory_stats()
    hc.reset_launches()
    bst = train_mode(lt, torch, card, ds, Xte, yte, "headline", rounds,
                     out_dir)
    got = dict(hc.LAUNCHES)
    log(f"headline path launches: {json.dumps(got)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if not (bst._gbdt.learner.quantized and
            bst._gbdt.config.stochastic_rounding):
        raise AssertionError("the headline configuration did not train "
                             "quantized with stochastic rounding")
    missing = [k for k in ("hist_leaves_q8", "wave_row_update",
                           "hist_single") if got[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched by the headline "
                             f"configuration: {missing}")
    for k, v in got.items():
        launches[k] += v
    del bst
    if profile:
        head = mode_params("headline")
        profile_iteration(lt, torch, card, ds, head, "headline", out_dir,
                          traffic=False)
        profile_iteration(lt, torch, card, ds,
                          dict(head, stochastic_rounding=False),
                          "headline_half_up", out_dir, traffic=False)

    # (b) 3-class softmax, labels cut at the logit's terciles
    cuts = np.quantile(logit_tr, [1 / 3, 2 / 3])
    y3 = np.digitize(logit_tr, cuts).astype(np.float32)
    y3te = np.digitize(logit_te, cuts).astype(np.int64)
    ds3 = copy.copy(ds)                 # the same binned rows on the card
    ds3.metadata = copy.copy(ds.metadata)
    ds3.metadata.set_label(y3)
    params = dict(objective="multiclass", num_class=MC_CLASSES,
                  num_leaves=NUM_LEAVES, max_bin=MAX_BIN, learning_rate=0.1,
                  verbosity=-1, use_quantized_grad=True)
    ticks = []

    def tick(env):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())

    hc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds3, mc_rounds, callbacks=[tick])
    got = dict(hc.LAUNCHES)
    steady = ((len(ticks) - 1) / (ticks[-1] - ticks[0])
              if len(ticks) > 1 else float("nan"))
    trees = bst.num_trees()
    log(f"[{card}] train multiclass (K={MC_CLASSES}, quantized, stochastic "
        f"rounding): {len(ticks)} rounds in {ticks[-1] - t0:.3f} s (first "
        f"{ticks[0] - t0:.3f} s), steady {steady:.4f} iterations/s, "
        f"{trees} trees; launches {json.dumps(got)}")
    if trees != mc_rounds * MC_CLASSES:
        raise AssertionError(f"multiclass: {trees} trees, expected "
                             f"{mc_rounds * MC_CLASSES}")
    short = [k for k in ("hist_leaves_q8", "wave_row_update")
             if got[k] < trees]
    if short:
        raise AssertionError(f"multiclass: {short} launched fewer times "
                             f"than the {trees} class trees")
    path = os.path.join(out_dir, "model_multiclass.txt")
    bst.save_model(path)
    p = bst.predict(Xte)
    p2 = lt.Booster(model_file=path).predict(Xte)
    if p.shape != (len(Xte), MC_CLASSES) or not np.all(np.isfinite(p)):
        raise AssertionError(f"multiclass: predictions of shape {p.shape}, "
                             "or not finite")
    if not np.array_equal(p, p2):
        raise AssertionError("multiclass: the reloaded model predicts "
                             "differently")
    mlog = float(-np.mean(np.log(np.clip(p[np.arange(len(p)), y3te],
                                         1e-15, None))))
    log(f"[{card}] multiclass: held-out multi_logloss {mlog:.6f} over "
        f"{len(Xte)} rows (the class prior gives {np.log(3):.6f}); "
        f"predictions ({len(Xte)}, {MC_CLASSES}), reloaded model identical")
    if not mlog < np.log(3):
        raise AssertionError(f"multiclass: held-out multi_logloss {mlog} "
                             "is no better than the class prior")
    for k, v in got.items():
        launches[k] += v
    return launches


def _leaf_paths(tree):
    """The inner features on every root-to-leaf path of a host tree."""
    if tree.num_leaves <= 1:
        return [set()]
    out, stack = [], [(0, frozenset())]
    while stack:
        node, feats = stack.pop()
        feats = feats | {int(tree.split_feature[node])}
        for child in (tree.left_child[node], tree.right_child[node]):
            if child < 0:
                out.append(feats)
            else:
                stack.append((int(child), feats))
    return out


def monotone_violations(bst, Xte, rows: int = 1000, steps: int = 32):
    """Steps against the constraint along each constrained column
    (reference tests/test_monotone.py ``_is_monotone``): ``rows`` held-out
    rows, each column swept over a ``steps``-point grid between its 1%
    and 99% quantiles, raw scores compared step by step."""
    out = {}
    base = Xte[:rows]
    for c, sgn in zip(MONO_COLS, MONO_SIGNS):
        lo, hi = np.nanquantile(Xte[:, c], [0.01, 0.99])
        grid = np.linspace(lo, hi, steps, dtype=np.float32)
        batch = np.repeat(base, steps, axis=0)
        batch[:, c] = np.tile(grid, len(base))
        raw = bst.predict(batch, raw_score=True).reshape(len(base), steps)
        out[c] = int((np.diff(raw, axis=1) * sgn < -1e-6).sum())
    return out


def options_phase(lt, torch, card, ds, Xte, yte, out_dir: str) -> dict:
    """Phase 11: the split and grower options at full width on the main
    path's binned rows (255 leaves, 255 bins): (a) the headline
    configuration with monotone intermediate constraints on four
    high-level columns and interaction constraints in two groups, (b)
    quantized wave with smoothing, CEGB split and coupled penalties,
    feature_contri and three levels of forced splits, (c) exact wave with
    lazy CEGB, (d) the partitioned grower with monotone basic bounds and
    the forced splits, (e) the masked grower (no histogram pool under a
    16 MB budget).  Returns the launches."""
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    launches = {k: 0 for k in hc.LAUNCHES}
    used = list(ds.used_feature_map)
    runs = [("11a", "headline", "a", ("hist_leaves_q8", "wave_row_update",
                                       "hist_single")),
            ("11b", "quantized", "b", ("hist_leaves_q8", "wave_row_update",
                                        "wave_trial_channels")),
            ("11c", "exact", "c", ("hist_leaves", "wave_row_update")),
            ("11d", "partition", "d", ("hist_single",)),
            ("11e", "exact", "e", ("hist_single",))]
    log("cut: option rounds only: " + ", ".join(
        f"{k} {v}" for k, v in OPTION_ROUNDS.items()))
    for part, mode, opt, needs in runs:
        rounds = OPTION_ROUNDS[part]
        hc.reset_launches()
        torch.cuda.reset_peak_memory_stats()
        bst = train_mode(lt, torch, card, ds, Xte, yte, mode, rounds,
                         out_dir, tag=f"_{part}",
                         **option_params(out_dir, opt))
        got = dict(hc.LAUNCHES)
        gbdt = bst._gbdt
        trees = gbdt.models
        splits = [t.num_leaves - 1 for t in trees]
        log(f"phase {part} launches: {json.dumps(got)}; grower "
            f"{gbdt.learner.grow_mode}, splits per tree {splits}; peak "
            f"device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        missing = [k for k in needs if got[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched by phase {part}: "
                                 f"{missing}")
        want_mode = {"d": "partition", "e": "masked"}.get(opt, "wave")
        if gbdt.learner.grow_mode != want_mode:
            raise AssertionError(f"phase {part} trained on the "
                                 f"{gbdt.learner.grow_mode} grower")
        if opt in ("a", "d"):
            bad = monotone_violations(bst, Xte)
            log(f"phase {part}: steps against the constraint over 1000 "
                f"held-out rows x 32 grid points per constrained column: "
                f"{bad}")
            if any(bad.values()):
                raise AssertionError(f"phase {part}: predictions not "
                                     f"monotone: {bad}")
        if opt == "a":
            groups = [{used.index(f) for f in g if f in used}
                      for g in IC_GROUPS]
            mixed = sum(1 for t in trees for path in _leaf_paths(t)
                        if not any(path <= g for g in groups))
            log(f"phase {part}: {mixed} root-to-leaf paths mix features "
                f"of two interaction groups")
            if mixed:
                raise AssertionError(f"phase {part}: {mixed} paths break "
                                     "the interaction constraints")
        if opt in ("b", "d"):
            want = [used.index(f) for f in FORCED_FEATURES]
            opened = sum(list(t.split_feature[:len(want)]) == want
                         for t in trees)
            log(f"phase {part}: {opened} of {len(trees)} trees open with "
                f"the {len(want)} forced splits")
            if opened != len(trees):
                raise AssertionError(f"phase {part}: a tree does not open "
                                     "with the forced splits")
        if opt == "c":
            lazy = gbdt.learner._lazy_used
            log(f"phase {part}: lazy CEGB bitmap {tuple(lazy.shape)} "
                f"({lazy.numel() / 1e6:.1f} MB packed), "
                f"{int(lazy.count_nonzero())} bytes marked")
        if opt == "e":
            need = sum(1 + 2 * k for k in splits)
            log(f"phase {part}: {got['hist_single']} hist_single launches "
                f"for {sum(splits)} splits (root + 2 per split: {need})")
            if got["hist_single"] < need:
                raise AssertionError(f"phase {part}: {got['hist_single']} "
                                     f"hist_single launches, {need} needed")
        for k, v in got.items():
            launches[k] += v
        del bst
    return launches


def _path_runs(lt, torch, card, ds, Xte, yte, runs, out_dir, tag,
               what: str) -> dict:
    """Train each (mode, rounds, kernels that must launch) of ``runs`` on
    ``ds`` with the launch counts from 0; returns the launches."""
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    launches = {k: 0 for k in hc.LAUNCHES}
    for mode, rounds, needs in runs:
        torch.cuda.reset_peak_memory_stats()
        hc.reset_launches()
        bst = train_mode(lt, torch, card, ds, Xte, yte, mode, rounds,
                         out_dir, tag=tag)
        got = dict(hc.LAUNCHES)
        text = bst.model_to_string()
        n_cat = sum(int(ln.split("=")[1]) for ln in text.splitlines()
                    if ln.startswith("num_cat="))
        log(f"{what} {mode} path launches: {json.dumps(got)}; "
            f"{n_cat} categorical nodes; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        missing = [k for k in needs if got[k] <= 0]
        if missing:
            raise AssertionError(f"kernels not launched by the {what} "
                                 f"{mode} path: {missing}")
        if tag == "_categorical" and n_cat == 0:
            raise AssertionError(f"{what} {mode}: no categorical split")
        for k, v in got.items():
            launches[k] += v
        del bst
    return launches


def categorical_phase(lt, torch, card, X, logit, rows, rounds, out_dir,
                      seed, profile) -> dict:
    """Phase 10a: the Higgs-shaped rows plus the ``CAT_CARDS`` categorical
    columns (one-vs-rest, sorted subsets, the bin cap), 255 leaves: the
    headline configuration for ``rounds`` rounds, exact mode for
    ``CAT_EXACT_ROUNDS`` and the partitioned grower for
    ``CAT_PARTITION_ROUNDS``."""
    t0 = time.perf_counter()
    cats, z = cat_columns(len(X), seed, logit)
    y = draw_labels(z, seed + 12)
    Xc = np.concatenate([X, cats], axis=1)
    del cats
    cat_idx = list(range(NUM_FEATURES, NUM_FEATURES + len(CAT_CARDS)))
    ds = lt.Dataset(Xc[:rows], y[:rows], categorical_feature=cat_idx,
                    params={"max_bin": MAX_BIN})
    ds.construct()
    ds.device_bins(torch.device("cuda"))
    torch.cuda.synchronize()
    mappers = [ds.bin_mappers[j] for j in cat_idx]
    log(f"[{card}] categorical data: {rows} rows x {Xc.shape[1]} columns "
        f"({len(cat_idx)} categorical of {list(CAT_CARDS)} categories, "
        f"binned to {[m.num_bin for m in mappers]} bins), device bin "
        f"matrix {ds.X_binned.nbytes / 1e6:.1f} MB; built, binned and moved "
        f"in {time.perf_counter() - t0:.1f} s")
    runs = [("headline", rounds, ("hist_leaves_q8", "wave_row_update_ext",
                                  "hist_single")),
            ("exact", CAT_EXACT_ROUNDS, ("hist_leaves",
                                         "wave_row_update_ext")),
            ("partition", CAT_PARTITION_ROUNDS, ("hist_single",))]
    log(f"cut: categorical rounds only: headline {rounds}, exact "
        f"{CAT_EXACT_ROUNDS}, partition {CAT_PARTITION_ROUNDS}")
    launches = _path_runs(lt, torch, card, ds, Xc[rows:], y[rows:], runs,
                          out_dir, "_categorical", "categorical")
    if profile:
        profile_iteration(lt, torch, card, ds, mode_params("headline"),
                          "headline_categorical", out_dir, traffic=False)
    return launches


def efb_phase(lt, torch, card, seed, out_dir) -> dict:
    """Phase 10b: ``EFB_ROWS`` rows of :func:`efb_csr` as a CSR matrix
    (never densified), EFB-bundled into at most half as many device
    columns; quantized and exact wave training for ``EFB_ROUNDS`` rounds
    each."""
    t0 = time.perf_counter()
    test = 100_000
    mat, y = efb_csr(EFB_ROWS + test, seed + 21)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ds = lt.Dataset(mat[:EFB_ROWS], y[:EFB_ROWS], params={"max_bin": MAX_BIN})
    ds.construct()
    ds.device_bins(torch.device("cuda"))
    torch.cuda.synchronize()
    f = mat.shape[1]
    if ds.efb is None:
        raise AssertionError("EFB: the indicator columns were not bundled")
    g, bb = ds.efb.n_bundles, ds.efb.bundle_bins
    log(f"[{card}] EFB data: CSR {EFB_ROWS} rows x {f} columns, {mat.nnz} "
        f"stored values (generated in {t_gen:.1f} s); bundled into G={g} "
        f"device columns, {bb} bundle bins, device bin matrix "
        f"{ds.X_binned.nbytes / 1e6:.1f} MB, in "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"cut: EFB rows 10500000 -> {EFB_ROWS} (host set-up time), "
        f"{EFB_ROUNDS} rounds per mode")
    if not g <= f // 2:
        raise AssertionError(f"EFB: {g} device columns for {f} features "
                             f"(at most {f // 2} expected)")
    runs = [("quantized", EFB_ROUNDS, ("hist_leaves_q8",
                                       "wave_row_update_ext")),
            ("exact", EFB_ROUNDS, ("hist_leaves", "wave_row_update_ext"))]
    return _path_runs(lt, torch, card, ds, mat[EFB_ROWS:], y[EFB_ROWS:],
                      runs, out_dir, "_efb", "EFB")


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


def profile_iteration(lt, torch, card, ds, params, mode, out_dir,
                      traffic: bool = True) -> None:
    """One boosting iteration under ``torch.profiler``: device time by
    kernel and the device's busy share, written under ``out_dir``;
    ``traffic`` then records one more iteration's launches (partition:
    single-leaf, wave: leaf-channel and row-update)."""
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
    if not traffic:
        return
    if mode == "partition":
        single_traffic(torch, card, bst, out_dir)
    else:
        leaf_traffic(torch, card, bst, mode, out_dir)


def single_traffic(torch, card, bst, out_dir, reps=5) -> None:
    """The partitioned grower's ``hist_single`` launches of one more
    boosting iteration of ``bst``: each launch's rows, start row and
    strides (the views are kept; the grower's leaf-contiguous matrix they
    read stays alive, and each later segment holds the same rows in
    another order), then all of them replayed (CUDA events, median of
    ``reps``) at the geometry's rule, and each launch timed alone; written
    to ``single_traffic_partition.json``."""
    from lightgbm_tpu_torch.learner import partitioned
    calls = []
    real = partitioned.hist_single

    def call(bins, w, **kw):
        calls.append((bins, w, kw))
        return real(bins, w, **kw)
    partitioned.hist_single = call
    try:
        bst.update()
    finally:
        partitioned.hist_single = real
    torch.cuda.synchronize()
    rows = np.array([b.shape[1] for b, _, _ in calls])
    starts = [b.storage_offset() // max(b.stride(1), 1) for b, _, _ in calls]

    def replay():
        for bins, w, kw in calls:
            real(bins, w, **kw)
    ms = time_ms(replay, reps, spin=20 * SPIN_CYCLES)
    # each launch alone (its zero-filled output included), summed by
    # segment length
    each = [time_ms(lambda c=c: real(c[0], c[1], **c[2]), 3) for c in calls]
    edges = (0, 16_384, 65_536, 262_144, 1_048_576, 1 << 62)
    buckets = []
    for lo, hi in zip(edges, edges[1:]):
        sel = [t for t, n in zip(each, rows) if lo <= n < hi]
        buckets.append((lo, len(sel), float(sum(sel))))
    log(f"[{card}] single-leaf traffic partition: {len(calls)} launches, "
        f"rows min {rows.min()}, median {int(np.median(rows))}, mean "
        f"{rows.mean():.1f}, max {rows.max()}, sum {rows.sum()}; strides "
        f"{sorted({tuple(b.stride()) for b, _, _ in calls})}; replayed "
        f"{ms:.3f} ms")
    log("    launches alone, by rows: " + "; ".join(
        f">= {lo}: {k} launches, {t:.3f} ms" for lo, k, t in buckets))
    with open(os.path.join(out_dir, "single_traffic_partition.json"),
              "w") as fh:
        json.dump({"card": card, "rows": rows.tolist(), "starts": starts,
                   "strides": [list(b.stride()) for b, _, _ in calls],
                   "num_bins": calls[0][2]["num_bins"],
                   "replay_ms": ms, "launch_ms": each}, fh)
    del calls
    torch.cuda.empty_cache()


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
    row_real = {name: getattr(wave, name) for name in
                ("wave_row_update", "wave_trial_channels")}
    row_calls = []   # (rows, rows whose leaf an active split takes, in place)

    def recorder(fn):
        def call(bins, w, ch, **kw):
            calls.append((fn, bins, w, ch.clone(), kw))
            return fn(bins, w, ch, **kw)
        return call

    def row_recorder(fn, trial):
        def call(cols, rl, *a, **kw):
            leaves, act = (a[0], a[5]) if trial else (a[0][4], a[0][6] > 0)
            row_calls.append((rl.shape[0], torch.isin(
                rl, leaves[act.bool()].to(rl.dtype)).sum(),
                              "feats" in kw))
            return fn(cols, rl, *a, **kw)
        return call
    try:
        for name, fn in real.items():
            setattr(wave, name, recorder(fn))
        for name, fn in row_real.items():
            setattr(wave, name, row_recorder(fn, name == "wave_trial_channels"))
        bst.update()
    finally:
        for name, fn in {**real, **row_real}.items():
            setattr(wave, name, fn)
    torch.cuda.synchronize()
    row_share = np.array([int(m) / n for n, m, _ in row_calls])
    log(f"[{card}] row-update traffic {mode}: {len(row_calls)} launches "
        f"({sum(p for *_, p in row_calls)} reading the bin matrix in place), "
        f"share of rows whose leaf an active split takes: min "
        f"{row_share.min():.4f}, median {np.median(row_share):.4f}, mean "
        f"{row_share.mean():.4f}, max {row_share.max():.4f}")
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
                   "rule_groups": [list(p) for p in picks],
                   "row_update_share": row_share.tolist()}, fh)
    del calls
    torch.cuda.empty_cache()


# -- phase 12: the model-axis kernels and multi-model training --------------

LANES = 4
# the model-axis forms: the reference's jax.vmap of the same entry points
# (pallas_call's batching rule makes the batch axis a grid dimension,
# lightgbm_tpu/ops/histogram_pallas.py:45-48)
LANE_KERNELS = {
    "hist_leaves_q8_lanes": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                             "lightgbm_tpu/ops/histogram_pallas.py:1030"),
    "hist_leaves_q8_lanes_packed4": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                                     "lightgbm_tpu/ops/histogram_pallas.py:670"),
    "hist_leaves_lanes": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                          "lightgbm_tpu/ops/histogram_pallas.py:852"),
    "hist_leaves_lanes_packed4": ("lightgbm_tpu_torch/csrc/hist_leaves.cu",
                                  "lightgbm_tpu/ops/histogram_pallas.py:670"),
    "wave_row_update_lanes": ("lightgbm_tpu_torch/csrc/row_update.cu",
                              "lightgbm_tpu/ops/histogram_pallas.py:1280"),
    "wave_row_update_ext_lanes": ("lightgbm_tpu_torch/csrc/row_update.cu",
                                  "lightgbm_tpu/ops/histogram_pallas.py:1280"),
    "wave_trial_channels_lanes": ("lightgbm_tpu_torch/csrc/row_update.cu",
                                  "lightgbm_tpu/ops/histogram_pallas.py:1314"),
    "hist_single_lanes": ("lightgbm_tpu_torch/csrc/hist_single.cu",
                          "lightgbm_tpu/ops/histogram_pallas.py:471"),
    # the packed single-leaf form under vmap (only the autotune probe calls
    # the packed single form, and never under vmap: phase 12a holds it)
    "hist_single_lanes_packed4": ("lightgbm_tpu_torch/csrc/hist_single.cu",
                                  "lightgbm_tpu/ops/histogram_pallas.py:446"),
}
MANY_L2 = (0.0, 1.0, 4.0, 16.0)      # phase 12b's variants
MANY_ROUNDS = 3
CV_ROWS = 1_048_576                  # phase 12c's rows
CV_FOLDS = 4
SIDE_ROWS = 1_048_576                # phase 12e's packed / categorical rows


def _tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _lane_case(torch, card, name, tag, lanes_fn, single_fns, plain_fn,
               nbytes, ops, lib_fn, reps) -> dict:
    """One model-axis form: bitwise against its plain version and against
    one single launch per lane, identical across two runs; the one launch
    timed against the L single launches, the bound, the plain version and
    the library call."""
    got, again = _tuple(lanes_fn()), _tuple(lanes_fn())
    torch.cuda.synchronize()
    want = _tuple(plain_fn())
    err = 0.0
    for x, y, z in zip(got, again, want):
        if not torch.equal(x, y):
            raise AssertionError(f"{name} [{tag}] differs between two runs")
        err = max(err, float((x.double() - z.double()).abs().max()))
        if not torch.equal(x, z):
            raise AssertionError(f"{name} [{tag}] differs from its plain "
                                 f"version (max abs err {err})")
    del want
    for lane, fn in enumerate(single_fns):
        for x, one in zip(got, _tuple(fn())):
            if not torch.equal(x[lane], one):
                raise AssertionError(f"{name} [{tag}] lane {lane} differs "
                                     "from its single launch")
    del got, again
    b_ms, b_by = bound_ms(nbytes, ops)
    out = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
               ms=time_ms(lanes_fn, reps),
               singles_ms=time_ms(lambda: [fn() for fn in single_fns], reps),
               plain_ms=time_ms(plain_fn, 1),
               library_ms=None if lib_fn is None else time_ms(lib_fn, reps))
    log(f"[{card}] kernel {name} [{tag}, L={len(single_fns)}]: bitwise "
        f"equal to plain and to {len(single_fns)} single launches, "
        f"identical across two runs; one launch {out['ms']:.3f} ms, "
        f"{len(single_fns)} single launches {out['singles_ms']:.3f} ms, "
        f"bound {b_ms:.3f} ms ({b_by})")
    return out


def _lane_library(torch, bins, w3s, chs, k, num_bins, dtype):
    """One ``index_add_`` over lanes x channels (the library yardstick of
    the lane histograms; the port never calls it)."""
    f = bins.shape[0]
    idx, upd = [], []
    for lane, (w3, ch) in enumerate(zip(w3s, chs)):
        rows = torch.nonzero((ch >= 0) & (ch < k)).squeeze(1)
        idx.append((((ch[rows].long() + lane * k).unsqueeze(0) * f +
                     torch.arange(f, device=bins.device).unsqueeze(1)) *
                    num_bins + bins[:, rows].long()).reshape(-1))
        upd.append(w3[:3, rows].to(dtype).t().unsqueeze(0)
                   .expand(f, -1, -1).reshape(-1, 3))
    idx, upd = torch.cat(idx), torch.cat(upd).contiguous()
    size = len(w3s) * k * f * num_bins

    def call():
        out = torch.zeros((size, 3), dtype=dtype, device=bins.device)
        out.index_add_(0, idx, upd)
        return out
    return call


def lane_kernel_phase(torch, gen, dev, card: str, n: int, reps: int) -> dict:
    """Phase 12a: every model-axis form at L = 4 lanes with their own
    gradients, channels and tables over one shared bin matrix: the leaf
    histograms (q8 and exact) at the main shape and packed at B=16, the
    row update (numeric and categorical / EFB forms, W=42) and its trial
    form, and the single-leaf histogram over four lanes' row-major
    segments of different lengths, and its packed form over a shared
    nibble-packed matrix."""
    from lightgbm_tpu_torch.dataset import ROW_BLOCK
    from lightgbm_tpu_torch.ops import histogram as th
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    from lightgbm_tpu_torch.ops import quantize as tq
    f, L = NUM_FEATURES, LANES
    rec = {}
    bins = torch.randint(0, 256, (f, n), generator=gen, device=dev,
                         dtype=torch.uint8)
    lanes = []
    for _ in range(L):
        grad = torch.randn(n, generator=gen, device=dev) * 0.5
        hess = torch.rand(n, generator=gen, device=dev) * 0.25 + 0.01
        mask = (torch.rand(n, generator=gen, device=dev) < 0.8).float()
        ch = torch.randint(0, hc.Q_LEAF_CHANNELS, (n,), generator=gen,
                           device=dev, dtype=torch.int8)
        keep = torch.rand(n, generator=gen, device=dev) < 0.5
        ch = torch.where(keep, ch, torch.full_like(ch, -1)).contiguous()
        wch = tq.quantize_wch(grad, hess, mask, (grad * mask).abs().max() /
                              127, (hess * mask).max() / 127, gq_max=127,
                              hq_max=127)
        lanes.append((wch, th.pack_weights(grad, hess, mask), ch))
        del grad, hess, mask, keep
    for packed in (False, True):
        b = th.pack_bins4(bins & 15) if packed else bins
        nb = PACK_BINS if packed else 256
        sfx = "_packed4" if packed else ""
        tag = f"B={nb}" + (", packed" if packed else "") + f" F={f} N={n}"
        for q8 in (True, False):
            k = hc.Q_LEAF_CHANNELS if q8 else hc.LEAF_CHANNELS
            ws = [x[0] if q8 else x[1] for x in lanes]
            chs = [x[2] if q8 else torch.where(x[2] < k, x[2], -1)
                   .contiguous() for x in lanes]
            many = (hc.build_histogram_leaves_q8_lanes if q8
                    else hc.build_histogram_leaves_lanes)
            one = (hc.build_histogram_leaves_q8 if q8
                   else hc.build_histogram_leaves)
            plain = (hc.build_histogram_leaves_q8_lanes_plain if q8
                     else hc.build_histogram_leaves_lanes_plain)
            # each lane's channels and the weights of its rows that add;
            # the shared bins once, for every row (row pair, packed) that
            # adds in some lane; each lane's output (int32 q8, int64 fx)
            live = [(c >= 0) & (c < k) for c in chs]
            active = sum(int(x.sum()) for x in live)
            anyl = torch.stack(live).any(dim=0)
            if packed:
                anyl = anyl.view(-1, 2).any(dim=1)
            nbytes = (L * n + active * (3 if q8 else 24) +
                      f * int(anyl.sum()) +
                      L * k * f * nb * 3 * (4 if q8 else 8))
            del live, anyl
            lib = _lane_library(torch, bins & 15 if packed else bins,
                                [w if q8 else w.w for w in ws], chs, k, nb,
                                torch.int32 if q8 else torch.int64)
            name = ("hist_leaves_q8_lanes" if q8 else "hist_leaves_lanes") + \
                sfx
            rec[name] = _lane_case(
                torch, card, name, tag,
                lambda: many(b, ws, chs, num_bins=nb, bins_packed=packed),
                [lambda i=i: one(b, ws[i], chs[i], num_bins=nb,
                                 bins_packed=packed) for i in range(L)],
                lambda: plain(b, ws, chs, num_bins=nb, bins_packed=packed),
                nbytes, 3.0 * f * active, lib, reps)
            del lib, ws, chs
            torch.cuda.empty_cache()
        del b

    # ---- the row update, its categorical / EFB form and its trial form ----
    wn = hc.Q_LEAF_CHANNELS
    rows = [_row_case(torch, gen, dev, wn, n, 256, NUM_LEAVES, wn - 2)[1:]
            for _ in range(L)]
    feats = [r[0] for r in rows]
    rls = [r[1] for r in rows]
    tabs = [r[2] for r in rows]
    def lane_work(write_rl: bool):
        """The lanes' (bytes, operations): their own vectors and tables,
        and each bin byte of the shared matrix once."""
        seen = torch.zeros(bins.shape, dtype=torch.bool, device=dev)
        works = [_row_work(torch, bins.index_select(0, fc), rl, tab,
                           write_rl, seen, fc)
                 for fc, rl, tab in zip(
                     [ft.long().clamp(0, f - 1) for ft in feats], rls, tabs)]
        return (sum(w_[0] for w_ in works) + float(seen.sum()),
                sum(w_[1] for w_ in works))
    nbytes, ops = lane_work(True)
    rec["wave_row_update_lanes"] = _lane_case(
        torch, card, "wave_row_update_lanes", f"W={wn} N={n}",
        lambda: hc.wave_row_update_lanes(bins, rls, tabs, feats=feats),
        [lambda i=i: hc.wave_row_update(bins, rls[i], tabs[i],
                                        feats=feats[i]) for i in range(L)],
        lambda: hc.wave_row_update_lanes_plain(bins, rls, tabs, feats=feats),
        nbytes, ops, None, reps)
    decs = []
    for _ in range(L):
        is_cat = torch.rand(wn, generator=gen, device=dev) < 0.4
        member = torch.rand((wn, 256), generator=gen, device=dev) < 0.4
        z = torch.zeros(wn, dtype=torch.int32, device=dev)
        decs.append(hc.split_decode(is_cat, member, z, z + 256, z, z + 1))
    rec["wave_row_update_ext_lanes"] = _lane_case(
        torch, card, "wave_row_update_ext_lanes", f"W={wn} N={n}, 40% categorical",
        lambda: hc.wave_row_update_lanes(bins, rls, tabs, feats=feats,
                                         decode=decs),
        [lambda i=i: hc.wave_row_update(bins, rls[i], tabs[i],
                                        feats=feats[i], decode=decs[i])
         for i in range(L)],
        lambda: hc.wave_row_update_lanes_plain(bins, rls, tabs, feats=feats,
                                               decode=decs),
        nbytes + L * wn * 52, ops + 4.0 * L * n, None, reps)
    trial = [(t[4], t[0], t[1], t[2] > 0, t[3] > 0, t[6] > 0) for t in tabs]
    ttabs = [hc.trial_tab(*a) for a in trial]
    tbytes, tops = lane_work(False)
    rec["wave_trial_channels_lanes"] = _lane_case(
        torch, card, "wave_trial_channels_lanes", f"W={wn} N={n}",
        lambda: hc.wave_trial_channels_lanes(bins, rls, ttabs, feats=feats),
        [lambda i=i: hc.wave_trial_channels(bins, rls[i], *trial[i],
                                            feats=feats[i])
         for i in range(L)],
        lambda: hc.wave_trial_channels_lanes_plain(bins, rls, ttabs,
                                                   feats=feats),
        tbytes, tops, None, reps)
    del rows, feats, rls, tabs, decs, ttabs, trial
    torch.cuda.empty_cache()

    # ---- the single-leaf histogram over each lane's own row-major copy ----
    segs = [(0, n), (n // 4, n // 2), (12_345, 50_003), (n // 3, n // 5)]
    P = [bins.t().contiguous() for _ in range(L)]
    sb = [p[s:s + c].t() for p, (s, c) in zip(P, segs)]
    sw = [th.FxWeights(x[1].w[:, s:s + c], x[1].inv_scale)
          for x, (s, c) in zip(lanes, segs)]
    act = [(w.w != 0).any(dim=0) for w in sw]
    nact = sum(int(a.sum()) for a in act)
    nbytes = sum(24.0 * c for _, c in segs) + f * nact + L * f * 256 * 24
    idx, upd = [], []
    for lane, (b_, w_, a_) in enumerate(zip(sb, sw, act)):
        r_ = torch.nonzero(a_).squeeze(1)
        idx.append(((lane * f + torch.arange(f, device=dev).unsqueeze(1)) *
                    256 + b_[:, r_].long()).reshape(-1))
        upd.append(w_.w[:, r_].t().unsqueeze(0).expand(f, -1, -1)
                   .reshape(-1, 3))
    idx, upd = torch.cat(idx), torch.cat(upd).contiguous()

    def lib():
        o = torch.zeros((L * f * 256, 3), dtype=torch.int64, device=dev)
        o.index_add_(0, idx, upd)
        return o
    rec["hist_single_lanes"] = _lane_case(
        torch, card, "hist_single_lanes",
        f"row-major segments of {[c for _, c in segs]} rows, F={f} B=256",
        lambda: hc.hist_single_lanes(sb, sw, num_bins=256),
        [lambda i=i: hc.hist_single(sb[i], sw[i], num_bins=256)
         for i in range(L)],
        lambda: hc.hist_single_lanes_plain(sb, sw, num_bins=256),
        nbytes, 3.0 * f * nact, lib, reps)
    del P, sb, sw, idx, upd, lib
    torch.cuda.empty_cache()

    # ---- the packed single-leaf histogram: each lane's weights over one
    # shared (F, m/2) nibble-packed matrix of m = N/2 rows ----
    m = (n // 2) // ROW_BLOCK * ROW_BLOCK
    codes = (bins[:, :m] & 15).contiguous()
    pk = th.pack_bins4(codes)
    pw = [th.FxWeights(x[1].w[:, :m].contiguous(), x[1].inv_scale)
          for x in lanes]
    act = [(w.w != 0).any(dim=0) for w in pw]
    nact = sum(int(a.sum()) for a in act)
    pairs = int(torch.stack(act).any(dim=0).view(-1, 2).any(dim=1).sum())
    nbytes = L * 24.0 * m + f * pairs + L * f * PACK_BINS * 24
    idx, upd = [], []
    for lane, (w_, a_) in enumerate(zip(pw, act)):
        r_ = torch.nonzero(a_).squeeze(1)
        idx.append(((lane * f + torch.arange(f, device=dev).unsqueeze(1)) *
                    PACK_BINS + codes[:, r_].long()).reshape(-1))
        upd.append(w_.w[:, r_].t().unsqueeze(0).expand(f, -1, -1)
                   .reshape(-1, 3))
    idx, upd = torch.cat(idx), torch.cat(upd).contiguous()
    del codes

    def lib_p4():
        o = torch.zeros((L * f * PACK_BINS, 3), dtype=torch.int64,
                        device=dev)
        o.index_add_(0, idx, upd)
        return o
    rec["hist_single_lanes_packed4"] = _lane_case(
        torch, card, "hist_single_lanes_packed4",
        f"(F, N/2) packed, {m} rows each, F={f} B={PACK_BINS}",
        lambda: hc.hist_single_lanes([pk] * L, pw, num_bins=PACK_BINS,
                                     bins_packed=True),
        [lambda i=i: hc.hist_single(pk, pw[i], num_bins=PACK_BINS,
                                    bins_packed=True) for i in range(L)],
        lambda: hc.hist_single_lanes_plain([pk] * L, pw, num_bins=PACK_BINS,
                                           bins_packed=True),
        nbytes, 3.0 * f * nact, lib_p4, reps)
    del pk, pw, idx, upd, lanes, bins
    torch.cuda.empty_cache()
    for name, r in rec.items():
        lib = ("n/a" if r["library_ms"] is None
               else f"{r['library_ms']:.3f} ms")
        log(f"[{card}] {name} @ L={L} N={n}: one launch {r['ms']:.3f} ms, "
            f"{L} single launches {r['singles_ms']:.3f} ms, bound "
            f"{r['bound_ms']:.3f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.3f} ms, library {lib}")
    return rec


def _lane_launches(hc) -> dict:
    return {k: v for k, v in hc.LAUNCHES.items() if "_lanes" in k}


def _single_launches(hc) -> dict:
    return {k: v for k, v in hc.LAUNCHES.items() if "_lanes" not in k and v}


def many_phase(lt, torch, card, ds, Xtr, ytr, out_dir: str) -> dict:
    """Phase 12b-e: ``train_many``, ``cv`` and the partitioned lanes on the
    card.  Returns each model-axis form's launches over those runs."""
    from lightgbm_tpu_torch.models import gbdt as tg
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    launches = {k: 0 for k in LANE_KERNELS}
    # the histogram autotuner's probe (small shapes, models/gbdt.py
    # learner_config) times single launches: they are recorded apart, and
    # a batch may launch no other single form
    probe = collections.Counter()
    real_pick = tg.pick_hist_impl

    def pick(*a, **k):
        before = dict(hc.LAUNCHES)
        try:
            return real_pick(*a, **k)
        finally:
            probe.update({k_: v - before[k_]
                          for k_, v in hc.LAUNCHES.items()})

    def reset():
        hc.reset_launches()
        probe.clear()

    def count(tag, needs):
        got = _lane_launches(hc)
        single = {k: v - probe[k] for k, v in _single_launches(hc).items()
                  if v - probe[k]}
        log(f"phase 12{tag} launches: {json.dumps(got)}; single forms "
            f"{json.dumps(single)} (and the autotune probe's "
            f"{json.dumps({k: v for k, v in probe.items() if v})})")
        missing = [k for k in needs if got[k] <= 0]
        if missing:
            raise AssertionError(f"phase 12{tag}: kernels not launched: "
                                 f"{missing}")
        if single:
            raise AssertionError(f"phase 12{tag}: a batch launched single "
                                 f"forms {single}")
        for k in launches:
            launches[k] += got[k]
        return got

    tg.pick_hist_impl = pick
    try:
        return _many_runs(lt, torch, hc, card, ds, Xtr, ytr, out_dir,
                          reset, count, launches)
    finally:
        tg.pick_hist_impl = real_pick


def _many_runs(lt, torch, hc, card, ds, Xtr, ytr, out_dir, reset, count,
               launches) -> dict:

    # (b) train_many: the headline configuration, 4 variants
    head = mode_params("headline")
    variants = [{"lambda_l2": v} for v in MANY_L2]
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mb = lt.train_many(head, ds, MANY_ROUNDS, variants=variants,
                       device="cuda")
    torch.cuda.synchronize()
    t_many = time.perf_counter() - t0
    got = count("b", ("hist_leaves_q8_lanes", "wave_row_update_lanes",
                      "hist_single_lanes"))
    rate_many = LANES * MANY_ROUNDS / t_many
    t_one, single = [], None
    for m in (0, len(MANY_L2) - 1):
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ref = lt.train({**head, **variants[m]}, ds, MANY_ROUNDS,
                       device="cuda")
        torch.cuda.synchronize()
        t_one.append(time.perf_counter() - t0)
        single = single or dict(hc.LAUNCHES)
        if ref.model_to_string() != mb[m].model_to_string():
            raise AssertionError(f"phase 12b: train_many model {m} "
                                 f"(lambda_l2={MANY_L2[m]}) text differs "
                                 "from train()")
        mb[m].save_model(os.path.join(out_dir, f"many_{m}.txt"))
    rate_one = MANY_ROUNDS / float(np.mean(t_one))
    per_it = {k: v / MANY_ROUNDS for k, v in got.items() if v}
    four = {k.replace("_lanes", ""): LANES * single[k.replace("_lanes", "")]
            / MANY_ROUNDS for k in per_it
            if k.replace("_lanes", "") in single}
    log(f"[{card}] phase 12b train_many headline x{LANES} (lambda_l2 "
        f"{list(MANY_L2)}), {MANY_ROUNDS} rounds: {rate_many:.4f} "
        f"model-rounds/s in {t_many:.2f} s; standalone train() "
        f"{rate_one:.4f} rounds/s; models 0 and {len(MANY_L2) - 1} text "
        "identical to train()")
    log(f"[{card}] phase 12b launches per iteration: model-axis "
        f"{json.dumps(per_it)}; {LANES} x standalone single "
        f"{json.dumps(four)}")
    del mb, ref
    torch.cuda.empty_cache()

    # (c) cv: four folds at 1,048,576 rows, fast path against the per-fold
    # loop: the headline configuration (stochastic rounding and the
    # speculative ramp on, both drawing over each fold's own rows), then
    # the exact wave with the ramp off; the rows are binned first, outside
    # the timed runs
    rows = min(CV_ROWS, len(ytr))
    dcv = lt.Dataset(Xtr[:rows], ytr[:rows], params={"max_bin": MAX_BIN})
    dcv.construct()
    kw = dict(num_boost_round=MANY_ROUNDS, nfold=CV_FOLDS, seed=7,
              device="cuda")

    def timed_cv(params, many: bool):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = lt.cv({**params, "tpu_cv_many": many}, dcv, **kw)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    reset()
    t_hf, h_fast = timed_cv(head, True)
    count("c headline", ("hist_leaves_q8_lanes", "wave_row_update_lanes",
                         "hist_single_lanes"))
    t_hs, h_slow = timed_cv(head, False)
    if h_fast != h_slow:
        raise AssertionError(f"phase 12c: the headline cv fast path's metric "
                             f"history {h_fast} differs from the per-fold "
                             f"loop's {h_slow}")
    log(f"[{card}] phase 12c cv headline (ramp, stochastic rounding), "
        f"{CV_FOLDS} folds of {rows} rows, {MANY_ROUNDS} rounds: fast path "
        f"{t_hf:.2f} s, per-fold loop {t_hs:.2f} s, metric history "
        f"identical {json.dumps({k: v[-1] for k, v in h_fast.items()})}")

    # the exact wave with the ramp off
    exact = mode_params("exact", tpu_speculative_ramp=False)
    reset()
    t_fast, fast = timed_cv(exact, True)
    count("c exact", ("hist_leaves_lanes", "wave_row_update_lanes",
                      "wave_trial_channels_lanes"))
    t_slow, slow = timed_cv(exact, False)
    if fast != slow:
        raise AssertionError(f"phase 12c: the exact cv fast path's metric "
                             f"history {fast} differs from the per-fold "
                             f"loop's {slow}")
    log(f"[{card}] phase 12c cv exact wave (ramp off), {CV_FOLDS} folds of "
        f"{rows} rows, {MANY_ROUNDS} rounds: fast path {t_fast:.2f} s, "
        f"per-fold loop {t_slow:.2f} s, metric history identical "
        f"{json.dumps({k: v[-1] for k, v in fast.items()})}")
    del dcv
    torch.cuda.empty_cache()

    # (d) partitioned lanes
    part = mode_params("partition")
    pv = [{"lambda_l2": 0.0}, {"lambda_l2": 4.0}]
    reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mb = lt.train_many(part, ds, 2, variants=pv, device="cuda")
    torch.cuda.synchronize()
    t_part = time.perf_counter() - t0
    count("d", ("hist_single_lanes",))
    for m, v in enumerate(pv):
        ref = lt.train({**part, **v}, ds, 2, device="cuda")
        if ref.model_to_string() != mb[m].model_to_string():
            raise AssertionError(f"phase 12d: partitioned lane {m} text "
                                 "differs from train()")
    log(f"[{card}] phase 12d partitioned train_many x2, 2 rounds: "
        f"{2 * 2 / t_part:.4f} model-rounds/s, text identical to train()")
    del mb, ref
    torch.cuda.empty_cache()

    # (e) the packed and the categorical / EFB forms on their paths
    rows = min(SIDE_ROWS, len(ytr))
    packed_ds = lt.Dataset(Xtr[:rows], ytr[:rows],
                           params={"max_bin": PACK_MAX_BIN})
    Xc = np.c_[Xtr[:rows], (np.abs(Xtr[:rows, 0] * 7).astype(np.int64) % 40)]
    cat_ds = lt.Dataset(Xc, ytr[:rows], params={"max_bin": MAX_BIN},
                        categorical_feature=[NUM_FEATURES])
    side = [("packed quantized", mode_params("quantized", PACK_MAX_BIN),
             packed_ds, ("hist_leaves_q8_lanes_packed4",)),
            ("packed exact", mode_params("exact", PACK_MAX_BIN), packed_ds,
             ("hist_leaves_lanes_packed4",)),
            ("categorical", mode_params("quantized"), cat_ds,
             ("wave_row_update_ext_lanes",))]
    for tag, params, d, needs in side:
        reset()
        mb = lt.train_many(params, d, 1, variants=pv, device="cuda")
        count(f"e {tag}", needs)
        ref = lt.train({**params, **pv[1]}, d, 1, device="cuda")
        if ref.model_to_string() != mb[1].model_to_string():
            raise AssertionError(f"phase 12e ({tag}): lane text differs "
                                 "from train()")
        log(f"phase 12e {tag} train_many x2 at {rows} rows: text identical "
            "to train()")
    return launches


# -- phase 13: the boosting variants and the rest of the training surface ----

VARIANT_ROUNDS = 8                   # (a)-(c)
VARIANT_LR = 0.25                    # GOSS warms up int(1 / lr) = 4 rounds
GOSS_RATES = (0.2, 0.1)              # (a): top_rate, other_rate
LINEAR_ROUNDS = 5                    # (d)
FOBJ_ROUNDS = 5                      # (e)
FOBJ_CHECK_ROWS = 300_000            # (e): the card-against-CPU text check
MANY_VARIANT_ROUNDS = 6              # (g)
MANY_GOSS = ((0.2, 0.1), (0.3, 0.1), (0.2, 0.2), (0.1, 0.1))
MANY_DART = (0.05, 0.1, 0.2, 0.4)
HEAD_KERNELS = ("hist_leaves_q8", "wave_row_update", "hist_single")
EXACT_KERNELS = ("hist_leaves", "wave_row_update")


def logloss_fobj(preds, dataset):
    """Phase 13e's custom objective: binary logloss in numpy over the raw
    scores."""
    label = dataset.get_label()
    p = 1.0 / (1.0 + np.exp(-preds.astype(np.float64)))
    return p - label, p * (1.0 - p)


def auc_feval(preds, dataset):
    """Phase 13e's custom metric: the rank AUC of the raw scores, ties at
    their average rank, ranked on the card (a host sort of 10.5M scores
    each round would take seconds)."""
    import torch
    p = torch.as_tensor(preds, device="cuda")
    y = torch.as_tensor(dataset.get_label(), device="cuda")
    ps, order = torch.sort(p)
    _, counts = torch.unique_consecutive(ps, return_counts=True)
    first = torch.cumsum(counts, 0) - counts
    ranks = torch.repeat_interleave(first + (counts + 1) / 2.0, counts)
    pos = y[order] > 0
    npos = float(pos.sum())
    nneg = len(preds) - npos
    return ("auc_feval", float((ranks[pos].double().sum() -
                                npos * (npos + 1) / 2) / (npos * nneg)),
            True)


def _variant_train(lt, torch, hc, card, tag, params, ds, rounds, Xte, yte,
                   needs, callbacks=(), **kw):
    """One phase 13 training run with the launch counts from 0: its rate,
    launches and held-out AUC, which must beat chance; returns the booster
    and the launches."""
    hc.reset_launches()
    ticks = []

    def tick(env):
        torch.cuda.synchronize()
        ticks.append(time.perf_counter())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bst = lt.train(params, ds, rounds, callbacks=[*callbacks, tick],
                   device="cuda", **kw)
    got = dict(hc.LAUNCHES)
    missing = [k for k in needs if got[k] <= 0]
    if missing:
        raise AssertionError(f"phase 13{tag}: kernels not launched: "
                             f"{missing}")
    rate = len(ticks) / (ticks[-1] - t0)
    steady = ((len(ticks) - 1) / (ticks[-1] - ticks[0])
              if len(ticks) > 1 else float("nan"))
    p = bst.predict(Xte)
    if not np.all(np.isfinite(p)):
        raise AssertionError(f"phase 13{tag}: predictions not finite")
    a = auc(yte, p)
    log(f"[{card}] phase 13{tag}: {len(ticks)} rounds, {rate:.4f} "
        f"iterations/s (steady {steady:.4f}), held-out AUC {a:.6f}; "
        f"launches {json.dumps({k: v for k, v in got.items() if v})}")
    if not a > 0.6:
        raise AssertionError(f"phase 13{tag}: held-out AUC {a} is no better "
                             "than chance")
    return bst, got


def variants_phase(lt, torch, card, ds, Xtr, ytr, Xte, yte,
                   out_dir: str) -> dict:
    """Phase 13: GOSS, DART, RF, linear trees, a custom objective and
    metric, the Booster's model surgery, and GOSS / DART ``train_many``,
    on the main path's binned rows.  Returns the launches of every part."""
    from lightgbm_tpu_torch.learner import linear as tlin
    from lightgbm_tpu_torch.models import boosting as tb
    from lightgbm_tpu_torch.ops import histogram_cuda as hc
    total = collections.Counter()
    head = mode_params("headline")

    # (a) GOSS on the headline configuration: the host draw timed, with
    # the device-to-host copy of g and h and the mask's upload
    draws = []
    real_goss = tb.GOSS._prepare_iter_sampling

    def timed_goss(self, grad, hess):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_goss(self, grad, hess)
        torch.cuda.synchronize()
        draws.append((time.perf_counter() - t0, float(out[2].mean())))
        return out

    tb.GOSS._prepare_iter_sampling = timed_goss
    try:
        goss, got = _variant_train(
            lt, torch, hc, card, "a goss", {
                **head, "boosting": "goss", "learning_rate": VARIANT_LR,
                "top_rate": GOSS_RATES[0], "other_rate": GOSS_RATES[1]},
            ds, VARIANT_ROUNDS, Xte, yte, HEAD_KERNELS)
    finally:
        tb.GOSS._prepare_iter_sampling = real_goss
    total.update(got)
    sampled = [(ms, share) for ms, share in draws if share < 1.0]
    if len(sampled) < 4:
        raise AssertionError(f"phase 13a: GOSS sampled {len(sampled)} "
                             "iterations, expected at least 4")
    log(f"[{card}] phase 13a GOSS top_rate {GOSS_RATES[0]} other_rate "
        f"{GOSS_RATES[1]} lr {VARIANT_LR}: {len(sampled)} of "
        f"{len(draws)} iterations sampled, active-row share "
        f"{np.mean([s for _, s in sampled]):.4f}; host draw "
        f"{1e3 * np.mean([ms for ms, _ in sampled]):.1f} ms per sampled "
        f"iteration ({2 * 4 * len(ytr) / 1e6:.0f} MB of g/h to the host), "
        f"{1e3 * np.mean([ms for ms, s in draws if s == 1.0]):.1f} ms in "
        "warm-up")

    # (b) DART on the headline configuration
    drops = []
    dart, got = _variant_train(
        lt, torch, hc, card, "b dart",
        {**head, "boosting": "dart", "drop_rate": 0.1}, ds, VARIANT_ROUNDS,
        Xte, yte, HEAD_KERNELS,
        callbacks=[lambda env: drops.append(len(env.model._gbdt._drop_idx))])
    total.update(got)
    log(f"[{card}] phase 13b DART drop_rate 0.1: trees dropped per "
        f"iteration {drops}; base-prediction cache "
        f"{sum(t.numel() * 4 for t in dart._gbdt._base_pred) / 2**20:.1f} "
        "MiB on the card "
        f"({VARIANT_ROUNDS} x {len(ytr)} f32)")
    del dart
    torch.cuda.empty_cache()

    # (c) RF, exact wave
    rf, got = _variant_train(
        lt, torch, hc, card, "c rf",
        {**mode_params("exact"), "boosting": "rf", "bagging_fraction": 0.632,
         "bagging_freq": 1, "feature_fraction": 0.8},
        ds, VARIANT_ROUNDS, Xte, yte, EXACT_KERNELS)
    total.update(got)
    rf.save_model(os.path.join(out_dir, "model_rf.txt"))
    again = lt.Booster(model_file=os.path.join(out_dir, "model_rf.txt"))
    if not np.array_equal(again.predict(Xte[:10_000]),
                          rf.predict(Xte[:10_000])):
        raise AssertionError("phase 13c: the reloaded RF model predicts "
                             "differently")
    del rf, again
    torch.cuda.empty_cache()

    # (d) linear trees, exact wave: the raw used columns (kept by phase 4's
    # Dataset) go to the card beside the bins; each tree's moment pass
    # timed
    moments = []
    real_moments = tlin._moments

    def timed_moments(*a, **k):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = real_moments(*a, **k)
        torch.cuda.synchronize()
        moments.append(time.perf_counter() - t1)
        return out

    tlin._moments = timed_moments
    try:
        lin, got = _variant_train(
            lt, torch, hc, card, "d linear",
            {**mode_params("exact"), "linear_tree": True}, ds,
            LINEAR_ROUNDS, Xte, yte, EXACT_KERNELS)
    finally:
        tlin._moments = real_moments
    total.update(got)
    g = lin._gbdt
    linear_leaves = [sum(1 for c in t.leaf_coeff if c) for t in g.models]
    log(f"[{card}] phase 13d linear trees: raw matrix "
        f"{g.X_raw_dev.numel() * 4 / 2**30:.3f} GiB on the card; moment "
        f"pass {1e3 * np.mean(moments):.1f} ms per tree "
        f"({[round(1e3 * x, 1) for x in moments]}); linear leaves per tree "
        f"{linear_leaves}")
    if not any(linear_leaves):
        raise AssertionError("phase 13d: no leaf got a linear model")
    del lin, g
    torch.cuda.empty_cache()

    # (e) a quantized custom objective and metric; the text at 300K rows
    # equal on the card and on the CPU
    qparams = {**mode_params("quantized"), "objective": "none",
               "metric": "none"}
    hist = {}
    fo, got = _variant_train(
        lt, torch, hc, card, "e fobj", qparams, ds, FOBJ_ROUNDS, Xte, yte,
        ("hist_leaves_q8", "wave_row_update"),
        callbacks=[lt.record_evaluation(hist)], fobj=logloss_fobj,
        feval=auc_feval)
    total.update(got)
    log(f"[{card}] phase 13e feval history (training AUC): "
        f"{[round(v, 6) for v in hist['training']['auc_feval']]}")
    del fo
    rows = min(FOBJ_CHECK_ROWS, len(ytr))
    texts, secs = [], []
    for dev in ("cuda", "cpu"):
        d = lt.Dataset(Xtr[:rows], ytr[:rows], params={"max_bin": MAX_BIN})
        t0 = time.perf_counter()
        texts.append(lt.train(qparams, d, FOBJ_ROUNDS, fobj=logloss_fobj,
                              device=dev).model_to_string())
        secs.append(time.perf_counter() - t0)
    if texts[0] != texts[1]:
        raise AssertionError("phase 13e: the custom-objective model text "
                             f"at {rows} rows differs between card and CPU")
    log(f"[{card}] phase 13e at {rows} rows: model text identical on the "
        f"card ({secs[0]:.1f} s) and the CPU ({secs[1]:.1f} s)")

    # (f) the Booster's model surgery on (a)'s model
    raw = goss.predict(Xte, raw_score=True)
    t0 = time.perf_counter()
    lp = goss.predict(Xte, pred_leaf=True)
    t_leaf = time.perf_counter() - t0
    vals = np.zeros(len(yte))
    for i, tree in enumerate(goss._gbdt.models):
        vals += tree.leaf_value[lp[:, i]]
    if lp.shape != (len(yte), VARIANT_ROUNDS) or \
            not np.allclose(vals, raw, rtol=1e-5,
                            atol=1e-5 * np.abs(raw).max()):
        raise AssertionError("phase 13f: the leaf values at pred_leaf's "
                             "indices do not sum to the raw score")
    t0 = time.perf_counter()
    es = goss.predict(Xte, raw_score=True, pred_early_stop=True,
                      pred_early_stop_freq=2, pred_early_stop_margin=4.0)
    t_es = time.perf_counter() - t0
    stopped = float(np.mean(es != raw))
    a_es = auc(yte, es)
    if not a_es > 0.6:
        raise AssertionError(f"phase 13f: early-stopped AUC {a_es}")
    hc.reset_launches()
    goss.rollback_one_iter()
    goss.update()
    got = dict(hc.LAUNCHES)
    total.update(got)
    missing = [k for k in HEAD_KERNELS if got[k] <= 0]
    if missing or goss.num_trees() != VARIANT_ROUNDS:
        raise AssertionError(f"phase 13f: rollback then one round launched "
                             f"no {missing} or kept {goss.num_trees()} trees")
    a_rb = auc(yte, goss.predict(Xte))
    t0 = time.perf_counter()
    refit = goss.refit(Xte, yte, decay_rate=0.9)
    t_refit = time.perf_counter() - t0
    a_refit = auc(yte, refit.predict(Xte))
    log(f"[{card}] phase 13f surgery on 13a's model: pred_leaf over "
        f"{len(yte)} rows in {t_leaf:.2f} s, leaf values sum to the raw "
        f"score; pred_early_stop (freq 2, margin 4) {t_es:.2f} s, "
        f"{stopped:.3f} of the rows stopped early, AUC {a_es:.6f}; "
        f"rollback + 1 round AUC {a_rb:.6f} (launches "
        f"{json.dumps({k: v for k, v in got.items() if v})}); refit onto "
        f"the held-out rows in {t_refit:.2f} s, AUC there {a_refit:.6f}")
    if not (a_rb > 0.6 and a_refit > 0.6):
        raise AssertionError(f"phase 13f: AUC {a_rb} / {a_refit}")
    del goss, refit
    torch.cuda.empty_cache()

    # (g) GOSS and DART batches through train_many
    for kind, extra, variants in (
            ("goss", {"boosting": "goss", "learning_rate": 0.5},
             [{"top_rate": a, "other_rate": b} for a, b in MANY_GOSS]),
            ("dart", {"boosting": "dart"},
             [{"drop_rate": r} for r in MANY_DART])):
        params = {**head, **extra}
        hc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mb = lt.train_many(params, ds, MANY_VARIANT_ROUNDS,
                           variants=variants, device="cuda", strict=True)
        torch.cuda.synchronize()
        t_many = time.perf_counter() - t0
        got = dict(hc.LAUNCHES)
        lanes = {k: v for k, v in got.items() if "_lanes" in k and v}
        single = {k: v for k, v in got.items() if "_lanes" not in k and v}
        missing = [k for k in ("hist_leaves_q8_lanes",
                               "wave_row_update_lanes", "hist_single_lanes")
                   if got[k] <= 0]
        if missing or single or mb.num_groups != 1:
            raise AssertionError(f"phase 13g {kind}: lanes missing "
                                 f"{missing}, single forms {single}, "
                                 f"{mb.num_groups} groups")
        total.update(got)
        for m in (0, len(variants) - 1):
            ref = lt.train({**params, **variants[m]}, ds,
                           MANY_VARIANT_ROUNDS, device="cuda")
            if ref.model_to_string() != mb[m].model_to_string():
                raise AssertionError(f"phase 13g {kind}: model {m} text "
                                     "differs from train()")
        a = [auc(yte, mb[m].predict(Xte)) for m in range(len(variants))]
        if not min(a) > 0.6:
            raise AssertionError(f"phase 13g {kind}: held-out AUC {a}")
        log(f"[{card}] phase 13g train_many {kind} x{len(variants)} "
            f"({variants}), {MANY_VARIANT_ROUNDS} rounds: "
            f"{len(variants) * MANY_VARIANT_ROUNDS / t_many:.4f} "
            f"model-rounds/s, models 0 and {len(variants) - 1} text "
            f"identical to train(); held-out AUC {[round(x, 6) for x in a]}; "
            f"model-axis launches per iteration "
            f"{json.dumps({k: v / MANY_VARIANT_ROUNDS for k, v in lanes.items()})}")
        del mb, ref
        torch.cuda.empty_cache()
    return dict(total)


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
    ap.add_argument("--mc-rounds", type=int, default=3,
                    help="boosting rounds of the multiclass phase")
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
    rng_phase(card, n_pad)
    stamp("phase 2, kernels")

    # ---- phase 3: the same small model on card and CPU ----
    small_check(lt, args.seed, out_dir)
    stamp("phase 3, card vs CPU")

    # ---- phase 4: the main path ----
    t0 = time.perf_counter()
    X, y, logit = higgs_like(args.rows + args.test_rows, args.seed)
    Xtr, ytr = X[:args.rows], y[:args.rows]
    Xte, yte = X[args.rows:], y[args.rows:]
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    # linear_tree keeps the raw used columns beside the bins for phase
    # 13d (no other phase reads them)
    ds = lt.Dataset(Xtr, ytr, params={"max_bin": MAX_BIN,
                                      "linear_tree": True})
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

    # ---- phase 9: the training surface at full width ----
    if args.mc_rounds < 3:
        log(f"cut: multiclass rounds only, 3 -> {args.mc_rounds}")
    for k, v in surface_phase(lt, torch, card, ds, Xte, yte,
                              logit[:args.rows], logit[args.rows:],
                              args.rounds, args.mc_rounds, out_dir,
                              args.profile).items():
        launches[k] += v
    stamp("phase 9, training surface")

    # ---- phase 11: the split and grower options at full width ----
    for k, v in options_phase(lt, torch, card, ds, Xte, yte,
                              out_dir).items():
        launches[k] += v
    stamp("phase 11, split and grower options")

    # ---- phase 12: model-axis kernels and multi-model training ----
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed + 12)
    rec.update(lane_kernel_phase(torch, gen, torch.device("cuda"), card,
                                 n_pad, args.reps))
    stamp("phase 12a, model-axis kernels")
    for k, v in many_phase(lt, torch, card, ds, Xtr, ytr, out_dir).items():
        launches[k] += v
    stamp("phase 12b-e, train_many and cv")

    # ---- phase 13: boosting variants and the training surface ----
    for k, v in variants_phase(lt, torch, card, ds, Xtr, ytr, Xte, yte,
                               out_dir).items():
        launches[k] += v
    del ds
    torch.cuda.empty_cache()
    stamp("phase 13, boosting variants and the training surface")

    # ---- phase 10: categorical features, EFB and CSR input ----
    for k, v in categorical_phase(lt, torch, card, X, logit, args.rows,
                                  args.rounds, out_dir, args.seed,
                                  args.profile).items():
        launches[k] += v
    del X, Xtr, Xte, logit
    torch.cuda.empty_cache()
    stamp("phase 10a, categorical")
    for k, v in efb_phase(lt, torch, card, args.seed, out_dir).items():
        launches[k] += v
    torch.cuda.empty_cache()
    stamp("phase 10b, EFB and CSR")


    kernels = []
    for name, (source, replaces) in {**KERNELS, **LANE_KERNELS}.items():
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
