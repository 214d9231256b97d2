"""Chunked wave grower: leaf-wise growth over host-resident row chunks.

Port of ``lightgbm_tpu/ingest/grower.py``: the wave grower's full-data
histogram passes (learner/wave.py) run one level up the memory
hierarchy, host RAM -> device memory.  Each wave's (W, F, B, 3) histogram
batch is accumulated **chunk by chunk**, each chunk running the kernels
of ``csrc/`` on its slice of rows:

* the row update (``ops/histogram_cuda.wave_row_update``) applies the
  wave's W splits to the chunk's ``row_leaf`` and yields its channels;
* the leaf histogram (``build_histogram_leaves_q8`` quantized, or the
  fixed-point ``build_histogram_leaves`` exact) adds the chunk's rows to
  the wave's channels.

The root pass runs the leaf kernel with channel 0 on every row, as the
reference does (grower.py:164-179).  The reference's head / chunk-step /
tail split stays: :meth:`ChunkedWaveGrower._head` selects the wave,
:meth:`_chunk_step` runs one chunk, and :meth:`_tail` is the in-core
wave body after its histogram pass.  Both call the in-core body's own
pieces in ``learner/wave.py`` (``wave_state``, ``seed_root``,
``wave_select``, ``split_hists``, ``scatter_children``,
``write_wave_nodes``); what stays here is the chunk passes and the
children's scans (``ops/split.local_best_candidates``) for this
envelope.

Per-row state stays on the HOST, as in the reference: score, gradients,
the bag mask and the per-chunk ``row_leaf``.  Only chunk slices reach
the card, through :class:`ChunkRing`: two slots of pinned host buffers
and their device twins.  Chunk i+1 is copied on a side stream while
chunk i's kernels run on the current stream; events order the two (the
upload into a slot waits for the kernels that read it, the kernels wait
for their upload), and ``row_leaf`` comes back through pinned buffers
with a non-blocking copy.

**Exactness.**  The grower mirrors ``learner/wave.py``'s wave body for
its envelope (numeric non-EFB features, no monotone / interaction /
by-node / extra-trees / CEGB / forced splits / smoothing, the
speculative ramp and the exact endgame off).

* Quantized (``use_quantized_grad``, ``stochastic_rounding=false``): the
  per-tree scales come from one streaming max over the chunks (max is
  exact under any chunking) through ``ops/quantize.quant_scales``, and
  every channel sum is an exact int32, so the tree is the in-core
  grower's bit for bit.
* Exact: the in-core grower's fixed-point weights take their exponent
  from the tree's max |g*mask| and its padded row count
  (``ops/histogram.pack_weights``).  Here one exponent per tree comes
  from a streaming max over all chunks and the in-core padded count, the
  int64 sums add across chunks, and they turn into f32 once
  (``fx_to_f32``), so the exact tree is the in-core one bit for bit too
  (the reference sums f32 chunk histograms and matches only to f32
  tolerance).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..dataset import pad_rows
from ..learner.serial import GrownTree, child_outputs
from ..learner.wave import (Q_WAVE_SIZE, WAVE_SIZE, scatter_children,
                            seed_root, split_hists, wave_select, wave_state,
                            write_wave_nodes)
from ..models.tree import DEFAULT_LEFT_MASK, MISSING_NAN
from ..ops import histogram_cuda as hc
from ..ops.histogram import fx_exponents, fx_to_f32, pack_weights
from ..ops.quantize import dequant_scales, quant_scales, quantize_wch
from ..ops.split import (BIG, NEG_INF, SplitParams, leaf_output_smoothed,
                         local_best_candidates)
from ..telemetry.metrics import default_registry
from ..telemetry.trace import span

__all__ = ["ChunkedWaveGrower", "ChunkRing", "StreamedEnvelopeError"]

_I32 = torch.int32
_F32 = torch.float32


class StreamedEnvelopeError(ValueError):
    """The requested configuration is outside the chunked grower's
    envelope; train in-core (``tpu_ingest_mode=hbm``) instead."""


class ChunkRing:
    """The two-slot upload ring of one training run.

    ``store`` is a StreamedDataset (``chunk_rows``, ``chunk_bounds``,
    ``read_chunk_into``).  Pinned host buffers and their device twins are
    allocated here, once per run.  On a ``cuda`` device the uploads run
    on a side stream, ordered against the kernels by events.  On the CPU
    the host buffers are the chunks.

    :meth:`run` streams every chunk through ``step(bins_t, g, h, mask,
    rl)`` (the (F, m) uint8 feature-major bins, (m,) f32 gradient, hessian
    and bag mask, (m,) int32 ``row_leaf`` or None) on the current stream;
    a ``step`` that returns a new (m,) ``row_leaf`` has it copied back
    into ``rl_chunks``."""

    def __init__(self, store, device, *, rl_dtype=np.uint8,
                 profile: bool = False) -> None:
        self.store = store
        self.dev = torch.device(device)
        self.cuda = self.dev.type == "cuda"
        self.profile = bool(profile) and self.cuda
        c = int(store.chunk_rows)
        f = int(store.X_binned.shape[1])
        self.rl_t = torch.from_numpy(np.zeros(0, rl_dtype)).dtype
        pin = self.cuda

        def host(shape, dtype):
            return torch.empty(shape, dtype=dtype, pin_memory=pin)

        self.h_bins = [host((c, f), torch.uint8) for _ in range(2)]
        self.h_ghm = [host((3, c), _F32) for _ in range(2)]
        self.h_rl = [host((c,), self.rl_t) for _ in range(2)]
        self.h_out = [host((c,), self.rl_t) for _ in range(2)]
        if self.cuda:
            def dev(shape, dtype):
                return torch.empty(shape, dtype=dtype, device=self.dev)
            self.d_bins = [dev((c, f), torch.uint8) for _ in range(2)]
            self.d_ghm = [dev((3, c), _F32) for _ in range(2)]
            self.d_rl = [dev((c,), self.rl_t) for _ in range(2)]
            self.copy_stream = torch.cuda.Stream(device=self.dev)
            self.uploaded = [torch.cuda.Event() for _ in range(2)]
            self.consumed = [torch.cuda.Event() for _ in range(2)]
            self.downloaded = [torch.cuda.Event() for _ in range(2)]
        else:
            self.d_bins, self.d_ghm, self.d_rl = (self.h_bins, self.h_ghm,
                                                  self.h_rl)
        self.h2d_bytes = 0
        self._stalls: list = []     # (before wait, after wait) event pairs
        self._passes: list = []     # (pass start, pass end) event pairs
        self._h2d = default_registry().counter(
            "ingest_train_h2d_bytes_total",
            "host-to-device bytes streamed by chunked training")

    # -- one chunk in, one chunk out --------------------------------------
    def _stage(self, i: int, slot: int, grad, hess, mask, rl_chunks) -> int:
        """Read chunk ``i`` into the slot's host buffers and start its
        upload; returns its row count."""
        lo, hi = self.store.chunk_bounds(i)
        m = hi - lo
        if self.cuda:
            # the slot's last upload read these host buffers
            self.uploaded[slot].synchronize()
        self.store.read_chunk_into(i, self.h_bins[slot].numpy()[:m])
        ghm = self.h_ghm[slot].numpy()
        ghm[0, :m] = grad[lo:hi]
        ghm[1, :m] = hess[lo:hi]
        ghm[2, :m] = mask[lo:hi]
        nbytes = m * (self.h_bins[slot].shape[1] + 12)
        if rl_chunks is not None:
            self.h_rl[slot].numpy()[:m] = rl_chunks[i]
            nbytes += m * self.h_rl[slot].element_size()
        if self.cuda:
            stream = self.copy_stream
            with torch.cuda.stream(stream):
                # the kernels that read the slot's device buffers
                stream.wait_event(self.consumed[slot])
                self.d_bins[slot][:m].copy_(self.h_bins[slot][:m],
                                            non_blocking=True)
                for k in range(3):
                    self.d_ghm[slot][k, :m].copy_(self.h_ghm[slot][k, :m],
                                                  non_blocking=True)
                if rl_chunks is not None:
                    self.d_rl[slot][:m].copy_(self.h_rl[slot][:m],
                                              non_blocking=True)
                self.uploaded[slot].record(stream)
        self.h2d_bytes += nbytes
        self._h2d.inc(nbytes)
        return m

    def run(self, step, grad, hess, mask, rl_chunks=None) -> None:
        """One pass over every chunk (see the class docstring)."""
        nc = self.store.num_chunks()
        cur = torch.cuda.current_stream(self.dev) if self.cuda else None
        if self.profile:
            t0 = torch.cuda.Event(enable_timing=True)
            t0.record(cur)
        rows = [self._stage(0, 0, grad, hess, mask, rl_chunks)]
        pending = None          # (chunk, slot, rows) of an unread download
        for i in range(nc):
            s = i % 2
            if i + 1 < nc:
                rows.append(self._stage(i + 1, (i + 1) % 2, grad, hess,
                                        mask, rl_chunks))
            m = rows[i]
            if self.cuda:
                if self.profile:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record(cur)
                cur.wait_event(self.uploaded[s])
                if self.profile:
                    b.record(cur)
                    self._stalls.append((a, b))
            bins_t = self.d_bins[s][:m].t().contiguous()
            g, h, mk = (self.d_ghm[s][k, :m] for k in range(3))
            rl = (None if rl_chunks is None
                  else self.d_rl[s][:m].to(_I32))
            rl_new = step(bins_t, g, h, mk, rl)
            if self.cuda:
                self.consumed[s].record(cur)
            if rl_new is not None:
                if self.cuda:
                    self.h_out[s][:m].copy_(rl_new.to(self.rl_t),
                                            non_blocking=True)
                    self.downloaded[s].record(cur)
                else:
                    self.h_out[s][:m].copy_(rl_new.to(self.rl_t))
                if pending is not None:
                    self._collect(rl_chunks, *pending)
                pending = (i, s, m)
        if pending is not None:
            self._collect(rl_chunks, *pending)
        if self.profile:
            t1 = torch.cuda.Event(enable_timing=True)
            t1.record(cur)
            self._passes.append((t0, t1))

    def _collect(self, rl_chunks, i: int, slot: int, m: int) -> None:
        if self.cuda:
            self.downloaded[slot].synchronize()
        rl_chunks[i] = self.h_out[slot].numpy()[:m].copy()

    def stall_stats(self) -> dict:
        """(profile) Seconds the current stream waited on uploads, and
        the seconds of the passes, over every pass since the last call."""
        torch.cuda.synchronize(self.dev)
        wait = sum(a.elapsed_time(b) for a, b in self._stalls) / 1e3
        total = sum(a.elapsed_time(b) for a, b in self._passes) / 1e3
        self._stalls, self._passes = [], []
        return {"wait_s": wait, "pass_s": total,
                "wait_share": wait / total if total > 0 else 0.0}


class ChunkedWaveGrower:
    """One-tree grower over a chunk store (a StreamedDataset) through a
    :class:`ChunkRing`; the per-row arrays (grad / hess / mask) are host
    numpy, sliced and uploaded per chunk."""

    def __init__(self, *, num_leaves: int, num_features: int, max_bins: int,
                 max_depth: int, split_params: SplitParams,
                 num_bins: np.ndarray, has_nan: np.ndarray,
                 device, quantized: bool = False, gq_max: int = 127,
                 hq_max: int = 127, wave_size: int = 0,
                 num_data: Optional[int] = None) -> None:
        if split_params.any_cat:
            raise StreamedEnvelopeError(
                "chunked streamed training supports numeric features only")
        if max_bins > 255:
            raise StreamedEnvelopeError(
                "chunked streamed training requires max_bin <= 255")
        self.dev = torch.device(device)
        self.L = int(num_leaves)
        self.F = int(num_features)
        self.B = int(max_bins)
        self.max_depth = int(max_depth)
        self.sp = split_params
        self.quantized = bool(quantized)
        self.gq_max, self.hq_max = int(gq_max), int(hq_max)
        ch_cap = Q_WAVE_SIZE if quantized else WAVE_SIZE
        self.W = max(1, min(int(wave_size) or ch_cap, ch_cap, self.L - 1))
        self.rl_dtype = np.uint8 if self.L <= 256 else np.int32
        # the in-core grower's padded row count, which sets the exact
        # weights' fixed-point exponent (ops/histogram.py pack_weights)
        self.n_pad = None if num_data is None else pad_rows(int(num_data))
        self.num_bins = torch.as_tensor(num_bins, dtype=_I32, device=self.dev)
        self.has_nan = torch.as_tensor(has_nan, dtype=torch.bool,
                                       device=self.dev)
        self.monotone = torch.zeros((self.F,), dtype=_I32, device=self.dev)
        self.hist_dtype = _I32 if quantized else _F32
        self._passes = default_registry().counter(
            "ingest_train_hist_passes_total",
            "chunk-accumulated full-data histogram passes")

    # -- per-tree weights ------------------------------------------------
    def _scales(self, store, grad, hess, mask):
        """One streaming host pass: the per-tree quantization scales, or
        the exact weights' fixed-point exponents.  max is exact under any
        chunking, and numpy's f32 multiply is the IEEE op the in-core
        ``(grad * bag_mask)`` runs, so the values are the in-core ones."""
        gmax = hmax = 0.0
        for i in range(store.num_chunks()):
            lo, hi = store.chunk_bounds(i)
            g32 = np.asarray(grad[lo:hi], np.float32)
            h32 = np.asarray(hess[lo:hi], np.float32)
            m32 = np.asarray(mask[lo:hi], np.float32)
            if hi > lo:
                gmax = max(gmax, float(np.max(np.abs(g32 * m32))))
                hm = h32 * m32
                hmax = max(hmax, float(np.max(np.abs(hm)) if not
                                       self.quantized else np.max(hm)))
        if self.quantized:
            g_scale, h_scale = quant_scales(
                torch.tensor(gmax, dtype=_F32, device=self.dev),
                torch.tensor(hmax, dtype=_F32, device=self.dev),
                self.gq_max, self.hq_max)
            return (g_scale, h_scale), dequant_scales(g_scale, h_scale)
        n = self.n_pad or pad_rows(store.num_data())
        return fx_exponents(gmax, hmax, n), None

    def _weights(self, g, h, mk, scales):
        if self.quantized:
            return quantize_wch(g, h, mk, scales[0], scales[1], None,
                                gq_max=self.gq_max, hq_max=self.hq_max,
                                stochastic=False)
        return pack_weights(g, h, mk, exponents=scales)

    def _chunk_hist(self, bins_t, w, ch):
        """One chunk's (K, F, B, 3) leaf-channel sums: int32 (quantized)
        or the int64 fixed-point sums (exact), which add across chunks."""
        if self.quantized:
            return hc.build_histogram_leaves_q8(bins_t, w, ch,
                                                num_bins=self.B)
        return hc.build_histogram_leaves(bins_t, w, ch, num_bins=self.B,
                                         raw=True)

    def _dq(self, h, qscales):
        return h.float() * qscales if self.quantized else h

    def _candidates(self, hists, sums, fms, qscales, sums_exact=None,
                    bounds=None, depths=None, pouts=None):
        """The in-core ``many_candidates`` of learner/wave.py for this
        envelope."""
        return local_best_candidates(
            self._dq(hists, qscales), sums, self.num_bins, self.has_nan,
            fms, self.sp, sums_exact, None, None, monotone=self.monotone,
            bound=bounds, depth=depths, cegb_penalty=None, gain_scale=None,
            parent_out=pouts)

    # -- the root pass ---------------------------------------------------
    def _root_state(self, ring, grad, hess, mask, fm_row, scales, qscales):
        """The root pass (channel 0 on every row, chunk by chunk) and the
        initial state: learner/wave.py's ``root_state``."""
        F, B = self.F, self.B
        dev = self.dev
        acc = torch.zeros((1, F, B, 3), dtype=(_I32 if self.quantized
                                               else torch.int64), device=dev)
        wsum = torch.zeros((3,), dtype=torch.int64, device=dev)

        def step(bins_t, g, h, mk, _rl):
            nonlocal acc, wsum
            w = self._weights(g, h, mk, scales)
            ch = torch.zeros((g.shape[0],), dtype=torch.int8, device=dev)
            acc = acc + self._chunk_hist(bins_t, w, ch)[:1]
            if not self.quantized:
                wsum = wsum + w.w.sum(dim=1)
            return None

        ring.run(step, grad, hess, mask)
        zf = torch.zeros((), dtype=_F32, device=dev)
        root_exact = None
        if self.quantized:
            root_hist = acc[0]
            root_sum = self._dq(acc[:, 0].sum(dim=1).to(acc.dtype),
                                qscales)[0]
            root_exact = (root_hist[0].sum(dim=0).float().double() *
                          qscales.double())
        else:
            inv = torch.tensor([2.0 ** -e for e in scales] + [1.0],
                               dtype=torch.float64, device=dev)
            root_hist = fx_to_f32(acc, inv)[0]
            root_sum = fx_to_f32(wsum, inv)
        root_out = leaf_output_smoothed(root_sum[0], root_sum[1],
                                        root_sum[2], zf, self.sp)
        cand = self._candidates(
            root_hist.unsqueeze(0), root_sum.unsqueeze(0),
            fm_row.expand(1, F), qscales,
            None if root_exact is None else root_exact.unsqueeze(0),
            bounds=torch.tensor([[-BIG, BIG]], dtype=_F32, device=dev),
            depths=torch.zeros((1,), dtype=_I32, device=dev),
            pouts=root_out.view(1))
        s = wave_state(self.L, (F, B, 3), self.hist_dtype, B, dev)
        seed_root(s, root_hist, root_sum, root_out, cand)
        return s

    # -- one wave: head, chunk steps, tail ----------------------------------
    def _head(self, s, nl0: int) -> dict:
        """Wave-head selection: the top-k + taper block of the in-core
        body and the row update's table."""
        W = self.W
        jarange = torch.arange(W, dtype=_I32, device=self.dev)
        vals, sl, sel = wave_select(s["cand_gain"], self.L - nl0, W, jarange)
        feat = s["cand_feat"][sl]
        thr = s["cand_bin"][sl]
        dleft = s["cand_dleft"][sl]
        lsum = s["cand_lsum"][sl]
        rsum = s["cand_rsum"][sl]
        prefix = torch.cumsum(sel.to(_I32), 0).to(_I32)
        new_ids = nl0 + prefix - 1
        left_smaller = lsum[:, 2] <= rsum[:, 2]
        fnan = self.has_nan[feat.long()]
        f_nan_bin = torch.where(fnan, self.num_bins[feat.long()] - 1,
                                torch.full_like(feat, -1))
        tab = torch.stack([
            thr, f_nan_bin, dleft.to(_I32), left_smaller.to(_I32),
            sl.to(_I32), new_ids, sel.to(_I32),
            torch.zeros_like(thr)]).contiguous()
        return {"vals": vals, "sl": sl, "sel": sel, "feat": feat,
                "thr": thr, "dleft": dleft, "lsum": lsum, "rsum": rsum,
                "member": s["cand_member"][sl], "psum": s["leaf_sum"][sl],
                "prefix": prefix, "new_ids": new_ids,
                "node_ids": (nl0 - 1) + prefix - 1,
                "left_smaller": left_smaller, "fnan": fnan,
                "f_nan_bin": f_nan_bin, "tab": tab,
                "feats": feat.to(_I32)}

    def _chunk_step(self, acc, bins_t, rl, g, h, mk, head, scales):
        """One chunk of one wave: the row update and the smaller
        children's histograms over the chunk's rows, added to ``acc``."""
        rl_new, ch = hc.wave_row_update(bins_t, rl, head["tab"],
                                        feats=head["feats"])
        w = self._weights(g, h, mk, scales)
        acc += self._chunk_hist(bins_t, w, ch)[:self.W]
        return rl_new

    def _tail(self, s, head, hist_small, fm_row, qscales) -> int:
        """The in-core wave body after its histogram pass: subtraction,
        the children's candidates, the state scatter and the node
        records.  Returns the leaves added."""
        W, F = self.W, self.F
        sel, sl, new_ids = head["sel"], head["sl"], head["new_ids"]
        lsum, rsum = head["lsum"], head["rsum"]
        total_new = int(sel.cpu().sum())

        hist_l, hist_r = split_hists(s["hists"][sl], hist_small,
                                     head["left_smaller"])
        out_l, out_r = child_outputs(lsum, rsum, s["leaf_value"][sl],
                                     self.sp)
        child_depth = s["leaf_depth"][sl] + 1
        sums2 = torch.cat([lsum, rsum])
        idx2 = torch.cat([sl, new_ids.long()])
        v2 = torch.cat([sel, sel])
        cands = self._candidates(
            torch.cat([hist_l, hist_r]), sums2, fm_row.expand(2 * W, F),
            qscales, depths=torch.cat([child_depth, child_depth]),
            pouts=torch.cat([out_l, out_r]))
        depth_ok = (torch.ones_like(sel) if self.max_depth <= 0
                    else child_depth < self.max_depth)
        neg_inf = torch.full((), NEG_INF, dtype=_F32, device=self.dev)
        cg = torch.where(torch.cat([depth_ok, depth_ok]) & v2, cands[0],
                         neg_inf)
        scatter_children(s, sl, new_ids, idx2, v2, hist_l, hist_r, sums2,
                         child_depth, (cg,) + tuple(cands[1:]),
                         torch.cat([out_l, out_r]))
        dt_bits = (torch.where(head["dleft"], DEFAULT_LEFT_MASK, 0) |
                   torch.where(head["fnan"], MISSING_NAN, 0)).to(_I32)
        write_wave_nodes(s, sl, new_ids, head["node_ids"], sel,
                         feat=head["feat"], thr=head["thr"],
                         f_nan_bin=head["f_nan_bin"], member=head["member"],
                         dt_bits=dt_bits, gain=head["vals"],
                         psum=head["psum"], sp=self.sp)
        return total_new

    # -- host-driven tree growth ---------------------------------------------
    def grow(self, ring: ChunkRing, grad: np.ndarray, hess: np.ndarray,
             mask: np.ndarray, feature_mask: Optional[np.ndarray] = None
             ) -> tuple:
        """Grow one tree.  Returns (GrownTree on the device, with an empty
        ``row_leaf``; the per-chunk host ``row_leaf`` list)."""
        store = ring.store
        nc = store.num_chunks()
        fm_row = torch.as_tensor(
            feature_mask if feature_mask is not None
            else np.ones(self.F, bool), dtype=torch.bool, device=self.dev)
        scales, qscales = self._scales(store, grad, hess, mask)

        with span("ingest/train/tree_root_pass"):
            s = self._root_state(ring, grad, hess, mask, fm_row, scales,
                                 qscales)
        self._passes.inc()
        hist_passes = 1
        rl_chunks: List[np.ndarray] = [
            np.zeros(store.chunk_bounds(i)[1] - store.chunk_bounds(i)[0],
                     self.rl_dtype) for i in range(nc)]
        nl = 1
        done = False
        inv = (None if self.quantized else torch.tensor(
            [2.0 ** -e for e in scales] + [1.0], dtype=torch.float64,
            device=self.dev))
        while not done and nl < self.L:
            head = self._head(s, nl)
            with span("ingest/train/wave_pass"):
                acc = torch.zeros((self.W, self.F, self.B, 3),
                                  dtype=(_I32 if self.quantized
                                         else torch.int64), device=self.dev)

                def step(bins_t, g, h, mk, rl):
                    return self._chunk_step(acc, bins_t, rl, g, h, mk, head,
                                            scales)
                ring.run(step, grad, hess, mask, rl_chunks)
            hist_small = acc if self.quantized else fx_to_f32(acc, inv)
            total_new = self._tail(s, head, hist_small, fm_row, qscales)
            nl += total_new
            done = total_new == 0
            hist_passes += 1
            self._passes.inc()

        grown = GrownTree(
            split_feature=s["split_feature"],
            threshold_bin=s["threshold_bin"], nan_bin=s["nan_bin"],
            decision_type=s["decision_type"],
            left_child=s["left_child"], right_child=s["right_child"],
            split_gain=s["split_gain"],
            internal_value=s["internal_value"],
            internal_weight=s["internal_weight"],
            internal_count=s["internal_count"],
            leaf_value=s["leaf_value"], leaf_weight=s["leaf_weight"],
            leaf_count=s["leaf_count"], num_leaves=int(nl),
            row_leaf=torch.zeros((0,), dtype=_I32),
            hist_passes=int(hist_passes))
        return grown, rl_chunks

