"""The growers' kernel seam, and the lockstep driver of many trees.

The wave and partitioned growers (learner/wave.py, learner/partitioned.py)
are generators: each kernel they need is a :class:`KernelCall` they yield,
and the value sent back is the kernel's result.  Everything else a grower
runs (scans, host reads, monotone refinement, renewal bookkeeping) is its
own code on its own tensors.

* :func:`run_single` grows one tree: it fulfils every request with the
  single-lane wrapper of ops/histogram_cuda.py, exactly the call the
  grower made before the seam existed.
* :func:`run_lanes` grows L trees in lockstep, the port's counterpart of
  the reference's ``jax.vmap`` of one grower over the model axis
  (lightgbm_tpu/multitrain/batched.py:529-580).  It advances every live
  lane to its next request, groups the requests by kernel and static
  shape (:attr:`KernelCall.key`), and launches each group's model-axis
  form ONCE for all of its lanes; then it resumes the lanes with their
  slices of the result.

Each lane runs the standalone grower's own ops, and each model-axis kernel
gives every lane the single launch's bits (integer sums), so a lane's tree
is bitwise the tree a standalone grower grows from the same inputs.
"""

from __future__ import annotations

from typing import Any, Generator, List, Optional

import torch

from ..ops import histogram_cuda as hc

__all__ = ["KernelCall", "leaves_q8", "leaves_fx", "row_update", "trial",
           "single", "run_single", "run_lanes"]


def _layout(t: torch.Tensor) -> tuple:
    """A bin matrix's place in a group key: requests over uint8 and
    uint16 codes launch different forms, so the dtype keeps them apart."""
    return (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)


class KernelCall:
    """One kernel request of a grower: ``kind``, its arguments, and the
    ``key`` that requests must share to run in one model-axis launch (the
    kernel, its static shape and the shared bin matrix)."""

    __slots__ = ("kind", "key", "args")

    def __init__(self, kind: str, key: tuple, **args: Any) -> None:
        self.kind = kind
        self.key = key
        self.args = args


def leaves_q8(bins, wch, ch, *, num_bins: int,
              bins_packed: bool) -> KernelCall:
    """:func:`ops.histogram_cuda.build_histogram_leaves_q8`."""
    return KernelCall("leaves_q8", ("leaves_q8", _layout(bins), num_bins,
                                    bins_packed),
                      bins=bins, w=wch, ch=ch, num_bins=num_bins,
                      bins_packed=bins_packed)


def leaves_fx(bins, w, ch, *, num_bins: int, bins_packed: bool,
              raw: bool = False) -> KernelCall:
    """:func:`ops.histogram_cuda.build_histogram_leaves` (``raw``: its
    int64 sums, which a parallel strategy merges across ranks)."""
    return KernelCall("leaves_fx", ("leaves_fx", _layout(bins), num_bins,
                                    bins_packed, raw),
                      bins=bins, w=w, ch=ch, num_bins=num_bins,
                      bins_packed=bins_packed, raw=raw)


def row_update(bins, rl, tab, *, feats, bins_packed: bool = False,
               decode: Optional[hc.SplitDecode] = None) -> KernelCall:
    """:func:`ops.histogram_cuda.wave_row_update` on the bin matrix read
    in place."""
    return KernelCall("row_update", ("row_update", _layout(bins),
                                     tab.shape[1], bins_packed,
                                     decode is not None),
                      bins=bins, rl=rl, tab=tab, feats=feats,
                      bins_packed=bins_packed, decode=decode)


def trial(bins, rl, sel_leaves, thr, nan_bin, default_left, left_smaller,
          active, *, feats, bins_packed: bool = False) -> KernelCall:
    """:func:`ops.histogram_cuda.wave_trial_channels`."""
    return KernelCall("trial", ("trial", _layout(bins), sel_leaves.shape[0],
                                bins_packed),
                      bins=bins, rl=rl, sel=(sel_leaves, thr, nan_bin,
                                             default_left, left_smaller,
                                             active),
                      feats=feats, bins_packed=bins_packed)


def single(bins, w, *, num_bins: int) -> KernelCall:
    """:func:`ops.histogram_cuda.hist_single` of one leaf's rows (each
    lane's own bins view; views of equal strides share a launch)."""
    return KernelCall("single", ("single", bins.shape[0], bins.stride(),
                                 bins.dtype, bins.device, num_bins),
                      bins=bins, w=w, num_bins=num_bins)


def _run_one(c: KernelCall):
    a = c.args
    if c.kind == "leaves_q8":
        return hc.build_histogram_leaves_q8(
            a["bins"], a["w"], a["ch"], num_bins=a["num_bins"],
            bins_packed=a["bins_packed"])
    if c.kind == "leaves_fx":
        return hc.build_histogram_leaves(
            a["bins"], a["w"], a["ch"], num_bins=a["num_bins"],
            bins_packed=a["bins_packed"], raw=a["raw"])
    if c.kind == "row_update":
        return hc.wave_row_update(
            a["bins"], a["rl"], a["tab"], feats=a["feats"],
            bins_packed=a["bins_packed"], decode=a["decode"])
    if c.kind == "trial":
        return hc.wave_trial_channels(
            a["bins"], a["rl"], *a["sel"], feats=a["feats"],
            bins_packed=a["bins_packed"])
    return hc.hist_single(a["bins"], a["w"], num_bins=a["num_bins"])


def _run_group(calls: List[KernelCall]) -> list:
    """One model-axis launch for every request of one key; each lane's
    slice of the result."""
    c0 = calls[0]
    a0 = c0.args
    arg = [c.args for c in calls]
    if c0.kind == "leaves_q8":
        out = hc.build_histogram_leaves_q8_lanes(
            a0["bins"], [a["w"] for a in arg], [a["ch"] for a in arg],
            num_bins=a0["num_bins"], bins_packed=a0["bins_packed"])
        return list(out.unbind(0))
    if c0.kind == "leaves_fx":
        out = hc.build_histogram_leaves_lanes(
            a0["bins"], [a["w"] for a in arg], [a["ch"] for a in arg],
            num_bins=a0["num_bins"], bins_packed=a0["bins_packed"])
        return list(out.unbind(0))
    if c0.kind == "row_update":
        dec = None if a0["decode"] is None else [a["decode"] for a in arg]
        rl, ch = hc.wave_row_update_lanes(
            a0["bins"], [a["rl"] for a in arg], [a["tab"] for a in arg],
            feats=[a["feats"] for a in arg], bins_packed=a0["bins_packed"],
            decode=dec)
        return list(zip(rl.unbind(0), ch.unbind(0)))
    if c0.kind == "trial":
        ch = hc.wave_trial_channels_lanes(
            a0["bins"], [a["rl"] for a in arg],
            [hc.trial_tab(*a["sel"]) for a in arg],
            feats=[a["feats"] for a in arg], bins_packed=a0["bins_packed"])
        return list(ch.unbind(0))
    out = hc.hist_single_lanes([a["bins"] for a in arg],
                               [a["w"] for a in arg],
                               num_bins=a0["num_bins"])
    return list(out.unbind(0))


def run_single(gen: Generator) -> Any:
    """Drive one grower generator to its tree, one single-lane launch per
    request."""
    try:
        call = next(gen)
        while True:
            call = gen.send(_run_one(call))
    except StopIteration as stop:
        return stop.value


def run_lanes(gens: List[Generator]) -> list:
    """Drive L grower generators in lockstep: each round, every live
    lane's pending request joins the group of its key and each group runs
    as ONE model-axis launch.  Returns the lanes' trees in lane order."""
    results: list = [None] * len(gens)
    pending = {}

    def advance(i: int, value) -> None:
        try:
            pending[i] = (next(gens[i]) if value is None
                          else gens[i].send(value))
        except StopIteration as stop:
            results[i] = stop.value

    for i in range(len(gens)):
        advance(i, None)
    while pending:
        groups: dict = {}
        for i, call in pending.items():
            groups.setdefault(call.key, []).append(i)
        sends = {}
        for idx in groups.values():
            for i, out in zip(idx, _run_group([pending[i] for i in idx])):
                sends[i] = out
        pending.clear()
        for i in sorted(sends):
            advance(i, sends[i])
    return results
