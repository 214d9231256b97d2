"""One-shot histogram autotune with a persistent cache.

Port of ``lightgbm_tpu/learner/autotune.py``.  The reference times its
col-wise vs row-wise histogram construction on the first iteration and
keeps the winner (reference: src/io/dataset.cpp:659-670 ``ShareStates``
force_col_wise/force_row_wise timing).  Here the choice is the bin layout
of the hand-written kernels: the single-leaf histogram on uint8 bins
(``pallas``) against the same kernel on nibble-packed bins
(``pallas:packed4``, only when ``max_bins <= 16``).  When the binned matrix
is small enough that the probe is cheap, both are timed on the REAL data
once per ``(N, F, B)`` shape and the winner pins ``tpu_hist_pack4`` in a
copy of the config (:func:`apply_winner`, called by ``models/gbdt.py``).

What the reference probes and the port does not:

* ``pallas:blockspec``: the TPU's BlockSpec pipeline.  The port has one
  kernel per function (the TPU's DMA and BlockSpec pipelines collapse
  into it), so there is nothing to choose;
* ``onehot``, ``segment`` and the CPU ``packed4`` scatter: XLA
  formulations, which ``learner/serial.py`` ``resolve_hist_impl``
  refuses.

``train()`` calls the probe on a ``cuda`` device only, where it times with
CUDA events; on the CPU the port runs the plain versions, which exist for
the tests (:func:`pick_hist_impl` still takes a CPU device and times it
with the host clock).  A candidate that fails raises: there is no
fallback from one kernel form to the other.

Measured winners persist to a per-(backend, shape) ON-DISK cache
(``LGBM_TPU_TORCH_AUTOTUNE_CACHE`` env, default
``~/.cache/lightgbm_tpu_torch/hist_autotune.json``; set the env to "" to
disable persistence).  The key names the backend (``cuda``), and the file
is the port's own, so the reference's cache can never hand the port a
winner.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.log import log_info, log_warning

__all__ = ["AUTOTUNE_MAX_CELLS", "default_candidates", "pick_hist_impl",
           "apply_winner"]

# shape -> winning impl, process-lifetime cache
_CACHE: Dict[Tuple[str, int, int, int, tuple], str] = {}
_DISK_LOADED: Dict[str, Dict[str, str]] = {}

# above this many binned cells the static choice is kept and the probe is
# not worth its time (reference models/gbdt.py:395)
AUTOTUNE_MAX_CELLS = 1 << 22

_SCHEMA = "hist-autotune-v1"


def _cache_path() -> Optional[str]:
    p = os.environ.get("LGBM_TPU_TORCH_AUTOTUNE_CACHE")
    if p == "":
        return None
    if p:
        return p
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "lightgbm_tpu_torch", "hist_autotune.json")


def _disk_load(path: str) -> Dict[str, str]:
    if path in _DISK_LOADED:
        return _DISK_LOADED[path]
    data: Dict[str, str] = {}
    try:
        with open(path) as fh:
            raw = json.load(fh)
        if isinstance(raw, dict) and raw.get("schema") == _SCHEMA:
            data = {str(k): str(v) for k, v in raw.get("winners", {}).items()}
    except (OSError, ValueError):
        data = {}     # no cache yet, or an unreadable one: probe again
    _DISK_LOADED[path] = data
    return data


def _disk_store(path: str, key: str, win: str) -> None:
    """Merge ``key -> win`` into the cache file, from a fresh read (other
    processes may have added entries), written atomically.  Persistence
    is best effort: an unwritable path leaves the in-process cache."""
    _DISK_LOADED.pop(path, None)
    data = dict(_disk_load(path))
    data[key] = win
    payload = json.dumps({"schema": _SCHEMA, "winners": data}, indent=0,
                         sort_keys=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as fh:
            fh.write(payload)
        os.replace(tmp, path)
    except OSError as exc:
        log_warning(f"histogram autotune: cannot write {path} ({exc}); "
                    "the winner is kept for this process only")
        return
    _DISK_LOADED[path] = data


def _disk_key(backend: str, n: int, f: int, b: int, candidates) -> str:
    return f"{backend}/{n}x{f}x{b}/" + ",".join(candidates)


def default_candidates(backend: str, max_bins: int) -> tuple:
    """The kernel forms worth probing: uint8 bins, and packed bins when
    every feature fits a nibble.  ``cpu`` names the same forms' plain
    versions."""
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"no histogram kernels on backend {backend!r}")
    if max_bins <= 16:
        return ("pallas", "pallas:packed4")
    return ("pallas",)


def _make_runner(impl: str, X_binned: np.ndarray, max_bins: int,
                 device: torch.device):
    """A zero-argument closure running one single-leaf histogram of the
    candidate form on the padded data, with fixed random weights."""
    from ..dataset import pad_rows
    from ..ops.histogram import pack_bins4, pack_weights
    from ..ops.histogram_cuda import hist_single
    base, _, variant = impl.partition(":")
    if base != "pallas" or variant not in ("", "packed4"):
        raise ValueError(f"unknown histogram candidate {impl!r}")
    n, f = X_binned.shape
    n_pad = pad_rows(n)
    rng = np.random.RandomState(0)
    grad = np.zeros(n_pad, np.float32)
    hess = np.zeros(n_pad, np.float32)
    mask = np.zeros(n_pad, np.float32)
    grad[:n] = rng.randn(n)
    hess[:n] = np.abs(rng.randn(n))
    mask[:n] = 1.0
    w = pack_weights(*(torch.from_numpy(v).to(device)
                       for v in (grad, hess, mask)))
    xt = np.zeros((f, n_pad), np.uint8)
    xt[:, :n] = X_binned.T
    bins_t = torch.from_numpy(xt).to(device)
    packed = variant == "packed4"
    if packed:
        bins_t = pack_bins4(bins_t)

    def run():
        return hist_single(bins_t, w, num_bins=int(max_bins),
                           bins_packed=packed)
    return run


_PROBE_SPIN_CYCLES = 20_000_000      # ~10 ms of a spinning kernel
_PROBE_SPIN_TRIES = 4                # each try spins 4x longer


def _seconds_per_run(run, reps: int, device: torch.device) -> float:
    """Mean time of ``reps`` runs after one warm-up run (which also builds
    the kernels): CUDA events on the card, the host clock on the CPU.

    A launch at the probe's shape takes about as long on the card as the
    host takes to queue it (its output's zero-fill and the launch itself),
    so events around the bare runs would time the host.  A spinning kernel
    runs ahead instead: the host queues every run while the card waits,
    and the events time the card.  If the card reached the first event
    before the last run was queued, the spin was too short and the runs
    are timed again behind a longer one."""
    run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        spin = _PROBE_SPIN_CYCLES
        for _ in range(_PROBE_SPIN_TRIES):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(spin)
            start.record()
            for _ in range(reps):
                run()
            stop.record()
            queued_ahead = not start.query()
            stop.synchronize()
            if queued_ahead:
                break
            spin *= 4
        else:
            log_warning("histogram autotune: the card caught up with the "
                        "host while the probe was queued; its times "
                        "include the host's")
        return start.elapsed_time(stop) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        run()
    return (time.perf_counter() - t0) / reps


def pick_hist_impl(X_binned: np.ndarray, max_bins: int, device,
                   candidates=None, reps: int = 10) -> str:
    """Time one single-leaf histogram per candidate form on the actual
    data shape; return the faster (ties -> first candidate).

    The static default (candidates[0], uint8 bins) keeps a 1.3x
    hysteresis margin as in the reference: the probe must beat noise, not
    tie with it."""
    device = torch.device(device)
    backend = device.type
    n, f = X_binned.shape
    if candidates is None:
        candidates = default_candidates(backend, int(max_bins))
    candidates = tuple(candidates)
    if len(candidates) == 1:
        return candidates[0]
    key = (backend, n, f, int(max_bins), candidates)
    hit = _CACHE.get(key)
    if hit in candidates:
        return hit
    path = _cache_path()
    dkey = _disk_key(backend, n, f, int(max_bins), candidates)
    if path:
        disk_hit = _disk_load(path).get(dkey)
        if disk_hit in candidates:
            _CACHE[key] = disk_hit
            log_info(f"histogram autotune at shape ({n}, {f}, {max_bins}): "
                     f"{disk_hit} (cached winner, {path})")
            return disk_hit

    times = {impl: _seconds_per_run(
        _make_runner(impl, X_binned, max_bins, device), reps, device)
        for impl in candidates}
    win = min(candidates, key=lambda i: times[i])
    if win != candidates[0] and times[win] > times[candidates[0]] / 1.3:
        win = candidates[0]
    log_info("histogram autotune at shape "
             f"({n}, {f}, {max_bins}): " +
             ", ".join(f"{k}={v * 1e3:.3f}ms" for k, v in times.items()) +
             f" -> {win}")
    _CACHE[key] = win
    if path:
        _disk_store(path, dkey, win)
    return win


def apply_winner(cfg, win: str) -> None:
    """Map a winning form onto config knobs (reference
    autotune.py:210-222).  The layout and the pipeline are both pinned: a
    plain ``pallas`` winner beat the packed form, so the default-on
    ``tpu_hist_pack4`` is switched OFF for training to run the form that
    won."""
    base, _, variant = win.partition(":")
    cfg.tpu_histogram_impl = base
    if base == "pallas":
        cfg.tpu_hist_pack4 = variant == "packed4"
        cfg.tpu_pallas_pipeline = "dma"
