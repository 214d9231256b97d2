"""Model registry: named warm predictors with atomic hot-swap.

Port of ``lightgbm_tpu/serve/registry.py``.  A registry serves on one
device: ``cuda`` unless the caller asks for the CPU (``device="cpu"``);
without a card it raises ``DeviceUnavailableError`` when built, never
falling back.  Model files and texts load onto that device.

A registry maps names to :class:`CompiledPredictor` instances.  Loading
builds (and optionally warms) the new predictor entirely OUTSIDE the
lock, then swaps the reference in one locked assignment — readers either
get the old version or the new one, never a half-built model, and
traffic is served without interruption during a rollout.

Stats survive a swap: the new predictor inherits the old entry's
``ModelStats``, so ``/stats`` counters (including recompiles — usually 0
on a same-shape rollout thanks to the shared compile cache) track the
NAME, not the version.  Since the series live in the process-wide
telemetry registry (labeled ``model=<name>``), they are monotone across
ModelRegistry instances too — Prometheus counter semantics: a new
registry serving a previously-served name continues the name's series
rather than resetting it (scrapers take rates; pass a private
``metrics_registry`` for isolated counters).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from .predictor import CompiledPredictor, release_compile_keys
from .stats import ModelStats
from ..publish.delta import DeltaChainError, DeltaRecord, fingerprint_text
from ..telemetry.metrics import default_registry
from ..utils.device import resolve_device
from ..utils.log import log_info

__all__ = ["ModelRegistry", "ModelInUseError"]


class ModelInUseError(ValueError):
    """Refused eviction: the model is the registry's only (i.e. the
    default-served) entry.  Pass ``force=True`` to evict anyway."""


class ModelRegistry:
    """Thread-safe named model store with atomic hot-swap and eviction."""

    def __init__(self, max_models: Optional[int] = None,
                 metrics_registry=None, device=None) -> None:
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._models: Dict[str, CompiledPredictor] = {}
        # stats live keyed by NAME, independent of predictor versions, so
        # counters survive hot-swaps and racing first-time loads of the
        # same name share one instance
        self._stats: Dict[str, ModelStats] = {}
        self._versions: Dict[str, int] = {}
        # file path behind each loaded name (None for in-memory sources)
        # — a rolling deploy reads it back to roll a regressed swap back
        self._sources: Dict[str, Optional[str]] = {}
        # delta-chain position per name: (round, fingerprint) of the
        # last applied record; cleared by load()/evict() so a full
        # reload re-anchors the chain
        self._chain: Dict[str, tuple] = {}
        self._max_models = max_models
        # registry-managed models report into the process-wide metrics
        # registry (labeled model=<name>) so /metrics covers them
        self._metrics = (metrics_registry if metrics_registry is not None
                         else default_registry())

    def load(self, name: str, source, warmup: bool = True,
             **predictor_kwargs) -> CompiledPredictor:
        """Load or hot-swap ``name``.  The predictor is built and warmed
        before the swap, so in-flight traffic never waits on a compile;
        the swap itself is one dict assignment under the lock.  A build
        or warmup failure (corrupt file -> :class:`ModelCorruptError`,
        bad params, ...) therefore leaves the OLD entry serving
        untouched — same version, same stats, never torn or evicted —
        and surfaces the typed error to the caller."""
        with self._lock:
            stats = self._stats.get(name)
            created_stats = stats is None
            if created_stats:
                # priming deferred: a failed first load must not leave
                # phantom model=<name> series in the shared metrics
                # registry either (only registry-private bookkeeping is
                # rolled back below)
                stats = self._stats[name] = ModelStats(
                    model=name, registry=self._metrics, prime=False)
        try:
            pred = CompiledPredictor(source, stats=stats,
                                     device=self.device, **predictor_kwargs)
            if warmup:
                pred.warmup()
        except Exception:
            with self._lock:
                # a failed FIRST load must not leave a phantom stats
                # entry for a name that never served (hot-swap failures
                # keep theirs: the old version is still live)
                if created_stats and name not in self._models:
                    self._stats.pop(name, None)
            raise
        if created_stats:
            stats.prime_series()
        with self._lock:
            swapped = name in self._models
            self._models[name] = pred
            self._versions[name] = self._versions.get(name, 0) + 1
            self._sources[name] = source if isinstance(source, str) \
                else None
            self._chain.pop(name, None)   # full load re-anchors deltas
            if self._max_models is not None and \
                    len(self._models) > self._max_models:
                # evict the oldest OTHER entry (insertion order)
                for victim in list(self._models):
                    if victim != name:
                        self._drop_locked(victim)
                        break
        log_info(f"serve: {'hot-swapped' if swapped else 'loaded'} model "
                 f"'{name}' (v{self._versions[name]}, "
                 f"{pred.num_trees} trees)")
        return pred

    def get(self, name: Optional[str] = None) -> CompiledPredictor:
        """Predictor by name; with ``name=None`` the single loaded model
        (the common one-model deployment needs no name in requests)."""
        with self._lock:
            if name is None:
                if len(self._models) == 1:
                    return next(iter(self._models.values()))
                raise KeyError(
                    f"registry holds {len(self._models)} models; requests "
                    "must name one" if self._models else "no models loaded")
            if name not in self._models:
                raise KeyError(f"unknown model '{name}'")
            return self._models[name]

    def evict(self, name: str, force: bool = False) -> bool:
        """Drop ``name``.  Evicting the registry's ONLY model — the one
        unnamed requests resolve to — raises :class:`ModelInUseError`
        unless ``force=True``, so a fat-fingered evict cannot take a
        single-model deployment dark.  In-flight readers that already
        resolved the predictor finish normally either way: predictors
        are immutable and handlers hold their own reference."""
        with self._lock:
            if name not in self._models:
                return False
            if not force and len(self._models) == 1:
                raise ModelInUseError(
                    f"'{name}' is the only loaded model (the default "
                    f"served one); evicting it would take the service "
                    f"dark — pass force=True to do it anyway")
            self._drop_locked(name)
            log_info(f"serve: evicted model '{name}'")
            return True

    def _drop_locked(self, name: str) -> None:
        """Remove ``name`` and release everything it held: its metric
        series (stats.release) and — when no surviving model shares its
        shape signature — the signature's compile-cache mirror entries.
        Without this, zoo churn ratchets the process: same-shape compile
        keys are shared, so only the LAST model of a shape may release
        them.  Caller holds ``self._lock``."""
        victim = self._models.pop(name)
        stats = self._stats.pop(name, None)
        self._sources.pop(name, None)
        self._chain.pop(name, None)
        if stats is not None:
            stats.release()
        sig = victim.signature
        if not any(p.signature == sig for p in self._models.values()):
            release_compile_keys(sig)

    # -- continuous-learning lane (publish/) --------------------------------
    def apply_delta(self, name: str, record) -> dict:
        """Append a published delta's trees to ``name`` without a full
        reload: parse the fragment, extend the predictor (dense-table
        splice inside the shard-padding envelope — zero recompiles — or
        a rebuild), and hot-swap atomically exactly like :meth:`load`.

        ``record`` is a :class:`DeltaRecord` or its wire bytes.  The
        chain position is validated first — a round gap or fingerprint
        mismatch raises :class:`DeltaChainError` BEFORE any work, and a
        failed build leaves the old predictor serving — so a subscriber
        that fell behind gets a typed signal to fall back to a full
        reload instead of serving a torn ensemble."""
        from ..publish.subscriber import trees_from_fragment
        if isinstance(record, (bytes, bytearray)):
            record = DeltaRecord.from_bytes(bytes(record))
        with self._lock:
            if name not in self._models:
                raise KeyError(f"unknown model '{name}'")
            pred = self._models[name]
            chain = self._chain.get(name)
            source = self._sources.get(name)
        if chain is not None:
            rnd, fp = chain
            if record.round <= rnd:
                return {"model": name, "round": rnd, "mode": "noop",
                        "num_trees": pred.num_trees}
            if record.base_round != rnd or record.parent_fp != fp:
                raise DeltaChainError(
                    f"model '{name}' is at round {rnd} "
                    f"(fp {fp[:12]}...); delta extends round "
                    f"{record.base_round} (fp {record.parent_fp[:12]}...)"
                    f" — reload the full model to re-anchor")
        else:
            k = max(1, pred.num_class)
            have = pred.num_trees // k
            if record.base_round != have:
                raise DeltaChainError(
                    f"model '{name}' holds {have} rounds; delta extends "
                    f"round {record.base_round} — reload the full model "
                    f"to re-anchor")
            if source is not None:
                with open(source, "rb") as fh:
                    src_fp = fingerprint_text(fh.read().decode("utf-8"))
                if src_fp != record.parent_fp:
                    raise DeltaChainError(
                        f"model '{name}' was loaded from a base with "
                        f"fingerprint {src_fp[:12]}...; delta chains "
                        f"from {record.parent_fp[:12]}... — reload the "
                        f"full model to re-anchor")
        trees, frag_k = trees_from_fragment(
            record.payload, source=f"<delta round {record.round}>")
        if frag_k != max(1, pred.num_class):
            raise DeltaChainError(
                f"delta num_tree_per_iteration {frag_k} != model "
                f"{pred.num_class}")
        # build outside the lock (hot-swap discipline): a failure here
        # leaves the old predictor — and its chain position — untouched
        pred2, mode = pred.extended(trees)
        with self._lock:
            if self._models.get(name) is not pred:
                raise DeltaChainError(
                    f"model '{name}' was swapped while the delta was "
                    f"being applied; replay from its new round")
            self._models[name] = pred2
            self._versions[name] = self._versions.get(name, 0) + 1
            self._chain[name] = (record.round, record.fp)
        log_info(f"serve: applied delta to '{name}' -> round "
                 f"{record.round} ({mode}, {pred2.num_trees} trees)")
        return {"model": name, "round": record.round, "mode": mode,
                "num_trees": pred2.num_trees}

    def round_of(self, name: str) -> Optional[int]:
        """Last delta-applied round for ``name`` (None before any
        delta)."""
        with self._lock:
            chain = self._chain.get(name)
            return chain[0] if chain is not None else None

    def source_of(self, name: str) -> Optional[str]:
        """File path serving under ``name`` (None when loaded from an
        in-memory object) — the rollback source for a rolling deploy."""
        with self._lock:
            return self._sources.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return list(self._models)

    def info(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._models.items())
            versions = dict(self._versions)
            sources = dict(self._sources)
        return {name: {**pred.info(), "version": versions.get(name, 1),
                       "source": sources.get(name)}
                for name, pred in items}

    def stats(self) -> Dict[str, dict]:
        with self._lock:
            items = list(self._models.items())
        return {name: pred.stats.snapshot() for name, pred in items}
