"""Declared memory budgets: the peak device memory of a program family.

Port of the budget registry of ``lightgbm_tpu/analysis/contracts.py``
(``MemoryBudget``, ``memory_budget``, ``resolve_limit``) and nothing
else: the collective and donation contracts and the jaxpr walkers that
check them are ROADMAP queue 1 item 12.  A budget is declared next to
the code whose footprint it bounds (``ingest/stream.py`` declares the
chunked pipeline's) as an int or a callable of a ``ctx`` dict (rows,
features, bins, wave_size, leaves, chunk_rows, quantized ...); the
port's checks read it against ``torch.cuda.max_memory_allocated``.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple, Union

__all__ = ["resolve_limit", "MemoryBudget", "memory_budget",
           "memory_budget_for", "all_memory_budgets",
           "remove_memory_budget"]

Limit = Union[int, Callable[[Dict[str, Any]], int], None]


def resolve_limit(limit: Limit, ctx: Dict[str, Any]) -> Optional[int]:
    """An int ceiling, a callable of the ctx, or None (unbounded)."""
    if limit is None:
        return None
    if callable(limit):
        return int(limit(ctx))
    return int(limit)


_lock = threading.Lock()


# ---------------------------------------------------------------------------
# Memory budgets: peak device-memory curves per program family
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MemoryBudget:
    """Declared peak-memory curve for one program family.

    ``configs`` names the configurations the budget binds to;
    ``hbm_per_device`` bounds the peak device bytes of one device (the
    name is the reference's) and ``vmem_per_kernel`` the on-chip block
    bytes of one kernel.  Both are functions of the ctx (rows, features,
    bins, wave_size, leaves, chunk_rows, quantized ...), so one
    declaration covers every size."""

    name: str
    configs: Tuple[str, ...]
    hbm_per_device: Limit
    vmem_per_kernel: Limit = None
    declared_in: str = ""
    note: str = ""


_mem_budgets: Dict[str, MemoryBudget] = {}


def memory_budget(name: str, configs, hbm_per_device: Limit, *,
                  vmem_per_kernel: Limit = None,
                  note: str = "") -> MemoryBudget:
    """Declare (or redeclare) the memory curve for one program family;
    call at module scope next to the code whose footprint it bounds."""
    import inspect
    frame = inspect.currentframe()
    declared_in = ""
    if frame is not None and frame.f_back is not None:
        declared_in = frame.f_back.f_globals.get("__name__", "")
    if isinstance(configs, str):
        configs = (configs,)
    b = MemoryBudget(name=name, configs=tuple(configs),
                     hbm_per_device=hbm_per_device,
                     vmem_per_kernel=vmem_per_kernel,
                     declared_in=declared_in, note=note)
    with _lock:
        _mem_budgets[name] = b
    return b


def memory_budget_for(config: str) -> Optional[MemoryBudget]:
    """The budget whose ``configs`` tuple claims this configuration."""
    with _lock:
        for b in _mem_budgets.values():
            if config in b.configs:
                return b
    return None


def all_memory_budgets() -> Dict[str, MemoryBudget]:
    with _lock:
        return dict(_mem_budgets)


def remove_memory_budget(name: str) -> None:
    with _lock:
        _mem_budgets.pop(name, None)
