"""The process group as the 1-D ``workers`` mesh, and its collectives.

Port of ``lightgbm_tpu/parallel/mesh.py``.  The reference declares a 1-D
device mesh and its learners call ``jax.lax`` collectives inside
``shard_map``; the port's mesh is the ``torch.distributed`` process group
(one rank per process, ``distributed.init``) and each ``jax.lax``
collective the learners use has one helper here: :func:`psum`,
:func:`pmax`, :func:`pmin`, :func:`psum_scatter` (tiled, along a given
dimension) and :func:`all_gather`.

Every helper tallies its call under the reference's site name
(``telemetry.train_record.note_collective``), so ``booster.train_record``
lists the sites the reference lists.  A world of one process reduces
nothing: each helper returns its operand (``all_gather`` adds the
world axis).

Staging is a rule of the backend, never a reaction to an error: under
``gloo`` a CUDA operand is copied to host memory, reduced there and
copied back; under ``nccl`` it is reduced on its card.  ``gloo`` runs the
reduce-scatter as an all-reduce and keeps this rank's block (the
reference's ``psum_scatter_compat`` emulation); ``nccl`` runs a real
reduce-scatter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import distributed
from ..telemetry.train_record import note_collective

__all__ = ["Workers", "get_mesh", "psum", "pmax", "pmin", "psum_scatter",
           "all_gather"]


class Workers(NamedTuple):
    """The 1-D ``workers`` mesh: world size, this process's rank, the
    process group (None: the default group), this rank's device and the
    backend's name."""
    world: int
    rank: int
    group: Optional[object]
    device: Optional[torch.device]
    backend: Optional[str]


def get_mesh(num_devices: int = 0) -> Workers:
    """The mesh of every rank of the process group (the analog of the
    reference's num_machines rank space).  ``num_devices`` other than 0
    or the world size raises ``ValueError``: a port rank owns one
    device, so the mesh cannot be cut to fewer."""
    world = distributed.process_count()
    if num_devices and int(num_devices) != world:
        raise ValueError(
            f"num_devices={num_devices}: the port's mesh is the process "
            f"group, {world} rank(s) of one device each; pass 0 or "
            f"{world}")
    return Workers(world, distributed.process_index(), None,
                   distributed.device(), distributed.backend())


def _staged(v: torch.Tensor):
    """(wire tensor, back): the operand on the device the backend reduces
    on (host memory under gloo), and the map back to ``v``'s device and
    dtype.  Bools travel as uint8."""
    dev, dt = v.device, v.dtype
    w = v.to(torch.uint8) if dt == torch.bool else v
    if distributed.backend() == "gloo":
        w = w.cpu()
    elif w.device.type != "cuda":
        w = w.to(distributed.device())
    w = w.contiguous()

    def back(t: torch.Tensor) -> torch.Tensor:
        t = t.to(dev)
        return t.to(torch.bool) if dt == torch.bool else t
    return w, back


def _all_reduce(v: torch.Tensor, op) -> torch.Tensor:
    import torch.distributed as dist
    w, back = _staged(v)
    w = w.clone() if w.data_ptr() == v.data_ptr() else w
    dist.all_reduce(w, op=op)
    return back(w)


def psum(v: torch.Tensor, site: str) -> torch.Tensor:
    """``jax.lax.psum``: the elementwise sum over every rank."""
    note_collective(site, "psum", v)
    if distributed.process_count() == 1:
        return v
    import torch.distributed as dist
    return _all_reduce(v, dist.ReduceOp.SUM)


def pmax(v: torch.Tensor, site: str) -> torch.Tensor:
    """``jax.lax.pmax``: the elementwise max over every rank."""
    note_collective(site, "pmax", v)
    if distributed.process_count() == 1:
        return v
    import torch.distributed as dist
    return _all_reduce(v, dist.ReduceOp.MAX)


def pmin(v: torch.Tensor, site: str) -> torch.Tensor:
    """``jax.lax.pmin``: the elementwise min over every rank."""
    note_collective(site, "pmin", v)
    if distributed.process_count() == 1:
        return v
    import torch.distributed as dist
    return _all_reduce(v, dist.ReduceOp.MIN)


def psum_scatter(v: torch.Tensor, site: str, dim: int = 0) -> torch.Tensor:
    """``jax.lax.psum_scatter(..., tiled=True)``: the sum over every rank,
    of which this rank keeps block ``rank`` of ``dim`` (the dimension's
    size must divide by the world size).  The tally records the block
    received, as the reference's does."""
    world = distributed.process_count()
    rank = distributed.process_index()
    blk = v.shape[dim] // world
    if world == 1:
        note_collective(site, "psum_scatter", v)
        return v
    import torch.distributed as dist
    if distributed.backend() == "nccl":
        w, back = _staged(v.movedim(dim, 0))
        out = torch.empty((blk,) + tuple(w.shape[1:]), dtype=w.dtype,
                          device=w.device)
        dist.reduce_scatter_tensor(out, w, op=dist.ReduceOp.SUM)
        out = back(out).movedim(0, dim)
    else:
        full = _all_reduce(v, dist.ReduceOp.SUM)
        out = full.narrow(dim, rank * blk, blk)
    note_collective(site, "psum_scatter", out)
    return out


def all_gather(v: torch.Tensor, site: str) -> torch.Tensor:
    """``jax.lax.all_gather``: every rank's ``v`` stacked on a new
    leading world axis, in rank order."""
    note_collective(site, "all_gather", v)
    world = distributed.process_count()
    if world == 1:
        return v.unsqueeze(0)
    import torch.distributed as dist
    w, back = _staged(v)
    outs = [torch.empty_like(w) for _ in range(world)]
    dist.all_gather(outs, w)
    return back(torch.stack(outs))
