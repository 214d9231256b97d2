"""Multi-process bootstrap over ``torch.distributed``.

Port of ``lightgbm_tpu/distributed.py``.  The reference boots the JAX
multi-process runtime (``jax.distributed.initialize``) so that its mesh
spans every host's chips; the port forms a ``torch.distributed`` process
group instead, one process per rank, and the parallel tree learners
(``parallel/``) run their collectives over it.

* A rank on a CUDA device uses ``nccl``: the production layout, one card
  per rank (``local_device_ids`` picks the rank's ``cuda:i``).
* A rank on the CPU uses ``cpu_collectives`` (``gloo``).
* ``backend=`` names the backend outright.  Ranks that share one card
  must pass ``"gloo"`` (NCCL refuses two ranks on one device); the
  collectives then stage each CUDA operand through host memory
  (``parallel/mesh.py``).

Typical launch (one process per rank, same program)::

    import lightgbm_tpu_torch as lt
    lt.distributed.init(coordinator_address="10.0.0.1:1234",
                        num_processes=4, process_id=rank,
                        local_device_ids=[0])
    bst = lt.train({"tree_learner": "data", ...}, dset)

Without ``pre_partition`` every process passes the FULL data (the
reference's default distributed mode, dataset_loader.cpp:181) and each
rank's learner keeps only its own contiguous block of rows on its device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .utils.log import log_info, log_warning

__all__ = ["init", "shutdown", "is_initialized", "process_index",
           "process_count", "allgather_host", "device", "backend"]

_initialized = False
_device: Optional[torch.device] = None
_backend: Optional[str] = None


def init(coordinator_address: Optional[str] = None,
         num_processes: Optional[int] = None,
         process_id: Optional[int] = None,
         local_device_ids=None,
         cpu_collectives: str = "gloo",
         backend: Optional[str] = None) -> None:
    """Join the process group (replaces the reference's
    ``jax.distributed.initialize``, itself the replacement of LightGBM's
    ``Network::Init`` rank-0 handshake, network.cpp:26-43).

    ``coordinator_address`` is ``host:port`` of rank 0's rendezvous
    (``tcp://`` is added); ``None`` reads the ``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` environment
    (``env://``).  ``local_device_ids`` (a sequence, its first entry
    used) puts this rank on ``cuda:i`` and raises
    :class:`~lightgbm_tpu_torch.DeviceUnavailableError` without a card;
    without it a rank takes ``cuda:(process_id % cards)`` when cards are
    visible, else the CPU.  The backend is ``nccl`` for a CUDA rank and
    ``cpu_collectives`` for a CPU rank unless ``backend`` names one."""
    global _initialized, _device, _backend
    if _initialized:
        log_warning("lightgbm_tpu_torch.distributed.init called twice; "
                    "ignoring")
        return
    import torch.distributed as dist
    from .utils.device import resolve_device
    rank = 0 if process_id is None else int(process_id)
    if local_device_ids is not None:
        ids = ([int(local_device_ids)] if np.isscalar(local_device_ids)
               else [int(i) for i in local_device_ids])
        dev = resolve_device(f"cuda:{ids[0]}")
    elif torch.cuda.is_available():
        dev = torch.device(f"cuda:{rank % torch.cuda.device_count()}")
    else:
        dev = torch.device("cpu")
    name = backend or ("nccl" if dev.type == "cuda" else cpu_collectives)
    if name == "nccl" and dev.type != "cuda":
        raise ValueError("backend='nccl' needs a CUDA rank (pass "
                         "local_device_ids, or backend='gloo' for CPU "
                         "ranks)")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if coordinator_address is None:
        method = "env://"
    else:
        addr = str(coordinator_address)
        method = addr if "://" in addr else "tcp://" + addr
        kw = dict(world_size=int(num_processes), rank=rank)
    dist.init_process_group(name, init_method=method, **kw)
    _device, _backend, _initialized = dev, name, True
    log_info(f"distributed runtime up: process {dist.get_rank()}/"
             f"{dist.get_world_size()} on {dev} over {name}")


def shutdown() -> None:
    """Leave the process group (reference ``LGBM_NetworkFree``)."""
    global _initialized, _device, _backend
    if not _initialized:
        return
    import torch.distributed as dist
    dist.destroy_process_group()
    _initialized, _device, _backend = False, None, None


def is_initialized() -> bool:
    return _initialized


def process_index() -> int:
    if not _initialized:
        return 0
    import torch.distributed as dist
    return dist.get_rank()


def process_count() -> int:
    if not _initialized:
        return 1
    import torch.distributed as dist
    return dist.get_world_size()


def device() -> Optional[torch.device]:
    """This rank's device (None before :func:`init`)."""
    return _device


def backend() -> Optional[str]:
    """The process group's backend name (None before :func:`init`)."""
    return _backend


def _wire(t: torch.Tensor) -> torch.Tensor:
    """A host tensor on the device the backend reduces on: NCCL's card,
    gloo's host memory."""
    return t.to(_device) if _backend == "nccl" else t


def allgather_host(arr) -> np.ndarray:
    """Concatenate per-process host arrays along axis 0 in rank order.

    The host collective behind pre-partitioned ingest (the analog of the
    reference's BinMapper allgather, dataset_loader.cpp:1040-1130): bin
    finding summaries and metadata gathered once at
    ``Dataset.construct``.  Ranks may hold different lengths (max-pad and
    trim).  Rows travel as raw bytes, so every dtype (float64 included)
    comes through bit for bit."""
    arr = np.asarray(arr)
    if process_count() == 1:
        return arr
    import torch.distributed as dist
    world = process_count()
    arr = arr.reshape(1) if arr.ndim == 0 else arr
    n, tail = arr.shape[0], arr.shape[1:]
    width = arr.dtype.itemsize * int(np.prod(tail, dtype=np.int64))
    raw = np.ascontiguousarray(arr).view(np.uint8).reshape(n, width)
    lens = _wire(torch.tensor([n], dtype=torch.int64))
    lens_all = [torch.zeros_like(lens) for _ in range(world)]
    dist.all_gather(lens_all, lens)
    lens_h = [int(v.item()) for v in lens_all]
    m = max(lens_h)
    buf = np.zeros((m, width), np.uint8)
    buf[:n] = raw
    t = _wire(torch.from_numpy(buf))
    outs = [torch.zeros_like(t) for _ in range(world)]
    dist.all_gather(outs, t)
    parts = [o.cpu().numpy()[:k] for o, k in zip(outs, lens_h)]
    out = np.concatenate(parts, axis=0)
    return np.ascontiguousarray(out).view(arr.dtype).reshape(
        (sum(lens_h),) + tuple(tail))
