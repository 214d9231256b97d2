"""Fault tolerance for training and serving.

Port of ``lightgbm_tpu/resilience/``:

  * :mod:`.checkpoint`: crash-safe checkpoint/resume of the full
    boosting state;
  * :mod:`.faults`: chaos injection points (crash or kill at iteration k,
    a lost card, serve-side crash / hang / dropped connection) driven by
    ``LGBM_TPU_FAULTS`` or :func:`faults.configure`;
  * :mod:`.admission`: serving admission control: typed errors for a
    bounded request queue (503 + ``Retry-After``), per-request deadlines
    (504) and batcher shutdown (``ServerClosed``), with the shed and
    deadline counters in the telemetry registry.
"""

from .admission import (DeadlineExceeded, QueueFullError, ServerClosed,
                        deadline_counter, shed_counter)
from .checkpoint import (Checkpoint, CheckpointError, CheckpointManager,
                         PreemptionGuard, TrainingPreempted, load_checkpoint,
                         reject_checkpointing, resolve_checkpoint)
from .faults import InjectedFault, faults

__all__ = ["Checkpoint", "CheckpointError", "CheckpointManager",
           "PreemptionGuard", "TrainingPreempted", "load_checkpoint",
           "reject_checkpointing", "resolve_checkpoint",
           "InjectedFault", "faults",
           "DeadlineExceeded", "QueueFullError", "ServerClosed",
           "deadline_counter", "shed_counter"]
