"""Fault tolerance of training: crash-safe checkpoint/resume of the full
boosting state (:mod:`.checkpoint`).

Ports the checkpoint part of ``lightgbm_tpu/resilience/``; its chaos
injection (``faults``) and serving admission control (``admission``)
come with the serving tier (ROADMAP queue 1 item 11b).
"""

from .checkpoint import (Checkpoint, CheckpointError, CheckpointManager,
                         PreemptionGuard, TrainingPreempted, load_checkpoint,
                         reject_checkpointing, resolve_checkpoint)

__all__ = ["Checkpoint", "CheckpointError", "CheckpointManager",
           "PreemptionGuard", "TrainingPreempted", "load_checkpoint",
           "reject_checkpointing", "resolve_checkpoint"]
