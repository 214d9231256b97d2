"""Telemetry master switch (kept in its own leaf module so metrics/
trace/train_record can read it without import cycles).

Copy of ``lightgbm_tpu/telemetry/_config.py`` (pure Python) kept inside
the PyTorch port so the port never imports the JAX package.

Default ON — accumulation is cheap host-side bookkeeping and purely
observational (bit-identical training is a tested contract).  Disable
with ``LGBM_TPU_TELEMETRY=0`` or ``lightgbm_tpu_torch.telemetry.disable()``;
the span TRACER and the timetag timer stay separately opt-in."""

from __future__ import annotations

import os

_enabled = os.environ.get("LGBM_TPU_TELEMETRY", "1") != "0"


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False
