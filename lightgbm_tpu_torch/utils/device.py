"""Device resolution for the PyTorch port — the counterpart of
``lightgbm_tpu/utils/backend.py``.

The port's public entry points run on ``cuda`` unless the caller asks for
the CPU.  There is no silent fallback: asking for ``cuda`` on a machine
without a usable card raises :class:`DeviceUnavailableError`.  The CPU is
the plain-PyTorch path the tests use; every kernel wrapper dispatches on
the device of the tensor it is handed, never on what the machine has.
An armed ``device_loss`` fault (``resilience/faults.py``) makes a
``cuda`` resolution raise as a missing card does.
"""

from __future__ import annotations

from typing import Union

import torch

__all__ = ["DEFAULT_DEVICE", "DeviceUnavailableError", "resolve_device"]

DEFAULT_DEVICE = "cuda"

# device names accepted from params / arguments; "gpu" is LightGBM's own
# spelling of the accelerator device_type
_ALIASES = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


class DeviceUnavailableError(RuntimeError):
    """``cuda`` was requested but no CUDA device is usable here."""


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``None`` -> the default device (``cuda``); ``"cpu"`` -> the CPU.

    Raises :class:`DeviceUnavailableError` when ``cuda`` is asked for (or
    defaulted to) and ``torch.cuda.is_available()`` is false, and
    ``ValueError`` for a device name the port does not run on."""
    if isinstance(device, torch.device):
        dev = device
    else:
        name = DEFAULT_DEVICE if device in (None, "") else str(device)
        base, _, index = name.partition(":")
        if base not in _ALIASES:
            raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
        dev = torch.device(_ALIASES[base] + (f":{index}" if index else ""))
    if dev.type == "cuda":
        # the chaos layer's device_loss point (resilience/faults.py)
        from ..resilience.faults import faults
        faults.check_device_probe()
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "lightgbm_tpu_torch runs on a CUDA device by default, but "
            "torch.cuda.is_available() is False on this machine; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev
