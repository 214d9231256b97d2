"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX reference: it mirrors ``lightgbm_tpu``'s
module layout, imports ``torch`` and never ``jax``, and runs its hot path
through hand-written CUDA kernels for Hopper (``csrc/``).  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, which takes the
plain PyTorch versions of the kernels.

This slice carries training (binary and L2 regression, dense numeric
features, the wave grower in exact or quantized mode), model text save /
load and raw-feature prediction.
"""

from .basic import Booster
from .dataset import Dataset
from .engine import train
from .utils.device import DeviceUnavailableError

__all__ = ["train", "Dataset", "Booster", "DeviceUnavailableError"]
__version__ = "0.1.0"
