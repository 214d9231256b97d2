"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX reference: it mirrors ``lightgbm_tpu``'s
module layout, imports ``torch`` and never ``jax``, and runs its hot path
through hand-written CUDA kernels for Hopper (``csrc/``).  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, which takes the
plain PyTorch versions of the kernels.

The port carries training (every objective; the wave and partitioned
growers in exact or quantized mode; numeric and categorical features,
EFB bundling; dense, pandas, scipy sparse and data-file input; continued
training), model text save / load and raw-feature prediction.
"""

from .basic import Booster
from .callback import early_stopping, print_evaluation, record_evaluation
from .dataset import Dataset
from .engine import train
from .utils.device import DeviceUnavailableError

__all__ = ["train", "Dataset", "Booster", "DeviceUnavailableError",
           "early_stopping", "print_evaluation", "record_evaluation"]
__version__ = "0.1.0"
