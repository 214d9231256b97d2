"""lightgbm_tpu_torch — the PyTorch/CUDA port of lightgbm_tpu.

A second package beside the JAX reference: it mirrors ``lightgbm_tpu``'s
module layout, imports ``torch`` and never ``jax``, and runs its hot path
through hand-written CUDA kernels for Hopper (``csrc/``).  Entry points run
on ``cuda`` unless the caller passes ``device="cpu"``, which takes the
plain PyTorch versions of the kernels.

The port carries training (every objective; the wave and partitioned
growers in exact or quantized mode; numeric and categorical features,
EFB bundling; dense, pandas, scipy sparse and data-file input; continued
training), multi-model training (``train_many``) and cross-validation
(``cv``), checkpoint / resume of a training run (the reference's bundle
format, ``train(resume_from=...)``), model text save / load, and
prediction through the serving compiler's dense program
(``Booster.predict``, ``Booster.to_predictor``) with SHAP values
(``pred_contrib``) through dense TreeSHAP.
"""

from .basic import Booster
from .callback import early_stopping, print_evaluation, record_evaluation
from .dataset import Dataset
from .engine import CVBooster, cv, train
from .multitrain import ManyBooster, MultiTrainError, train_many
from .resilience.checkpoint import CheckpointError, TrainingPreempted
from .utils.device import DeviceUnavailableError

__all__ = ["train", "cv", "CVBooster", "train_many", "ManyBooster",
           "MultiTrainError", "Dataset", "Booster", "DeviceUnavailableError",
           "CheckpointError", "TrainingPreempted",
           "early_stopping", "print_evaluation", "record_evaluation"]
__version__ = "0.1.0"
