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
(``pred_contrib``) through dense TreeSHAP; ``max_bin`` up to 65,535
(uint16 bin codes), forced bins and the binary dataset cache; the
sklearn estimators (``LGBMRegressor``, ``LGBMClassifier``,
``LGBMRanker``; ``multitrain.GridSearchCVMany``) and the CLI
(``python -m lightgbm_tpu_torch``); out-of-core chunked ingest
(``ingest``: ``StreamedDataset``, ``train_streamed`` and
``tpu_ingest_mode=chunked``), the ``LGBM_*`` C API (``capi``, and its
native shim through ``utils.native.build_capi_shim``) and the plotting
helpers (``plot_*``; matplotlib and graphviz imported when they draw);
the serving tier (``serve``: the HTTP server, the micro-batcher, the
model registry and zoo; ``python -m lightgbm_tpu_torch serve``), the
continuous-learning lane (``publish``, ``train(publish_dir=...)``),
admission control and fault points (``resilience``) and telemetry
(``telemetry``: metrics, the train record, the flight recorder, the SLO
engine, Prometheus export).
"""

from . import capi, ingest, plotting, resilience, telemetry
from .basic import Booster
from .callback import early_stopping, print_evaluation, record_evaluation
from .dataset import Dataset, DatasetCorruptError
from .engine import CVBooster, cv, train
from .ingest import StreamedDataset, train_streamed
from .multitrain import ManyBooster, MultiTrainError, train_many
from .resilience.checkpoint import CheckpointError, TrainingPreempted
from .sklearn import LGBMClassifier, LGBMModel, LGBMRanker, LGBMRegressor
from .plotting import (create_tree_digraph, plot_importance, plot_metric,
                       plot_split_value_histogram, plot_tree)
from .utils.device import DeviceUnavailableError

__all__ = ["train", "cv", "CVBooster", "train_many", "ManyBooster",
           "MultiTrainError", "Dataset", "Booster", "DeviceUnavailableError",
           "CheckpointError", "TrainingPreempted", "DatasetCorruptError",
           "LGBMModel", "LGBMRegressor", "LGBMClassifier", "LGBMRanker",
           "early_stopping", "print_evaluation", "record_evaluation",
           "capi", "ingest", "plotting", "resilience", "telemetry",
           "StreamedDataset",
           "train_streamed", "plot_importance", "plot_metric", "plot_tree",
           "plot_split_value_histogram", "create_tree_digraph"]
__version__ = "0.1.0"
