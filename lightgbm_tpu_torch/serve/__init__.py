"""lightgbm_tpu_torch.serve: the compiled inference path.

Ports the prediction core of ``lightgbm_tpu/serve``:

- :class:`CompiledPredictor`: the model's lowered dense program (or the
  walk, with a counted reason) on its device, requests padded up the
  ``SHAPE_BUCKETS`` ladder, with ``warmup()`` and the explain lane;
- :func:`compile_ensemble` / :class:`DenseExecutable`: the serving
  compiler behind ``tpu_predict_compiler``;
- :class:`ModelStats`: per-model serving counters.

The micro-batcher, model registry, HTTP server, fleet supervisor and
model zoo come with the serving tier (ROADMAP queue 1 item 11b).
"""

from .compiler import (DenseExecutable, DenseLoweringError,
                       StackedExecutable, compile_ensemble, fallback_counts)
from .predictor import SHAPE_BUCKETS, CompiledPredictor
from .stats import ModelStats

__all__ = ["CompiledPredictor", "ModelStats", "SHAPE_BUCKETS",
           "DenseExecutable", "DenseLoweringError", "StackedExecutable",
           "compile_ensemble", "fallback_counts"]
