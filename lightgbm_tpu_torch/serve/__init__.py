"""lightgbm_tpu_torch.serve: the serving tier.

Port of ``lightgbm_tpu/serve``:

- :class:`CompiledPredictor`: the model's lowered dense program (or the
  walk, with a counted reason) on its device, requests padded up the
  ``SHAPE_BUCKETS`` ladder, with ``warmup()``, the explain lane and delta
  appends (``extended``);
- :func:`compile_ensemble` / :class:`DenseExecutable` /
  :class:`StackedExecutable`: the serving compiler behind
  ``tpu_predict_compiler``;
- :class:`MicroBatcher`: coalesces concurrent small requests into one
  bucketed device call under a max-wait / max-rows policy, with
  admission control (load shed, deadlines) in front;
- :class:`ModelRegistry`: named models with atomic hot swap, eviction
  and the delta lane (``apply_delta``);
- :class:`PredictionServer`: the ``http.server`` JSON endpoint
  (``/predict``, ``/explain``, ``/models``, ``/healthz``, ``/stats``,
  ``/metrics``, ``/slo``, ``/models/<name>/delta``), the
  ``python -m lightgbm_tpu_torch serve`` CLI verb;
- :class:`ModelZoo`: the bounded multi-tenant tier over the registry
  (traffic-weighted LRU eviction, cold load-on-miss, per-tenant quotas,
  stacked cross-model dispatch);
- :class:`ModelStats`: per-model serving counters;
- :class:`FleetSupervisor`: N server processes behind one dispatcher
  with crash-restart, a crash-loop circuit breaker, rolling drain and
  rolling deploys, hash placement and the delta journal follow
  (``python -m lightgbm_tpu_torch serve-fleet``); the workers share the
  card, one CUDA context each, and the supervisor never touches it;
- :mod:`.loadgen`: the load generator and the ``/metrics`` scrape
  helpers.

Everything runs on ``cuda`` unless the caller asks for the CPU.
"""

from .batcher import MicroBatcher
from .compiler import (DenseExecutable, DenseLoweringError,
                       StackedExecutable, compile_ensemble, fallback_counts)
from .fleet import FleetSupervisor
from .predictor import SHAPE_BUCKETS, CompiledPredictor
from .registry import ModelRegistry
from .server import PredictionServer
from .stats import ModelStats
from .zoo import ModelZoo

__all__ = ["CompiledPredictor", "MicroBatcher", "ModelRegistry",
           "PredictionServer", "ModelStats", "SHAPE_BUCKETS",
           "DenseExecutable", "DenseLoweringError", "StackedExecutable",
           "compile_ensemble", "fallback_counts", "FleetSupervisor",
           "ModelZoo"]
