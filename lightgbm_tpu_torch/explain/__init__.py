"""Explanation: the dense TreeSHAP lowering and its compile entry.

Port of ``lightgbm_tpu/explain``: ``dense_shap`` lowers an ensemble's
TreeSHAP (Lundberg's Algorithm 2, the algebra of ``models/shap.py``) to
one loop-free-in-rows tensor program; ``compiler`` wraps it in the
serving-compiler contract, an executable or a counted fallback reason.
"""

from .compiler import (EXPLAIN_FALLBACK_COUNTER, ExplainAdditivityError,
                       ExplainExecutable, check_additivity, compile_explain,
                       explain_fallback_counts, note_explain_fallback_batch)
from .dense_shap import (EXPLAIN_DEPTH_BUDGET, EXPLAIN_TABLE_BUDGET,
                         ExplainArrays, ExplainMeta, dense_explain,
                         lower_explain)

__all__ = [
    "EXPLAIN_DEPTH_BUDGET", "EXPLAIN_TABLE_BUDGET",
    "EXPLAIN_FALLBACK_COUNTER", "ExplainAdditivityError", "ExplainArrays",
    "ExplainExecutable", "ExplainMeta", "check_additivity",
    "compile_explain", "dense_explain", "explain_fallback_counts",
    "lower_explain", "note_explain_fallback_batch",
]
