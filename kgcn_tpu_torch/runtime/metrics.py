"""Metric-dict aggregation — the port's own copy of ``aggregate_metrics``
(``kgcn_tpu/runtime/metrics.py:21``).

Models emit per-batch metric dicts (``correct_count``, ``count``,
``each_correct_count``, ``each_count``, ``error_sum`` — the reference
protocol, kgcn/core.py:168-209).  ``aggregate_metrics`` sums them across
batches and derives accuracy / mse / gmfe / each_accuracy.  The offline
sklearn battery (``compute_metrics``) comes with the training slice.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


def aggregate_metrics(
    batch_metrics: List[Dict[str, np.ndarray]],
    num: int,
    task: str = "multitask_classification",
    key_prefix: str = "",
) -> Optional[Dict[str, np.ndarray]]:
    """Sum per-batch metric dicts, then derive task metrics
    (reference: kgcn/core.py:168-209)."""
    if not batch_metrics:
        return None
    summed: Dict[str, np.ndarray] = {}
    for m in batch_metrics:
        for k, v in m.items():
            v = np.asarray(v)
            summed[k] = v if k not in summed else summed[k] + v
    out = {key_prefix + k: v for k, v in summed.items()}

    def _ratio(a, b):
        return summed[a] / summed[b] if b in summed else summed[a] / num

    if task == "regression":
        if "error_sum" in summed:
            out[key_prefix + "mse"] = _ratio("error_sum", "count")
    elif task == "regression_gmfe":
        if "error_sum" in summed:
            out[key_prefix + "gmfe"] = np.exp(_ratio("error_sum", "count"))
    else:
        if "correct_count" in summed:
            out[key_prefix + "accuracy"] = _ratio("correct_count", "count")
        if "each_correct_count" in summed:
            out[key_prefix + "each_accuracy"] = _ratio(
                "each_correct_count", "each_count"
            )
        if key_prefix + "accuracy" not in out and key_prefix + "each_accuracy" in out:
            out[key_prefix + "accuracy"] = np.nanmean(
                out[key_prefix + "each_accuracy"]
            )
    return out
