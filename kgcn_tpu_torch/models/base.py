"""Model protocol — the counterpart of ``kgcn_tpu/models/base.py``.

A model is an ``nn.Module`` whose ``forward(batch, train)`` returns a
:class:`ModelOutput`; the fields map one-to-one onto the reference's
``(prediction, cost_opt, cost_sum, metrics)`` (example_model/model.py:16-71).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch


@dataclasses.dataclass
class ModelOutput:
    """prediction: per-example outputs ([B, ...]); cost_opt: scalar mean loss
    (optimised); cost_sum: scalar summed loss (reported); metrics: the
    reference metric-dict protocol (correct_count / count / ...)."""

    prediction: Any
    cost_opt: torch.Tensor
    cost_sum: torch.Tensor
    metrics: Dict[str, torch.Tensor]
