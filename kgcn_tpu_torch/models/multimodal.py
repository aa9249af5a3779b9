"""Graph regression — the counterpart of ``GCNRegression`` in
``kgcn_tpu/models/multimodal.py:134-167``.  The multimodal models of that
file (graph ‖ sequence, graph ‖ vector modal, the sequence CNN) come with
the other model families (ROADMAP.md A.8)."""
from __future__ import annotations

import torch
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.models.base import ModelOutput
from kgcn_tpu_torch.models.standard import _reset, dropout
from kgcn_tpu_torch.nn import layers as knn


class GCNRegression(nn.Module):
    """Graph-only regression head: 2 × GraphConv + sigmoid → GraphBN →
    sigmoid → dropout → GraphDense + sigmoid → GraphGather → Dense(label_dim)
    (reference: the *_regression example models).  The cost is the squared
    error summed over outputs under ``mask_label``, times ``pad_mask``, and
    averaged over the whole batch, padding rows included, as ``kgcn_tpu``
    has it; the metrics are the ``error_sum``/``count`` protocol
    (kgcn/core.py:185-196)."""

    def __init__(self, in_features: int, channels: int = 1, label_dim: int = 1,
                 hidden: int = 50, dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.GraphConv_0 = knn.GraphConv(in_features, hidden, channels)
        self.GraphConv_1 = knn.GraphConv(hidden, hidden, channels)
        self.GraphBatchNormalization_0 = knn.GraphBatchNormalization(hidden)
        self.GraphDense_0 = knn.GraphDense(hidden, hidden)
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = nn.Linear(hidden, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _reset((self.GraphConv_0, self.GraphConv_1, self.GraphBatchNormalization_0,
                self.GraphDense_0), generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        x = torch.sigmoid(self.GraphConv_0(g.nodes, g))
        x = torch.sigmoid(self.GraphConv_1(x, g))
        x = self.GraphBatchNormalization_0(x, g, use_running_average=not train)
        x = torch.sigmoid(x)
        x = dropout(x, self.dropout_rate, train, generator)
        x = torch.sigmoid(self.GraphDense_0(x, g))
        pred = self.Dense_0(self.GraphGather_0(x, g))
        labels = batch.labels.to(pred.dtype)
        mask_label = (batch.mask_label.to(torch.float32)
                      if batch.mask_label is not None else torch.ones_like(pred))
        err = torch.sum((labels - pred) ** 2 * mask_label, dim=1) * batch.pad_mask
        metrics = {"error_sum": torch.sum(err), "count": torch.sum(batch.pad_mask)}
        return ModelOutput(pred, torch.mean(err), torch.sum(err), metrics)
