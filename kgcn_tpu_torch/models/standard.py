"""Standard graph-classification models — the counterparts of
``kgcn_tpu/models/standard.py:21-74``.  The other models of that file
(GIN, RxnGCN, GAT, multitask, node-label) are still to be ported
(ROADMAP.md queue A).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.models.base import ModelOutput
from kgcn_tpu_torch.nn import layers as knn


def softmax_ce_cost(logits, labels, pad_mask):
    """Per-example masked softmax CE → (cost_opt, cost_sum, prediction,
    metrics) — the recurring block of the reference models
    (example_model/model.py:57-69)."""
    logits = logits.to(torch.float32)  # losses always in full precision
    labels = labels.to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    cost = -torch.sum(labels * logp, dim=-1) * pad_mask
    prediction = F.softmax(logits, dim=-1)
    correct = pad_mask * (
        torch.argmax(prediction, dim=-1) == torch.argmax(labels, dim=-1)
    ).to(torch.float32)
    metrics = {"correct_count": torch.sum(correct), "count": torch.sum(pad_mask)}
    return torch.mean(cost), torch.sum(cost), prediction, metrics


class GCN(nn.Module):
    """3-layer GCN binary graph classifier
    (reference: example_model/model.py:30-71).

    Submodule names are the flax scope names of ``kgcn_tpu``'s GCN
    (``GraphConv_0`` …), so a JAX parameter tree converts by rule
    (``kgcn_tpu_torch/convert.py``)."""

    def __init__(self, in_features: int, channels: int = 1, label_dim: int = 2,
                 hidden: int = 50, dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.GraphConv_0 = knn.GraphConv(in_features, hidden, channels)
        self.GraphConv_1 = knn.GraphConv(hidden, hidden, channels)
        self.GraphConv_2 = knn.GraphConv(hidden, hidden, channels)
        self.GraphBatchNormalization_0 = knn.GraphBatchNormalization(hidden)
        self.GraphDense_0 = knn.GraphDense(hidden, hidden)
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = nn.Linear(hidden, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """Draw every parameter from ``generator`` (layer order fixed)."""
        for layer in (self.GraphConv_0, self.GraphConv_1, self.GraphConv_2,
                      self.GraphBatchNormalization_0, self.GraphDense_0):
            layer.reset_parameters(generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        if g.nodes is None:
            raise NotImplementedError(
                "GCN without node features (node-embedding mode) is not "
                "ported yet (ROADMAP.md queue A)"
            )
        x = torch.sigmoid(self.GraphConv_0(g.nodes, g))
        x = torch.sigmoid(self.GraphConv_1(x, g))
        x = self.GraphConv_2(x, g)
        x = self.GraphBatchNormalization_0(x, g, use_running_average=not train)
        x = torch.sigmoid(x)
        x = F.dropout(x, self.dropout_rate, training=train)
        x = torch.sigmoid(self.GraphDense_0(x, g))
        x = self.GraphGather_0(x, g)
        logits = self.Dense_0(x)
        cost_opt, cost_sum, pred, metrics = softmax_ce_cost(
            logits, batch.labels, batch.pad_mask
        )
        return ModelOutput(pred, cost_opt, cost_sum, metrics)
