"""Standard graph-classification models — the counterparts of
``kgcn_tpu/models/standard.py:21-74, 139-175`` (GCN and GATModel).  The
other models of that file (GIN, RxnGCN, multitask, node-label) are still to
be ported (ROADMAP.md queue A).

Dropout draws from the ``torch.Generator`` the trainer passes in
(``forward(batch, train, generator)``), as the JAX models draw from the
``dropout`` rng stream; the two give different masks from one seed.
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


def dropout(x, rate: float, train: bool, generator=None):
    """flax ``nn.Dropout``: keep with probability ``1 - rate`` and scale by
    its inverse; the identity when not training or ``rate == 0``."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


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

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
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
        x = dropout(x, self.dropout_rate, train, generator)
        x = torch.sigmoid(self.GraphDense_0(x, g))
        x = self.GraphGather_0(x, g)
        logits = self.Dense_0(x)
        cost_opt, cost_sum, pred, metrics = softmax_ce_cost(
            logits, batch.labels, batch.pad_mask
        )
        return ModelOutput(pred, cost_opt, cost_sum, metrics)


class GATModel(nn.Module):
    """GraphDense + GAT ×3; readouts after blocks 2 and 3 only, as the
    reference's model_gat.py:44-54.  ``gat_normalize`` defaults to
    ``"sender"``, the reference's denominator gather, which the shipped ring
    classification task needs."""

    def __init__(self, in_features: int, channels: int = 1, label_dim: int = 2,
                 hidden: int = 50, gat_normalize: str = "sender"):
        super().__init__()
        self.GraphDense_0 = knn.GraphDense(in_features, hidden)
        self.GAT_0 = knn.GAT(hidden, channels, normalize=gat_normalize)
        self.GraphDense_1 = knn.GraphDense(hidden, hidden)
        self.GAT_1 = knn.GAT(hidden, channels, normalize=gat_normalize)
        self.GraphDense_2 = knn.GraphDense(hidden, hidden)
        self.GAT_2 = knn.GAT(hidden, channels, normalize=gat_normalize)
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = nn.Linear(2 * hidden, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        for layer in (self.GraphDense_0, self.GAT_0, self.GraphDense_1,
                      self.GAT_1, self.GraphDense_2, self.GAT_2):
            layer.reset_parameters(generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        x = self.GAT_0(self.GraphDense_0(g.nodes, g), g)
        x = self.GAT_1(self.GraphDense_1(x, g), g)
        block_out = [x]
        x = self.GAT_2(self.GraphDense_2(x, g), g)
        block_out.append(x)
        h = torch.cat([self.GraphGather_0(b, g) for b in block_out], dim=1)
        logits = self.Dense_0(h)
        cost_opt, cost_sum, pred, metrics = softmax_ce_cost(
            logits, batch.labels, batch.pad_mask
        )
        return ModelOutput(pred, cost_opt, cost_sum, metrics)
