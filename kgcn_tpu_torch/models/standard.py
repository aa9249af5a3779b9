"""Standard graph-classification models — the counterparts of
``kgcn_tpu/models/standard.py:21-251`` (GCN, RxnGCN, GIN, GATModel and
GCNMultitask).  The node-label model of that file is still to be ported
(ROADMAP.md queue A).

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


def _reset(layers, generator):
    for layer in layers:
        layer.reset_parameters(generator)


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


class RxnGCN(nn.Module):
    """Reaction-template classifier: 3×(GraphConv(128) + GraphBN + relu) →
    GraphDense(128) + relu → GraphGather → Dense (reference:
    example_model/model_rxn_3layer.py, whose declared dropout is unused)."""

    def __init__(self, in_features: int, channels: int = 1, label_dim: int = 2,
                 hidden: int = 128):
        super().__init__()
        self.GraphConv_0 = knn.GraphConv(in_features, hidden, channels)
        self.GraphConv_1 = knn.GraphConv(hidden, hidden, channels)
        self.GraphConv_2 = knn.GraphConv(hidden, hidden, channels)
        self.GraphBatchNormalization_0 = knn.GraphBatchNormalization(hidden)
        self.GraphBatchNormalization_1 = knn.GraphBatchNormalization(hidden)
        self.GraphBatchNormalization_2 = knn.GraphBatchNormalization(hidden)
        self.GraphDense_0 = knn.GraphDense(hidden, hidden)
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = nn.Linear(hidden, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _reset((self.GraphConv_0, self.GraphConv_1,
                self.GraphConv_2, self.GraphBatchNormalization_0,
                self.GraphBatchNormalization_1, self.GraphBatchNormalization_2,
                self.GraphDense_0), generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        x = g.nodes
        for conv, bn in ((self.GraphConv_0, self.GraphBatchNormalization_0),
                         (self.GraphConv_1, self.GraphBatchNormalization_1),
                         (self.GraphConv_2, self.GraphBatchNormalization_2)):
            x = torch.relu(bn(conv(x, g), g, use_running_average=not train))
        x = torch.relu(self.GraphDense_0(x, g))
        logits = self.Dense_0(self.GraphGather_0(x, g))
        cost_opt, cost_sum, pred, metrics = softmax_ce_cost(
            logits, batch.labels, batch.pad_mask
        )
        return ModelOutput(pred, cost_opt, cost_sum, metrics)


class GIN(nn.Module):
    """2-block GIN, each block GINAggregate → GraphDense + relu ×2, with the
    blocks' readouts concatenated (reference: example_model/model_gin.py:
    29-78; hidden 50, the published width)."""

    def __init__(self, in_features: int, channels: int = 1, label_dim: int = 2,
                 hidden: int = 50, num_blocks: int = 2):
        super().__init__()
        self.num_blocks = num_blocks
        fin = in_features
        for b in range(num_blocks):
            setattr(self, f"GINAggregate_{b}", knn.GINAggregate(channels))
            setattr(self, f"GraphDense_{2 * b}", knn.GraphDense(fin, hidden))
            setattr(self, f"GraphDense_{2 * b + 1}", knn.GraphDense(hidden, hidden))
            fin = hidden
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = nn.Linear(num_blocks * hidden, label_dim)
        self.reset_parameters()

    def _block(self, b):
        return (getattr(self, f"GINAggregate_{b}"), getattr(self, f"GraphDense_{2 * b}"),
                getattr(self, f"GraphDense_{2 * b + 1}"))

    def reset_parameters(self, generator=None) -> None:
        _reset([m for b in range(self.num_blocks) for m in self._block(b)], generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        x = g.nodes
        readouts = []
        for b in range(self.num_blocks):
            agg, dense_a, dense_b = self._block(b)
            x = torch.relu(dense_a(agg(x, g), g))
            x = torch.relu(dense_b(x, g))
            readouts.append(self.GraphGather_0(x, g))
        logits = self.Dense_0(torch.cat(readouts, dim=1))
        cost_opt, cost_sum, pred, metrics = softmax_ce_cost(
            logits, batch.labels, batch.pad_mask
        )
        return ModelOutput(pred, cost_opt, cost_sum, metrics)


class GCNMultitask(nn.Module):
    """Tox21-style multitask head: a sigmoid per task, masked labels, the
    weighted CE of ``tf.nn.weighted_cross_entropy_with_logits`` when the
    dataset gives ``pos_weight`` (reference: example_model/
    model_multitask.py:31-101); exact match counted over labelled tasks
    only, as ``kgcn_tpu`` does.  The declared dropout is not applied (nor is
    it in ``kgcn_tpu``)."""

    def __init__(self, in_features: int, channels: int = 1, label_dim: int = 12,
                 hidden: int = 50, wide_hidden: int = 256, pos_weight=None):
        super().__init__()
        self.pos_weight = None if pos_weight is None else tuple(
            float(p) for p in pos_weight)
        self.GraphConv_0 = knn.GraphConv(in_features, wide_hidden, channels)
        self.GraphConv_1 = knn.GraphConv(wide_hidden, wide_hidden, channels)
        self.GraphDense_0 = knn.GraphDense(wide_hidden, wide_hidden)
        self.GraphConv_2 = knn.GraphConv(wide_hidden, hidden, channels)
        self.GraphBatchNormalization_0 = knn.GraphBatchNormalization(hidden)
        self.GraphDense_1 = knn.GraphDense(hidden, hidden)
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = nn.Linear(hidden, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _reset((self.GraphConv_0, self.GraphConv_1,
                self.GraphDense_0, self.GraphConv_2,
                self.GraphBatchNormalization_0, self.GraphDense_1), generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        x = torch.sigmoid(self.GraphConv_0(g.nodes, g))
        x = torch.sigmoid(self.GraphConv_1(x, g))
        x = torch.sigmoid(self.GraphDense_0(x, g))
        x = self.GraphConv_2(x, g)
        x = self.GraphBatchNormalization_0(x, g, use_running_average=not train)
        x = torch.sigmoid(x)
        x = torch.sigmoid(self.GraphDense_1(x, g))
        logits = self.Dense_0(self.GraphGather_0(x, g)).to(torch.float32)

        labels = batch.labels.to(torch.float32)
        mask_label = (batch.mask_label.to(torch.float32)
                      if batch.mask_label is not None else torch.ones_like(labels))
        pad = batch.pad_mask
        if self.pos_weight is not None:
            # tf.nn.weighted_cross_entropy_with_logits, stable form
            pw = torch.tensor(self.pos_weight, dtype=torch.float32, device=logits.device)
            ce = ((1 - labels) * (logits + F.softplus(-logits))
                  + labels * pw * F.softplus(-logits))
        else:
            # tf.nn.sigmoid_cross_entropy_with_logits, stable form
            ce = (torch.clamp(logits, min=0) - logits * labels
                  + F.softplus(-torch.abs(logits)))
        cost = pad * torch.sum(mask_label * ce, dim=1)
        prediction = torch.sigmoid(logits)
        hit = (prediction > 0.5) == (labels > 0.5)
        exact = pad * torch.all(hit | (mask_label <= 0), dim=1).to(torch.float32)
        task_correct = hit.to(torch.float32) * mask_label * pad[:, None]
        metrics = {
            "correct_count": torch.sum(exact),
            "count": torch.sum(pad),
            "each_correct_count": torch.sum(task_correct, dim=0),
            "each_count": torch.sum(mask_label * pad[:, None], dim=0),
        }
        pred2 = torch.stack([1.0 - prediction, prediction], dim=-1)  # [B, T, 2]
        return ModelOutput(pred2, torch.mean(cost), torch.sum(cost), metrics)
