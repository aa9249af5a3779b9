"""Standard graph-classification models — the counterparts of
``kgcn_tpu/models/standard.py`` (GCN, RxnGCN, GIN, GATModel, GCNMultitask
and GCNNodeLabel).

``GCN``, ``RxnGCN``, ``GCNMultitask`` and ``GCNNodeLabel`` have the
node-embedding mode of ``kgcn_tpu``'s ``_maybe_embed`` (``standard.py:
39-44``): built with ``in_features=None`` they look the batch's
``node_ids`` up in a ``NodeEmbedding_0`` table of ``all_node_num`` rows and
``embedding_dim`` columns instead of reading node features.  GIN and GAT
have no such mode there, nor here.

Dropout draws from the ``torch.Generator`` the trainer passes in
(``forward(batch, train, generator)``), as the JAX models draw from the
``dropout`` rng stream; the two give different masks from one seed.
"""
from __future__ import annotations

from typing import Optional

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


def _embedding(in_features, all_node_num, embedding_dim):
    """(the first layer's input width, the ``NodeEmbedding`` of
    node-embedding mode or None): features of ``in_features`` columns, or
    with ``in_features`` None an ``all_node_num × embedding_dim`` table."""
    if in_features is not None:
        return in_features, None
    if not all_node_num:
        raise ValueError("node-embedding mode needs all_node_num (the dataset's "
                         "node_num)")
    return embedding_dim, knn.NodeEmbedding(int(all_node_num), int(embedding_dim))


def _inputs(model, g):
    """Node features, or in node-embedding mode the embedded node ids
    (``kgcn_tpu``'s ``_maybe_embed``)."""
    emb = getattr(model, "NodeEmbedding_0", None)
    if emb is None:
        if g.nodes is None:
            raise ValueError(f"{type(model).__name__} was built for node features, "
                             "and the batch has none")
        return g.nodes
    return emb(g)


def _reset_embedding(model, generator):
    emb = getattr(model, "NodeEmbedding_0", None)
    if emb is not None:
        emb.reset_parameters(generator)


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

    def __init__(self, in_features: Optional[int], channels: int = 1,
                 label_dim: int = 2, hidden: int = 50, dropout_rate: float = 0.2,
                 all_node_num: Optional[int] = None, embedding_dim: int = 10):
        super().__init__()
        self.dropout_rate = dropout_rate
        in_features, emb = _embedding(in_features, all_node_num, embedding_dim)
        if emb is not None:
            self.NodeEmbedding_0 = emb
        self.GraphConv_0 = knn.GraphConv(in_features, hidden, channels)
        self.GraphConv_1 = knn.GraphConv(hidden, hidden, channels)
        self.GraphConv_2 = knn.GraphConv(hidden, hidden, channels)
        self.GraphBatchNormalization_0 = knn.GraphBatchNormalization(hidden)
        self.GraphDense_0 = knn.GraphDense(hidden, hidden)
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = knn.Dense(hidden, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """Draw every parameter from ``generator`` (layer order fixed)."""
        _reset_embedding(self, generator)
        for layer in (self.GraphConv_0, self.GraphConv_1, self.GraphConv_2,
                      self.GraphBatchNormalization_0, self.GraphDense_0):
            layer.reset_parameters(generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        x = torch.sigmoid(self.GraphConv_0(_inputs(self, g), g))
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
        self.Dense_0 = knn.Dense(2 * hidden, label_dim)
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

    def __init__(self, in_features: Optional[int], channels: int = 1,
                 label_dim: int = 2, hidden: int = 128,
                 all_node_num: Optional[int] = None, embedding_dim: int = 10):
        super().__init__()
        in_features, emb = _embedding(in_features, all_node_num, embedding_dim)
        if emb is not None:
            self.NodeEmbedding_0 = emb
        self.GraphConv_0 = knn.GraphConv(in_features, hidden, channels)
        self.GraphConv_1 = knn.GraphConv(hidden, hidden, channels)
        self.GraphConv_2 = knn.GraphConv(hidden, hidden, channels)
        self.GraphBatchNormalization_0 = knn.GraphBatchNormalization(hidden)
        self.GraphBatchNormalization_1 = knn.GraphBatchNormalization(hidden)
        self.GraphBatchNormalization_2 = knn.GraphBatchNormalization(hidden)
        self.GraphDense_0 = knn.GraphDense(hidden, hidden)
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = knn.Dense(hidden, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _reset_embedding(self, generator)
        _reset((self.GraphConv_0, self.GraphConv_1,
                self.GraphConv_2, self.GraphBatchNormalization_0,
                self.GraphBatchNormalization_1, self.GraphBatchNormalization_2,
                self.GraphDense_0), generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        x = _inputs(self, g)
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
        self.Dense_0 = knn.Dense(num_blocks * hidden, label_dim)
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

    def __init__(self, in_features: Optional[int], channels: int = 1,
                 label_dim: int = 12, hidden: int = 50, wide_hidden: int = 256,
                 pos_weight=None, all_node_num: Optional[int] = None,
                 embedding_dim: int = 10):
        super().__init__()
        self.pos_weight = None if pos_weight is None else tuple(
            float(p) for p in pos_weight)
        in_features, emb = _embedding(in_features, all_node_num, embedding_dim)
        if emb is not None:
            self.NodeEmbedding_0 = emb
        self.GraphConv_0 = knn.GraphConv(in_features, wide_hidden, channels)
        self.GraphConv_1 = knn.GraphConv(wide_hidden, wide_hidden, channels)
        self.GraphDense_0 = knn.GraphDense(wide_hidden, wide_hidden)
        self.GraphConv_2 = knn.GraphConv(wide_hidden, hidden, channels)
        self.GraphBatchNormalization_0 = knn.GraphBatchNormalization(hidden)
        self.GraphDense_1 = knn.GraphDense(hidden, hidden)
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = knn.Dense(hidden, label_dim)
        self.reset_parameters()

    def _pos_weight_on(self, device) -> torch.Tensor:
        """``pos_weight`` as a tensor on ``device``, copied there once (the
        first, eager call of a captured step makes it; the capture may not
        copy from the host)."""
        cache = self.__dict__.setdefault("_pos_weight_cache", {})
        if device not in cache:
            cache[device] = torch.tensor(self.pos_weight, dtype=torch.float32,
                                         device=device)
        return cache[device]

    def reset_parameters(self, generator=None) -> None:
        _reset_embedding(self, generator)
        _reset((self.GraphConv_0, self.GraphConv_1,
                self.GraphDense_0, self.GraphConv_2,
                self.GraphBatchNormalization_0, self.GraphDense_1), generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        x = torch.sigmoid(self.GraphConv_0(_inputs(self, g), g))
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
            pw = self._pos_weight_on(logits.device)
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


class GCNNodeLabel(nn.Module):
    """Node-centric classification: 2 × (GraphConv + GraphBN + relu) →
    GraphConv(label_dim) → a softmax per node (reference: example_model/
    model_node_label.py:30-76, as ``kgcn_tpu``'s ``GCNNodeLabel``,
    ``standard.py:253-302``).  The cost and the accuracy average over each
    graph's valid nodes (``iota < n_node``, made on the device, times
    ``mask_node_label`` where the dataset has one): ``kgcn_tpu``'s fix over
    the reference, which averaged over every padded slot."""

    def __init__(self, in_features: Optional[int], channels: int = 1,
                 label_dim: int = 2, hidden: int = 64,
                 all_node_num: Optional[int] = None, embedding_dim: int = 10):
        super().__init__()
        self.label_dim = label_dim
        in_features, emb = _embedding(in_features, all_node_num, embedding_dim)
        if emb is not None:
            self.NodeEmbedding_0 = emb
        self.GraphConv_0 = knn.GraphConv(in_features, hidden, channels)
        self.GraphBatchNormalization_0 = knn.GraphBatchNormalization(hidden)
        self.GraphConv_1 = knn.GraphConv(hidden, hidden, channels)
        self.GraphBatchNormalization_1 = knn.GraphBatchNormalization(hidden)
        self.GraphConv_2 = knn.GraphConv(hidden, label_dim, channels)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _reset_embedding(self, generator)
        _reset((self.GraphConv_0, self.GraphBatchNormalization_0, self.GraphConv_1,
                self.GraphBatchNormalization_1, self.GraphConv_2), generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        g = batch.graph.with_dense_adj()
        x = _inputs(self, g)
        for conv, bn in ((self.GraphConv_0, self.GraphBatchNormalization_0),
                         (self.GraphConv_1, self.GraphBatchNormalization_1)):
            x = torch.relu(bn(conv(x, g), g, use_running_average=not train))
        B, N = g.n_graph, g.max_nodes
        logits = self.GraphConv_2(x, g).reshape(B, N, self.label_dim).to(torch.float32)
        labels = batch.node_label.to(torch.float32)
        pad = batch.pad_mask
        iota = torch.arange(N, device=logits.device)
        node_valid = (iota[None, :] < g.n_node[:, None]).to(torch.float32)
        if batch.mask_node_label is not None:
            m = batch.mask_node_label.to(torch.float32)
            if m.dim() == 3:
                m = torch.amax(m, dim=-1)
            node_valid = node_valid * m
        denom = torch.clamp(torch.sum(node_valid, dim=1), min=1.0)  # [B]
        logp = F.log_softmax(logits, dim=-1)
        ce = -torch.sum(labels * logp, dim=-1)  # [B, N]
        cost = pad * (torch.sum(node_valid * ce, dim=1) / denom)
        prediction = F.softmax(logits, dim=-1)
        node_correct = (torch.argmax(prediction, -1)
                        == torch.argmax(labels, -1)).to(torch.float32)
        correct = pad * (torch.sum(node_valid * node_correct, dim=1) / denom)
        metrics = {"correct_count": torch.sum(correct), "count": torch.sum(pad)}
        return ModelOutput(prediction, torch.mean(cost), torch.sum(cost), metrics)
