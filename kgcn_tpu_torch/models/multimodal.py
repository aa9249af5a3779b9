"""Multimodal (compound–protein interaction) models and graph regression —
the counterparts of ``kgcn_tpu/models/multimodal.py``.

* ``GCNMultimodal``: the graph branch (GraphConv → GraphDense →
  GraphGather, through the dense adjacency, so through the gconv kernel)
  ‖ the sequence branch (``nn/multimodal.SequenceEncoder``) → Dense(52) →
  Dense(labels) (reference: example_model/model_multimodal.py:32-126);
* ``GCNVectorModal``: the graph branch ‖ one ``VectorModalEncoder`` per
  vector modal (reference: model_multimodal_vec.py);
* ``SequenceCNN``: the sequence-only CNN baseline (reference:
  sample_protein/sequence/cnn.py:9-25);
* ``GCNRegression``: the graph-only regression head.

A ``task`` containing ``"regression"`` gives the multimodal models the
squared-error head (``error_sum``/``count`` metrics), as in ``kgcn_tpu``.
Submodule names are the flax ones (``gconv``, ``gdense``, ``seq_enc``,
``shared1``, ``head``, ``modal_encs_<i>`` of ``setup``; ``Conv_0`` …
elsewhere).
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.models.base import ModelOutput
from kgcn_tpu_torch.models.standard import _reset, dropout, softmax_ce_cost
from kgcn_tpu_torch.nn import layers as knn
from kgcn_tpu_torch.nn.multimodal import (Conv1dSame, SequenceEncoder,
                                          VectorModalEncoder, max_pool)


def _squared_error(pred, batch: Batch) -> ModelOutput:
    """The multimodal regression head: per-example squared error summed
    over outputs, times ``pad_mask``."""
    err = torch.sum((batch.labels.to(pred.dtype) - pred) ** 2, dim=1) * batch.pad_mask
    metrics = {"error_sum": torch.sum(err), "count": torch.sum(batch.pad_mask)}
    return ModelOutput(pred, torch.mean(err), torch.sum(err), metrics)


def _head(logits, batch: Batch, task: str) -> ModelOutput:
    if task == "regression":
        return _squared_error(logits, batch)
    cost_opt, cost_sum, pred, metrics = softmax_ce_cost(logits, batch.labels,
                                                        batch.pad_mask)
    return ModelOutput(pred, cost_opt, cost_sum, metrics)


class _GraphBranch(nn.Module):
    """GraphConv + sigmoid → GraphDense + sigmoid → GraphGather; the
    layers sit on the model under flax's ``setup`` names."""

    def _graph_layers(self, in_features, channels, hidden):
        self.gconv = knn.GraphConv(in_features, hidden, channels)
        self.gdense = knn.GraphDense(hidden, hidden)
        self.gather = knn.GraphGather()

    def graph_branch(self, batch: Batch) -> torch.Tensor:
        g = batch.graph.with_dense_adj()
        if g.nodes is None:
            raise ValueError(f"{type(self).__name__} needs node features")
        x = torch.sigmoid(self.gconv(g.nodes, g))
        x = torch.sigmoid(self.gdense(x, g))
        return self.gather(x, g)


class GCNMultimodal(_GraphBranch):
    """Graph ‖ sequence → Dense(52) + relu → Dense(labels)."""

    def __init__(self, in_features: int, channels: int = 1, label_dim: int = 2,
                 hidden: int = 50, sequence_symbol_num: int = 25,
                 embedding_dim: int = 10, lstm_features: int = 32,
                 task: str = "classification"):
        super().__init__()
        self.task = task
        self._graph_layers(in_features, channels, hidden)
        self.seq_enc = SequenceEncoder(sequence_symbol_num, embedding_dim,
                                       lstm_features=lstm_features)
        self.shared1 = knn.Dense(lstm_features + hidden, 52)
        self.head = knn.Dense(52, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _reset((self.gconv, self.gdense, self.seq_enc), generator)
        knn.reset_linear_(self.shared1, generator)
        knn.reset_linear_(self.head, generator)

    def embedding(self, sequences: torch.Tensor) -> torch.Tensor:
        """The sequence-embedding hook of IG on embeddings (reference:
        model_multimodal.py:122-126): ``[B, L, embedding_dim]``."""
        return self.seq_enc(sequences, return_embedded=True)

    def forward(self, batch: Batch, train: bool = False,
                generator=None, embedded=None) -> ModelOutput:
        """``embedded``: the sequence embedding to use in place of the
        sequences' (``embedding``'s output, scaled by IG)."""
        gh = self.graph_branch(batch)
        if batch.sequences is None:
            raise ValueError("gcn_multimodal needs a 'sequence' entry in the dataset "
                             "(this batch carries none)")
        sh = self.seq_enc(batch.sequences, embedded=embedded)
        h = torch.relu(self.shared1(torch.cat([sh, gh], dim=1)))
        return _head(self.head(h), batch, self.task)


class GCNVectorModal(_GraphBranch):
    """Graph ‖ one dense encoder per vector modal → Dense(52) + relu →
    Dense(labels).  ``modal_dims``: each modal's width (the dataset's
    ``vector_modal_dim``)."""

    def __init__(self, in_features: int, modal_dims: Sequence[int],
                 channels: int = 1, label_dim: int = 2, hidden: int = 50,
                 task: str = "classification"):
        super().__init__()
        self.task = task
        # a dataset without modals still gets one encoder, as kgcn_tpu's
        # max(len(dims), 1); its forward then refuses the batch
        dims = list(modal_dims) or [1]
        self.num_modals = len(dims)
        self._graph_layers(in_features, channels, hidden)
        for i, d in enumerate(dims):
            setattr(self, f"modal_encs_{i}", VectorModalEncoder(int(d), features=32))
        self.shared1 = knn.Dense(hidden + 32 * len(dims), 52)
        self.head = knn.Dense(52, label_dim)
        self.reset_parameters()

    def modal_encs(self):
        return [getattr(self, f"modal_encs_{i}") for i in range(self.num_modals)]

    def reset_parameters(self, generator=None) -> None:
        _reset((self.gconv, self.gdense, *self.modal_encs()), generator)
        knn.reset_linear_(self.shared1, generator)
        knn.reset_linear_(self.head, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        gh = self.graph_branch(batch)
        if batch.vector_modal is None:
            raise ValueError(
                "gcn_vector_modal needs a 'vector_modal' entry in the "
                "dataset (this batch carries none)"
            )
        if len(batch.vector_modal) != self.num_modals:
            raise ValueError(
                f"dataset has {len(batch.vector_modal)} vector modalities "
                f"but the model was built with {self.num_modals} — "
                "zip would silently drop the extras"
            )
        parts = [gh] + [enc(v, train=train, generator=generator)
                        for enc, v in zip(self.modal_encs(), batch.vector_modal)]
        h = torch.relu(self.shared1(torch.cat(parts, dim=1)))
        return _head(self.head(h), batch, self.task)


class SequenceCNN(nn.Module):
    """Embed → Conv1D(5, relu) → MaxPool(2) → Conv1D(5, relu) → global max
    over the sequence → Dense(labels), softmax cross entropy."""

    def __init__(self, vocab_size: int = 25, label_dim: int = 2,
                 embedding_dim: int = 10, conv_features: int = 64):
        super().__init__()
        self.Embed_0 = knn.Embed(vocab_size, embedding_dim)
        self.Conv_0 = Conv1dSame(embedding_dim, conv_features, 5)
        self.Conv_1 = Conv1dSame(conv_features, conv_features, 5)
        self.Dense_0 = knn.Dense(conv_features, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        _reset((self.Embed_0, self.Conv_0, self.Conv_1), generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        x = self.Embed_0(batch.sequences)
        x = max_pool(torch.relu(self.Conv_0(x)), 2)
        x = torch.relu(self.Conv_1(x))
        return _head(self.Dense_0(torch.amax(x, dim=1)), batch, "classification")


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
        self.Dense_0 = knn.Dense(hidden, label_dim)
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

