"""Block-diagonal sparse GCN for classification over many labels (reaction
prediction: 20,014 classes) — the counterpart of
``kgcn_tpu/models/sparse.py`` (reference: example_model/sparse.py:14-139,
driven by task_sparse_gcn.py, ``kgcn-sparse``).

GraphConv stack + relu → GraphDense + BN + relu → per-graph sum readout →
tanh → Dense(num_classes); softmax cross-entropy SUMMED over the batch (the
reference optimises the sum, sparse.py:109-110), accuracy and the top-k
counts (in_top_k: the label's probability at least the k-th largest, ties
counted) for each k below the class count.

Graphs of up to ``runtime/backend.DENSE_MAX_NODES`` padded nodes aggregate
on the dense adjacency (the CUDA gconv kernel); beyond it the layers take the
batch's edge-list route (the resolved backend: ``auto`` gives block-diagonal
batches the tiled kernel).  The backend owns the threshold, so the model
takes the route the batches were built for.  The head is a plain
matrix product (``knn.Dense`` in the features' dtype, as ``kgcn_tpu``'s
``nn.Dense(dtype=h.dtype)``), which ``kgcn_tpu`` leaves to XLA.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.models.base import ModelOutput
from kgcn_tpu_torch.nn import layers as knn
from kgcn_tpu_torch.runtime.backend import DENSE_MAX_NODES


class SparseGCN(nn.Module):
    """GraphConv(256) × 3 + relu → GraphDense(256) + BN + relu → sum readout →
    tanh → Dense(num_classes).  Submodule names are the flax ones."""

    def __init__(self, in_features: int, channels: int = 1, num_classes: int = 2,
                 out_dims: Tuple[int, ...] = (256, 256, 256), dense_dim: int = 256,
                 batch_normalize: bool = True, topk: Tuple[int, ...] = (30, 50)):
        super().__init__()
        self.num_classes = int(num_classes)
        self.topk = tuple(int(k) for k in topk)
        self.batch_normalize = bool(batch_normalize)
        self.n_conv = len(out_dims)
        dims = (in_features, *out_dims)
        for i in range(self.n_conv):
            setattr(self, f"GraphConv_{i}", knn.GraphConv(dims[i], dims[i + 1], channels))
        self.GraphDense_0 = knn.GraphDense(dims[-1], dense_dim)
        if self.batch_normalize:
            self.GraphBatchNormalization_0 = knn.GraphBatchNormalization(dense_dim)
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = knn.Dense(dense_dim, self.num_classes, promote=False)  # in h's dtype
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        for i in range(self.n_conv):
            getattr(self, f"GraphConv_{i}").reset_parameters(generator)
        self.GraphDense_0.reset_parameters(generator)
        if self.batch_normalize:
            self.GraphBatchNormalization_0.reset_parameters(generator)
        knn.reset_linear_(self.Dense_0, generator)

    def forward(self, batch: Batch, train: bool = False, generator=None) -> ModelOutput:
        g = batch.graph
        if g.max_nodes <= DENSE_MAX_NODES:
            g = g.with_dense_adj()
        x = g.nodes
        for i in range(self.n_conv):
            x = torch.relu(getattr(self, f"GraphConv_{i}")(x, g))
        x = self.GraphDense_0(x, g)
        if self.batch_normalize:
            x = self.GraphBatchNormalization_0(x, g, use_running_average=not train)
        h = torch.tanh(self.GraphGather_0(torch.relu(x), g))
        logits = self.Dense_0(h).to(torch.float32)

        labels = batch.labels
        if labels.dim() > 1:
            labels = labels[:, 0]  # the first task column (sparse.py:108)
        labels = labels.long()[:, None]
        pad = batch.pad_mask
        cost = -torch.gather(F.log_softmax(logits, dim=-1), 1, labels)[:, 0] * pad
        probs = F.softmax(logits, dim=-1)
        label_p = torch.gather(probs, 1, labels)[:, 0]
        metrics = {
            "correct_count": torch.sum(pad * (torch.argmax(probs, dim=-1) == labels[:, 0])),
            "count": torch.sum(pad),
        }
        for k in self.topk:
            if k < self.num_classes:
                # the k-th largest probability without sorting every column;
                # >= counts ties as kgcn_tpu's sort does
                kth = torch.topk(probs, k, dim=-1).values[:, -1]
                metrics[f"top{k}_count"] = torch.sum(pad * (label_p >= kth))
        total = torch.sum(cost)
        return ModelOutput(probs, total, total, metrics)
