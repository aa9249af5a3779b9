"""Pairwise preference ranking (RankNet) over graph pairs — the counterpart
of ``kgcn_tpu/models/pair.py`` (reference: gcn_pair.py and
example_model/model_pair.py:60-172).

A shared GCN tower scores each graph of a preference pair (``b``, the
second graph of the pair, preferred); the cost is RankNet's
``−log σ(s1 − s0)`` (model_pair.py:140-142) in its softplus form;
``correct_count`` counts the pairs ranked the right way.

``PairBatcher`` serves both towers from one streaming ``Batcher``;
``ResidentPairBatcher`` gathers both towers' graphs on the device from one
``DeviceDataset`` in each step of the trainer's scanned epoch (on the card
each step replayed from one captured CUDA graph, ``runtime/runner.py``).
Pairs are shuffled by the batcher's own ``RandomState``, epoch after epoch,
as ``kgcn_tpu``'s pair batchers shuffle them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch, Batcher, epoch_permutation
from kgcn_tpu_torch.models.base import ModelOutput
from kgcn_tpu_torch.models.standard import dropout
from kgcn_tpu_torch.nn import layers as knn
from kgcn_tpu_torch.runtime.resident import build_device_dataset, gather_batch


@dataclasses.dataclass
class PairBatch:
    """Two aligned graph batches: ``b`` is the preferred graph of each pair."""

    a: Batch
    b: Batch

    @property
    def pad_mask(self) -> torch.Tensor:
        return self.a.pad_mask

    def to(self, device) -> "PairBatch":
        return PairBatch(a=self.a.to(device), b=self.b.to(device))


class GCNPairRanker(nn.Module):
    """The shared tower (GraphConv × 3 + GraphMaxPooling + BN + GraphDense +
    GraphGather → score), applied to both graphs; RankNet cost.  Submodule
    names are the flax ``setup`` ones."""

    def __init__(self, in_features: int, channels: int = 1, label_dim: int = 1,
                 hidden: int = 32, dropout_rate: float = 0.2):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.conv1 = knn.GraphConv(in_features, hidden, channels)
        self.conv2 = knn.GraphConv(hidden, hidden, channels)
        self.conv3 = knn.GraphConv(hidden, hidden, channels)
        self.maxpool = knn.GraphMaxPooling()
        self.bn = knn.GraphBatchNormalization(hidden)
        self.dense = knn.GraphDense(hidden, hidden)
        self.gather = knn.GraphGather()
        self.head = knn.Dense(hidden, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        for layer in (self.conv1, self.conv2, self.conv3, self.bn, self.dense):
            layer.reset_parameters(generator)
        knn.reset_linear_(self.head, generator)

    def tower(self, batch: Batch, train: bool, generator=None) -> torch.Tensor:
        g = batch.graph.with_dense_adj()
        x = torch.sigmoid(self.conv1(batch.graph.nodes, g))
        x = torch.sigmoid(self.conv2(x, g))
        x = self.conv3(x, g)
        x = self.maxpool(x, batch.graph)  # the max pools over the edge lists
        x = torch.sigmoid(self.bn(x, g, use_running_average=not train))
        x = dropout(x, self.dropout_rate, train, generator)
        x = torch.sigmoid(self.dense(x, g))
        return self.head(self.gather(x, g))  # [B, label_dim]

    def forward(self, pair: PairBatch, train: bool = False, generator=None) -> ModelOutput:
        s0 = self.tower(pair.a, train, generator)
        s1 = self.tower(pair.b, train, generator)
        mask = pair.a.pad_mask
        # −log σ(s1 − s0) as softplus(s0 − s1): the literal form overflows
        # the backward once the score gap passes ~88 in float32
        cost = mask * F.softplus(s0[:, 0] - s1[:, 0])
        metrics = {
            "correct_count": torch.sum(mask * (s1[:, 0] > s0[:, 0])),
            "miss_count": torch.sum(mask * (s1[:, 0] < s0[:, 0])),
            "count": torch.sum(mask),
        }
        prediction = torch.stack([s0, s1], dim=1)  # [B, 2, label_dim]
        return ModelOutput(prediction, torch.mean(cost), torch.sum(cost), metrics)


def _valid_counts(n: int, bs: int):
    return [min(bs, n - s) for s in range(0, n, bs)]


class PairBatcher:
    """``PairBatch``es from a dataset and index pairs ``pairs[i] =
    (worse, better)`` (the reference's ``graph_index_list``,
    kgcn/feed_index.py:8-111).  One ``Batcher`` serves both towers."""

    def __init__(self, ds, info, pairs, batch_size: int, seed: int = 0, backend=None):
        self.batcher = Batcher(ds, info, batch_size, seed=seed, backend=backend)
        self.pairs = np.asarray(pairs)
        self.batch_size = int(batch_size)
        self.ds = ds
        self._rng = np.random.RandomState(seed)

    @property
    def valid_per_epoch(self) -> int:
        return len(self.pairs)

    def batch_valid_counts(self):
        return _valid_counts(len(self.pairs), self.batch_size)

    def make_batch(self, pair_idx) -> PairBatch:
        p = self.pairs[np.asarray(pair_idx)]
        self.last_valid = len(p)
        return PairBatch(a=self.batcher.make_batch(p[:, 0]),
                         b=self.batcher.make_batch(p[:, 1]))

    def batches(self, shuffle: bool = True, epoch: Optional[int] = None):
        """One pass over the pairs; ``epoch`` is not read (the order comes
        from the batcher's ``RandomState``, as in ``kgcn_tpu``)."""
        order = np.arange(len(self.pairs))
        if shuffle:
            self._rng.shuffle(order)
        for start in range(0, len(order), self.batch_size):
            yield self.make_batch(order[start:start + self.batch_size])


class ResidentPairBatcher:
    """The dataset on the device once; each step gathers BOTH towers' graphs
    there (``epoch_scan_inputs`` / ``make_scan_batch``: the trainer's
    scanned epoch, no host work a step)."""

    def __init__(self, ds, info, pairs, batch_size: int, seed: int = 0, backend=None,
                 device="cpu"):
        self.device_data = build_device_dataset(ds, info, backend=backend, device=device)
        self.pairs = np.asarray(pairs)
        self.batch_size = int(batch_size)
        self.ds = ds
        self.seed = int(seed)
        self._rng = np.random.RandomState(seed)

    @property
    def valid_per_epoch(self) -> int:
        return len(self.pairs)

    def batch_valid_counts(self):
        return _valid_counts(len(self.pairs), self.batch_size)

    def _schedule(self, shuffle: bool):
        """[S, B] int32 indices of each tower's graphs and [S, B] float32
        validity of one epoch (NumPy)."""
        order = epoch_permutation(len(self.pairs), self.seed, None,
                                  rng=self._rng if shuffle else None)
        B = self.batch_size
        S = -(-len(order) // B)
        p = np.zeros((S * B, 2), np.int32)
        p[:len(order)] = self.pairs[order]
        valid = (np.arange(S * B) < len(order)).astype(np.float32)
        return p[:, 0].reshape(S, B), p[:, 1].reshape(S, B), valid.reshape(S, B)

    def epoch_scan_inputs(self, shuffle: bool = True, epoch: Optional[int] = None):
        """(this batcher, the epoch's per-step tower indices and validity);
        ``epoch`` is not read, as in ``kgcn_tpu``."""
        return self, self._schedule(shuffle)

    @staticmethod
    def make_scan_batch(const: "ResidentPairBatcher", x, generator=None) -> PairBatch:
        ia, ib, v = x
        dd = const.device_data
        return PairBatch(a=gather_batch(dd, ia, v), b=gather_batch(dd, ib, v))

    def _gather(self, ia, ib, v) -> PairBatch:
        dev = self.device_data.device
        return self.make_scan_batch(self, tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                                                for a in (ia, ib, v)))

    def make_batch(self, pair_idx) -> PairBatch:
        p = self.pairs[np.asarray(pair_idx)]
        B = self.batch_size
        ia, ib = np.zeros(B, np.int32), np.zeros(B, np.int32)
        ia[:len(p)], ib[:len(p)] = p[:, 0], p[:, 1]
        self.last_valid = len(p)
        return self._gather(ia, ib, (np.arange(B) < len(p)).astype(np.float32))

    def batches(self, shuffle: bool = True, epoch: Optional[int] = None):
        ia, ib, v = self._schedule(shuffle)
        for s in range(ia.shape[0]):
            yield self._gather(ia[s], ib[s], v[s])
