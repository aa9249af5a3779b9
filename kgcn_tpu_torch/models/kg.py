"""Knowledge-graph link prediction — the counterpart of
``kgcn_tpu/models/kg.py`` (reference: sample_kg/network_prediction/model_py/
{distmult,gcn,gin}.py and the preference-pair feed kgcn/feed.py:33-86).

One big multi-relation graph (batch 1, node-embedding mode) trained on
preference pairs: a positive triple (h, r, t) against a corrupted negative
(h', r', t'), loss ``softplus(s_neg − s_pos + γ)`` (distmult.py:52-56 in its
gradient-stable form).  Triples are ``label_list`` rows
``[h, r, t, h_neg, r_neg, t_neg]``.

``KGBatcher`` builds the whole graph once (through ``Batcher.make_batch``:
on the stream backend it carries one ``StreamCOO`` per relation channel)
and yields it with per-step label slices and fresh negatives, drawn from
``np.random.RandomState(seed)`` in ``kgcn_tpu``'s order, so one seed gives
both packages the same slices and negatives.  Training takes the scanned
epoch (``epoch_scan_inputs`` / ``make_scan_batch``, as
``kgcn_tpu/models/kg.py:218-231``): the graph stays on the device and only
the epoch's label slices move there, in one copy; on the card each step is
replayed from one captured CUDA graph (``runtime/runner.py``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch, Batcher, as_tensor
from kgcn_tpu_torch.models.base import ModelOutput
from kgcn_tpu_torch.nn import layers as knn


def sample_negatives(label_list: np.ndarray, all_nodes: np.ndarray,
                     rng: np.random.RandomState, mode: str = "both") -> np.ndarray:
    """Fill columns 3..5 with a corrupted copy of the positive triple
    (reference: get_preference_label_list_feed, kgcn/feed.py:33-86;
    ``preference_pair_mode`` right / left / both)."""
    out = np.array(label_list, dtype=np.int32, copy=True)
    n = len(out)
    neg = rng.choice(all_nodes, (n,))
    if mode == "right":
        out[:, 3] = out[:, 0]
        out[:, 4] = out[:, 1]
        out[:, 5] = neg
    elif mode == "left":
        out[:, 3] = neg
        out[:, 4] = out[:, 1]
        out[:, 5] = out[:, 2]
    else:  # both: corrupt one random side
        out[:, 3] = out[:, 0]
        out[:, 4] = out[:, 1]
        out[:, 5] = out[:, 2]
        side = rng.choice([3, 5], (n,))
        out[np.arange(n), side] = neg
    return out


class KGLinkPredictor(nn.Module):
    """Node-embedding encoder, optionally refined by two graph
    convolutions (``encoder`` "gcn": GraphConv + tanh; "gin": GINAggregate +
    tanh), and a DistMult scorer.  Submodule names are ``kgcn_tpu``'s
    (``embed``, ``conv1``, ``conv2``, ``distmult``)."""

    def __init__(self, all_node_num: int, embedding_dim: int = 10,
                 channels: int = 1, encoder: str = "embedding", gamma: float = 0.1):
        super().__init__()
        if encoder not in ("embedding", "gcn", "gin"):
            raise ValueError(f"kg_encoder must be embedding, gcn or gin, got {encoder!r}")
        self.encoder = encoder
        self.gamma = gamma
        self.embed = knn.Embed(all_node_num, embedding_dim)
        if encoder == "gcn":
            self.conv1 = knn.GraphConv(embedding_dim, embedding_dim, channels)
            self.conv2 = knn.GraphConv(embedding_dim, embedding_dim, channels)
        elif encoder == "gin":
            self.conv1 = knn.GINAggregate(channels)
            self.conv2 = knn.GINAggregate(channels)
        self.distmult = knn.DistMult(embedding_dim, channels)

    def reset_parameters(self, generator=None) -> None:
        self.embed.reset_parameters(generator)
        if self.encoder != "embedding":
            self.conv1.reset_parameters(generator)
            self.conv2.reset_parameters(generator)
        self.distmult.reset_parameters(generator)

    def node_embeddings(self, batch: Batch) -> torch.Tensor:
        g = batch.graph.with_dense_adj()
        x = self.embed(g.node_ids) * g.node_mask[:, None]
        if self.encoder != "embedding":
            x = torch.tanh(self.conv1(x, g))
            x = torch.tanh(self.conv2(x, g))
        return x  # [V, dim]

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        z = self.node_embeddings(batch)
        ll = batch.label_list[0].long()  # [L, 6]: batch 1, whole graph
        s1 = self.distmult.score(z[ll[:, 0]], z[ll[:, 2]], ll[:, 1])
        s2 = self.distmult.score(z[ll[:, 3]], z[ll[:, 5]], ll[:, 4])
        # -log(1/(1+exp(s))) == softplus(s), as jax.nn.softplus computes it
        score = s2 - s1 + self.gamma
        cost = torch.logaddexp(score, torch.zeros_like(score))
        # wrap-padded slice rows must not count twice
        lv = (batch.label_valid[0] if batch.label_valid is not None
              else torch.ones(ll.shape[0], device=z.device))
        cost = cost * lv
        n = torch.clamp(torch.sum(lv), min=1.0)
        metrics = {
            "correct_count": torch.sum((s1 > s2).to(torch.float32) * lv),
            "count": torch.sum(lv),
        }
        return ModelOutput(prediction=z[None], cost_opt=torch.sum(cost) / n,
                           cost_sum=torch.sum(cost), metrics=metrics)

    def left_prediction(self, batch: Batch, tails, relations) -> torch.Tensor:
        """Score every entity as head for each (r, t): ``[K, V]``
        (reference: distmult.py:63-66)."""
        z = self.node_embeddings(batch)
        return self.distmult.left_prediction(z, z[tails.long()], relations)

    def right_prediction(self, batch: Batch, heads, relations) -> torch.Tensor:
        z = self.node_embeddings(batch)
        return self.distmult.right_prediction(z[heads.long()], z, relations)


class KGBatcher:
    """Whole-graph batches with label-list slices and fresh negatives
    (the reference's ``label_batch_size`` inner iteration, kgcn/core.py:
    219-222,258, and per-step negative resampling, kgcn/feed.py:33-86).

    ``backend``: the resolved backend of the graph batch; ``device``: where
    the graph batch is moved once (the per-step label slices follow)."""

    def __init__(self, ds, info, *, label_batch_size: Optional[int] = None,
                 pair_mode: str = "both", seed: int = 0, test: bool = False,
                 backend=None, device=None):
        self.ds = ds
        self.info = info
        base = Batcher(ds, info, batch_size=1, seed=seed, backend=backend)
        self.graph_batch = base.make_batch(np.arange(1))
        self.host_seconds = base.host_seconds
        self.stream_seconds = base.stream_seconds
        if device is not None:
            self.graph_batch = self.graph_batch.to(device)
        self.label_list = np.asarray(ds.label_list[0], dtype=np.int32)
        if self.label_list.shape[1] == 3:  # pad pos-only triples to 6 cols
            self.label_list = np.concatenate([self.label_list, self.label_list], axis=1)
        self.label_batch_size = label_batch_size or len(self.label_list)
        self.pair_mode = pair_mode
        self.all_nodes = np.arange(info.all_node_num, dtype=np.int32)
        self._rng = np.random.RandomState(seed)
        self.test = test

    @property
    def num_labels(self) -> int:
        return len(self.label_list)

    @property
    def valid_per_epoch(self) -> int:
        # one whole-graph "example" per label slice
        L = self.label_batch_size
        return (self.num_labels + L - 1) // L

    def batch_valid_counts(self):
        return [1] * self.valid_per_epoch

    def _epoch_label_lists(self, shuffle: bool):
        """([S, L, 6] label slices, [S, L] validity) of one epoch: the
        shuffle, then each slice's negatives, in ``kgcn_tpu``'s draw order;
        the last slice wraps cyclically."""
        order = np.arange(self.num_labels)
        if shuffle:
            self._rng.shuffle(order)
        L = self.label_batch_size
        slices, valids = [], []
        for start in range(0, self.num_labels, L):
            idx = order[start : start + L]
            n_real = len(idx)
            if n_real < L:
                idx = np.resize(idx, L)
            ll = self.label_list[idx]
            if not self.test:
                ll = sample_negatives(ll, self.all_nodes, self._rng, self.pair_mode)
            slices.append(ll)
            valids.append((np.arange(L) < n_real).astype(np.float32))
        return np.stack(slices), np.stack(valids)

    def _with_labels(self, ll: np.ndarray, lv: np.ndarray) -> Batch:
        dev = self.graph_batch.graph.senders.device
        return self.graph_batch.replace(label_list=as_tensor(ll[None]).to(dev),
                                        label_valid=as_tensor(lv[None]).to(dev))

    def init_batch(self) -> Batch:
        """The first label slice with positives echoed as negatives; draws
        nothing from the generator."""
        L = self.label_batch_size
        idx = np.arange(L) % self.num_labels
        lv = (np.arange(L) < self.num_labels).astype(np.float32)
        return self._with_labels(self.label_list[idx], lv)

    def batches(self, shuffle: bool = True, epoch: Optional[int] = None):
        """One epoch of batches.  ``epoch`` is accepted for the Trainer's
        call and ignored: the order advances the seeded generator, as in
        ``kgcn_tpu``."""
        lls, lvs = self._epoch_label_lists(shuffle)
        for ll, lv in zip(lls, lvs):
            yield self._with_labels(ll, lv)

    # --- the scanned epoch (Trainer.epoch_on_device) ----------------------
    def epoch_scan_inputs(self, shuffle: bool = True, epoch: Optional[int] = None):
        """(constant batch, per-step inputs): the graph batch, which stays
        on the device, and the epoch's ``[S, 1, L, 6]`` int32 label slices
        and ``[S, 1, L]`` float32 validity (NumPy; the runner moves them in
        one copy), drawn as ``batches`` draws them."""
        lls, lvs = self._epoch_label_lists(shuffle)
        return self.graph_batch, (lls[:, None].astype(np.int32), lvs[:, None])

    @staticmethod
    def make_scan_batch(const_batch: Batch, x, generator=None) -> Batch:
        """Step ``x``'s batch (the runner's ``generator``: nothing is drawn)."""
        ll, lv = x
        return const_batch.replace(label_list=ll, label_valid=lv)
