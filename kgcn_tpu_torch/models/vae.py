"""Graph VAE — the counterpart of ``kgcn_tpu/models/vae.py`` (reference:
example_model/model_vae.py:63-259, driven by gcn_gen.py, the ``kgcn-gen``
engine).

Encoder: GraphConv × 2 (BN + tanh) → GraphDense + sigmoid → GraphGather →
(μ, σ) heads with the reference's clipping; the reparameterisation reads ε
from the batch (``Batch.rng_normal``, the reference's fed ``epsilon``,
kgcn/feed_index.py:107-109; zeros when the batch has none).  Decoders: a
per-node GraphDense feature decoder and a per-channel DistMult link
decoder.  Loss: BCE(features) + BCE(adjacency) + the reference's
non-standard KL term ``−½ Σ (1 + 2 log σ − μ² − σ)`` verbatim
(model_vae.py:176-183).  The prediction is a dict ``{"feature",
"dense_adj"}``.  The reconstruction target of the adjacency is the batch's
dense adjacency as the dataset gives it (normalised under
``normalize_adj_flag``), as in ``kgcn_tpu``.

``link_only=True`` is the reference's link-only variant
(example_model/model_vae_onlylink.py:155-235): no feature decoder, the
``pos_weight``-weighted adjacency CE scaled by ``norm`` (both from edge
density, computed by the engine, gcn_gen.py:51-74), its KL variant
``(0.5/70)·mean_D(Σ_N 1 + 2 log σ − z² − σ)`` and the cost
``|mean(cost) − mean(kl)|`` verbatim; the prediction's ``feature`` passes
the input features through.  The products of the decoders are einsums, as
``kgcn_tpu`` leaves them to XLA.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.models.base import ModelOutput
from kgcn_tpu_torch.nn import layers as knn


def _bce(labels, logits):
    """``tf.nn.sigmoid_cross_entropy_with_logits`` in float32."""
    logits = logits.to(torch.float32)
    return (torch.maximum(logits, torch.zeros_like(logits)) - logits * labels
            + F.softplus(-torch.abs(logits)))


def _weighted_bce(labels, logits, pos_weight: float):
    """``tf.nn.weighted_cross_entropy_with_logits`` in float32."""
    logits = logits.to(torch.float32)
    log_weight = 1.0 + (pos_weight - 1.0) * labels
    return (1.0 - labels) * logits + log_weight * (
        F.softplus(-torch.abs(logits)) + torch.maximum(-logits, torch.zeros_like(logits)))


class GCNVAE(nn.Module):
    """Graph VAE with feature and link decoders.  Submodule names are the
    flax ``setup`` ones (a list's entries named ``<name>_<c>``)."""

    def __init__(self, in_features: int, channels: int = 1, feature_dim: int = 0,
                 latent_dim: int = 64, internal_dim: int = 64, link_only: bool = False,
                 pos_weight: float = 1.0, norm: float = 1.0):
        super().__init__()
        self.channels = int(channels)
        self.feature_dim = int(feature_dim)
        self.latent_dim = int(latent_dim)
        self.link_only = bool(link_only)
        self.pos_weight = float(pos_weight)
        self.norm = float(norm)
        d = int(internal_dim)
        self.enc_conv1 = knn.GraphConv(in_features, d, channels)
        self.enc_bn1 = knn.GraphBatchNormalization(d)
        self.enc_conv2 = knn.GraphConv(d, d, channels)
        self.enc_bn2 = knn.GraphBatchNormalization(d)
        self.enc_dense = knn.GraphDense(d, d)
        self.gather = knn.GraphGather()
        self.mean_head = knn.Dense(d, self.latent_dim)
        self.std_head = knn.Dense(d, self.latent_dim)
        if not self.link_only:
            self.node_decoder = knn.GraphDense(self.latent_dim, self.feature_dim,
                                               mask_output=False)
        for c in range(self.channels):
            setattr(self, f"link_dense1_{c}", knn.GraphDense(self.latent_dim, d))
            setattr(self, f"link_bn_{c}", knn.GraphBatchNormalization(d))
            setattr(self, f"link_dense2_{c}", knn.GraphDense(d, d))
            setattr(self, f"link_decoder_{c}", knn.GraphDecoderDistMult(d))
        self.reset_parameters()

    def _link(self, name: str, c: int):
        return getattr(self, f"{name}_{c}")

    def reset_parameters(self, generator=None) -> None:
        for layer in (self.enc_conv1, self.enc_bn1, self.enc_conv2, self.enc_bn2,
                      self.enc_dense):
            layer.reset_parameters(generator)
        with torch.no_grad():  # flax's uniform(scale=0.05): U[0, 0.05)
            self.mean_head.weight.uniform_(0.0, 0.05, generator=generator)
            self.mean_head.bias.zero_()
        knn.reset_linear_(self.std_head, generator)
        if not self.link_only:
            self.node_decoder.reset_parameters(generator)
        for c in range(self.channels):
            for name in ("link_dense1", "link_bn", "link_dense2", "link_decoder"):
                self._link(name, c).reset_parameters(generator)

    def encode(self, batch: Batch, train: bool):
        g = batch.graph.with_dense_adj()
        x = g.nodes
        x = torch.tanh(self.enc_bn1(self.enc_conv1(x, g), g, use_running_average=not train))
        x = torch.tanh(self.enc_bn2(self.enc_conv2(x, g), g, use_running_average=not train))
        x = torch.sigmoid(self.enc_dense(x, g))
        h = self.gather(x, g)
        mean = torch.clamp(self.mean_head(h), -100.0, 100.0)
        std = torch.clamp(torch.sqrt(F.softplus(self.std_head(h))), max=5.0)
        return mean, std

    def decode(self, z, batch: Batch, train: bool):
        """z ``[V, latent]`` per-node latents → (feature logits ``[B, N, F]``
        or None, adjacency logits ``[B, C, N, N]``)."""
        g = batch.graph
        B, N = g.n_graph, g.max_nodes
        feat_logits = (None if self.link_only
                       else self.node_decoder(z, g).reshape(B, N, self.feature_dim))
        adjs = []
        for c in range(self.channels):
            h = torch.sigmoid(self._link("link_bn", c)(
                self._link("link_dense1", c)(z, g), g, use_running_average=not train))
            h = torch.sigmoid(self._link("link_dense2", c)(h, g))
            adjs.append(self._link("link_decoder", c)(h, g))  # [B, N, N]
        return feat_logits, torch.stack(adjs, dim=1)

    def forward(self, batch: Batch, train: bool = False, generator=None) -> ModelOutput:
        g = batch.graph
        B, N = g.n_graph, g.max_nodes
        mean, std = self.encode(batch, train)
        # one latent per node (reference: model_vae.py:168-173)
        mean_t = mean[:, None, :].expand(B, N, self.latent_dim)
        std_t = std[:, None, :].expand(B, N, self.latent_dim)
        eps = (batch.rng_normal if batch.rng_normal is not None
               else torch.zeros((B, N, self.latent_dim), device=mean.device))
        z = (mean_t + std_t * eps).reshape(B * N, self.latent_dim)

        # the reference's KL variant, verbatim (model_vae.py:176-183)
        e = 1.0e-10
        kl_el = 1.0 + 2.0 * torch.log(std_t + e) - mean_t ** 2 - std_t
        klqp = -0.5 * torch.mean(torch.sum(kl_el, dim=(1, 2)))

        feat_logits, adj_logits = self.decode(z, batch, train)

        # the targets: the batch's own graphs (gcn_gen.py:89-92 pairs each
        # graph with itself)
        target_feat = g.nodes.reshape(B, N, -1)
        target_adj = g.with_dense_adj().dense_adj.transpose(0, 1)  # [B, C, N, N]

        pad = batch.pad_mask
        if self.link_only:
            # model_vae_onlylink.py:201-216: pos_weight CE on the links,
            # norm scaling, the KL over the sampled z, |cost − kl|
            wce = _weighted_bce(target_adj, adj_logits, self.pos_weight)
            cost = pad * (self.norm * torch.mean(wce, dim=(1, 2, 3)))
            z_b = z.reshape(B, N, self.latent_dim)
            kl_el = 1.0 + 2.0 * torch.log(std_t + e) - z_b ** 2 - std_t
            kl = (0.5 / 70.0) * torch.mean(torch.sum(kl_el, dim=1), dim=1)
            cost_opt = torch.abs(torch.mean(cost) - torch.mean(kl))
        else:
            cost_features = torch.mean(_bce(target_feat, feat_logits), dim=2)  # [B, N]
            cost_links = torch.mean(_bce(target_adj, adj_logits), dim=(2, 3))  # [B, C]
            cost = pad * (torch.mean(cost_features, dim=1) + torch.mean(cost_links, dim=1))
            cost_opt = torch.mean(cost) + klqp
        cost_sum = torch.mean(cost)  # the reference's mean (model_vae.py:243)

        correct_exist = ((torch.amax(adj_logits, dim=1) > 0.0)
                         == (torch.amax(target_adj, dim=1) > 0.5)).to(torch.float32)
        correct = pad * torch.mean(correct_exist, dim=(1, 2))
        metrics = {"correct_count": torch.sum(correct), "count": torch.sum(pad)}
        prediction = {
            # link-only passes the input features through (model_vae_onlylink.py:233)
            "feature": target_feat if self.link_only else torch.sigmoid(feat_logits),
            "dense_adj": torch.sigmoid(adj_logits),
        }
        return ModelOutput(prediction, cost_opt, cost_sum, metrics)

    def generate(self, batch: Batch, train: bool = False):
        """Decode from the prior: ε is the latent (reference:
        example_model/model_vae_gen.py:16-33)."""
        g = batch.graph
        z = batch.rng_normal.reshape(g.n_graph * g.max_nodes, self.latent_dim)
        feat_logits, adj_logits = self.decode(z, batch, train)
        out = {"dense_adj": torch.sigmoid(adj_logits)}
        if feat_logits is not None:
            out["feature"] = torch.sigmoid(feat_logits)
        return out
