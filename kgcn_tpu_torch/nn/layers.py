"""Graph NN layers (torch.nn) — the counterparts of
``kgcn_tpu/nn/layers.py:44-467``.

Semantics as there (checked against the reference, SURVEY.md §2.2):

* GraphConv: per-channel weights AND biases, channel outputs summed
  (kgcn/layers.py:52-62,107-115).  Dense batches aggregate through the fused
  ``gconv`` op; the others project ``X W_c + b_c`` and aggregate it, in
  the JAX package's order: stream structures (the stream kernels with the
  baked adjacency weights), tiled structures (the tiled SpMM kernel), ELL
  arrays (``ell_aggregate``: the ELL gather kernel on ``pallas``, the
  gather and einsum on ``xla``), else the edge lists (the ``xla`` scatter,
  which ``pallas`` takes too, saying so once).  The kernels are
  hand-written CUDA on the GPU.
* GINAggregate: ``Σ_c (ε_c X + A_c X)`` with a learnable scalar ε per
  channel, zeros init, applied as ``(Σ_c ε_c)·X + Σ_c A_c X`` — the naive
  path of the reference (kgcn/layers.py:464-471), as ``kgcn_tpu`` keeps it;
  ``A_c X`` takes GraphConv's branches on ``X`` itself.
* Embed / NodeEmbedding: the node-id embedding table of node-embedding
  mode (kgcn/default_model.py:24-27), flax ``nn.Embed``'s initialisation.
* DistMult: the multi-relation scorer ``Σ_f h_f w_{r,f} t_f``
  (kgcn/layers.py:307-358) with all-entity left/right prediction; the
  relation rows are gathered by index (``kgcn_tpu`` gathers them by a
  one-hot matmul, a TPU device for the same values).
* GAT: single-head edge attention per channel, sigmoid output, channels
  summed (kgcn/layers.py:477-542), with the edge-list path (tiled batches:
  the attention weights go through ``tiled_spmm``, whose backward gives
  their gradient by the SDDMM kernel) and the dense path ``_dense``.
  ``normalize="sender"`` keeps the reference's denominator gathered at the
  sender (kgcn/layers.py:530-531).
* GraphMaxPooling: the neighbourhood max of ``A ⊙ x`` per feature,
  channels summed, with the reference's densified-row zero floor
  (kgcn/layers.py:122-153): ``segment_max`` over the edge lists, padding
  edges masked to -inf.
* GraphDecoderInnerProd / GraphDecoderDistMult: the graph VAE's adjacency
  decoders ``Z Zᵀ`` and ``(w ⊙ Z) Zᵀ`` (kgcn/layers.py:268-305), einsums as
  in ``kgcn_tpu``.
* Dense: flax ``nn.Dense`` (an ``nn.Linear`` with flax's ``[in, out]``
  names in ``convert.py``): without ``dtype`` flax computes in the
  promotion of the input's and the float32 parameters' types, so a bf16
  input gives a float32 output; ``promote=False`` is ``nn.Dense(dtype=
  x.dtype)``, the parameters cast to the input's type.
* Mixed precision (``"precision": "bfloat16"``): parameters live in float32
  and are cast to the activation dtype where ``kgcn_tpu`` casts them
  (GraphConv's kernel and bias, GIN's ε, GAT's ``attn``, the DistMult
  decoder's kernel); ``GraphDense`` computes in its input's dtype; GAT's
  scores and softmax and the batch norm's moments run in float32.
* GraphBatchNormalization: statistics over valid (un-padded) node rows only,
  biased variance, running statistics ``m·ra + (1-m)·batch`` (m = 0.9,
  ε = 1e-3), output multiplied by the node mask.  Not ``nn.BatchNorm1d``,
  which keeps the unbiased running variance and knows no mask.

Parameter names follow the flax ones (``kernel`` ``[C, Fin, Fout]``, ``bias``,
``scale``, ``mean``/``var`` buffers), so ``convert.params_from_jax`` maps a
JAX parameter tree onto these modules by rule.  Every layer has
``reset_parameters(generator)``: initialisation draws from a
``torch.Generator``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from kgcn_tpu_torch.graph.batch import GraphBatch
from kgcn_tpu_torch.ops import segment
from kgcn_tpu_torch.ops.gconv import gconv
from kgcn_tpu_torch.ops.spmm import ell_aggregate, spmm_dense, spmm_multichannel
from kgcn_tpu_torch.ops.tiled_spmm import tiled_spmm


def _coo_backend(graph: GraphBatch) -> str:
    """The edge-list route of a batch without kernel structures: ``pallas``
    (which falls back to the scatter, as the JAX package's jitted step
    does) or ``xla``."""
    return "pallas" if graph.backend == "pallas" else "xla"


def _stream_weights(graph: GraphBatch):
    """The weights the stream route aggregates with: None takes those
    baked into the structures; a batch with ``live_weights`` passes its
    ``edge_weights`` (differentiable, the weight-gradient kernel)."""
    return graph.edge_weights if graph.live_weights else None


def _flat(x: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
    """Accept [V, F] or [B, N, F]; return [V, F]."""
    if x.dim() == 3:
        return x.reshape(graph.total_nodes, x.shape[-1])
    return x


@torch.no_grad()
def per_channel_glorot_(t: torch.Tensor, generator=None) -> torch.Tensor:
    """Glorot-uniform over the LAST TWO dims only: a [C, Fin, Fout] kernel
    initialises each channel like an independent (Fin, Fout) weight
    (kgcn/layers.py:52-57)."""
    fan_in, fan_out = t.shape[-2], t.shape[-1]
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, generator=None) -> torch.Tensor:
    """flax's default Dense kernel init (``lecun_normal``: truncated normal
    with variance 1/fan_in), for an ``nn.Linear`` weight ``[out, in]``."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


def reset_linear_(lin: nn.Linear, generator=None) -> None:
    lecun_normal_(lin.weight, generator)
    if lin.bias is not None:
        nn.init.zeros_(lin.bias)


class Dense(nn.Linear):
    """flax ``nn.Dense``.  ``promote`` (flax's ``dtype=None``): computed in
    the promotion of the input's type and the parameters' float32, so a
    bf16 input gives float32; else (``dtype=x.dtype``) in the input's type,
    the parameters cast to it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 promote: bool = True):
        super().__init__(in_features, out_features, bias=bias)
        self.promote = promote

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.promote:
            dtype = torch.promote_types(x.dtype, self.weight.dtype)
            return F.linear(x.to(dtype), self.weight.to(dtype),
                            None if self.bias is None else self.bias.to(dtype))
        return F.linear(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype))


class GraphConv(nn.Module):
    """Multi-channel Kipf graph convolution ``Σ_c A_c (X W_c + b_c)``
    (reference: kgcn/layers.py:32-119)."""

    def __init__(self, in_features: int, features: int, channels: int = 1):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(channels, in_features, features))
        self.bias = nn.Parameter(torch.zeros(channels, features))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        per_channel_glorot_(self.kernel, generator)
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        x = _flat(x, graph)
        w, b = self.kernel.to(x.dtype), self.bias.to(x.dtype)
        if graph.dense_adj is not None:
            xb = x.reshape(graph.n_graph, graph.max_nodes, x.shape[-1])
            return gconv(graph.dense_adj, xb, w, b).reshape(graph.total_nodes, -1)
        hw = torch.einsum("vf,cfo->cvo", x, w) + b[:, None, :]
        if graph.stream_adj is not None:
            return spmm_multichannel(
                graph.senders, graph.receivers, _stream_weights(graph), hw,
                graph.total_nodes, backend="stream", stream=graph.stream_adj,
                compute_dtype=graph.compute_dtype,
            )
        if graph.tiled_adj is not None:
            return spmm_multichannel(
                graph.senders, graph.receivers, graph.edge_weights, hw,
                graph.total_nodes, backend="tiled", tiled=graph.tiled_adj,
                compute_dtype=graph.compute_dtype,
            )
        if graph.ell_senders is not None:
            return ell_aggregate(graph.ell_senders, graph.ell_weights, hw,
                                 backend=graph.backend,
                                 transpose=graph.ell_transpose())
        return spmm_multichannel(graph.senders, graph.receivers, graph.edge_weights,
                                 hw, graph.total_nodes, backend=_coo_backend(graph),
                                 segments=graph.receiver_segments())


class GINAggregate(nn.Module):
    """GIN aggregation ``Σ_c (ε_c X + A_c X)``; ε a learnable scalar per
    channel, zeros init (reference: kgcn/layers.py:400-475, naive path)."""

    def __init__(self, channels: int = 1):
        super().__init__()
        self.epsilon = nn.Parameter(torch.zeros(channels))

    def reset_parameters(self, generator=None) -> None:
        nn.init.zeros_(self.epsilon)

    def forward(self, x: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        x = _flat(x, graph)
        if graph.dense_adj is not None:
            xb = x.reshape(graph.n_graph, graph.max_nodes, -1)
            agg = spmm_dense(graph.dense_adj, xb).reshape(x.shape)
        elif graph.stream_adj is not None:
            agg = spmm_multichannel(
                graph.senders, graph.receivers, _stream_weights(graph), x,
                graph.total_nodes, backend="stream", stream=graph.stream_adj,
                compute_dtype=graph.compute_dtype,
            )
        elif graph.tiled_adj is not None:
            agg = spmm_multichannel(
                graph.senders, graph.receivers, graph.edge_weights, x,
                graph.total_nodes, backend="tiled", tiled=graph.tiled_adj,
                compute_dtype=graph.compute_dtype,
            )
        elif graph.ell_senders is not None:
            agg = ell_aggregate(graph.ell_senders, graph.ell_weights, x,
                                backend=graph.backend,
                                transpose=graph.ell_transpose())
        else:
            agg = spmm_multichannel(graph.senders, graph.receivers,
                                    graph.edge_weights, x, graph.total_nodes,
                                    backend=_coo_backend(graph),
                                    segments=graph.receiver_segments())
        return torch.sum(self.epsilon).to(x.dtype) * x + agg


class GAT(nn.Module):
    """Single-head graph attention per adjacency channel, channel-summed,
    sigmoid output (reference: kgcn/layers.py:477-542).  ``attn`` is
    ``[C, 2F, 1]``: sender half, then receiver half."""

    def __init__(self, in_features: int, channels: int = 1,
                 normalize: str = "receiver"):
        super().__init__()
        if normalize not in ("receiver", "sender"):
            raise ValueError(f"normalize must be receiver or sender, got {normalize!r}")
        self.normalize = normalize
        self.attn = nn.Parameter(torch.empty(channels, 2 * in_features, 1))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        per_channel_glorot_(self.attn, generator)

    def forward(self, x: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        x = _flat(x, graph)
        Fx = x.shape[-1]
        a = self.attn.to(x.dtype)
        if graph.dense_adj is not None:
            return self._dense(x, graph, a)
        V = graph.total_nodes
        edge_mask = graph.edge_mask()
        out = None
        for c in range(a.shape[0]):
            segments = graph.receiver_segments(c)
            s, r = graph.senders[c].long(), segments[0]
            # the bilinear logit factorises into per-node scores gathered per
            # edge; the softmax runs in float32 whatever the payload
            ls = (x @ a[c, :Fx, 0]).to(torch.float32)
            lr = (x @ a[c, Fx:, 0]).to(torch.float32)
            logit = F.leaky_relu(ls[s] + lr[r], negative_slope=0.2)
            if self.normalize == "receiver":
                alpha = segment.segment_softmax(logit, r, V, mask=edge_mask[c],
                                                sorted_segments=segments)
            else:  # the reference's receiver sums gathered at the sender
                e = torch.exp(logit) * edge_mask[c]
                alpha = e / (segment.segment_sum(e, r, V, segments)[s] + 1e-10)
            if graph.tiled_adj is not None:
                agg = tiled_spmm(graph.tiled_adj[c], alpha, x,
                                 compute_dtype=graph.compute_dtype).to(x.dtype)
            else:
                agg = segment.segment_sum(alpha.to(x.dtype)[:, None] * x[s], r, V,
                                          segments)
            out = torch.sigmoid(agg) if out is None else out + torch.sigmoid(agg)
        return out

    def _dense(self, x, graph: GraphBatch, a):
        """Attention on the full ``[B, N, N]`` grid masked by the adjacency
        (``kgcn_tpu``'s ``GAT._dense``)."""
        Fx = x.shape[-1]
        B, N = graph.n_graph, graph.max_nodes
        xb = x.reshape(B, N, Fx)
        # a fill on the device, not a copy from the host (a captured step
        # may not copy)
        neg = torch.full((), -1e30, dtype=torch.float32, device=x.device)
        out = torch.zeros((B, N, Fx), dtype=x.dtype, device=x.device)
        for c in range(a.shape[0]):
            mask = graph.dense_adj[c] != 0                    # [B, r, s]
            ls = (xb @ a[c, :Fx, 0]).to(torch.float32)        # sender [B, N]
            lr = (xb @ a[c, Fx:, 0]).to(torch.float32)        # receiver
            logit = F.leaky_relu(ls[:, None, :] + lr[:, :, None], negative_slope=0.2)
            logit = torch.where(mask, logit, neg)
            if self.normalize == "receiver":
                m = torch.maximum(logit.amax(dim=-1, keepdim=True), neg)
                e = torch.exp(logit - m) * mask
                denom = e.sum(dim=-1, keepdim=True)
                alpha = e / torch.where(denom == 0, torch.ones_like(denom), denom)
            else:
                e = torch.exp(logit) * mask
                alpha = e / (e.sum(dim=-1)[:, None, :] + 1e-10)
            out = out + torch.sigmoid(torch.einsum("brs,bsf->brf", alpha.to(x.dtype), xb))
        return out.reshape(graph.total_nodes, Fx)


class GraphGather(nn.Module):
    """Graph-level readout: masked sum over each graph's nodes
    (reference: kgcn/layers.py:156-167)."""

    def forward(self, x: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        xb = _flat(x, graph).reshape(graph.n_graph, graph.max_nodes, -1)
        return torch.sum(xb * graph.mask_batched()[..., None], dim=1)


class GraphDense(nn.Module):
    """Per-node dense layer; padded node rows are zeroed afterwards unless
    ``mask_output`` is false (reference: kgcn/layers.py:223-265).
    ``Dense_0`` is flax's name for the inner layer."""

    def __init__(self, in_features: int, features: int, mask_output: bool = True):
        super().__init__()
        self.mask_output = mask_output
        self.Dense_0 = Dense(in_features, features, promote=False)  # in x's dtype
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        reset_linear_(self.Dense_0, generator)

    def forward(self, x: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        out = self.Dense_0(_flat(x, graph))
        if not self.mask_output:
            return out
        return out * graph.node_mask.to(out.dtype)[:, None]


class GraphMaxPooling(nn.Module):
    """Neighbourhood max of ``A ⊙ x`` per feature, channels summed
    (reference: kgcn/layers.py:122-153).  The reference densifies each row,
    so its implicit zeros take part in the max: the max is floored at 0
    where a row is not fully dense (``deg < max_nodes``), and a row without
    edges gives 0.  Padding edges are masked to -inf, and the rows they
    reach are masked out of the backward by the same ``where``."""

    def forward(self, x: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        x = _flat(x, graph)
        V, N = graph.total_nodes, graph.max_nodes
        edge_mask = graph.edge_mask()
        out = torch.zeros_like(x)
        for c in range(graph.senders.shape[0]):
            r = graph.receivers[c].long()
            contrib = graph.edge_weights[c].to(x.dtype)[:, None] * x[graph.senders[c].long()]
            contrib = torch.where(edge_mask[c][:, None] > 0, contrib, float("-inf"))
            m = segment.segment_max(contrib, r, V)
            # the edge counts are sums of ones: exact in any order
            deg = torch.zeros(V, dtype=torch.float32, device=x.device).index_add_(
                0, r, edge_mask[c].to(torch.float32))[:, None]
            m = torch.where(deg < N, torch.maximum(m, torch.zeros_like(m)), m)
            out = out + torch.where(deg == 0, torch.zeros_like(m), m)
        return out


class GraphDecoderInnerProd(nn.Module):
    """Adjacency reconstruction ``Z Zᵀ`` per graph, ``[B, N, N]``
    (reference: kgcn/layers.py:268-282)."""

    def forward(self, z: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        zb = _flat(z, graph).reshape(graph.n_graph, graph.max_nodes, -1)
        return torch.einsum("bnf,bmf->bnm", zb, zb)


class GraphDecoderDistMult(nn.Module):
    """``(w ⊙ Z) Zᵀ`` per graph with a learned diagonal relation vector
    ``kernel`` ``[features]``, Glorot-uniform as ``kgcn_tpu``'s
    ``glorot_uniform_nd`` draws a 1-D kernel (fan in = fan out = features;
    reference: kgcn/layers.py:285-305)."""

    def __init__(self, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        limit = math.sqrt(6.0 / (2 * self.kernel.shape[0]))
        self.kernel.uniform_(-limit, limit, generator=generator)

    def forward(self, z: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        zb = _flat(z, graph).reshape(graph.n_graph, graph.max_nodes, -1)
        return torch.einsum("bnf,bmf->bnm", self.kernel.to(zb.dtype) * zb, zb)


class GraphBatchNormalization(nn.Module):
    """Batch norm over valid node rows only (mask-aware moments);
    reference: kgcn/layers.py:170-220."""

    MOMENTUM = 0.9
    EPSILON = 1e-3

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def reset_parameters(self, generator=None) -> None:
        nn.init.ones_(self.scale)
        nn.init.zeros_(self.bias)
        self.mean.zero_()
        self.var.fill_(1.0)

    def forward(self, x: torch.Tensor, graph: GraphBatch,
                use_running_average: bool = True) -> torch.Tensor:
        in_dtype = x.dtype
        x = _flat(x, graph).to(torch.float32)  # moments in full precision
        mask = graph.node_mask.to(torch.float32)[:, None]
        if use_running_average:
            mean, var = self.mean, self.var
        else:
            count = torch.clamp(torch.sum(mask), min=1.0)
            mean = torch.sum(x * mask, dim=0) / count
            var = torch.sum(mask * (x - mean) ** 2, dim=0) / count
            with torch.no_grad():  # running statistics, updated in place
                m = self.MOMENTUM
                self.mean.mul_(m).add_((1 - m) * mean)
                self.var.mul_(m).add_((1 - m) * var)
        y = (x - mean) * torch.rsqrt(var + self.EPSILON) * self.scale + self.bias
        return (y * mask).to(in_dtype)


class Embed(nn.Module):
    """flax ``nn.Embed``: an ``embedding`` table ``[num, features]`` drawn
    from N(0, 1/features) (flax's ``variance_scaling(1, "fan_in",
    "normal", out_axis=0)``), looked up by index."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        std = 1.0 / math.sqrt(self.embedding.shape[1])
        self.embedding.normal_(0.0, std, generator=generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.embedding[ids.long()]


class NodeEmbedding(nn.Module):
    """Node-id embedding for KG / featureless mode, padding rows zeroed
    (reference: kgcn/default_model.py:24-27 ``with_node_embedding``).
    ``Embed_0`` is flax's name for the inner table."""

    def __init__(self, vocab_size: int, features: int):
        super().__init__()
        self.Embed_0 = Embed(vocab_size, features)

    def reset_parameters(self, generator=None) -> None:
        self.Embed_0.reset_parameters(generator)

    def forward(self, graph: GraphBatch) -> torch.Tensor:
        return self.Embed_0(graph.node_ids) * graph.node_mask[:, None]


class DistMult(nn.Module):
    """Multi-relation DistMult scorer (reference: kgcn/layers.py:307-358).
    ``kernel`` ``[channels, dim]`` holds one relation vector per channel,
    Glorot-uniform initialised as ``kgcn_tpu``'s ``glorot_uniform_nd``."""

    def __init__(self, dim: int, channels: int = 1):
        super().__init__()
        if dim <= 0:
            raise ValueError("DistMult requires dim")
        self.kernel = nn.Parameter(torch.empty(channels, dim))
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        per_channel_glorot_(self.kernel, generator)

    def forward(self, z: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        """Full reconstruction ``[B, C, N, N]``."""
        zb = _flat(z, graph).reshape(graph.n_graph, graph.max_nodes, -1)
        return torch.einsum("cf,bnf,bmf->bcnm", self.kernel, zb, zb)

    def score(self, z_head, z_tail, channel):
        """``Σ_f h_f · w_{r,f} · t_f`` per row (kgcn/layers.py:321-325)."""
        return torch.sum(z_head * z_tail * self.kernel[channel.long()], dim=-1)

    def left_prediction(self, z_all, z_tail, channel):
        """Score every entity as head: ``[K, num_nodes]``
        (kgcn/layers.py:327-337)."""
        return (z_tail * self.kernel[channel.long()]) @ z_all.T

    def right_prediction(self, z_head, z_all, channel):
        """Score every entity as tail (kgcn/layers.py:339-347)."""
        return (z_head * self.kernel[channel.long()]) @ z_all.T
