"""Graph NN layers (torch.nn) — the dense-path counterparts of
``kgcn_tpu/nn/layers.py:44-131, 294-383``.

Semantics as there (checked against the reference, SURVEY.md §2.2):

* GraphConv: per-channel weights AND biases, channel outputs summed
  (kgcn/layers.py:52-62,107-115); aggregation through the fused ``gconv``
  op, which runs the hand-written CUDA kernel on the GPU.
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
from torch import nn

from kgcn_tpu_torch.graph.batch import GraphBatch
from kgcn_tpu_torch.ops.gconv import gconv


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


class GraphConv(nn.Module):
    """Multi-channel Kipf graph convolution ``Σ_c A_c (X W_c + b_c)``
    (reference: kgcn/layers.py:32-119), dense path."""

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
        if graph.dense_adj is None:
            raise NotImplementedError(
                "GraphConv without a dense adjacency needs the sparse "
                "backends (tiled/stream/ELL), which are not ported yet "
                "(ROADMAP.md queue A, sparse backends)"
            )
        xb = x.reshape(graph.n_graph, graph.max_nodes, x.shape[-1])
        out = gconv(graph.dense_adj, xb, self.kernel.to(x.dtype), self.bias.to(x.dtype))
        return out.reshape(graph.total_nodes, -1)


class GraphGather(nn.Module):
    """Graph-level readout: masked sum over each graph's nodes
    (reference: kgcn/layers.py:156-167)."""

    def forward(self, x: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        xb = _flat(x, graph).reshape(graph.n_graph, graph.max_nodes, -1)
        return torch.sum(xb * graph.mask_batched()[..., None], dim=1)


class GraphDense(nn.Module):
    """Per-node dense layer; padded node rows are zeroed afterwards
    (reference: kgcn/layers.py:223-265).  ``Dense_0`` is flax's name for
    the inner layer."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.Dense_0 = nn.Linear(in_features, features)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        reset_linear_(self.Dense_0, generator)

    def forward(self, x: torch.Tensor, graph: GraphBatch) -> torch.Tensor:
        out = self.Dense_0(_flat(x, graph))
        return out * graph.node_mask.to(out.dtype)[:, None]


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
