"""Channel-summed sparse aggregation — the counterpart of ``spmm`` and
``spmm_multichannel`` (``kgcn_tpu/ops/spmm.py:63-140``) for the backends
the port has.

* ``stream``: one stream product per channel (C is small), summed — the
  CUDA stream kernels on the GPU.  ``weights=None`` takes the weights baked
  into the structures (the static route); given weights are honoured
  through ``stream_spmm_edges``; a structure without baked weights and no
  weights given raises.
* ``tiled``: one ``tiled_spmm`` per channel, summed — the CUDA kernel on
  the GPU.
* ``xla``: the JAX package's own non-kernel path, a gather of sender rows
  scaled by the edge weights and an ``index_add_`` into the receivers; the
  oracle of the tests.

``spmm_dense`` is the dense-adjacency aggregation (GIN's), an einsum in
both packages.
"""
from __future__ import annotations

import torch

from kgcn_tpu_torch.ops.stream_spmm import stream_spmm, stream_spmm_edges
from kgcn_tpu_torch.ops.tiled_spmm import tiled_spmm


def spmm_multichannel(senders, receivers, weights, x, num_nodes: int, *,
                      backend: str = "xla", tiled=None, stream=None,
                      compute_dtype="bfloat16"):
    """``out[r] = Σ_c Σ_e w[c,e] · x_c[s[c,e]]``.

    senders/receivers/weights ``[C, E]`` (weights may be None on the stream
    backend: the baked ones); x ``[C, V, F]`` (per-channel features) or
    ``[V, F]`` (shared).  ``tiled`` / ``stream``: the per-channel
    ``TiledCOO`` / ``StreamCOO`` structures of the batch.
    Returns ``[num_nodes, F]`` in x's dtype."""
    C = senders.shape[0]
    # unbind, not x[c]: its backward stacks the channels' gradients once,
    # where C selects would each fill and add a [C, V, F] gradient
    xs = x.unbind(0) if x.dim() == 3 else (x,) * C
    if backend == "stream":
        if stream is None:
            raise ValueError("backend 'stream' needs the batch's stream structures")
        out = None
        for c in range(C):
            if weights is None:  # raises when no weights are baked in
                o = stream_spmm(stream[c], x=xs[c], compute_dtype=compute_dtype)
            else:
                o = stream_spmm_edges(stream[c], weights[c], xs[c],
                                      compute_dtype=compute_dtype)
            out = o if out is None else out + o
        return out.to(x.dtype)
    if backend == "tiled":
        if tiled is None:
            raise ValueError("backend 'tiled' needs the batch's tiled structures")
        out = None
        for c in range(C):
            o = tiled_spmm(tiled[c], weights[c], xs[c], compute_dtype=compute_dtype)
            out = o if out is None else out + o
        return out.to(x.dtype)
    if backend != "xla":
        raise NotImplementedError(f"spmm backend {backend!r} is not ported "
                                  "(ROADMAP.md A.5)")
    if x.dim() == 2:
        x = x.expand(C, *x.shape)
    # one flat edge list over the channels: a single index_add_ sums them
    V = x.shape[1]
    offs = (torch.arange(C, device=senders.device) * V)[:, None]
    flat_x = x.reshape(C * V, x.shape[2])
    gathered = flat_x[(senders.long() + offs).reshape(-1)]
    gathered = gathered * weights.reshape(-1, 1).to(x.dtype)
    out = x.new_zeros((num_nodes, x.shape[2]))
    return out.index_add(0, receivers.long().reshape(-1), gathered)


def spmm_dense(adj, x):
    """Dense-adjacency aggregation (``kgcn_tpu``'s ``spmm_dense``): adj
    ``[C, B, N, N]``, x ``[B, N, F]`` (shared) or ``[C, B, N, F]`` →
    ``[B, N, F]`` summed over channels."""
    if x.dim() == 3:
        return torch.einsum("cbnm,bmf->bnf", adj.to(x.dtype), x)
    return torch.einsum("cbnm,cbmf->bnf", adj.to(x.dtype), x)
