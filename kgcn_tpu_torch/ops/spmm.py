"""Sparse aggregation — the counterpart of ``kgcn_tpu/ops/spmm.py``
(``spmm``, ``spmm_multichannel``, ``ell_aggregate``, ``sddmm``,
``spmm_dense``) over the backends of the port.

* ``stream``: one stream product per channel (C is small), summed — the
  CUDA stream kernels on the GPU.  ``weights=None`` takes the weights baked
  into the structures (the static route); given weights are honoured
  through ``stream_spmm_edges``; a structure without baked weights and no
  weights given raises.
* ``tiled``: one ``tiled_spmm`` per channel, summed — the CUDA kernel on
  the GPU.
* ``pallas``: the ELL kernel (``ops/ell_spmm.py``, CUDA on the GPU).
  ``ell_aggregate`` runs it once for all channels on the batch's ELL
  arrays, and its backward's dx kernel once over the batch's transposed
  slot lists.
  ``spmm`` converts its COO list with ``spmm_pallas``.  ``spmm_multichannel``
  (the layers' edge-list route, taken when the batch has no ELL arrays)
  takes the ``xla`` scatter and says so once, as the JAX package's jitted
  step does (its edge lists are traced there and have no host-visible
  degrees).
* ``xla``: the JAX package's non-kernel path — a gather of sender rows
  scaled by the edge weights and a segment sum into the receivers (in a
  fixed order, ``ops/segment.segment_sum``), or
  on ELL arrays the gather and einsum of ``ops/ell.py``; the oracle of the
  tests.

Which route runs is decided on the host from the data (the batch's
backend and whether it carries ELL arrays), never from whether a kernel
built: a kernel that fails to build or launch raises.
``spmm_dense`` is the dense-adjacency aggregation (GIN's), an einsum in
both packages.
"""
from __future__ import annotations

import torch

from kgcn_tpu_torch.ops.ell import spmm_ell_multichannel
from kgcn_tpu_torch.ops.ell_spmm import SpmmEll, spmm_pallas
from kgcn_tpu_torch.ops.segment import segment_sum
from kgcn_tpu_torch.ops.stream_spmm import stream_spmm, stream_spmm_edges
from kgcn_tpu_torch.ops.tiled_spmm import tiled_spmm

_PALLAS_FALLBACK_WARNED = [False]


def _warn_pallas_fallback() -> None:
    """The JAX package's message (``kgcn_tpu/ops/spmm.py:47-59``), once."""
    if not _PALLAS_FALLBACK_WARNED[0]:
        _PALLAS_FALLBACK_WARNED[0] = True
        print(
            "[spmm] pallas backend requested but no static max_degree is "
            "available on the COO path under jit — using the XLA scatter "
            "path (identical results); the Pallas kernel engages on the ELL "
            "path when the dataset's degree layout qualifies"
        )


def _scatter(senders, receivers, weights, x, num_nodes, segments=None):
    """``xla``: gather the sender rows, scale, sum by receiver
    (``segments``: the receivers' ``sort_segments``, when the caller has
    them)."""
    gathered = x[senders.long()] * weights.reshape(-1, 1).to(x.dtype)
    return segment_sum(gathered, receivers, num_nodes, segments)


def spmm(senders, receivers, weights, x, num_nodes: int, *, backend: str = "xla",
         max_degree=None, tiled=None, stream=None, compute_dtype="bfloat16"):
    """``out[r] = Σ_{e: receivers[e]=r} weights[e] · x[senders[e]]`` for one
    edge list (``[E]``; padding edges carry weight 0), x ``[V, F]`` →
    ``[num_nodes, F]`` in x's dtype.  ``tiled`` / ``stream``: the list's
    prebuilt ``TiledCOO`` / ``StreamCOO`` (the tiled and stream backends);
    on the stream backend ``weights=None`` takes the baked weights."""
    if backend == "stream" and stream is not None:
        if weights is None:  # raises when no weights are baked in
            out = stream_spmm(stream, x=x, compute_dtype=compute_dtype)
        else:
            out = stream_spmm_edges(stream, weights, x, compute_dtype=compute_dtype)
        return out.to(x.dtype)
    if backend == "tiled" and tiled is not None:
        return tiled_spmm(tiled, weights, x, compute_dtype=compute_dtype).to(x.dtype)
    if backend == "pallas":
        return spmm_pallas(senders, receivers, weights, x, num_nodes,
                           max_degree=max_degree)
    return _scatter(senders, receivers, weights, x, num_nodes)


def spmm_multichannel(senders, receivers, weights, x, num_nodes: int, *,
                      backend: str = "xla", tiled=None, stream=None,
                      compute_dtype="bfloat16", segments=None):
    """``out[r] = Σ_c Σ_e w[c,e] · x_c[s[c,e]]``.

    senders/receivers/weights ``[C, E]`` (weights may be None on the stream
    backend: the baked ones); x ``[C, V, F]`` (per-channel features) or
    ``[V, F]`` (shared).  ``tiled`` / ``stream``: the per-channel
    ``TiledCOO`` / ``StreamCOO`` structures of the batch.  ``segments``:
    the scatter's sorted receivers, all channels as one list
    (``GraphBatch.receiver_segments()``), else sorted here.
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
    if backend == "pallas":
        _warn_pallas_fallback()
    elif backend != "xla":
        raise ValueError(f"unknown spmm backend {backend!r}")
    if x.dim() == 2:
        x = x.expand(C, *x.shape)
    # one flat edge list over the channels: a single segment sum adds them
    V = x.shape[1]
    offs = (torch.arange(C, device=senders.device) * V)[:, None]
    return _scatter((senders.long() + offs).reshape(-1), receivers.reshape(-1),
                    weights, x.reshape(C * V, x.shape[2]), num_nodes, segments)


def ell_aggregate(ell_senders, ell_weights, x, backend: str = "xla", transpose=None):
    """Channel-summed ELL aggregation ``out[v] = Σ_c Σ_k w[c,v,k]·x_c[i[c,v,k]]``.

    ell_senders / ell_weights ``[C, V, K]``; x ``[C, V, F]`` (per channel)
    or ``[V, F]`` (shared).  ``pallas``: one differentiable ELL call for all
    channels (``SpmmEll``): on the card one forward launch, whatever C, whose
    per-channel f32 sums are added in channel order (the bits of the
    per-channel products summed ``o_0 + o_1 + …`` in f32), and in the
    backward one dx launch over ``transpose`` (the batch's sender-grouped
    slot lists, ``GraphBatch.ell_transpose()``; built on the card when
    None), with no atomics; otherwise the gather and einsum."""
    if backend == "pallas":
        return SpmmEll.apply(ell_senders, ell_weights, x, transpose)
    return spmm_ell_multichannel(ell_senders, ell_weights, x)


def sddmm(senders, receivers, a, b):
    """Per-edge inner products ``out[e] = Σ_f a[receivers[e], f] ·
    b[senders[e], f]`` — the values-gradient of ``spmm`` and GAT's
    edge-logit pattern."""
    return torch.einsum("ef,ef->e", a[receivers.long()], b[senders.long()])


def spmm_dense(adj, x):
    """Dense-adjacency aggregation (``kgcn_tpu``'s ``spmm_dense``): adj
    ``[C, B, N, N]``, x ``[B, N, F]`` (shared) or ``[C, B, N, F]`` →
    ``[B, N, F]`` summed over channels."""
    if x.dim() == 3:
        return torch.einsum("cbnm,bmf->bnf", adj.to(x.dtype), x)
    return torch.einsum("cbnm,cbmf->bnf", adj.to(x.dtype), x)
