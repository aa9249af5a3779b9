"""Channel-summed sparse aggregation — the counterpart of
``spmm_multichannel`` (``kgcn_tpu/ops/spmm.py:109-140``) for the backends
the port has.

* ``tiled``: one ``tiled_spmm`` per channel (C is small), summed — the CUDA
  kernel on the GPU.
* ``xla``: the JAX package's own non-kernel path, a gather of sender rows
  scaled by the edge weights and an ``index_add_`` into the receivers; the
  oracle of the tests.
"""
from __future__ import annotations

import torch

from kgcn_tpu_torch.ops.tiled_spmm import tiled_spmm


def spmm_multichannel(senders, receivers, weights, x, num_nodes: int, *,
                      backend: str = "xla", tiled=None,
                      compute_dtype="bfloat16"):
    """``out[r] = Σ_c Σ_e w[c,e] · x_c[s[c,e]]``.

    senders/receivers/weights ``[C, E]``; x ``[C, V, F]`` (per-channel
    features) or ``[V, F]`` (shared).  ``tiled``: the per-channel
    ``TiledCOO`` structures of the batch (``backend="tiled"``).
    Returns ``[num_nodes, F]`` in x's dtype."""
    C = senders.shape[0]
    if backend == "tiled":
        if tiled is None:
            raise ValueError("backend 'tiled' needs the batch's tiled structures")
        out = None
        for c in range(C):
            xc = x[c] if x.dim() == 3 else x
            o = tiled_spmm(tiled[c], weights[c], xc, compute_dtype=compute_dtype)
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
