"""ELL gather SpMM — the counterpart of ``kgcn_tpu/ops/pallas_spmm.py``.

``out[v] = Σ_k w[v,k] · x[idx[v,k]]`` over padded per-row neighbour lists
(idx int32 ``[V, K]``, w float32 ``[V, K]``, x ``[N, F]`` float32 or bf16).

* ``spmm_ell_gpu`` launches the hand-written Hopper kernel ``csrc/ell.cu``
  (which replaces the Pallas ``_ell_kernel``) for CUDA tensors and raises if
  it cannot; for CPU tensors it computes the plain version
  ``spmm_ell_reference``.  ``spmm_ell_gpu.launches`` counts kernel launches
  and nothing else.
* ``spmm_ell_reference`` is the kernel's contract in plain PyTorch: the
  gather and einsum of ``ops/ell.spmm_ell`` with f32 weights and an f32
  sum, the result in x's dtype (as the Pallas kernel: f32 accumulate, out
  in x's dtype).  For float32 x it is ``spmm_ell`` itself.
* ``SpmmEll`` is the counterpart of the custom VJP ``spmm_ell_ad``
  (``pallas_spmm.py:107-140``).  As there, the backward is not a kernel:
  dx is the transpose scatter (an ``index_add_`` of ``w[v,k]·g[v]`` into
  row ``idx[v,k]``) and dw is ``einsum("vf,vkf->vk", g, x[idx])``, computed
  only when the weights need a gradient (the layers' adjacency weights are
  constants, so training never asks).
* ``coo_to_ell_device`` and ``spmm_pallas`` are the COO entry: the
  conversion on the tensors' device, and the product through ``SpmmEll``
  with the JAX package's ``max_degree`` rule (``pallas_spmm.py:159-200``).

The TPU version's VMEM budget and compile probe (``VMEM_X_BUDGET_BYTES``,
``_kernel_supported``) have no counterpart: on Hopper x is read from device
memory and L2, so the kernel takes every size, and there is no quiet
ELL-XLA fallback on the card.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from kgcn_tpu_torch.ops import _build
from kgcn_tpu_torch.ops.ell import spmm_ell

_ENTRY = {torch.float32: "kgcn_ell_spmm_f32", torch.bfloat16: "kgcn_ell_spmm_bf16"}


def _check(idx, w, x):
    if idx.dim() != 2 or tuple(w.shape) != tuple(idx.shape) or x.dim() != 2:
        raise ValueError(
            "spmm_ell expects idx [V, K], w [V, K] and x [N, F]; got "
            f"{tuple(idx.shape)}, {tuple(w.shape)}, {tuple(x.shape)}"
        )
    devices = {t.device for t in (idx, w, x)}
    if len(devices) != 1:
        raise ValueError(f"spmm_ell operands on several devices: {devices}")


def _launch(idx, w, x):
    """One launch of the CUDA kernel → ``[V, F]`` in x's dtype."""
    if idx.dtype != torch.int32:
        raise TypeError(f"ELL kernel takes int32 indices, got {idx.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"ELL kernel takes float32 weights, got {w.dtype}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"ELL kernel takes float32 or bfloat16 x, got {x.dtype}")
    for name, t in (("idx", idx), ("w", w), ("x", x)):
        if not t.is_contiguous():
            raise ValueError(f"ELL kernel needs contiguous {name}")
    if x.data_ptr() % 16:  # vector loads need 16-byte-aligned rows
        x = x.clone()
    V, K = idx.shape
    N, F = x.shape
    if max(V * K, N * F, V * F) >= 2**31:
        raise ValueError(f"ELL kernel takes fewer than 2^31 elements per array "
                         f"(V={V}, K={K}, N={N}, F={F})")
    out = torch.empty((V, F), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.zero_()
    lib = _build.load("ell")
    fn = getattr(lib, _ENTRY[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(idx.data_ptr(), w.data_ptr(), x.data_ptr(), out.data_ptr(),
                  V, K, F, stream)
    _build.check(lib, code, "ell_spmm launch")
    spmm_ell_gpu.launches += 1
    return out


def spmm_ell_reference(idx, w, x):
    """The plain version: ``spmm_ell`` in float32, cast to x's dtype."""
    return spmm_ell(idx, w.to(torch.float32), x.to(torch.float32)).to(x.dtype)


def spmm_ell_gpu(idx, w, x):
    """``out[v] = Σ_k w[v,k] · x[idx[v,k]]``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors.  Not differentiable (see
    ``SpmmEll``)."""
    _check(idx, w, x)
    if x.is_cuda:
        return _launch(idx.contiguous(), w.contiguous(), x.contiguous())
    return spmm_ell_reference(idx, w, x)


spmm_ell_gpu.launches = 0


class SpmmEll(torch.autograd.Function):
    """Differentiable ELL product (JAX ``spmm_ell_ad``): forward by
    ``spmm_ell_gpu``; dx the transpose scatter, dw only when asked for; the
    indices get no gradient."""

    @staticmethod
    def forward(ctx, idx, w, x):
        ctx.save_for_backward(idx, w, x)
        return spmm_ell_gpu(idx, w, x)

    @staticmethod
    def backward(ctx, g):
        idx, w, x = ctx.saved_tensors
        _, need_w, need_x = ctx.needs_input_grad
        g32 = g.to(torch.float32)
        flat = idx.reshape(-1).long()
        dw = dx = None
        if need_x:
            # dx[u] = Σ_{v,k: idx[v,k]=u} w[v,k] · g[v]
            contrib = (w.to(torch.float32)[:, :, None] * g32[:, None, :]).reshape(
                flat.numel(), -1)
            dx = torch.zeros((x.shape[0], g.shape[1]), dtype=torch.float32,
                             device=g.device).index_add_(0, flat, contrib).to(x.dtype)
        if need_w:
            # dw[v,k] = ⟨g[v], x[idx[v,k]]⟩
            dw = torch.einsum("vf,vkf->vk", g32,
                              x[idx.long()].to(torch.float32)).to(w.dtype)
        return None, dw, dx


def coo_to_ell_device(senders, receivers, weights, num_nodes: int,
                      max_degree: int):
    """COO → ELL ``(idx [V, K] int32, w [V, K])`` on the tensors' device
    (JAX ``coo_to_ell_device``).  An edge's slot is its rank among the
    earlier VALID edges of its receiver: zero-weight (padding) edges take no
    slot, and edges past ``max_degree`` are dropped."""
    E = senders.shape[0]
    dev = senders.device
    valid = weights != 0
    r_eff = torch.where(valid, receivers.to(torch.int64),
                        torch.full_like(receivers, num_nodes, dtype=torch.int64))
    order = torch.sort(r_eff, stable=True).indices
    r_sorted = r_eff[order]
    first = torch.searchsorted(r_sorted, r_sorted, side="left")
    slot = torch.empty(E, dtype=torch.int64, device=dev)
    slot[order] = torch.arange(E, device=dev) - first
    ok = valid & (slot < max_degree)
    # invalid edges go to a sacrificial extra slot that is sliced off
    flat = torch.where(ok, receivers.to(torch.int64) * max_degree + slot,
                       torch.full_like(slot, num_nodes * max_degree))
    n = num_nodes * max_degree + 1
    idx = torch.zeros(n, dtype=torch.int32, device=dev)
    idx[flat] = senders.to(torch.int32)
    wv = torch.zeros(n, dtype=weights.dtype, device=dev)
    wv[flat] = weights
    return (idx[:-1].reshape(num_nodes, max_degree),
            wv[:-1].reshape(num_nodes, max_degree))


def spmm_pallas(senders, receivers, weights, x, num_nodes: int,
                max_degree: int | None = None):
    """COO SpMM ``out[r] = Σ_e w_e · x[s_e]`` through the ELL kernel (JAX
    ``spmm_pallas``).  Without ``max_degree`` it is the largest in-degree
    over the nonzero-weight edges, counted from host copies."""
    if max_degree is None:
        r = receivers.cpu().numpy()
        deg = np.zeros(num_nodes, np.int64)
        np.add.at(deg, r[weights.detach().cpu().numpy() != 0], 1)
        max_degree = max(int(deg.max()) if deg.size else 0, 1)
    idx, w = coo_to_ell_device(senders, receivers, weights, num_nodes, max_degree)
    return SpmmEll.apply(idx, w, x)
