"""ELL gather SpMM — the counterpart of ``kgcn_tpu/ops/pallas_spmm.py``.

``out[v] = Σ_c Σ_k w[c,v,k] · x_c[idx[c,v,k]]`` over padded per-row
neighbour lists (idx int32 ``[C, V, K]``, or ``[V, K]`` for one channel; w
of the same shape, float32 or bf16 (a batch's slot weights under
``"precision": "bfloat16"``, read as bf16 and widened in the kernel, as the
Pallas kernel widens them); x ``[C, N, F]`` per channel or ``[N, F]``
shared, float32 or bf16).

* ``spmm_ell_gpu`` launches the hand-written Hopper kernel ``csrc/ell.cu``
  (which replaces the Pallas ``_ell_kernel``) for CUDA tensors, ONE launch
  for all C channels, and raises if it cannot; for CPU tensors it computes
  the plain version ``spmm_ell_reference``.  ``spmm_ell_gpu.launches``
  counts kernel launches and nothing else.
* ``spmm_ell_dx_gpu`` is the backward's dx, ``dx[u] = Σ_{v,k: idx[v,k]=u}
  w[v,k] · g[v]`` per channel (channel-summed for shared x): for CUDA
  tensors one launch of the same source's dx kernel, which walks each
  sender's slot list (``ops/ell.ell_transpose``: built on the host with the
  batch, or here on the card by a stable sort when the caller has none)
  with no atomics, in the order of the reference's segment sum, so GPU runs
  repeat bitwise; for CPU tensors the plain version
  ``spmm_ell_dx_reference`` (``index_add_``, which on the CPU adds in that
  same order).  ``spmm_ell_dx_gpu.launches`` counts its launches.
* ``spmm_ell_reference`` is the forward's contract in plain PyTorch: per
  channel the gather and einsum of ``ops/ell.spmm_ell`` with f32 weights
  and an f32 sum, the channels added in channel order in f32, the result in
  x's dtype (as the Pallas kernel: f32 accumulate, out in x's dtype).  For
  one float32 channel it is ``spmm_ell`` itself.
* ``SpmmEll`` is the counterpart of the custom VJP ``spmm_ell_ad``
  (``pallas_spmm.py:107-140``): dx by ``spmm_ell_dx_gpu``, dw by
  ``einsum("vf,vkf->vk", g, x[idx])`` per channel, computed only when the
  weights need a gradient (the layers' adjacency weights are constants, so
  training never asks).
* ``coo_to_ell_device`` and ``spmm_pallas`` are the COO entry: the
  conversion on the tensors' device, and the product through ``SpmmEll``
  with the JAX package's ``max_degree`` rule (``pallas_spmm.py:159-200``).
  ``ell_transpose_device`` builds the dx kernel's slot lists there.

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

_DTYPES = (torch.float32, torch.bfloat16)


def _channels(idx, w):
    """idx, w as ``[C, V, K]`` (a ``[V, K]`` pair is one channel)."""
    return (idx[None], w[None]) if idx.dim() == 2 else (idx, w)


def _check(idx, w, x):
    if (idx.dim() not in (2, 3) or tuple(w.shape) != tuple(idx.shape)
            or x.dim() not in (2, 3) or (x.dim() == 3 and (idx.dim() != 3
                                                         or x.shape[0] != idx.shape[0]))):
        raise ValueError(
            "spmm_ell expects idx/w [V, K] or [C, V, K] and x [N, F] or [C, N, F]; "
            f"got {tuple(idx.shape)}, {tuple(w.shape)}, {tuple(x.shape)}"
        )
    devices = {t.device for t in (idx, w, x)}
    if len(devices) != 1:
        raise ValueError(f"spmm_ell operands on several devices: {devices}")


def _lib():
    lib = _build.load("ell")
    if lib.kgcn_ell_spmm.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.kgcn_ell_spmm.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
        lib.kgcn_ell_spmm.restype = i32
        lib.kgcn_ell_dx.argtypes = [ptr] * 5 + [i32] * 8 + [ptr]
        lib.kgcn_ell_dx.restype = i32
    return lib


def _call(t, fn, *args):
    """``fn(*args, stream)`` on the current stream of ``t``'s device, with
    that device made current only where it is not already."""
    dev = t.device
    if dev.index == torch.cuda.current_device():
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    with torch.cuda.device(dev):
        return fn(*args, torch.cuda.current_stream(dev).cuda_stream)


def _aligned(t):
    """``t`` contiguous, copied where its start is not 16-byte aligned (the
    kernels' vector loads)."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def _check_kernel_operands(idx, w, src):
    if idx.dtype != torch.int32:
        raise TypeError(f"ELL kernel takes int32 indices, got {idx.dtype}")
    if w.dtype not in _DTYPES:
        raise TypeError(f"ELL kernel takes float32 or bfloat16 weights, got {w.dtype}")
    if src.dtype not in _DTYPES:
        raise TypeError(f"ELL kernel takes float32 or bfloat16 x, got {src.dtype}")
    for name, t in (("idx", idx), ("w", w), ("x", src)):
        if not t.is_contiguous():
            raise ValueError(f"ELL kernel needs contiguous {name}")


def _launch(idx, w, x):
    """One launch of the forward kernel over every channel → ``[V, F]`` in
    x's dtype (idx/w ``[C, V, K]`` or ``[V, K]``)."""
    _check_kernel_operands(idx, w, x)
    x = _aligned(x)
    C, V, K = (1, *idx.shape) if idx.dim() == 2 else idx.shape
    N, F = x.shape[-2:]
    if max(C * V * K, x.numel(), V * F) >= 2**31:
        raise ValueError(f"ELL kernel takes fewer than 2^31 elements per array "
                         f"(C={C}, V={V}, K={K}, N={N}, F={F})")
    out = torch.empty((V, F), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    if K == 0 or C == 0:
        return out.zero_()
    lib = _lib()
    code = _call(x, lib.kgcn_ell_spmm, idx.data_ptr(), w.data_ptr(), x.data_ptr(),
                 out.data_ptr(), C, V, K, N, F, int(x.dim() == 2),
                 int(x.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16))
    _build.check(lib, code, "ell_spmm launch")
    spmm_ell_gpu.launches += 1
    return out


def _dx_launch(offsets, slots, w, g, x_shape):
    """One launch of the dx kernel → dx of ``x_shape`` (``[N, F]``: the
    channels' dx added in channel order; ``[C, N, F]``: one per channel) in
    g's dtype.  offsets ``[C, N + 1]`` and slots as ``ell_transpose``'s; w
    ``[C, V, K]`` or ``[V, K]``."""
    _check_kernel_operands(slots, w, g)
    if offsets.dtype != torch.int32 or not offsets.is_contiguous():
        raise TypeError("ELL dx kernel takes contiguous int32 offsets")
    if any(t.device != g.device for t in (offsets, slots, w)):
        raise ValueError(f"ELL dx operands on several devices: "
                         f"{ {t.device for t in (offsets, slots, w, g)} }")
    g = _aligned(g)
    C, V, K = (1, *w.shape) if w.dim() == 2 else w.shape
    N, F = x_shape[-2:]
    if tuple(offsets.shape) != (C, N + 1) or tuple(g.shape) != (V, F):
        raise ValueError(f"ELL dx: offsets {tuple(offsets.shape)} and g "
                         f"{tuple(g.shape)} do not fit w {tuple(w.shape)} and x "
                         f"{tuple(x_shape)}")
    if max(C * V * K, C * N * F, V * F) >= 2**31:
        raise ValueError(f"ELL dx kernel takes fewer than 2^31 elements per array "
                         f"(C={C}, V={V}, K={K}, N={N}, F={F})")
    dx = torch.empty(tuple(x_shape), device=g.device, dtype=g.dtype)
    if dx.numel() == 0:
        return dx
    if K == 0 or C == 0:
        return dx.zero_()
    lib = _lib()
    code = _call(g, lib.kgcn_ell_dx, slots.data_ptr(), offsets.data_ptr(), w.data_ptr(),
                 g.data_ptr(), dx.data_ptr(), C, V, K, N, F, int(len(x_shape) == 2),
                 int(g.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16))
    _build.check(lib, code, "ell_dx launch")
    spmm_ell_dx_gpu.launches += 1
    return dx


def spmm_ell_reference(idx, w, x):
    """The plain version: per channel ``spmm_ell`` in float32, the channels
    added in channel order in float32, cast to x's dtype."""
    idx, w = _channels(idx, w)
    xs = x.unbind(0) if x.dim() == 3 else (x,) * idx.shape[0]
    out = None
    for c, xc in enumerate(xs):
        o = spmm_ell(idx[c], w[c].to(torch.float32), xc.to(torch.float32))
        out = o if out is None else out + o
    return out.to(x.dtype)


def spmm_ell_dx_reference(idx, w, g, x_shape):
    """The plain dx: per channel ``index_add_`` of ``w[v,k]·g[v]`` into row
    ``idx[v,k]`` over the slots in (v, k) order, in float32; for a shared x
    (``x_shape`` ``[N, F]``) the channels added in channel order; cast to
    g's dtype."""
    idx, w = _channels(idx, w)
    C, V, K = idx.shape
    N, F = x_shape[-2:]
    g32 = g.to(torch.float32)
    out = []
    for c in range(C):
        contrib = (w[c].to(torch.float32)[:, :, None] * g32[:, None, :]).reshape(V * K, F)
        out.append(torch.zeros((N, F), dtype=torch.float32, device=g.device).index_add_(
            0, idx[c].reshape(-1).long(), contrib))
    if len(x_shape) == 3:
        return torch.stack(out).to(g.dtype)
    dx = out[0]
    for d in out[1:]:
        dx = dx + d
    return dx.to(g.dtype)


def spmm_ell_gpu(idx, w, x):
    """``out[v] = Σ_c Σ_k w[c,v,k] · x_c[idx[c,v,k]]``: the CUDA kernel for
    CUDA tensors (one launch), the plain version for CPU tensors.  Not
    differentiable (see ``SpmmEll``)."""
    _check(idx, w, x)
    if x.is_cuda:
        return _launch(idx.contiguous(), w.contiguous(), x.contiguous())
    return spmm_ell_reference(idx, w, x)


def spmm_ell_dx_gpu(idx, w, g, x_shape, transpose=None):
    """dx of the ELL product for cotangent ``g [V, F]``, of ``x_shape``
    (``[N, F]``: summed over channels; ``[C, N, F]``: per channel).  CUDA
    tensors: one launch of the dx kernel over ``transpose`` (``(offsets,
    slots)`` as ``ops/ell.ell_transpose`` gives them, on the card), built
    here on the card when None; CPU tensors: the plain version."""
    if not g.is_cuda:
        return spmm_ell_dx_reference(idx, w, g, x_shape)
    if transpose is None:
        transpose = ell_transpose_device(idx, w, x_shape[-2])
    offsets, slots = transpose
    return _dx_launch(offsets, slots, w.contiguous(), g, x_shape)


spmm_ell_gpu.launches = 0
spmm_ell_dx_gpu.launches = 0


class SpmmEll(torch.autograd.Function):
    """Differentiable ELL product (JAX ``spmm_ell_ad``): forward by
    ``spmm_ell_gpu``; dx by ``spmm_ell_dx_gpu`` over ``transpose`` (the
    batch's sender-grouped slot lists, or None: built on the card when
    needed); dw only when asked for; the indices get no gradient."""

    @staticmethod
    def forward(ctx, idx, w, x, transpose=None):
        ctx.save_for_backward(idx, w, x)
        ctx.transpose = transpose
        return spmm_ell_gpu(idx, w, x)

    @staticmethod
    def backward(ctx, g):
        idx, w, x = ctx.saved_tensors
        need_w, need_x = ctx.needs_input_grad[1:3]
        dw = dx = None
        if need_x:
            dx = spmm_ell_dx_gpu(idx, w, g, tuple(x.shape), ctx.transpose).to(x.dtype)
        if need_w:
            # dw[c,v,k] = ⟨g[v], x_c[idx[c,v,k]]⟩
            i3, _ = _channels(idx, w)
            xs = x.unbind(0) if x.dim() == 3 else (x,) * i3.shape[0]
            xg = torch.stack([xc[ic.long()] for xc, ic in zip(xs, i3)])
            dw = torch.einsum("vf,cvkf->cvk", g.to(torch.float32),
                              xg.to(torch.float32)).reshape(w.shape).to(w.dtype)
        return (None, dw, dx) + (None,) * (len(ctx.needs_input_grad) - 3)


def ell_transpose_device(idx, w, num_rows: int):
    """``ops/ell.ell_transpose`` on the tensors' device, with no host sync:
    a stable sort of the slots by (channel, sender), padding slots (weight
    0) keyed past the last sender, so each channel's padding follows its
    real slots and the slot list keeps all ``C·V·K`` entries (its real
    length would need a read of the card).  → ``(offsets [C, num_rows + 1],
    slots [C·V·K])`` int32, sender ``u`` of channel ``c`` owning
    ``slots[offsets[c, u] : offsets[c, u + 1]]``."""
    idx, w = _channels(idx, w)
    C, V, K = idx.shape
    dev = idx.device
    base = (torch.arange(C, device=dev) * (num_rows + 1))[:, None, None]
    key = torch.where(w != 0, idx.long(), num_rows) + base
    sorted_key, order = torch.sort(key.reshape(-1), stable=True)
    slots = (order % max(V * K, 1)).to(torch.int32)
    bounds = torch.arange(C * (num_rows + 1), device=dev)
    offsets = torch.searchsorted(sorted_key, bounds).to(torch.int32)
    return offsets.reshape(C, num_rows + 1), slots


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
    over the nonzero-weight edges, counted from host copies.  On the card
    the backward builds its slot lists there (``ell_transpose_device``)."""
    if max_degree is None:
        r = receivers.cpu().numpy()
        deg = np.zeros(num_nodes, np.int64)
        np.add.at(deg, r[weights.detach().cpu().numpy() != 0], 1)
        max_degree = max(int(deg.max()) if deg.size else 0, 1)
    idx, w = coo_to_ell_device(senders, receivers, weights, num_nodes, max_degree)
    return SpmmEll.apply(idx, w, x)
