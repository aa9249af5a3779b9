"""Fused multi-channel graph convolution ``Σ_c A_c (X W_c + b_c)``.

The counterpart of ``kgcn_tpu/ops/pallas_gconv.py`` (the Pallas kernel
``_gconv_kernel`` behind ``gconv_fused``) and of its plain XLA twin
``gconv_dense`` (``kgcn_tpu/ops/spmm.py:224-234``).  Shapes as there:
adj ``[C, B, N, N]``, x ``[B, N, Fin]``, w ``[C, Fin, Fout]``, b ``[C, Fout]``
→ ``[B, N, Fout]``.

* ``gconv`` is the op the layers call.  On CUDA tensors it launches the
  hand-written Hopper kernel ``csrc/gconv.cu`` (float32, any N and B: one
  launch per call for molecule-sized graphs, else the projection
  ``X W_c + b_c`` into a scratch the wrapper allocates, then the
  aggregation over it); on CPU tensors it computes ``gconv_reference``.  It
  never falls back from one to the other.
* The backward is the torch translation of ``_bwd``
  (``pallas_gconv.py:139-152``): einsums for dA, dX, dW and db, as the JAX
  package computes it with XLA einsums.
* ``gconv.launches`` counts the CUDA kernels a call launched, as the C
  entry reports them (one, or the two or three of the projection, the
  aggregation and the sum of its split runs), and nothing else, so a run
  can show that its path went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from kgcn_tpu_torch.ops import _build

def gconv_reference(adj, x, w, b):
    """Plain PyTorch version: per-channel ``X W_c + b_c``, then aggregate —
    the kernel's arithmetic, one einsum at a time."""
    hw = torch.einsum("bmi,cif->cbmf", x, w) + b[:, None, None, :]
    return torch.einsum("cbnm,cbmf->bnf", adj, hw)


def _check(adj, x, w, b):
    if adj.dim() != 4 or x.dim() != 3 or w.dim() != 3 or b.dim() != 2:
        raise ValueError(
            "gconv expects adj [C,B,N,N], x [B,N,Fin], w [C,Fin,Fout], "
            f"b [C,Fout]; got {tuple(adj.shape)}, {tuple(x.shape)}, "
            f"{tuple(w.shape)}, {tuple(b.shape)}"
        )
    C, B, N, N2 = adj.shape
    Fin, Fout = w.shape[1], w.shape[2]
    if (N2 != N or tuple(x.shape) != (B, N, Fin)
            or tuple(w.shape) != (C, Fin, Fout) or tuple(b.shape) != (C, Fout)):
        raise ValueError(
            f"gconv shape mismatch: adj {tuple(adj.shape)}, x "
            f"{tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}"
        )
    devices = {t.device for t in (adj, x, w, b)}
    if len(devices) != 1:
        raise ValueError(f"gconv operands on several devices: {devices}")


def _launch(adj, x, w, b):
    """One call of the CUDA kernel; float32, contiguous, one device."""
    for name, t in (("adj", adj), ("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(
                f"gconv CUDA kernel takes float32 only; {name} is {t.dtype} "
                "(bf16 is listed in ROADMAP.md)"
            )
        if not t.is_contiguous():
            raise ValueError(f"gconv CUDA kernel needs contiguous {name}")
    C, B, N, _ = adj.shape
    Fin, Fout = w.shape[1], w.shape[2]
    out = torch.empty((B, N, Fout), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    lib = _build.load("gconv")
    fn = lib.kgcn_gconv_f32
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        lib.kgcn_gconv_f32_scratch_floats.argtypes = [ctypes.c_int] * 5
        lib.kgcn_gconv_f32_scratch_floats.restype = ctypes.c_longlong
    # the projection's (and the split runs') scratch where the kernel takes
    # its two-launch design (none for molecule-sized graphs)
    floats = lib.kgcn_gconv_f32_scratch_floats(C, B, N, Fin, Fout)
    scratch = (torch.empty(floats, device=x.device, dtype=torch.float32)
               if floats else None)
    launched = ctypes.c_int(0)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(adj.data_ptr(), x.data_ptr(), w.data_ptr(), b.data_ptr(),
                  0 if scratch is None else scratch.data_ptr(), out.data_ptr(),
                  C, B, N, Fin, Fout, stream, ctypes.byref(launched))
    _build.check(lib, code, "gconv launch")
    gconv.launches += launched.value
    return out


class _GConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, adj, x, w, b):
        ctx.save_for_backward(adj, x, w, b)
        if adj.is_cuda:
            return _launch(adj, x, w, b)
        return gconv_reference(adj, x, w, b)

    @staticmethod
    def backward(ctx, g):
        """dX = Σ_c A_cᵀ g W_cᵀ; dW_c = Σ_b X_bᵀ (A_cᵀ g); db_c = Σ A_cᵀ g;
        dA[c,b,n,m] = g[b,n,:] · (X_b W_c + b_c)[m,:].  Each only when asked
        for: training never asks for dA, the [C,B,N,N] product."""
        adj, x, w, b = ctx.saved_tensors
        need_adj, need_x, need_w, need_b = ctx.needs_input_grad
        dadj = dx = dw = db = None
        if need_x or need_w or need_b:
            at_g = torch.einsum("cbnm,bnf->cbmf", adj, g)
            if need_x:
                dx = torch.einsum("cbmf,cof->bmo", at_g, w)
            if need_w:
                dw = torch.einsum("bmi,cbmf->cif", x, at_g)
            if need_b:
                db = at_g.sum(dim=(1, 2))
        if need_adj:
            hw = torch.einsum("bmi,cif->cbmf", x, w) + b[:, None, None, :]
            dadj = torch.einsum("bnf,cbmf->cbnm", g, hw)
        return dadj, dx, dw, db


def gconv(adj, x, w, b):
    """``Σ_c A_c (X W_c + b_c)``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; differentiable in all four operands."""
    _check(adj, x, w, b)
    return _GConv.apply(adj, x, w, b)


gconv.launches = 0
