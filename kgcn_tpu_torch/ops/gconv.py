"""Fused multi-channel graph convolution ``Σ_c A_c (X W_c + b_c)``.

The counterpart of ``kgcn_tpu/ops/pallas_gconv.py`` (the Pallas kernel
``_gconv_kernel`` behind ``gconv_fused``) and of its plain XLA twin
``gconv_dense`` (``kgcn_tpu/ops/spmm.py:224-234``).  Shapes as there:
adj ``[C, B, N, N]``, x ``[B, N, Fin]``, w ``[C, Fin, Fout]``, b ``[C, Fout]``
→ ``[B, N, Fout]``.

* ``gconv`` is the op the layers call, registered as the custom op
  ``kgcn_torch::gconv`` (``torch.ops.kgcn_torch.gconv``) with a fake
  implementation for its output's shape, so that ``torch.export`` captures
  it as one call (``runtime/export.py``).  On CUDA tensors it launches the
  hand-written Hopper kernel ``csrc/gconv.cu`` (any N and B: one launch
  per call for molecule-sized graphs, else the projection ``X W_c + b_c``
  into a scratch the wrapper allocates, then the aggregation over it):
  ``kgcn_gconv_f32`` on float32 operands (FP32 FMAs, one launch up to 64
  nodes), ``kgcn_gconv_bf16`` on bf16 ones (``"precision": "bfloat16"``:
  the Pallas kernel's semantics on bf16 refs, f32 sums and one rounding to
  bf16 at the output, on the tensor cores, one launch up to 256 nodes); a
  mix of types raises ``TypeError``.  On CPU tensors it computes
  ``gconv_reference``.  It never falls back from one to the other.
* The backward is the torch translation of ``_bwd``
  (``pallas_gconv.py:139-152``): einsums for dA, dX, dW and db, as the JAX
  package computes it with XLA einsums, in the operands' dtype.
* ``gconv.launches`` counts the CUDA kernels a call launched, as the C
  entry reports them (one, or the two or three of the projection, the
  aggregation and the sum of its split runs), and nothing else, so a run
  can show that its path went through the kernel; ``gconv.bf16_launches``
  counts those of the bf16 entry alone.
"""
from __future__ import annotations

import ctypes

import torch

from kgcn_tpu_torch.ops import _build

def gconv_reference(adj, x, w, b):
    """Plain PyTorch version: per-channel ``X W_c + b_c``, then aggregate —
    the kernel's arithmetic, one einsum at a time.  bf16 operands are
    widened to float32 and the result rounded to bf16 once (the Pallas
    kernel's f32 accumulation, ``pallas_gconv.py:33-53``)."""
    dtype = x.dtype
    if dtype == torch.bfloat16:
        adj, x, w, b = (t.to(torch.float32) for t in (adj, x, w, b))
    hw = torch.einsum("bmi,cif->cbmf", x, w) + b[:, None, None, :]
    return torch.einsum("cbnm,cbmf->bnf", adj, hw).to(dtype)


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


# (entry, its scratch size in floats) by operand type
_ENTRIES = {torch.float32: ("kgcn_gconv_f32", "kgcn_gconv_f32_scratch_floats"),
            torch.bfloat16: ("kgcn_gconv_bf16", "kgcn_gconv_bf16_scratch_floats")}


def _launch(adj, x, w, b):
    """One call of the CUDA kernel: all four operands float32
    (``kgcn_gconv_f32``) or all bf16 (``kgcn_gconv_bf16``, which reads them
    as bf16: no float32 copy is made), contiguous, on one device; the
    output in their type."""
    dtypes = {t.dtype for t in (adj, x, w, b)}
    if len(dtypes) != 1 or x.dtype not in _ENTRIES:
        raise TypeError(
            "gconv CUDA kernel takes all-float32 or all-bfloat16 operands; got "
            f"adj {adj.dtype}, x {x.dtype}, w {w.dtype}, b {b.dtype}")
    for name, t in (("adj", adj), ("x", x), ("w", w), ("b", b)):
        if not t.is_contiguous():
            raise ValueError(f"gconv CUDA kernel needs contiguous {name}")
    if x.dtype == torch.bfloat16:
        # the bf16 kernel stages rows with 16-byte copies from tensors that
        # start on a 16-byte boundary: a view that does not is copied
        adj, x, w = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (adj, x, w))
    C, B, N, _ = adj.shape
    Fin, Fout = w.shape[1], w.shape[2]
    out = torch.empty((B, N, Fout), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    lib = _build.load("gconv")
    fn, sizer = (getattr(lib, name) for name in _ENTRIES[x.dtype])
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
        fn.restype = ctypes.c_int
        sizer.argtypes = [ctypes.c_int] * 5
        sizer.restype = ctypes.c_longlong
    # the projection's (and the split runs') float32 scratch where the
    # kernel takes its two-launch design (none for graphs it takes in one
    # launch)
    floats = sizer(C, B, N, Fin, Fout)
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
    if x.dtype == torch.bfloat16:
        gconv.bf16_launches += launched.value
    return out


@torch.library.custom_op("kgcn_torch::gconv", mutates_args=())
def _gconv_op(adj: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
              b: torch.Tensor) -> torch.Tensor:
    """The op: the CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if adj.is_cuda:
        return _launch(adj, x, w, b)
    return gconv_reference(adj, x, w, b)


@_gconv_op.register_fake
def _gconv_fake(adj, x, w, b):
    """The output's shape and type, for tracing (``torch.export``)."""
    dtype = torch.promote_types(torch.promote_types(adj.dtype, x.dtype),
                                torch.promote_types(w.dtype, b.dtype))
    return x.new_empty((x.shape[0], x.shape[1], w.shape[2]), dtype=dtype)


def _setup_context(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _backward(ctx, g):
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


_gconv_op.register_autograd(_backward, setup_context=_setup_context)


def gconv(adj, x, w, b):
    """``Σ_c A_c (X W_c + b_c)``: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors; differentiable in all four operands."""
    _check(adj, x, w, b)
    return _gconv_op(adj, x, w, b)


gconv.launches = 0
gconv.bf16_launches = 0  # the bf16 kernel's launches (in gconv.launches too)
