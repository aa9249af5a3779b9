"""Fused Adam / AdamW update: every leaf's parameters and moments updated in
place in one launch of ``csrc/adam.cu``.

The kernel replaces no TPU kernel (``kgcn_tpu`` leaves optax's update to
XLA); it is the captured training step's optimizer update
(``runtime/optim.make_optimizer`` gives the Adam and AdamW chains a
``plan`` and an ``apply_row`` that calls ``adam``), where the generic
update ran about 17 PyTorch kernels a leaf.  Its arithmetic is the generic
update's, one rounding at a time in the same order, so the two give the
same bits (``adam_reference`` is that arithmetic in PyTorch).

* ``Plan(names, params, mu, nu)``: the device tables of the leaves'
  parameter and moment pointers, made once for buffers that stay put (a
  runner's static buffers; the runner keeps the plan with its graph).  A
  table takes at most ``MAX_LEAVES`` leaves, the gradients one launch
  passes by value; a larger model takes a launch a table.
* ``adam(plan, grads, row, hyper)``: the update of the plan's leaves in
  place from ``grads``, on the card.  ``row`` holds the bias corrections
  ``c1``, ``c2`` and, under a schedule, ``-lr`` at ``hyper.lr_col`` (the
  optimizer's table row of the step, on the device).
* ``refusal(...)``: why the kernel does not take these tensors, or None.
* ``fall_back(why)``: the dispatch's record of a step on the card that
  took the generic update instead; ``adam.fallbacks`` counts them and the
  first warns.
* ``adam.launches`` counts the kernel's launches (a replayed graph's are
  not counted: they are the warm-up's and the capture's).
"""
from __future__ import annotations

import ctypes
import warnings
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from kgcn_tpu_torch.ops import _build

CHUNK = 2048       # elements of a leaf a block takes at a time (csrc/adam.cu)
MAX_LEAVES = 256   # gradients a launch passes by value (csrc/adam.cu)


class Hyper(NamedTuple):
    """The update's numbers: Adam's ``b1``, ``b2``, ``eps``; AdamW's
    ``weight_decay`` (None: no decay term); the learning rate as the
    constant ``-lr`` (``neg_lr``) or as the row's column ``lr_col``."""
    b1: float
    b2: float
    eps: float
    weight_decay: Optional[float]
    neg_lr: Optional[float]
    lr_col: Optional[int]


def _f32(x: float) -> float:
    """``x`` rounded to float32, as PyTorch rounds a Python number against
    a float32 tensor."""
    return float(np.float32(x))


def adam_reference(params, grads, mu, nu, row, hyper: Hyper) -> None:
    """The kernel's arithmetic in PyTorch, in place: each operation rounded
    on its own, in the kernel's (and the generic update's) order."""
    h = hyper
    rc1, rc2 = torch.reciprocal(row[0]), torch.reciprocal(row[1])
    neg_lr = row[h.lr_col] if h.lr_col is not None else _f32(h.neg_lr)
    for p, g, m, v in zip(params, grads, mu, nu):
        m.copy_(_f32(1 - h.b1) * g + _f32(h.b1) * m)
        v.copy_(_f32(1 - h.b2) * g * g + _f32(h.b2) * v)
        u = m * rc1 / (torch.sqrt(v * rc2) + _f32(h.eps))
        if h.weight_decay is not None:
            u = u + _f32(h.weight_decay) * p
        p.add_(neg_lr * u)


def on_card(t: torch.Tensor) -> bool:
    return t.is_cuda


def refusal(params, mu, nu, grads=None, row=None) -> Optional[str]:
    """Why the kernel does not take these tensors, or None: it takes
    float32 tensors on one CUDA device, contiguous but for the gradients
    (a strided one goes in as a contiguous copy: an einsum's backward may
    hand a kernel's gradient over transposed), each leaf's parameter,
    moments and gradient of one shape."""
    lists = [params, mu, nu] + ([grads] if grads is not None else [])
    if not params or len({len(x) for x in lists}) != 1:
        return "leaf lists of different lengths"
    rows = [row] if row is not None else []
    tensors = [t for x in lists for t in x] + rows
    if not all(on_card(t) for t in tensors):
        return "a tensor off the card"
    wrong = next((t.dtype for t in tensors if t.dtype != torch.float32), None)
    if wrong is not None:
        return f"a {wrong} tensor (the kernel takes float32)"
    if len({t.device for t in tensors}) != 1:
        return "tensors on more than one device"
    if not all(t.is_contiguous() for t in [*params, *mu, *nu, *rows]):
        return "a parameter or moment that is not contiguous"
    if not all(len({tuple(t.shape) for t in leaf}) == 1 for leaf in zip(*lists)):
        return "a leaf whose parameter, moments and gradient differ in shape"
    return None


class Plan:
    """The kernel's device tables for one set of parameter and moment
    buffers whose addresses do not move, made once (a runner makes it from
    its static buffers and keeps it with its graph): a table, and a launch,
    for each run of at most ``MAX_LEAVES`` leaves (``groups``: first leaf,
    end, table, chunks).  ``names``: the leaves' names, in the tables'
    order."""

    def __init__(self, names: Sequence[str], params: Sequence[torch.Tensor],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor]):
        why = refusal(params, mu, nu)
        if why is not None or len(names) != len(params):
            raise ValueError(f"the fused Adam kernel does not take these buffers: {why}")
        self.names, self.params, self.mu, self.nu = list(names), list(params), list(mu), list(nu)
        self.groups = []
        for lo in range(0, len(params), MAX_LEAVES):
            hi = min(lo + MAX_LEAVES, len(params))
            leaves = np.array([(p.data_ptr(), m.data_ptr(), v.data_ptr(), p.numel())
                               for p, m, v in zip(params[lo:hi], mu[lo:hi], nu[lo:hi])],
                              np.int64)
            first = np.concatenate([[0], np.cumsum(-(-leaves[:, 3] // CHUNK))])
            host = torch.from_numpy(np.concatenate([leaves.reshape(-1), first]))
            table = torch.empty_like(host, device=params[0].device)
            # from pinned memory without blocking, as the runner uploads its
            # tables: a step never synchronises with the card
            table.copy_(host.pin_memory() if table.is_cuda else host, non_blocking=True)
            self.groups.append((lo, hi, table, int(first[-1])))


def fall_back(why: str) -> None:
    """Record a step of a fused-capable chain on the card that took the
    generic update (about 17 kernels a leaf) instead: ``adam.fallbacks``
    counts them; the first warns, with ``why``."""
    adam.fallbacks += 1
    if adam.fallbacks == 1:
        warnings.warn(f"the fused Adam update does not take this step ({why}); the "
                      "generic update runs instead", RuntimeWarning, stacklevel=3)


def adam(plan: Plan, grads: Sequence[torch.Tensor], row: torch.Tensor,
         hyper: Hyper) -> None:
    """The Adam (AdamW) update of ``plan``'s leaves in place: its
    parameters and moments overwritten, leaf ``i`` from ``grads[i]`` (in
    ``plan.names``' order), in one launch a table.  Raises where the kernel
    does not take the tensors (``refusal``)."""
    why = refusal(plan.params, plan.mu, plan.nu, grads, row)
    if why is not None:
        raise ValueError(f"the fused Adam kernel does not take these tensors: {why}")
    lib = _build.load("adam")
    fn = lib.kgcn_adam
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p] + [ctypes.c_float] * 6 + [ctypes.c_int]
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    h = hyper
    grads = [g.contiguous() for g in grads]  # alive until the launches are queued
    with torch.cuda.device(row.device):
        stream = torch.cuda.current_stream(row.device).cuda_stream
        for lo, hi, table, chunks in plan.groups:
            g_ptrs = (ctypes.c_void_p * (hi - lo))(*(g.data_ptr() for g in grads[lo:hi]))
            code = fn(table.data_ptr(), g_ptrs, hi - lo, chunks, CHUNK, row.data_ptr(),
                      _f32(h.b1), _f32(1 - h.b1), _f32(h.b2), _f32(1 - h.b2), _f32(h.eps),
                      _f32(h.weight_decay or 0.0), int(h.weight_decay is not None),
                      _f32(h.neg_lr or 0.0), -1 if h.lr_col is None else int(h.lr_col),
                      stream)
            _build.check(lib, code, "adam launch")
            adam.launches += 1


adam.launches = 0
adam.fallbacks = 0
