"""What the reference models share: their matrix product in a stated
precision, the sparse aggregation ``out[r] = Σ_e w_e · x[c_e]`` with its
payload dtype, and optax's Adam.

Precisions: ``"float32"`` computes every product in float32 (TF32 off, as
the configurations state); ``"tf32"`` rounds both operands of every matrix
product, forward and backward, to TF32's 10-bit mantissa (round to nearest
even) and sums in float32, as the card's TF32 tensor cores do.  The
rounding is done here rather than by cuBLAS's switch, so that the control
reads the same on the CPU and on the card.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

@contextlib.contextmanager
def full_float32():
    """Float32 library products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 (10 mantissa bits, nearest even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = g @ round_tf32(b).transpose(-1, -2) if ctx.needs_input_grad[0] else None
        gb = round_tf32(a).transpose(-1, -2) @ g if ctx.needs_input_grad[1] else None
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float32":
        return a @ b
    if precision == "tf32":
        return _TF32Matmul.apply(a, b)
    raise ValueError(f"unknown precision {precision!r}")


class _RoundedScatter(torch.autograd.Function):
    """``out[r] = Σ_e bf16(w_e)·bf16(x[c_e])`` (products exact in float32,
    float32 sums); its input gradient ``dx[c] = Σ_e bf16(w_e)·bf16(dy[r_e])``:
    a payload rounded to bf16 on the way into each sum."""

    @staticmethod
    def forward(ctx, x, row, col, w, n_out):
        ctx.save_for_backward(row, col, w)
        ctx.n_in = x.shape[0]
        wr = round_bf16(w)[:, None]
        return x.new_zeros(n_out, x.shape[1]).index_add_(0, row, round_bf16(x)[col] * wr)

    @staticmethod
    def backward(ctx, dy):
        row, col, w = ctx.saved_tensors
        wr = round_bf16(w)[:, None]
        dx = dy.new_zeros(ctx.n_in, dy.shape[1]).index_add_(0, col, round_bf16(dy)[row] * wr)
        return dx, None, None, None, None


def aggregate(x: torch.Tensor, row: torch.Tensor, col: torch.Tensor, w: torch.Tensor,
              n_out: int, payload: str = "float32") -> torch.Tensor:
    """``out[row_e] += w_e · x[col_e]`` over the edges, the payload in
    ``payload`` (``"float32"`` or ``"bfloat16"``)."""
    if payload == "bfloat16":
        return _RoundedScatter.apply(x, row, col, w, n_out)
    if payload != "float32":
        raise ValueError(f"unknown payload {payload!r}")
    return x.new_zeros(n_out, x.shape[1]).index_add_(0, row, x[col] * w[:, None])


def _bias_correction(decay: float, t: int) -> float:
    """``1 − decay^t`` in float32, as optax computes it (with 0.999 rounded
    to float32, the first step's correction is 1.3e-5 below 0.001)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(t))


class Adam:
    """optax.adam: ``m ← b1·m + (1-b1)·g``, ``v ← b2·v + (1-b2)·g²``, the
    update ``-lr · m̂ / (√v̂ + eps)`` with the bias corrections of step t."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]) -> None:
        self.t += 1
        c1 = _bias_correction(self.b1, self.t)
        c2 = _bias_correction(self.b2, self.t)
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_((1.0 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            upd = (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
            params[k].sub_(self.lr * upd)


def leaf_norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().to(torch.float64)))


def train_readings(loss_fn, weights: Dict[str, torch.Tensor], batches, lr: float,
                   check_steps: int, frozen: bool = False) -> dict:
    """The reference's Adam steps from ``weights``, one a batch:
    {"loss": [each step's summed loss], "grad": {leaf: ‖first gradient‖},
    "delta": {leaf: ‖parameters after ``check_steps`` steps − before‖},
    "epoch_delta": the same after every step, "epoch_mu": {leaf: ‖Adam's
    first moment after every step‖}}.  ``loss_fn`` (parameters, batch) →
    (loss to optimise, summed loss).  ``frozen``: a step that returns its
    state unchanged (a fault the comparison has to catch): no update, and
    Adam's moments, from which the program's gradient is read, stay
    nought."""
    params = {k: v.detach().clone() for k, v in weights.items()}
    opt = Adam(params, lr)
    out = {"loss": [], "grad": {}, "delta": {}}
    for i, batch in enumerate(batches):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        opt_loss, summed = loss_fn(leaves, batch)
        names = list(leaves)
        grads = torch.autograd.grad(opt_loss, [leaves[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        out["loss"].append(float(summed.detach()))
        if i == 0:
            out["grad"] = {k: 0.0 if frozen else leaf_norm(g) for k, g in grads.items()}
        if not frozen:
            opt.step(params, grads)
        if i + 1 == check_steps:
            out["delta"] = {k: leaf_norm(params[k] - weights[k]) for k in params}
    out["epoch_delta"] = {k: leaf_norm(params[k] - weights[k]) for k in params}
    out["epoch_mu"] = {k: leaf_norm(m) for k, m in opt.m.items()}
    return out
