"""The port's fused graph convolution (kgcn_tpu_torch/ops/gconv.py) against
the JAX package's ``gconv_dense`` and Pallas ``gconv_fused`` (interpret
mode), values and all four gradients.

Tolerance: float32 with rtol = atol = 1e-5 — the two packages sum the
N-term contractions in different orders, nothing else differs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.ops.gconv import gconv, gconv_reference

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)

# (C, B, N, Fin, Fout): the JAX suite's shapes (tests/test_kernels.py:16,89,
# 193 — the last is N misaligned to any tile) and the serving path's first
# layer at a cut batch
SHAPES = [(2, 3, 6, 5, 4), (2, 2, 10, 7, 5), (1, 1, 300, 5, 3), (1, 4, 47, 81, 50)]


def _inputs(shape, seed=0):
    """Operands at the scales the model gives them: a (Kipf-)normalised
    adjacency sums ~1 over a row and a Glorot weight ~1/√Fin, so outputs
    are O(1) whatever N and Fin are."""
    C, B, N, Fi, Fo = shape
    rng = np.random.RandomState(seed)
    arrs = (
        rng.standard_normal((C, B, N, N)) / np.sqrt(N),
        rng.standard_normal((B, N, Fi)),
        rng.standard_normal((C, Fi, Fo)) / np.sqrt(Fi),
        rng.standard_normal((C, Fo)),
    )
    cot = rng.standard_normal((B, N, Fo)).astype(np.float32)
    return [a.astype(np.float32) for a in arrs], cot


def _torch_value_and_grads(arrs, cot):
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    out = gconv(*ts)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _jax_value_and_grads(fn, arrs, cot):
    js = [jnp.asarray(a) for a in arrs]
    out = fn(*js)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * cot), argnums=(0, 1, 2, 3))(*js)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("shape", SHAPES)
def test_gconv_matches_gconv_dense(shape):
    from kgcn_tpu.ops.spmm import gconv_dense

    arrs, cot = _inputs(shape)
    out, grads = _torch_value_and_grads(arrs, cot)
    want, want_grads = _jax_value_and_grads(gconv_dense, arrs, cot)
    np.testing.assert_allclose(out, want, **TOL)
    for name, g, w in zip(("adj", "x", "w", "b"), grads, want_grads):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("shape", [(2, 2, 10, 7, 5), (1, 1, 300, 5, 3)])
def test_gconv_matches_pallas_interpret(shape):
    """Against the Pallas kernel itself, run in interpret mode as the JAX
    suite does (tests/test_kernels.py:79-110, 180-203)."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        from kgcn_tpu.ops.pallas_gconv import gconv_fused

        arrs, cot = _inputs(shape, seed=1)
        out, grads = _torch_value_and_grads(arrs, cot)
        want, want_grads = _jax_value_and_grads(gconv_fused, arrs, cot)
    finally:
        pl.pallas_call = orig
    np.testing.assert_allclose(out, want, **TOL)
    for name, g, w in zip(("adj", "x", "w", "b"), grads, want_grads):
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **TOL)


def test_gconv_backward_computes_only_requested_grads(monkeypatch):
    """Training never asks for dA: the backward then skips its [C,B,N,N]
    product, and the other three gradients are unchanged."""
    from kgcn_tpu.ops.spmm import gconv_dense

    arrs, cot = _inputs((2, 3, 6, 5, 4), seed=3)
    _, want = _jax_value_and_grads(gconv_dense, arrs, cot)
    shapes = []
    orig = torch.einsum
    monkeypatch.setattr(torch, "einsum",
                        lambda eq, *ops: shapes.append(eq) or orig(eq, *ops))
    adj = torch.from_numpy(arrs[0])
    rest = [torch.tensor(a, requires_grad=True) for a in arrs[1:]]
    (gconv(adj, *rest) * torch.from_numpy(cot)).sum().backward()
    assert adj.grad is None
    assert "bnf,cbmf->cbnm" not in shapes  # dA
    for name, t, w in zip(("x", "w", "b"), rest, want[1:]):
        np.testing.assert_allclose(t.grad.numpy(), w, err_msg=f"d{name}", **TOL)


def test_gconv_reference_is_the_channel_loop():
    """The plain version against the loop it stands for."""
    arrs, _ = _inputs((3, 2, 9, 4, 6), seed=2)
    adj, x, w, b = arrs
    want = np.zeros((2, 9, 6), np.float32)
    for c in range(3):
        for g in range(2):
            want[g] += adj[c, g] @ (x[g] @ w[c] + b[c])
    got = gconv_reference(*map(torch.from_numpy, arrs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_gconv_on_cpu_launches_no_kernel():
    arrs, _ = _inputs((1, 2, 5, 3, 4))
    before = gconv.launches
    gconv(*map(torch.from_numpy, arrs))
    assert gconv.launches == before


@pytest.mark.parametrize("bad", ["adj_rank", "x_nodes", "w_fin", "b_fout"])
def test_gconv_rejects_mismatched_shapes(bad):
    C, B, N, Fi, Fo = 2, 2, 5, 3, 4
    shapes = {"adj": (C, B, N, N), "x": (B, N, Fi), "w": (C, Fi, Fo), "b": (C, Fo)}
    shapes.update({
        "adj_rank": {"adj": (B, N, N)},
        "x_nodes": {"x": (B, N + 1, Fi)},
        "w_fin": {"w": (C, Fi + 1, Fo)},
        "b_fout": {"b": (C, Fo + 1)},
    }[bad])
    with pytest.raises(ValueError):
        gconv(*(torch.zeros(shapes[k]) for k in ("adj", "x", "w", "b")))


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build raises and says why (it never falls back)."""
    from kgcn_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
