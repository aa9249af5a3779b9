"""The port's fused graph convolution (kgcn_tpu_torch/ops/gconv.py) against
the JAX package's ``gconv_dense`` and Pallas ``gconv_fused`` (interpret
mode), values and all four gradients.

Tolerance: float32 with rtol = atol = 1e-5 — the two packages sum the
N-term contractions in different orders, nothing else differs.
"""
import contextlib
import functools
import types

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


@pytest.mark.parametrize("shape", [(1, 2, 600, 4, 3), (2, 1, 1024, 3, 2)])
def test_gconv_large_graphs_match_gconv_dense(shape):
    """Dense graphs of 600 and 1024 nodes at narrow widths (the kernel's
    two-launch design on the card).  Value and dX as above (rtol = atol =
    1e-5); dA, dW and
    db sum over up to B·N·N terms (7·10⁵), so their atol is 1e-5 of their
    largest magnitude."""
    from kgcn_tpu.ops.spmm import gconv_dense

    arrs, cot = _inputs(shape, seed=4)
    out, grads = _torch_value_and_grads(arrs, cot)
    want, want_grads = _jax_value_and_grads(gconv_dense, arrs, cot)
    np.testing.assert_allclose(out, want, **TOL)
    for name, g, w in zip(("adj", "x", "w", "b"), grads, want_grads):
        tol = TOL if name == "x" else dict(rtol=1e-5, atol=1e-5 * np.abs(w).max())
        np.testing.assert_allclose(g, w, err_msg=f"d{name}", **tol)


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


class _FakeLib:
    """A stand-in for the built library: records each kernel call's sizes
    and returns CUDA success (and, as the scratch size and the count of
    kernels launched, the two-launch design's beyond 64 nodes)."""

    def __init__(self):
        self.calls = []
        lib = self

        def kgcn_gconv_f32(*args):
            lib.calls.append(args[6:11])  # C, B, N, Fin, Fout
            args[12]._obj.value = 2 if args[8] > 64 else 1  # kernels launched
            return 0

        def kgcn_gconv_f32_scratch_floats(C, B, N, Fin, Fout):
            return C * B * N * Fout if N > 64 else 0

        kgcn_gconv_f32.argtypes = None
        self.kgcn_gconv_f32 = kgcn_gconv_f32
        self.kgcn_gconv_f32_scratch_floats = kgcn_gconv_f32_scratch_floats


@pytest.mark.parametrize("shape", [(1, 1, 1024, 3, 2), (1, 70_000, 2, 3, 2)])
def test_gconv_launch_has_no_size_bound(monkeypatch, shape):
    """The CUDA wrapper passes any N and B to the kernel (the kernel streams
    N and walks B in a grid-stride loop): nothing is refused for size."""
    from kgcn_tpu_torch.ops import _build
    from kgcn_tpu_torch.ops import gconv as gm

    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(gm.gconv, "launches", 0)
    C, B, N, Fi, Fo = shape
    out = gm._launch(torch.zeros(C, B, N, N), torch.zeros(B, N, Fi),
                     torch.zeros(C, Fi, Fo), torch.zeros(C, Fo))
    assert fake.calls == [shape] and out.shape == (B, N, Fo)
    assert gm.gconv.launches == (2 if N > 64 else 1)  # the kernels it launched


def test_gconv_bf16_launch_passes_16_byte_aligned_operands(monkeypatch):
    """The bf16 entry stages rows with 16-byte copies and refuses operands
    that do not start on a 16-byte boundary: the wrapper passes such a view
    as a copy (the same values), an aligned tensor as it is, and counts the
    launch in ``gconv.launches`` and ``gconv.bf16_launches``."""
    from kgcn_tpu_torch.ops import _build
    from kgcn_tpu_torch.ops import gconv as gm

    seen = []

    def kgcn_gconv_bf16(*args):
        seen.append(args[:3])  # adj, x, w
        args[12]._obj.value = 1
        return 0

    kgcn_gconv_bf16.argtypes = None
    fake = types.SimpleNamespace(
        kgcn_gconv_bf16=kgcn_gconv_bf16,
        kgcn_gconv_bf16_scratch_floats=lambda C, B, N, Fin, Fout: 0)
    monkeypatch.setattr(_build, "load", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(gm.gconv, "launches", 0)
    monkeypatch.setattr(gm.gconv, "bf16_launches", 0)

    def view_at(t, offset):  # t's values in a tensor starting `offset` elements in
        buf = torch.zeros(t.numel() + offset, dtype=t.dtype)
        v = buf[offset:].view(t.shape)
        v.copy_(t)
        return v

    adj, x, w, b = (t.to(torch.bfloat16) for t in _op_inputs(C=2, B=3, N=5, Fi=4, Fo=6))
    ops = [view_at(adj, 1), view_at(x, 8), view_at(w, 3), b]
    assert [t.data_ptr() % 16 for t in ops[:3]] == [2, 0, 6]
    gm._launch(*ops)
    (p_adj, p_x, p_w), = seen
    assert p_adj % 16 == 0 and p_w % 16 == 0
    assert p_x == ops[1].data_ptr()  # aligned: passed as it is
    assert gm.gconv.launches == 1 and gm.gconv.bf16_launches == 1


# ---- the custom op (torch.export captures it) ------------------------------


def _op_inputs(C=2, B=3, N=5, Fi=4, Fo=6, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(C, B, N, N, generator=g), torch.rand(B, N, Fi, generator=g),
            torch.rand(C, Fi, Fo, generator=g), torch.rand(C, Fo, generator=g))


def test_gconv_is_the_custom_op_and_its_cpu_path_is_the_plain_version():
    """``gconv`` calls ``torch.ops.kgcn_torch.gconv``; on CPU tensors it is
    ``gconv_reference`` bit for bit, and its backward the einsum backward
    (against autograd through the plain version, 1e-5)."""
    adj, x, w, b = (t.requires_grad_(True) for t in _op_inputs())
    out = gconv(adj, x, w, b)
    assert torch.equal(out, gconv_reference(adj, x, w, b))
    assert torch.equal(torch.ops.kgcn_torch.gconv(adj, x, w, b), out)
    g = torch.rand(out.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(out, (adj, x, w, b), g)
    want = torch.autograd.grad(gconv_reference(adj, x, w, b), (adj, x, w, b), g)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)
    # only the gradients asked for are computed (training never asks for dA)
    dx, = torch.autograd.grad(gconv(adj.detach(), x, w.detach(), b.detach()), (x,), g)
    torch.testing.assert_close(dx, want[1], rtol=1e-5, atol=1e-5)


def test_gconv_fake_tensor_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        adj, x, w, b = _op_inputs(C=3, B=7, N=11, Fi=9, Fo=13)
        out = gconv(adj, x, w, b)
        assert tuple(out.shape) == (7, 11, 13) and out.dtype == torch.float32
    meta = [t.to("meta") for t in _op_inputs()]
    assert tuple(torch.ops.kgcn_torch.gconv(*meta).shape) == (3, 5, 6)


@pytest.mark.parametrize("shape", [(1, 2, 4, 3, 5), (3, 1, 7, 2, 2), (2, 4, 9, 5, 1)])
def test_gconv_opcheck(shape):
    """``torch.library.opcheck``: the schema, the fake implementation, the
    autograd registration and AOT dispatch."""
    C, B, N, Fi, Fo = shape
    inputs = tuple(t.requires_grad_(True) for t in _op_inputs(C, B, N, Fi, Fo, seed=C))
    result = torch.library.opcheck(torch.ops.kgcn_torch.gconv.default, inputs)
    assert set(result.values()) == {"SUCCESS"}, result
