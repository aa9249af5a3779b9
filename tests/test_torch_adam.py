"""The fused Adam update (``ops/adam.py``, ``csrc/adam.cu``) and the
dispatch to it (``runtime/optim.make_optimizer``'s ``apply_row``).

On the CPU: the kernel's arithmetic (``adam_reference``, and an emulation
of the C entry that reads its leaf table and gradient pointers) against the
generic update as it runs on the card, bitwise; which chains and leaves take
the fused launch, with the C entry mocked, and that the others fall back
counted and warned of.  On the card (``card``: skipped without one): seven
fused updates, eager and captured, bitwise the generic update's.  This file
imports no JAX; on the card it runs alone:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_adam.py
"""
from __future__ import annotations

import contextlib
import ctypes
import types

import numpy as np
import pytest
import torch

from kgcn_tpu_torch.ops import _build
from kgcn_tpu_torch.ops import adam as fa
from kgcn_tpu_torch.runtime import optim as topt

FUSED = {
    "adam": {}, "adamw": {"optimizer": "adamw", "weight_decay": 0.01},
    "adamw_no_decay": {"optimizer": "adamw"},
    "warmup_cosine": {"lr_schedule": "warmup_cosine", "warmup_steps": 2, "decay_steps": 6},
    "adamw_exponential": {"optimizer": "adamw", "weight_decay": 0.02,
                          "lr_schedule": "exponential", "decay_steps": 2},
}
GENERIC = {
    "adam_clip": {"gradient_clip": 0.1}, "grad_accum": {"grad_accum_steps": 3},
    "sgd": {"optimizer": "sgd"}, "momentum": {"optimizer": "momentum"},
    "rmsprop": {"optimizer": "rmsprop"}, "lamb": {"optimizer": "lamb", "weight_decay": 0.01},
}
SIZES = (1, 5, 2_200, 20_014)  # not multiples of 4 but one: the kernel's scalar tails


def _card_div(x, c):
    """``optim._div`` as it runs on the card: times the float32 reciprocal."""
    return x * torch.reciprocal(c) if isinstance(c, torch.Tensor) else x / c


def _leaves(sizes, seed, device="cpu", dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return {f"w{i}": torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        device=device, dtype=dtype) for i, n in enumerate(sizes)}


def _grads(params, steps, seed):
    rng = np.random.RandomState(seed)
    return [{k: torch.from_numpy((rng.standard_normal(tuple(v.shape)) * (s + 1)).astype(
        np.float32)).to(device=v.device, dtype=v.dtype) for k, v in params.items()}
        for s in range(steps)]


def _run(tx, params, grads, apply, device="cpu", epochs=(4, 3)):
    """``apply(grads, state, params, row, plan)`` over ``grads`` in epochs of
    the optimizer's table (rows on ``device``), as the runner steps, the
    plan made once of the buffers; → (params, state, what each apply
    returned)."""
    state, done, out = tx.init(params), 0, []
    plan = tx.plan(state, params)
    for n in epochs:
        table = torch.from_numpy(tx.table(state, n)).to(device)
        for j in range(n):
            out.append(apply(grads[done + j], state, params, table[j], plan))
        state = tx.advance(state, n)
        done += n
    return params, state, out


def _tree(t):
    return [x for v in t.values() for x in _tree(v)] if isinstance(t, dict) else [t]


def _equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(_tree(a), _tree(b)))


class _EmulatedLib:
    """The C entry ``kgcn_adam`` emulated: it reads the leaf table and the
    gradient pointers it is given, as the kernel does, and updates the
    buffers they point at in place with the scalars it is given
    (``adam_reference``: the kernel's roundings, in PyTorch, whose CPU
    square root is the CPU generic update's)."""

    def __init__(self):
        self.calls = []
        lib = self

        def kgcn_adam(table, grads, leaves, chunks, chunk, row, b1, omb1, b2, omb2, eps,
                      wd, decay, neg_lr, lr_col, stream):
            lib.calls.append(dict(table=table, leaves=leaves, chunks=chunks, chunk=chunk,
                                  decay=decay, neg_lr=neg_lr, lr_col=lr_col))
            tab = np.ctypeslib.as_array((ctypes.c_int64 * (5 * leaves + 1)).from_address(table))
            first = tab[4 * leaves:]
            assert first[0] == 0 and first[-1] == chunks

            def at(ptr, n, kind=ctypes.c_float):
                return torch.from_numpy(np.ctypeslib.as_array((kind * n).from_address(ptr)))
            bufs = []
            for i in range(leaves):
                p, m, v, n = (int(x) for x in tab[4 * i:4 * i + 4])
                assert first[i + 1] - first[i] == -(-n // chunk)
                bufs.append((at(p, n), at(grads[i], n), at(m, n), at(v, n)))
            f32 = np.float32  # make_optimizer's Adam, rounded as PyTorch rounds it
            assert (b1, omb1, b2, omb2, eps) == (f32(0.9), f32(1 - 0.9), f32(0.999),
                                                 f32(1 - 0.999), f32(1e-8))
            fa.adam_reference(*zip(*bufs), at(row, max(2, lr_col + 1)), fa.Hyper(
                0.9, 0.999, 1e-8, wd if decay else None, neg_lr,
                lr_col if lr_col >= 0 else None))
            return 0

        kgcn_adam.argtypes = None
        self.kgcn_adam = kgcn_adam


@pytest.fixture
def emulated(monkeypatch):
    """CPU tensors taken for CUDA ones by the dispatch, the C entry
    emulated (``_EmulatedLib``), the launch and fallback counters at 0."""
    fake = _EmulatedLib()
    monkeypatch.setattr(fa, "on_card", lambda t: True)
    monkeypatch.setattr(_build, "load", lambda name: fake)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(topt, "_div", _card_div)
    monkeypatch.setattr(fa.adam, "launches", 0)
    monkeypatch.setattr(fa.adam, "fallbacks", 0)
    return fake


@pytest.mark.parametrize("name", sorted(FUSED))
def test_reference_is_the_generic_update_on_the_card(monkeypatch, name):
    """``adam_reference`` gives the generic ``apply_row``'s parameters and
    moments bit for bit, with ``_div`` as the card computes it."""
    monkeypatch.setattr(topt, "_div", _card_div)
    tx = topt.make_optimizer(dict(FUSED[name], learning_rate=0.1))
    grads = _grads(_leaves(SIZES, 0), 7, 1)
    pg, sg, _ = _run(tx, _leaves(SIZES, 0), grads, tx.apply_row_generic)
    cfg = FUSED[name]
    decay = (float(cfg.get("weight_decay") or 0.0)
             if cfg.get("weight_decay") or cfg.get("optimizer") == "adamw" else None)
    scheduled = callable(topt.make_schedule(dict(cfg, learning_rate=0.1)))
    hyper = fa.Hyper(0.9, 0.999, 1e-8, decay, None if scheduled else -0.1,
                     2 if scheduled else None)

    def reference(g, state, params, row, plan):
        names = list(g)
        fa.adam_reference([params[k] for k in names], [g[k] for k in names],
                          [state["0"]["0"]["mu"][k] for k in names],
                          [state["0"]["0"]["nu"][k] for k in names], row, hyper)
    pr, sr, _ = _run(tx, _leaves(SIZES, 0), grads, reference)
    assert _equal(pg, pr) and _equal(sg, sr)


@pytest.mark.parametrize("name", sorted(FUSED))
def test_adam_chains_on_card_leaves_take_one_fused_launch(emulated, name):
    """Adam and AdamW, with a constant or a scheduled rate, on contiguous
    float32 leaves of one card: one launch a step over every leaf (the leaf
    table made once), the scalars rounded to float32, the same bits as the
    generic update."""
    cfg = dict(FUSED[name], learning_rate=0.1)
    tx = topt.make_optimizer(cfg)
    grads = _grads(_leaves(SIZES, 0), 7, 1)
    pg, sg, _ = _run(tx, _leaves(SIZES, 0), grads, tx.apply_row_generic)
    pf, sf, took = _run(tx, _leaves(SIZES, 0), grads, tx.apply_row)
    assert took == [len(SIZES)] * 7 and fa.adam.launches == 7 and fa.adam.fallbacks == 0
    assert _equal(pg, pf) and _equal(sg, sf)
    call = emulated.calls[0]
    scheduled = callable(topt.make_schedule(cfg))
    assert call["leaves"] == len(SIZES) and call["chunk"] == fa.CHUNK
    assert call["chunks"] == sum(-(-n // fa.CHUNK) for n in SIZES)
    assert call["lr_col"] == (2 if scheduled else -1)
    assert call["decay"] == int(cfg.get("optimizer") == "adamw")
    if not scheduled:
        assert call["neg_lr"] == np.float32(-0.1)
    assert len({c["table"] for c in emulated.calls}) == 1  # the leaf table made once


def test_a_strided_gradient_goes_in_as_a_contiguous_copy(emulated):
    """A gradient handed over transposed (as an einsum's backward hands the
    KG's relation kernels' over) on contiguous leaves: still one fused
    launch, with the generic update's bits."""
    tx = topt.make_optimizer({"learning_rate": 0.1})
    grads = _grads(_leaves(SIZES, 0), 7, 1)
    for g in grads:
        g["w3"] = g["w3"].reshape(2, -1).t().contiguous().t().reshape(2, -1)
    assert not grads[0]["w3"].is_contiguous()

    def leaves():
        p = _leaves(SIZES, 0)
        p["w3"] = p["w3"].reshape(2, -1)
        return p
    pg, sg, _ = _run(tx, leaves(), grads, tx.apply_row_generic)
    pf, sf, took = _run(tx, leaves(), grads, tx.apply_row)
    assert took == [len(SIZES)] * 7 and fa.adam.launches == 7
    assert _equal(pg, pf) and _equal(sg, sf)


@pytest.mark.parametrize("name", sorted(GENERIC) + ["adam_bf16", "adam_strided"])
def test_other_chains_and_leaves_take_the_generic_update(emulated, name):
    """Clip, accumulation, sgd, momentum, rmsprop and lamb, and Adam on bf16
    or non-contiguous leaves: no fused launch, the generic update's
    numbers, ``apply_row`` returns 0.  Adam's steps on the card fall back
    counted (``adam.fallbacks``), with a warning at the first; the other
    chains have no fused path to fall back from."""
    cfg = dict(GENERIC.get(name, {}), learning_rate=0.1)
    tx = topt.make_optimizer(cfg)

    def leaves():
        if name == "adam_bf16":
            return _leaves(SIZES, 0, dtype=torch.bfloat16)
        p = _leaves(SIZES, 0)
        p["wt"] = torch.arange(12, dtype=torch.float32).reshape(3, 4).t()
        return p
    grads = _grads(leaves(), 7, 1)
    pg, sg, _ = _run(tx, leaves(), grads, tx.apply_row_generic)
    fused = name in ("adam_bf16", "adam_strided")
    with pytest.warns(RuntimeWarning, match="generic update") if fused else \
            contextlib.nullcontext():
        pa, sa, took = _run(tx, leaves(), grads, tx.apply_row)
    assert took == [0] * 7 and not emulated.calls and fa.adam.launches == 0
    assert fa.adam.fallbacks == (7 if fused else 0)
    assert _equal(pg, pa) and _equal(sg, sa)


def test_more_leaves_than_one_launch_passes_take_a_launch_each(emulated):
    """A model of more leaves than one launch passes gradients for
    (``MAX_LEAVES``): a table and a launch for each run of them, every leaf
    fused, the generic update's bits."""
    sizes = [1 + (i * 37) % 300 for i in range(fa.MAX_LEAVES + 44)]
    tx = topt.make_optimizer({"learning_rate": 0.1})
    grads = _grads(_leaves(sizes, 0), 3, 1)
    pg, sg, _ = _run(tx, _leaves(sizes, 0), grads, tx.apply_row_generic, epochs=(3,))
    pf, sf, took = _run(tx, _leaves(sizes, 0), grads, tx.apply_row, epochs=(3,))
    assert took == [len(sizes)] * 3 and fa.adam.launches == 6 and fa.adam.fallbacks == 0
    assert [c["leaves"] for c in emulated.calls[:2]] == [fa.MAX_LEAVES, 44]
    assert len({c["table"] for c in emulated.calls}) == 2  # two tables, made once
    assert _equal(pg, pf) and _equal(sg, sf)


def test_adam_refuses_what_the_kernel_does_not_take(emulated):
    """A plan is not made of buffers the kernel does not take, ``adam``
    raises for gradients it does not take, and ``apply_row`` raises for a
    plan of other buffers than it is given: it never runs the plain
    version on the card."""
    p = _leaves(SIZES, 0, dtype=torch.bfloat16)
    z = [torch.zeros_like(v) for v in p.values()]
    with pytest.raises(ValueError, match="float32"):
        fa.Plan(list(p), list(p.values()), z, z)
    p = _leaves(SIZES, 0)
    z = [torch.zeros_like(v) for v in p.values()]
    plan = fa.Plan(list(p), list(p.values()), z, [torch.zeros_like(v) for v in z])
    with pytest.raises(ValueError, match="float32"):
        fa.adam(plan, [g.bfloat16() for g in z], torch.ones(2),
                fa.Hyper(0.9, 0.999, 1e-8, None, -0.1, None))
    tx = topt.make_optimizer({"learning_rate": 0.1})
    params = _leaves(SIZES, 0)
    state = tx.init(params)
    other = tx.plan(tx.init(_leaves(SIZES, 0)), _leaves(SIZES, 0))
    with pytest.raises(ValueError, match="other buffers"):
        tx.apply_row(_grads(params, 1, 1)[0], state, params, torch.ones(2), other)
    assert not emulated.calls and fa.adam.launches == 0


# ---- on the card ----------------------------------------------------------------

CARD_SIZES = (1, 5, 2_200, 20_014, 5_123_584)
# more leaves than one launch passes gradients for: a launch for each run of them
CARD_MANY = tuple(1 + (i * 37) % 3_000 for i in range(fa.MAX_LEAVES + 44))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("mode", ["eager", "captured", "captured_strided", "captured_many"])
@pytest.mark.parametrize("name", ["adam", "adamw", "warmup_cosine"])
def test_fused_update_is_the_generic_update_on_the_card(card, name, mode):
    """Seven steps of ``apply_row`` through the kernel, eager or captured
    into a CUDA graph and replayed (``captured_strided``: the largest
    leaf's gradient a strided view; ``captured_many``: 300 leaves), give the
    generic update's parameters and moments bit for bit: one launch a step
    (a launch for each ``MAX_LEAVES`` leaves), every leaf fused, no
    fallback."""
    sizes = CARD_MANY if mode == "captured_many" else CARD_SIZES
    launches = -(-len(sizes) // fa.MAX_LEAVES)
    tx = topt.make_optimizer(dict(FUSED[name], learning_rate=0.1))
    grads = _grads(_leaves(sizes, 0, card), 7, 1)
    pg, sg, _ = _run(tx, _leaves(sizes, 0, card), grads, tx.apply_row_generic, card)
    before, fallbacks = fa.adam.launches, fa.adam.fallbacks
    if mode == "eager":
        pf, sf, took = _run(tx, _leaves(sizes, 0, card), grads, tx.apply_row, card)
        assert fa.adam.launches - before == 7 * launches
    else:
        g_buf = {k: torch.zeros_like(v) for k, v in grads[0].items()}
        if mode == "captured_strided":
            g_buf["w4"] = torch.zeros(2 * CARD_SIZES[4], device=card)[::2]
        row_buf = torch.zeros(tx.width, device=card)
        graph, took = None, []

        def replay(g, state, params, row, plan):
            nonlocal graph
            for k, v in g.items():
                g_buf[k].copy_(v)
            row_buf.copy_(row)
            if graph is None:  # warm up (loads the kernel), undo it, capture
                buffers = [t for t in _tree(params) + _tree(state) if t.is_cuda]
                keep = [t.clone() for t in buffers]
                tx.apply_row(g_buf, state, params, row_buf, plan)
                for t, k in zip(buffers, keep):
                    t.copy_(k)
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    took.append(tx.apply_row(g_buf, state, params, row_buf, plan))
            graph.replay()
        pf, sf, _ = _run(tx, _leaves(sizes, 0, card), grads, replay, card)
        took = took * 7
        assert fa.adam.launches - before == 2 * launches  # the warm-up and the capture
    torch.cuda.synchronize()
    assert took == [len(sizes)] * 7 and fa.adam.fallbacks == fallbacks
    assert all(torch.equal(pg[k], pf[k]) for k in pg)
    assert _equal(sg, sf)
