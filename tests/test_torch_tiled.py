"""The port's tiled sparse backend (kgcn_tpu_torch/ops/tiled_spmm.py,
ops/spmm.py, ops/segment.py, GraphBatch.with_tiled, Batcher._attach_tiled,
the GAT layer) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
tiled kernels run in Pallas interpret mode, as tests/test_tiled_spmm.py runs
them.  Tolerances: structures equal array for array; float32 values and
gradients rtol = atol = 1e-5 (summation order only); bf16 payload 1e-4
(both packages round the same operands to bf16 and accumulate in f32).
"""
import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu.ops import tiled_spmm as jt
from kgcn_tpu_torch.ops import tiled_spmm as tt

torch.set_num_threads(1)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-4, atol=1e-4)
TOL = {"float32": F32, "bfloat16": BF16}
FIELDS = ("s_loc", "r_loc", "slot_src", "chunk_rt", "chunk_st", "edge_slot",
          "node_perm", "node_inv")


@contextlib.contextmanager
def jax_backend(name, dtype="float32"):
    """The JAX package's process globals for ``name``, restored after."""
    from kgcn_tpu.graph.batch import set_dense_path

    spmm_mod = importlib.import_module("kgcn_tpu.ops.spmm")
    set_dense_path(name == "dense")
    spmm_mod.set_backend("xla" if name == "dense" else name)
    jt.set_compute_dtype(dtype)
    try:
        yield
    finally:
        spmm_mod.set_backend("xla")
        jt.set_compute_dtype(jnp.bfloat16)
        set_dense_path(True)


def _coo(V, E, seed, vs=None):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, vs or V, E).astype(np.int32)
    r = rng.randint(0, V, E).astype(np.int32)
    w = (rng.random_sample(E) + 0.1).astype(np.float32)
    return s, r, w


def assert_same_structure(je, te):
    assert dataclasses.asdict(je.meta) == dataclasses.asdict(te.meta)
    for name in FIELDS:
        a, b = getattr(je, name), getattr(te, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.dtype == torch.int32, name
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)
    assert (je.transpose is None) == (te.transpose is None)
    if je.transpose is not None:
        assert_same_structure(je.transpose, te.transpose)


# (name, V, E, build kwargs, Vs): the JAX suite's cases and the kernels' trouble spots:
# rectangular operands, padding, budget fillers, empty receiver
# tiles, the locality permutation
CASES = [
    ("square", 64, 300, dict(ts=32, tr=32, chunk=16), None),
    ("unaligned", 100, 500, dict(ts=32, tr=48, chunk=32), None),
    ("empty_receiver_tiles", 33, 40, dict(ts=16, tr=16, chunk=8), None),
    ("rectangular", 40, 250, dict(ts=32, tr=16, chunk=16), 90),
    ("budget", 64, 300, dict(ts=32, tr=32, chunk=16, chunk_budget=48), None),
    ("locality", 96, 400, dict(ts=32, tr=32, chunk=16, locality=True), None),
]


def _case(name):
    _, V, E, kw, vs = next(c for c in CASES if c[0] == name)
    s, r, w = _coo(V, E, seed=V, vs=vs)
    w[::4] = 0.0  # padding edges, dropped from the structure
    if vs is not None:
        kw = dict(kw, num_sender_nodes=vs)
    return V, vs or V, s, r, w, kw


def _both(name):
    V, Vs, s, r, w, kw = _case(name)
    return (V, Vs, s, r, w, jt.build_tiled(s, r, V, weights=w, **kw),
            tt.build_tiled(s, r, V, weights=w, **kw))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_build_tiled_matches_jax(name):
    *_, je, te = _both(name)
    assert_same_structure(je, te)


def test_build_tiled_valid_mask_keeps_zero_weight_edges():
    s, r, w = _coo(48, 200, seed=7)
    w[::3] = 0.0
    valid = np.ones_like(w)
    valid[1::5] = 0.0
    kw = dict(ts=16, tr=16, chunk=8, valid_mask=valid)
    je = jt.build_tiled(s, r, 48, weights=w, **kw)
    te = tt.build_tiled(s, r, 48, weights=w, **kw)
    assert_same_structure(je, te)
    assert te.meta.num_edges == 200
    kept = set(te.slot_src.numpy().ravel()) - {200}
    assert kept == set(np.nonzero(valid)[0].tolist())


def test_build_tiled_budget_too_small_raises():
    s, r, w = _coo(64, 300, seed=1)
    with pytest.raises(ValueError, match="chunk budget"):
        tt.build_tiled(s, r, 64, weights=w, ts=32, tr=32, chunk=16, chunk_budget=2)


def _graphs():
    """A uniform, a power-law and a block-diagonal edge list."""
    rng = np.random.RandomState(0)
    V, E = 3000, 20000
    uni = (rng.randint(0, V, E), rng.randint(0, V, E))
    hubs = rng.randint(0, 40, E // 2)
    power = (np.concatenate([hubs, rng.randint(0, V, E - E // 2)]), rng.randint(0, V, E))
    blocks = rng.randint(0, 60, E) * 50
    block = (blocks + rng.randint(0, 50, E), blocks + rng.randint(0, 50, E))
    return V, {"uniform": uni, "power_law": power, "block_diagonal": block}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_choose_tiling_matches_jax(dtype):
    V, graphs = _graphs()
    nbytes = 2 if dtype == "bfloat16" else 4
    with jax_backend("tiled", dtype):
        for name, (s, r) in graphs.items():
            for F in (50, 128, 300):
                want, want_cost = jt.choose_tiling(s, r, V, F, return_cost=True)
                got, got_cost = tt.choose_tiling(s, r, V, F, bytes_per_elt=nbytes,
                                                 return_cost=True)
                assert got == want, (name, F)
                assert got_cost == pytest.approx(want_cost, rel=1e-12)
            assert (tt.choose_tiling_with_locality(s, r, V, 128, bytes_per_elt=nbytes)
                    == jt.choose_tiling_with_locality(s, r, V, 128)), name
            np.testing.assert_array_equal(tt.locality_order(s, r, V),
                                          jt.locality_order(s, r, V))


# ---- the operations --------------------------------------------------------


def _inputs(Vs, Vr, F, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((Vs, F)).astype(np.float32),
            rng.standard_normal((Vr, F)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_tiled_spmm_and_sddmm_match_jax(name, dtype):
    V, Vs, s, r, w, je, te = _both(name)
    x, a = _inputs(Vs, V, 24)
    got = tt.tiled_spmm(te, torch.from_numpy(w), torch.from_numpy(x), compute_dtype=dtype)
    want = jt.tiled_spmm(je, jnp.asarray(w), jnp.asarray(x), compute_dtype=jnp.dtype(dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
    # a: receiver rows, x: sender rows
    got = tt.tiled_sddmm(te, torch.from_numpy(a), torch.from_numpy(x), compute_dtype=dtype)
    want = jt.tiled_sddmm(je, jnp.asarray(a), jnp.asarray(x), compute_dtype=jnp.dtype(dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[dtype])
    assert not np.any(got.numpy()[w == 0.0])  # dropped edges get 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["unaligned", "rectangular", "budget", "locality"])
def test_tiled_spmm_gradients_match_jax_grad(name, dtype):
    """dx (the transpose SpMM) and d(weights) (the SDDMM) against jax.grad
    through the JAX custom VJP."""
    V, Vs, s, r, w, je, te = _both(name)
    x, _ = _inputs(Vs, V, 12, seed=1)
    cot = np.random.RandomState(2).standard_normal((V, 12)).astype(np.float32)

    def loss(wv, xv):
        out = jt.tiled_spmm(je, wv, xv, compute_dtype=jnp.dtype(dtype))
        return jnp.sum(out * cot)

    want_w, want_x = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    wt = torch.tensor(w, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    out = tt.tiled_spmm(te, wt, xt, compute_dtype=dtype)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), **TOL[dtype])
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_w), **TOL[dtype])


def test_tiled_spmm_skips_the_sddmm_for_constant_weights(monkeypatch):
    """A GCN's adjacency weights need no gradient: the backward runs the
    transpose SpMM only."""
    V, Vs, s, r, w, je, te = _both("square")
    calls = []
    orig = tt._sddmm
    monkeypatch.setattr(tt, "_sddmm", lambda *a: calls.append(1) or orig(*a))
    xt = torch.tensor(_inputs(V, V, 8)[0], requires_grad=True)
    tt.tiled_spmm(te, torch.from_numpy(w), xt).sum().backward()
    assert not calls and xt.grad is not None
    wt = torch.tensor(w, requires_grad=True)
    tt.tiled_spmm(te, wt, xt).sum().backward()
    assert calls == [1] and wt.grad is not None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_versions_against_the_coo_oracle(dtype):
    """The plain versions against the edge-list formula they stand for
    (the XLA branch of spmm_multichannel, and a per-edge dot)."""
    from kgcn_tpu_torch.ops.spmm import spmm_multichannel

    V, Vs, s, r, w, je, te = _both("budget")
    x, a = _inputs(V, V, 16, seed=3)
    xq, aq = torch.from_numpy(x), torch.from_numpy(a)
    wq = torch.from_numpy(w)
    if dtype == "bfloat16":  # the oracle on the operands the kernel rounds
        xq, aq, wq = tt._rb(xq), tt._rb(aq), tt._rb(wq)
    want = spmm_multichannel(torch.from_numpy(s)[None], torch.from_numpy(r)[None],
                             wq[None], xq, V)
    got = tt.tiled_spmm_reference(te, torch.from_numpy(w), torch.from_numpy(x), dtype)
    tol = dict(rtol=1e-2, atol=1e-2) if dtype == "bfloat16" else F32  # message rounding
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    dots = (aq[torch.from_numpy(r).long()] * xq[torch.from_numpy(s).long()]).sum(1)
    dots = torch.where(torch.from_numpy(w) != 0, dots, torch.zeros_like(dots))
    got = tt._slots_to_edges(te, tt.tiled_sddmm_reference(te, torch.from_numpy(x),
                                                          torch.from_numpy(a), dtype))
    np.testing.assert_allclose(got.numpy(), dots.numpy(), **F32)


def test_cpu_tensors_launch_no_kernel():
    V, Vs, s, r, w, je, te = _both("square")
    before = (tt.tiled_spmm.launches, tt.tiled_sddmm.launches)
    x = torch.randn(V, 4, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    tt.tiled_spmm(te, wt, x).sum().backward()
    tt.tiled_sddmm(te, x.detach(), x.detach())
    assert (tt.tiled_spmm.launches, tt.tiled_sddmm.launches) == before


def test_tiled_spmm_rejects_bad_operands():
    V, Vs, s, r, w, je, te = _both("square")
    with pytest.raises(ValueError, match="num_senders"):
        tt.tiled_spmm(te, torch.from_numpy(w), torch.zeros(V + 1, 4))
    with pytest.raises(ValueError, match="with_transpose"):
        tt.tiled_spmm(te.replace(transpose=None), torch.from_numpy(w), torch.zeros(V, 4))
    with pytest.raises(ValueError, match="compute dtype"):
        tt.tiled_spmm(te, torch.from_numpy(w), torch.zeros(V, 4), compute_dtype="float16")


def test_spmm_multichannel_xla_matches_jax():
    from kgcn_tpu.ops.spmm import spmm_multichannel as j_smc
    from kgcn_tpu_torch.ops.spmm import spmm_multichannel as t_smc

    rng = np.random.RandomState(5)
    C, V, E, F = 3, 40, 120, 6
    s = rng.randint(0, V, (C, E)).astype(np.int32)
    r = rng.randint(0, V, (C, E)).astype(np.int32)
    w = rng.standard_normal((C, E)).astype(np.float32)
    for x in (rng.standard_normal((V, F)), rng.standard_normal((C, V, F))):
        x = x.astype(np.float32)
        want = j_smc(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w), jnp.asarray(x), V,
                     backend="xla")
        got = t_smc(*map(torch.from_numpy, (s, r, w, x)), V)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_segment_ops_match_jax():
    from kgcn_tpu.ops import segment as js
    from kgcn_tpu_torch.ops import segment as ts

    rng = np.random.RandomState(6)
    E, V = 200, 30  # node 29 receives nothing: an empty segment
    ids = rng.randint(0, V - 1, E).astype(np.int32)
    logits = (rng.standard_normal(E) * 3).astype(np.float32)
    mask = (rng.random_sample(E) > 0.2).astype(np.float32)
    got = ts.segment_sum(torch.from_numpy(logits), torch.from_numpy(ids), V)
    want = js.segment_sum(jnp.asarray(logits), jnp.asarray(ids), V)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    for m in (None, mask):
        got = ts.segment_softmax(torch.from_numpy(logits), torch.from_numpy(ids), V,
                                 mask=None if m is None else torch.from_numpy(m))
        want = js.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), V,
                                  mask=None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


# ---- batches and the GAT layer -----------------------------------------------


def _datasets(data, cfg):
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu_torch.data.dataset import build_dataset as t_build

    return j_build(dict(data), cfg), t_build(dict(data), cfg)


def _tiled_batchers(data, bs, dtype, cfg=None):
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
    from kgcn_tpu_torch.runtime.backend import Backend

    (jds, jinfo), (tds, tinfo) = _datasets(data, cfg or {"normalize_adj_flag": True})
    return (JBatcher(jds, jinfo, bs, seed=0),
            TBatcher(tds, tinfo, bs, seed=0, backend=Backend("tiled", dtype)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attach_tiled_matches_jax(dtype):
    """Batcher._attach_tiled: the probe batch's pinned tiling, locality flags
    and chunk budget, and the structures of every batch of an epoch."""
    from kgcn_tpu.data.synthetic import make_random_graphs

    data = make_random_graphs(40, 30, 5, avg_degree=4, num_channels=2, seed=1)
    with jax_backend("tiled", dtype):
        jb, tb = _tiled_batchers(data, 12, dtype)
        jbatches = list(jb.batches(shuffle=True, epoch=0))
    tbatches = list(tb.batches(shuffle=True, epoch=0))
    assert (tb._tiled_cfg, tb._tiled_loc, tb._tiled_budget) == (
        jb._tiled_cfg, jb._tiled_loc, jb._tiled_budget)
    for j, t in zip(jbatches, tbatches):
        assert t.graph.backend == "tiled" and t.graph.compute_dtype == dtype
        assert t.graph.with_dense_adj() is t.graph  # no dense path on tiled
        assert len(j.graph.tiled_adj) == len(t.graph.tiled_adj) == 2
        for je, te in zip(j.graph.tiled_adj, t.graph.tiled_adj):
            assert_same_structure(je, te)


def test_with_tiled_auto_locality_single_graph_matches_jax():
    """One whole graph with hub nodes: "auto" runs the cost model with and
    without the relabelling, in both packages alike."""
    from kgcn_tpu.graph.batch import batch_graphs as j_batch
    from kgcn_tpu_torch.graph.batch import batch_graphs as t_batch

    V, graphs = _graphs()
    s, r = graphs["power_law"]
    adj = [[(np.stack([r, s], 1), np.ones(len(s), np.float32), (V, V))]]
    jg, tg = j_batch(adj, None, V), t_batch(adj, None, V)
    with jax_backend("tiled", "bfloat16"):
        je = jg.with_tiled(feature_dim=64).tiled_adj[0]
    te = tg.with_tiled(feature_dim=64).tiled_adj[0]
    assert_same_structure(je, te)


def _gat_pair(normalize, path, dtype="float32"):
    from kgcn_tpu import nn as jnn
    from kgcn_tpu.data.synthetic import make_random_graphs
    from kgcn_tpu_torch.convert import params_from_jax
    from kgcn_tpu_torch.nn import layers as tnn

    data = make_random_graphs(9, 8, 5, num_channels=2, seed=4)
    with jax_backend("tiled", dtype):
        jb, tb = _tiled_batchers(data, 6, dtype)
        jg = jb.make_batch(np.array([0, 2, 4, 6])).graph
    if path == "dense":
        jg = jg.replace(tiled_adj=None).with_dense_adj()
    elif path == "edge_list":
        jg = jg.replace(tiled_adj=None)
    tg = tb.make_batch(np.array([0, 2, 4, 6])).graph
    if path == "dense":
        tg = tg.replace(backend="dense").with_dense_adj()
    elif path == "edge_list":
        tg = tg.replace(tiled_adj=None)
    layer = jnn.GAT(2, normalize=normalize)
    v = layer.init(jax.random.PRNGKey(0), jg.nodes, jg)
    attn = np.random.RandomState(5).standard_normal((2, 10, 1)).astype(np.float32)
    params = {"params": {"attn": jnp.asarray(attn)}}
    port = tnn.GAT(5, 2, normalize=normalize)
    port.load_state_dict(params_from_jax(jax.device_get(params["params"]), {})["params"])
    assert v["params"]["attn"].shape == attn.shape
    return layer, params, jg, port, tg


@pytest.mark.parametrize("path", ["tiled", "edge_list", "dense"])
@pytest.mark.parametrize("normalize", ["sender", "receiver"])
def test_gat_layer_matches_flax(normalize, path):
    """Values and the gradients of attn and x, on the three paths."""
    layer, params, jg, port, tg = _gat_pair(normalize, path)
    cot = np.random.RandomState(7).standard_normal((jg.total_nodes, 5)).astype(np.float32)
    x = np.asarray(jg.nodes)

    def loss(p, xv):
        return jnp.sum(layer.apply(p, xv, jg) * cot)

    with jax_backend("tiled", "float32"):  # the payload dtype of JAX's tiled_spmm
        want = layer.apply(params, jnp.asarray(x), jg)
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    got = port(xt, tg)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **F32)
    np.testing.assert_allclose(port.attn.grad.numpy(), np.asarray(gp["params"]["attn"]),
                               **F32)
