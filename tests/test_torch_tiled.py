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


def test_build_tiled_rejects_an_edge_outside_the_nodes():
    """The native packer checks every kept edge against the tiles of the
    node range before it writes a slot."""
    s, r, w = _coo(64, 300, seed=1)
    r[5] = 64 * 3
    with pytest.raises(ValueError, match="outside the node range"):
        tt.build_tiled(s, r, 64, weights=w, ts=32, tr=32, chunk=16)


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


# ---- the SpMM kernel's plan (TiledPlan) ---------------------------------------
#
# On the card the SpMM walks the structure's TiledPlan: the real slots in
# receiver order (stable in slot order) cut into pieces, split rows summed
# from their partials.  Its arithmetic is replayed here in NumPy, in the
# kernel's order, and held against the plain version and the JAX package.

# csrc/tiled.cu: a split row of at most this many partials is summed by one
# warp in piece order, a longer one in PIECES_PER_BLOCK consecutive runs
SPLIT_WARP = 64


def _path_structure_graph():
    """The solubility training path's first batch on the tiled backend (1 504
    nodes, ~740 edges): its GraphBatch, as the Batcher builds it on the CPU."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.runtime.backend import Backend
    from kgcn_tpu_torch.runtime.config import load_config

    cfg = load_config("example_config/solubility_cls.json", {})
    ds, info = load_jbl(cfg["dataset"], cfg)
    bs = int(cfg["batch_size"])
    return Batcher(ds, info, bs, backend=Backend("tiled", "bfloat16")).make_batch(
        np.arange(bs)).graph


def _path_structure():
    """The path batch's (TiledCOO of channel 0, senders, receivers, weights,
    valid mask, node count) as the batch carries them."""
    g = _path_structure_graph()
    ev = None if g.edge_valid is None else g.edge_valid[0].numpy()
    return (g.tiled_adj[0], g.senders[0].numpy(), g.receivers[0].numpy(),
            g.edge_weights[0].numpy(), ev, g.total_nodes)


def _hub_structure(kind):
    """``hub``: a receiver of 3 000 in-edges among 2 000 nodes (its row spans
    ~94 pieces: more than SPLIT_WARP partials); ``locality_hubs``: 8 000
    edges from Pareto senders (node 0 sends ~3 000) relabelled degree-first,
    whose transpose has the hubs as receivers; ``large``: 20 000 uniform
    edges and 2 000 more into one receiver among 4 000 nodes, past
    ``tt._SMALL`` real slots (cuts every ``piece``, moved to row starts)."""
    rng = np.random.RandomState(11)
    V, E = 2000, 4000
    if kind == "locality_hubs":
        s = np.minimum((rng.pareto(1.2, 2 * E) * 2).astype(np.int64), V - 1)
        r = rng.randint(0, V, 2 * E)
    elif kind == "hub":
        s = rng.randint(0, V, E + 3000)
        r = np.concatenate([rng.randint(0, V, E), np.full(3000, 7)])
    else:
        V = 4000
        s = rng.randint(0, V, 22_000)
        r = np.concatenate([rng.randint(0, V, 20_000), np.full(2000, 11)])
    w = (rng.random_sample(len(s)) + 0.1).astype(np.float32)
    return tt.build_tiled(s, r, V, weights=w, ts=256, tr=256, chunk=64,
                          locality=kind == "locality_hubs")


PLAN_NAMES = ["path", "budget", "empty_receiver_tiles", "locality", "hub",
              "locality_hubs", "large", "rectangular", "unaligned"]


def _plan_structure(name):
    """The named structure with its plans, as ``to`` a CUDA device builds them."""
    if name == "path":
        return tt.with_plan(_path_structure()[0])
    if name in ("hub", "locality_hubs", "large"):
        return tt.with_plan(_hub_structure(name))
    return tt.with_plan(_both(name)[-1])


def _piece_rows(plan):
    """(piece of each entry, first and last row of each piece)."""
    row = plan.entries[1].numpy().astype(np.int64)
    starts = plan.starts.numpy().astype(np.int64)
    piece = np.repeat(np.arange(len(starts) - 1), np.diff(starts))
    return piece, row[starts[:-1]], row[starts[1:] - 1]


def _piece_size(n_real):
    """The plan's target piece: a multiple of 32 (a warp's batch), 32-512,
    for about ``tt._TARGET_PIECES`` pieces a structure."""
    return int(min(512, 32 * max(1, -(-n_real // (32 * tt._TARGET_PIECES)))))


def _cut_window(piece):
    """How far back a cut may move to a row start: a quarter piece, at
    least 8."""
    return max(8, piece // 4)


def _check_cuts(plan):
    """The pieces tile the entries in order.  Below ``tt._SMALL`` entries a
    piece is a row, a row of more than ``piece`` entries cut at the
    multiples of ``piece`` in it; beyond, each cut lies at most
    ``_cut_window(piece)`` before its multiple of ``piece``, at a row start
    unless that row has more than ``piece`` entries or starts more than
    ``_cut_window(piece)`` back."""
    row = plan.entries[1].numpy().astype(np.int64)
    starts = plan.starts.numpy().astype(np.int64)
    n, P = len(row), plan.piece
    assert P == _piece_size(n) and P % 32 == 0
    assert starts[0] == 0 and starts[-1] == n and len(starts) == plan.pieces.shape[0] + 1
    assert (np.diff(starts) >= 1).all()
    cut = starts[1:-1]
    if n < tt._SMALL:
        first, last = row[starts[:-1]], row[starts[1:] - 1]
        assert (first == last).all()  # no piece spans two rows
        assert (np.diff(starts) <= P).all()
        new_row = np.flatnonzero(np.diff(row)) + 1
        assert np.isin(new_row, cut).all()  # every row starts a piece
        inside = cut[~np.isin(cut, new_row)]
        assert (inside % P == 0).all()
        assert (np.bincount(row)[row[inside]] > P).all()
        return
    W = _cut_window(P)
    target = np.arange(1, len(cut) + 1) * P
    assert ((cut <= target) & (cut >= target - W)).all()
    # the row that holds each target entry: where it starts, how long it is
    t_row = row[target]
    run_start = np.searchsorted(row, t_row)
    run_len = np.bincount(row)[t_row]
    stays = (run_len > P) | (target - run_start > W)
    np.testing.assert_array_equal(cut[stays], target[stays])  # cut inside its row
    np.testing.assert_array_equal(cut[~stays], run_start[~stays])  # moved to its start


def _rb_np(a):
    """float32 → bfloat16 (round to nearest even) → float32, in NumPy."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _replay(te, weights, x, bf16):
    """The SpMM kernel's arithmetic in its order, in NumPy float32: each
    piece sums its rows from 0 in entry order (w·x, and with bf16 the
    operands and the message rounded); whole rows go to the output, the
    pieces' first and last rows to partials; a split row is the sum of its
    partials (in order where there are at most SPLIT_WARP, else
    PIECES_PER_BLOCK consecutive runs in order, then the runs in order);
    rows without a slot are zeros.  Checks that every row is written once."""
    plan, m = tt.with_plan(te).plan, te.meta
    eid, row, send = plan.entries.numpy().astype(np.int64)
    w = np.asarray(weights, np.float32)[eid]
    xs = np.asarray(x, np.float32)[send]
    msg = (_rb_np(_rb_np(w)[:, None] * _rb_np(xs)) if bf16
           else w[:, None] * xs)
    piece, first, last = _piece_rows(plan)
    info = plan.pieces.numpy().astype(np.int64)
    c = np.where(row == first[piece], info[piece, 1],
                 np.where(row == last[piece], info[piece, 3], -1))
    direct = c < 0
    F = xs.shape[1]
    out = np.zeros((m.num_receivers, F), np.float32)
    np.add.at(out, row[direct], msg[direct])      # in entry order
    part = np.zeros((plan.n_parts, F), np.float32)
    np.add.at(part, c[~direct], msg[~direct])
    written = np.zeros(m.num_receivers, np.int64)
    pairs = np.unique(np.stack([row[direct], piece[direct]]), axis=1)
    np.add.at(written, pairs[0], 1)

    def in_order(rows):
        total = np.zeros(F, np.float32)
        for r in rows:
            total = total + r
        return total

    for r, off, count, _ in plan.splits.numpy().astype(np.int64):
        per = count if count <= SPLIT_WARP else -(-count // tt.PIECES_PER_BLOCK)
        runs = [in_order(part[off + min(i * per, count): off + min((i + 1) * per, count)])
                for i in range(tt.PIECES_PER_BLOCK)]
        out[r] = in_order(runs)
        written[r] += 1
    written[plan.empty_rows.numpy()] += 1
    assert (written == 1).all()
    return out


def test_spmm_plan_built_for_the_card_only():
    """``build_tiled``, the CPU Batcher and a move to the CPU attach no plan
    (the plain version never reads it); ``with_plan``, which ``to`` a CUDA
    device calls, attaches one to each direction, once, and a move keeps it."""
    te = _both("budget")[-1]
    assert te.plan is None and te.transpose.plan is None
    assert te.to("cpu").plan is None and te.to("cpu").transpose.plan is None
    g = _path_structure_graph()
    assert all(t.plan is None and t.transpose.plan is None for t in g.tiled_adj)
    assert all(t.plan is None for t in g.to("cpu").tiled_adj)
    tp = tt.with_plan(te)
    assert tp.plan is not None and tp.transpose.plan is not None
    assert tt.with_plan(tp).plan is tp.plan
    moved = tp.to("cpu")
    assert moved.transpose.plan is not None
    np.testing.assert_array_equal(moved.plan.entries.numpy(), tp.plan.entries.numpy())
    assert tp.plan.seconds > 0


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_spmm_plan_covers_every_real_slot_once(name):
    """Both directions: the plan's entries are the structure's real slots,
    each once, as (edge id, receiver row, sender), sorted by receiver row and
    within a row in slot order (the plain version's order of sums)."""
    te = _plan_structure(name)
    for st in (te, te.transpose):
        valid, send, recv = (t.numpy() for t in tt._slot_rows(st))
        eid, row, sender = st.plan.entries.numpy().astype(np.int64)
        slot = np.full(st.meta.num_edges + 1, -1, np.int64)
        src = st.slot_src.numpy().reshape(-1)
        slot[src] = np.arange(len(src))
        slot = slot[eid]
        np.testing.assert_array_equal(np.sort(slot), np.flatnonzero(valid))
        np.testing.assert_array_equal(src[slot], eid)
        np.testing.assert_array_equal(row, recv[slot])
        np.testing.assert_array_equal(sender, send[slot])
        assert (np.diff(row) >= 0).all()
        assert (np.diff(slot)[np.diff(row) == 0] > 0).all()  # stable
        assert (row < st.meta.num_receivers).all() and (sender < st.meta.num_senders).all()


@pytest.mark.parametrize("name", PLAN_NAMES)
def test_spmm_plan_pieces_and_partials(name):
    """Pieces tile the entries, cut at row starts except inside rows of
    more than ``piece`` entries (or, past ``tt._SMALL`` entries, where a
    row start lies too far back); split rows are exactly the rows whose
    entries lie in more than one piece, each with consecutive partials in
    piece order that the pieces name; every partial is used once; whole
    rows name none; empty rows are the rows without an entry; no arrival is
    pending.  Molecule batches split no row."""
    te = _plan_structure(name)
    longest = 0
    for st in (te, te.transpose):
        plan = st.plan
        row = plan.entries[1].numpy().astype(np.int64)
        _check_cuts(plan)
        piece, first, last = _piece_rows(plan)
        info, splits = plan.pieces.numpy(), plan.splits.numpy()
        rows_u, n_pieces = np.unique(np.unique(np.stack([row, piece]), axis=1)[0],
                                     return_counts=True)
        np.testing.assert_array_equal(splits[:, 0], rows_u[n_pieces > 1])
        used = []
        for k, (r, off, count, blocks) in enumerate(splits):
            ps = np.unique(piece[row == r])
            assert count == len(ps)
            assert blocks == len(np.unique(ps // tt.PIECES_PER_BLOCK))
            which = np.where(first[ps] == r, 0, 2)
            np.testing.assert_array_equal(info[ps, which], k)
            np.testing.assert_array_equal(info[ps, which + 1], np.arange(off, off + count))
            used.extend(info[ps, which + 1])
            longest = max(longest, count)
        assert sorted(used) == list(range(plan.n_parts))
        assert (info[~np.isin(first, splits[:, 0]), :2] == -1).all()
        assert (info[~np.isin(last, splits[:, 0]) | (last == first), 2:] == -1).all()
        filled = np.zeros(st.meta.num_receivers, bool)
        filled[row] = True
        np.testing.assert_array_equal(plan.empty_rows.numpy(), np.flatnonzero(~filled))
        assert plan.arrivals.shape == (len(splits),) and not plan.arrivals.any()
        # every array starts on a 16-byte boundary of the one buffer
        assert all(o % 4 == 0 for o in plan.offsets)
    if name in ("hub", "locality_hubs"):
        assert longest > SPLIT_WARP  # the many-warp sum is exercised
    if name == "large":
        assert te.plan.counts[0] >= tt._SMALL and longest > 1
    if name == "path":
        assert longest == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", PLAN_NAMES)
def test_spmm_plan_replay_matches_reference(name, dtype):
    """The kernel's order of sums gives the plain version's values, both
    directions: rtol = atol = 1e-6 on every row that one piece holds (the
    same roundings, summed in the same order), and every row, split hub
    rows of thousands of order-1 terms too, within 1e-6 +
    sqrt(n)·2^-24·Σ|message| of the f64 sum of its n messages (the
    probabilistic bound of an f32 sum in any order; Higham and Mary 2019),
    where the plain version's own slot-order sum is off by ~1e-4."""
    te = _plan_structure(name)
    rng = np.random.RandomState(12)
    w = (rng.random_sample(te.meta.num_edges) + 0.1).astype(np.float32)
    bf16 = dtype == "bfloat16"
    for st in (te, te.transpose):
        x = rng.standard_normal((st.meta.num_senders, 20)).astype(np.float32)
        want = tt.tiled_spmm_reference(st, torch.from_numpy(w), torch.from_numpy(x),
                                       dtype).numpy()
        got = _replay(st, w, x, bf16)
        eid, row, send = st.plan.entries.numpy().astype(np.int64)
        n = np.bincount(row, minlength=st.meta.num_receivers)
        whole = ~np.isin(np.arange(st.meta.num_receivers), st.plan.splits[:, 0].numpy())
        np.testing.assert_allclose(got[whole], want[whole], rtol=1e-6, atol=1e-6)
        wq, xq = w[eid], x[send]
        if bf16:
            wq, xq = _rb_np(wq), _rb_np(xq)
        msg = wq.astype(np.float64)[:, None] * xq
        if bf16:
            msg = _rb_np(msg.astype(np.float32)).astype(np.float64)
        exact = np.zeros(got.shape)
        np.add.at(exact, row, msg)
        mag = np.zeros(got.shape)
        np.add.at(mag, row, np.abs(msg))
        tol = 1e-6 + np.sqrt(n)[:, None] * 2.0 ** -24 * mag
        assert (np.abs(got - exact) <= tol).all()


def _replay_product(te, w, x, bf16):
    """``tiled_spmm``'s forward through the replay: the locality
    permutation in and out, as the wrapper applies it."""
    if te.node_perm is None:
        return _replay(te, w, x, bf16)
    return _replay(te, w, x[te.node_perm.numpy()], bf16)[te.node_inv.numpy()]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["path", "budget", "empty_receiver_tiles", "locality"])
def test_spmm_plan_replay_matches_jax(name, dtype):
    """The replay against the JAX package's tiled SpMM (Pallas, interpret
    mode): the forward on the structure, and dx = Aᵀ g (the transpose
    structure, through jax.vjp) — tolerances as for the plain versions."""
    if name == "path":
        te, s, r, w, ev, V = _path_structure()
        m = te.meta
        kw = dict(ts=m.ts, tr=m.tr, chunk=m.chunk, chunk_budget=m.n_chunks, valid_mask=ev)
        je = jt.build_tiled(s, r, V, weights=w, **kw)
        assert_same_structure(je, tt.build_tiled(s, r, V, weights=w, **kw))
        Vs = V
    else:
        V, Vs, s, r, w, je, te = _both(name)
    x, g = _inputs(Vs, V, 24, seed=13)
    jdt = jnp.dtype(dtype)
    bf16 = dtype == "bfloat16"
    want, vjp = jax.vjp(lambda xv: jt.tiled_spmm(je, jnp.asarray(w), xv, compute_dtype=jdt),
                        jnp.asarray(x))
    np.testing.assert_allclose(_replay_product(te, w, x, bf16), np.asarray(want), **TOL[dtype])
    (want_dx,) = vjp(jnp.asarray(g))
    tr = te.transpose.replace(node_perm=te.node_perm, node_inv=te.node_inv)
    np.testing.assert_allclose(_replay_product(tr, w, g, bf16), np.asarray(want_dx),
                               **TOL[dtype])


@pytest.mark.parametrize("name", ["budget", "locality"])
def test_move_to_the_card_copies_every_array_once(name):
    """``_to_card`` (what ``TiledCOO.to`` a CUDA device runs after
    ``with_plan``), here onto the CPU: every array of both directions and
    their plans comes back equal, as views of one buffer, each on a 16-byte
    boundary of it."""
    te = tt.with_plan(_both(name)[-1])
    moved = tt._to_card(te, "cpu")
    base = moved.s_loc.untyped_storage().data_ptr()
    for d0, d1 in ((te, moved), (te.transpose, moved.transpose)):
        for f in dataclasses.fields(d0):
            a, b = getattr(d0, f.name), getattr(d1, f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), f.name
                assert b.untyped_storage().data_ptr() == base, f.name
                assert (b.data_ptr() - base) % 16 == 0, f.name
            elif f.name not in ("transpose", "plan"):
                assert a == b, f.name
        for n in tt.TiledPlan.ARRAYS:
            assert torch.equal(d0.plan.array(n), d1.plan.array(n)), n
            assert (d1.plan.array(n).data_ptr() - base) % 16 == 0, n
    assert moved.transpose.transpose is None


def test_plan_builder_rejects_a_receiver_outside_the_structure():
    """The host builder checks each real slot's receiver row against the
    structure's receiver count, and the wrapper raises."""
    te = _both("budget")[-1]
    bad = te.replace(meta=dataclasses.replace(te.meta, num_receivers=te.meta.tr - 1))
    with pytest.raises(ValueError, match="outside the structure"):
        tt.with_plan(bad.replace(transpose=None))
