"""The port's ELL backend pieces (kgcn_tpu_torch/ops/ell.py, ops/ell_spmm.py,
the ELL and pallas parts of ops/spmm.py, the Batcher's ELL arrays,
data/synthetic.py) against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both packages.  The JAX
Pallas kernel ``_ell_kernel`` runs in interpret mode (as
tests/test_pallas_spmm.py runs it); its compile-probe cache ``_KERNEL_OK``
and the JAX package's backend globals are reset after every test.
Tolerances: host arrays equal; float32 values and gradients rtol = atol =
1e-5 (the same sums in another order).  On the CPU the port's kernel
wrapper computes its plain version, so its launch count stays 0.
"""
import contextlib
import functools
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kgcn_tpu_torch.ops import ell as tell
from kgcn_tpu_torch.ops import ell_spmm as tes
from kgcn_tpu_torch.ops import spmm as tspmm

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def jax_state():
    """Restore the JAX package's globals and clear the Pallas ELL probe
    cache after each test (xdist runs a whole file in one process)."""
    yield
    from kgcn_tpu.graph.batch import set_dense_path
    from kgcn_tpu.ops import pallas_spmm

    importlib.import_module("kgcn_tpu.ops.spmm").set_backend("xla")
    set_dense_path(True)
    pallas_spmm._KERNEL_OK.clear()


@contextlib.contextmanager
def pallas_interpret():
    """Run every ``pl.pallas_call`` in interpret mode inside the block."""
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig
        from kgcn_tpu.ops import pallas_spmm

        pallas_spmm._KERNEL_OK.clear()


def _coo(V, E, seed, zero_every=0):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, V, E).astype(np.int32)
    r = rng.randint(0, V, E).astype(np.int32)
    w = (rng.random_sample(E) + 0.1).astype(np.float32)
    if zero_every:
        w[::zero_every] = 0.0
    return s, r, w


def _ell(V, K, F, seed, pad_share=0.3):
    """Random ELL arrays (padding slots: index 0, weight 0) and x."""
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, V, (V, K)).astype(np.int32)
    w = rng.standard_normal((V, K)).astype(np.float32)
    pad = rng.random_sample((V, K)) < pad_share
    idx[pad], w[pad] = 0, 0.0
    x = rng.standard_normal((V, F)).astype(np.float32)
    return idx, w, x


# ---- host conversion and the gate -------------------------------------------


@pytest.mark.parametrize("max_degree", [None, 2, 9])
@pytest.mark.parametrize("zero_every", [0, 4])
def test_coo_to_ell_and_stats_match_jax(max_degree, zero_every):
    from kgcn_tpu.ops import ell as jell

    s, r, w = _coo(40, 200, seed=1, zero_every=zero_every)
    for a, b in zip(tell.coo_to_ell(s, r, w, 40, max_degree),
                    jell.coo_to_ell(s, r, w, 40, max_degree)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    adjs = [[(c[1], c[0], c[2]) for c in (_coo(12, 30, seed=g), _coo(12, 9, seed=g + 9))]
            for g in range(5)]
    assert tell.scan_ell_stats(adjs) == jell.scan_ell_stats(adjs)


@pytest.mark.parametrize("args", [(4, 100, 300), (33, 10, 500), (5, 100, 200),
                                  (0, 10, 0), (3, 10, 15)])
def test_ell_layout_ok_matches_jax(args):
    from kgcn_tpu.ops import ell as jell

    assert tell.ELL_MAX_DEGREE == jell.ELL_MAX_DEGREE
    assert tell.ell_layout_ok(*args) == jell.ell_layout_ok(*args)


@pytest.mark.parametrize("max_degree", [2, 6])
def test_coo_to_ell_device_matches_jax(max_degree):
    from kgcn_tpu.ops.pallas_spmm import coo_to_ell_device as j_conv

    s, r, w = _coo(30, 120, seed=2, zero_every=5)
    want = j_conv(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w), 30, max_degree)
    got = tes.coo_to_ell_device(torch.from_numpy(s), torch.from_numpy(r),
                                torch.from_numpy(w), 30, max_degree)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_coo_to_ell_device_ignores_zero_weight_edges():
    """tests/test_kernels.py's case: a zero-weight edge listed first must
    not take receiver 2's first slot and push a real edge out."""
    s = np.array([0, 1, 3, 0], np.int32)
    r = np.array([2, 2, 2, 4], np.int32)
    w = np.array([0.0, 1.0, 2.0, 3.0], np.float32)
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    idx, wv = tes.coo_to_ell_device(torch.from_numpy(s), torch.from_numpy(r),
                                    torch.from_numpy(w), 6, max_degree=2)
    got = tell.spmm_ell(idx, wv, torch.from_numpy(x))
    want = np.zeros_like(x)
    np.add.at(want, r, x[s] * w[:, None])
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---- the product and its gradients ------------------------------------------


@pytest.mark.parametrize("V,K,F", [(150, 5, 3), (150, 5, 50), (300, 16, 81), (64, 1, 128)])
def test_spmm_ell_matches_the_pallas_kernel(V, K, F):
    from kgcn_tpu.ops import ell as jell
    from kgcn_tpu.ops.pallas_spmm import spmm_ell_pallas

    idx, w, x = _ell(V, K, F, seed=V + K + F)
    with pallas_interpret():
        want = spmm_ell_pallas(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(x))
    got = tell.spmm_ell(torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jell.spmm_ell(jnp.asarray(idx), jnp.asarray(w),
                                              jnp.asarray(x))), **TOL)
    gpu = tes.spmm_ell_gpu(torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(gpu.numpy(), got.numpy(), rtol=0, atol=0)


def test_spmm_ell_multichannel_matches_jax():
    from kgcn_tpu.ops import ell as jell

    parts = [_ell(40, 4, 6, seed=c) for c in range(3)]
    idx = np.stack([p[0] for p in parts])
    w = np.stack([p[1] for p in parts])
    x = parts[0][2]
    want = jell.spmm_ell_multichannel(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(x))
    got = tell.spmm_ell_multichannel(torch.from_numpy(idx), torch.from_numpy(w),
                                     torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("V,K,F", [(150, 5, 3), (120, 7, 50)])
def test_spmm_ell_ad_value_and_gradients_match_jax(V, K, F):
    from kgcn_tpu.ops.pallas_spmm import spmm_ell_ad as j_ad

    idx, w, x = _ell(V, K, F, seed=7)
    cot = np.random.RandomState(8).standard_normal((V, F)).astype(np.float32)

    def loss(w_, x_):
        return jnp.sum(j_ad(jnp.asarray(idx), w_, x_) * jnp.asarray(cot))

    with pallas_interpret():
        want = j_ad(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(x))
        jdw, jdx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(x))
    tw = torch.from_numpy(w).requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tes.SpmmEll.apply(torch.from_numpy(idx), tw, tx)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


def test_spmm_ell_ad_skips_the_weight_gradient_unless_asked():
    idx, w, x = _ell(50, 4, 8, seed=9)
    tx = torch.from_numpy(x).requires_grad_(True)
    tw = torch.from_numpy(w)
    out = tes.SpmmEll.apply(torch.from_numpy(idx), tw, tx)
    out.sum().backward()
    assert tw.grad is None and tx.grad is not None


@pytest.mark.parametrize("max_degree", [None, 3])
def test_spmm_pallas_matches_jax(max_degree):
    from kgcn_tpu.ops.pallas_spmm import spmm_pallas as j_pallas

    s, r, w = _coo(64, 300, seed=3, zero_every=7)
    x = np.random.RandomState(4).standard_normal((64, 16)).astype(np.float32)
    with pallas_interpret():
        want = j_pallas(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w), jnp.asarray(x),
                        64, max_degree=max_degree)
    got = tes.spmm_pallas(torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(w),
                          torch.from_numpy(x), 64, max_degree=max_degree)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---- ops/spmm.py --------------------------------------------------------------


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_ell_aggregate_matches_jax(shared, backend):
    from kgcn_tpu.ops.spmm import ell_aggregate as j_agg

    C, V, K, F = 2, 60, 4, 10
    parts = [_ell(V, K, F, seed=20 + c) for c in range(C)]
    idx = np.stack([p[0] for p in parts])
    w = np.stack([p[1] for p in parts])
    x = parts[0][2] if shared else np.stack([p[2] for p in parts])
    with pallas_interpret():
        want = j_agg(jnp.asarray(idx), jnp.asarray(w), jnp.asarray(x), backend=backend)
    tx = torch.from_numpy(x).requires_grad_(True)
    got = tspmm.ell_aggregate(torch.from_numpy(idx), torch.from_numpy(w), tx,
                              backend=backend)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.sum().backward()
    jdx = jax.grad(lambda x_: jnp.sum(j_agg(jnp.asarray(idx), jnp.asarray(w), x_,
                                            backend="xla")))(jnp.asarray(x))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_spmm_and_sddmm_match_jax(backend):
    jspmm = importlib.import_module("kgcn_tpu.ops.spmm")

    s, r, w = _coo(50, 240, seed=5, zero_every=6)
    rng = np.random.RandomState(6)
    x = rng.standard_normal((50, 12)).astype(np.float32)
    a = rng.standard_normal((50, 12)).astype(np.float32)
    with pallas_interpret():
        want = jspmm.spmm(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w), jnp.asarray(x),
                          50, backend=backend)
    got = tspmm.spmm(torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(w),
                     torch.from_numpy(x), 50, backend=backend)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want_e = jspmm.sddmm(jnp.asarray(s), jnp.asarray(r), jnp.asarray(a), jnp.asarray(x))
    got_e = tspmm.sddmm(torch.from_numpy(s), torch.from_numpy(r), torch.from_numpy(a),
                        torch.from_numpy(x))
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), **TOL)


@pytest.mark.parametrize("backend,baked", [("tiled", False), ("stream", False),
                                           ("stream", True)])
def test_single_channel_spmm_on_the_kernel_backends_equals_the_scatter(backend, baked):
    """``spmm`` on the tiled and stream structures (float32 payload; the
    stream one with runtime or baked weights) equals its xla scatter."""
    from kgcn_tpu_torch.ops.stream_spmm import build_stream
    from kgcn_tpu_torch.ops.tiled_spmm import build_tiled

    s, r, w = _coo(300, 1500, seed=14, zero_every=9)
    x = torch.from_numpy(np.random.RandomState(15).standard_normal((300, 8))
                         .astype(np.float32))
    args = [torch.from_numpy(a) for a in (s, r, w)]
    want = tspmm.spmm(*args, x, 300)
    if backend == "tiled":
        kw = dict(tiled=build_tiled(s, r, 300, weights=w, ts=128, tr=128, chunk=128))
    else:
        kw = dict(stream=build_stream(s, r, 300, weights=w))
    if baked:
        args[2] = None
    got = tspmm.spmm(*args, x, 300, backend=backend, compute_dtype="float32", **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_spmm_multichannel_pallas_takes_the_scatter_and_says_so_once(capsys):
    """The edge-list route on ``pallas``: the xla scatter with the JAX
    package's message, printed once, equal to the JAX package's
    multichannel product."""
    from kgcn_tpu.ops.spmm import spmm_multichannel as j_multi

    C, V, E = 3, 20, 70
    rng = np.random.RandomState(11)
    s = rng.randint(0, V, (C, E)).astype(np.int32)
    r = rng.randint(0, V, (C, E)).astype(np.int32)
    w = rng.random_sample((C, E)).astype(np.float32)
    x = rng.standard_normal((C, V, 5)).astype(np.float32)
    want = np.asarray(j_multi(jnp.asarray(s), jnp.asarray(r), jnp.asarray(w),
                              jnp.asarray(x), V, backend="xla"))
    tspmm._PALLAS_FALLBACK_WARNED[0] = False
    args = [torch.from_numpy(a) for a in (s, r, w, x)]
    for _ in range(2):
        got = tspmm.spmm_multichannel(*args, V, backend="pallas")
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert capsys.readouterr().out.count("[spmm] pallas backend requested") == 1


# ---- the Batcher and the ring dataset -----------------------------------------


@pytest.mark.parametrize("seed", [0, 1])
def test_make_ring_dataset_matches_jax(seed):
    from kgcn_tpu.data.synthetic import make_ring_dataset as j_ring
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset as t_ring

    kw = dict(num_pairs=60, num_nodes=6, seed=seed)
    want, got = j_ring(**kw), t_ring(**kw)
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(t_ring(num_pairs=5)["dense_adj"],
                                  j_ring(num_pairs=5)["dense_adj"])


def _batchers(data, backend, bs=25):
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
    from kgcn_tpu_torch.data.dataset import build_dataset as t_build
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = {"normalize_adj_flag": True}
    jds, jinfo = j_build(dict(data), cfg)
    tds, tinfo = t_build(dict(data), cfg)
    return JBatcher(jds, jinfo, bs), TBatcher(tds, tinfo, bs, backend=Backend(backend))


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_batcher_ell_arrays_match_jax_on_ring6(backend):
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    jb, tb = _batchers(make_ring_dataset(num_pairs=100, num_nodes=6, seed=0), backend)
    for idx in (np.arange(25), np.array([3, 40, 41, 199]), np.arange(175, 200)):
        jg, tg = jb.make_batch(idx).graph, tb.make_batch(idx).graph
        assert tg.ell_senders is not None and tg.backend == backend
        assert tuple(tg.ell_senders.shape) == (1, 150, 4)
        np.testing.assert_array_equal(tg.ell_senders.numpy(), np.asarray(jg.ell_senders))
        np.testing.assert_array_equal(tg.ell_weights.numpy(), np.asarray(jg.ell_weights))
    assert tb.ell_seconds > 0.0


@pytest.mark.parametrize("backend", ["pallas", "xla", "tiled", "dense"])
def test_no_ell_arrays_where_the_gate_refuses(backend):
    """synthetic.jbl (10-node graphs): the gate refuses ELL in both
    packages; the port attaches nothing on the other backends either."""
    from kgcn_tpu_torch.data import jbl

    data = jbl.load(os.path.join(REPO, "example_jbl/synthetic.jbl"))
    jb, tb = _batchers(data, backend)
    jg, tg = jb.make_batch(np.arange(25)).graph, tb.make_batch(np.arange(25)).graph
    assert jg.ell_senders is None
    assert tg.ell_senders is None and tg.ell_weights is None


def test_launches_stay_zero_on_the_cpu():
    tes.spmm_ell_gpu.launches = 0
    idx, w, x = _ell(30, 3, 4, seed=12)
    tes.spmm_ell_gpu(torch.from_numpy(idx), torch.from_numpy(w), torch.from_numpy(x))
    tspmm.ell_aggregate(torch.from_numpy(idx)[None], torch.from_numpy(w)[None],
                        torch.from_numpy(x), backend="pallas")
    assert tes.spmm_ell_gpu.launches == 0


def test_the_kernel_wrapper_checks_its_operands():
    idx, w, x = (torch.from_numpy(a) for a in _ell(8, 2, 4, seed=13))
    with pytest.raises(ValueError, match="expects idx"):
        tes.spmm_ell_gpu(idx, w[:, :1], x)
    with pytest.raises(TypeError, match="int32 indices"):
        tes._launch(idx.long(), w, x)
    with pytest.raises(TypeError, match="float32 or bfloat16 weights"):
        tes._launch(idx, w.double(), x)
    with pytest.raises(TypeError, match="float32 or bfloat16 x"):
        tes._launch(idx, w, x.double())
    with pytest.raises(ValueError, match="contiguous x"):
        tes._launch(idx, w, x.t())


# ---- the dx kernel's slot lists and orders of sums ---------------------------


def _ell_channels(C, V, K, F, seed):
    """C channels of random ELL arrays, a shared x and per-channel xs."""
    parts = [_ell(V, K, F, seed=seed + c) for c in range(C)]
    return (np.stack([p[0] for p in parts]), np.stack([p[1] for p in parts]),
            parts[0][2], np.stack([p[2] for p in parts]))


def _ring6_batches(backend="pallas"):
    """(graph indices, the port's GraphBatch) of three ring6 batches: a full
    one, a partial one of scattered graphs, the dataset's last 25."""
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    _, tb = _batchers(make_ring_dataset(num_pairs=100, num_nodes=6, seed=0), backend)
    return [tb.make_batch(i).graph for i in (np.arange(25), np.array([3, 40, 41, 199]),
                                              np.arange(175, 200))]


def _check_lists(offsets, slots, idx, w):
    """Each real slot once, in its sender's list, in increasing (v, k)
    order; no padding slot."""
    C, V, K = idx.shape
    for c in range(C):
        lo, hi = int(offsets[c, 0]), int(offsets[c, -1])
        lists = slots[lo:hi].astype(np.int64)
        np.testing.assert_array_equal(np.sort(lists), np.flatnonzero(w[c].reshape(-1)))
        for u in range(offsets.shape[1] - 1):
            mine = slots[offsets[c, u]:offsets[c, u + 1]].astype(np.int64)
            assert (idx[c].reshape(-1)[mine] == u).all()
            assert (np.diff(mine) > 0).all()


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_batch_transpose_equals_a_recomputation_on_ring6(backend):
    """The Batcher's transposed slot lists (built per graph once per
    dataset, offset per batch) equal ``ell_transpose`` recomputed from the
    batch's own forward ELL arrays; ``ell_senders`` and ``ell_weights`` are
    views of the same int32 buffer."""
    for g in _ring6_batches(backend):
        offsets, slots = g.ell_transpose()
        want = tell.ell_transpose(g.ell_senders.numpy(), g.ell_weights.numpy(),
                                  g.total_nodes)
        assert offsets.dtype == slots.dtype == torch.int32
        np.testing.assert_array_equal(offsets.numpy(), want[0])
        np.testing.assert_array_equal(slots.numpy(), want[1])
        lo = g.ell_pack.data_ptr()
        hi = lo + 4 * g.ell_pack.numel()
        for t in (g.ell_senders, g.ell_weights, offsets, slots):  # inside the pack
            assert lo <= t.data_ptr() and t.data_ptr() + 4 * t.numel() <= hi
        assert g.ell_weights.dtype == torch.float32
        assert g.ell_pack.numel() == (2 * g.ell_senders.numel() + offsets.numel()
                                      + slots.numel())


@pytest.mark.parametrize("source", ["ring6", "random"])
def test_transpose_lists_each_real_slot_once_in_slot_order(source):
    if source == "ring6":
        for g in _ring6_batches():
            offsets, slots = g.ell_transpose()
            _check_lists(offsets.numpy(), slots.numpy(), g.ell_senders.numpy(),
                         g.ell_weights.numpy())
        return
    idx, w, _, _ = _ell_channels(3, 70, 6, 4, seed=30)
    idx[1, 5] = 9  # a hub sender: one out-edge from every slot of a row
    offsets, slots = tell.ell_transpose(idx, w, 70)
    _check_lists(offsets, slots, idx, w)


def _emulate_dx(offsets, slots, w, g, K, x_shape):
    """The dx kernel's arithmetic in PyTorch: per channel, each row's sum
    from 0 over its slot list in list order, each product and each sum
    rounded to f32 apart; for a shared x the channels' sums added in
    channel order."""
    C = w.shape[0]
    N, F = x_shape[-2:]
    wf = w.reshape(C, -1)
    out = []
    for c in range(C):
        acc = torch.zeros((N, F), dtype=torch.float32)
        deg = (offsets[c, 1:] - offsets[c, :-1]).long()
        for j in range(int(deg.max()) if N else 0):
            rows = torch.nonzero(deg > j).reshape(-1)
            s = slots[offsets[c, rows].long() + j].long()
            acc[rows] = acc[rows] + wf[c, s][:, None] * g[s // K]
        out.append(acc)
    if len(x_shape) == 3:
        return torch.stack(out)
    tot = out[0]
    for o in out[1:]:
        tot = tot + o
    return tot


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("C,V,K,F", [(1, 150, 5, 3), (1, 120, 7, 50), (3, 90, 4, 12)])
def test_dx_kernel_order_equals_index_add_bitwise(C, V, K, F, shared):
    """A PyTorch emulation of the dx kernel's order of sums over the host
    slot lists equals the plain ``index_add_`` dx bitwise in f32, for one
    and for three channels, shared and per-channel x."""
    idx, w, x, xc = _ell_channels(C, V, K, F, seed=40 + C)
    g = torch.from_numpy(np.random.RandomState(41).standard_normal((V, F))
                         .astype(np.float32))
    x_shape = x.shape if shared else xc.shape
    offsets, slots = (torch.from_numpy(a) for a in tell.ell_transpose(idx, w, V))
    got = _emulate_dx(offsets, slots, torch.from_numpy(w), g, K, x_shape)
    want = tes.spmm_ell_dx_reference(torch.from_numpy(idx), torch.from_numpy(w), g, x_shape)
    assert torch.equal(got, want)
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(tes.spmm_ell_dx_gpu(torch.from_numpy(idx), torch.from_numpy(w), g,
                                           x_shape), want)


@pytest.mark.parametrize("V,K,F", [(150, 5, 3), (120, 7, 50)])
def test_dx_kernel_order_matches_jax_vjp(V, K, F):
    """The emulated dx kernel against JAX's ``spmm_ell_ad`` dx through
    ``jax.vjp`` (Pallas in interpret mode): the same sums."""
    from kgcn_tpu.ops.pallas_spmm import spmm_ell_ad as j_ad

    idx, w, x = _ell(V, K, F, seed=7)
    g = np.random.RandomState(8).standard_normal((V, F)).astype(np.float32)
    with pallas_interpret():
        _, vjp = jax.vjp(lambda x_: j_ad(jnp.asarray(idx), jnp.asarray(w), x_),
                         jnp.asarray(x))
        (jdx,) = vjp(jnp.asarray(g))
    offsets, slots = (torch.from_numpy(a) for a in tell.ell_transpose(idx, w, V))
    got = _emulate_dx(offsets, slots, torch.from_numpy(w)[None], torch.from_numpy(g), K,
                      x.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(jdx), **TOL)


@pytest.mark.parametrize("shared", [True, False])
def test_fused_forward_equals_the_per_channel_sum_bitwise(shared):
    """C = 3: the channel-ordered fused forward (the plain version the CPU
    runs and the order in which the kernel adds its channels) equals the
    per-channel products summed ``o_0 + o_1 + o_2`` in f32, as
    ``ell_aggregate`` summed them one launch per channel; and
    ``ell_aggregate`` on pallas is that fused call, with dx equal to the
    per-channel calls' summed gradients."""
    idx, w, x, xc = _ell_channels(3, 80, 5, 9, seed=50)
    ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    tx = torch.from_numpy(x if shared else xc)
    xs = (tx,) * 3 if shared else tx.unbind(0)
    per = [tes.spmm_ell_reference(ti[c], tw[c], xs[c]) for c in range(3)]
    want = per[0] + per[1] + per[2]
    assert torch.equal(tes.spmm_ell_reference(ti, tw, tx), want)
    assert torch.equal(tes.spmm_ell_gpu(ti, tw, tx), want)
    xg = tx.clone().requires_grad_(True)
    got = tspmm.ell_aggregate(ti, tw, xg, backend="pallas")
    assert torch.equal(got, want)
    cot = torch.from_numpy(np.random.RandomState(51).standard_normal((80, 9))
                           .astype(np.float32))
    (got * cot).sum().backward()
    dx = [tes.spmm_ell_dx_reference(ti[c], tw[c], cot, tuple(xs[c].shape)) for c in range(3)]
    np.testing.assert_allclose(xg.grad.numpy(), (dx[0] + dx[1] + dx[2] if shared
                                                 else torch.stack(dx)).numpy(), **TOL)


@pytest.mark.parametrize("case", ["coo", "channels"])
def test_device_transpose_matches_the_host_one(case):
    """``ell_transpose_device`` (the COO entry's, a stable sort with padding
    keyed last) gives each sender the host ``ell_transpose``'s list."""
    if case == "coo":
        s, r, w = _coo(30, 120, seed=2, zero_every=5)
        ti, tw = tes.coo_to_ell_device(torch.from_numpy(s), torch.from_numpy(r),
                                       torch.from_numpy(w), 30, 6)
        ti, tw = ti[None], tw[None]
    else:
        idx, w, _, _ = _ell_channels(3, 40, 5, 2, seed=60)
        ti, tw = torch.from_numpy(idx), torch.from_numpy(w)
    N = ti.shape[1]
    d_off, d_slots = tes.ell_transpose_device(ti, tw, N)
    h_off, h_slots = tell.ell_transpose(ti.numpy(), tw.numpy(), N)
    assert d_off.dtype == d_slots.dtype == torch.int32
    assert d_slots.numel() == ti.numel()
    for c in range(ti.shape[0]):
        np.testing.assert_array_equal(np.diff(d_off[c].numpy()), np.diff(h_off[c]))
        np.testing.assert_array_equal(d_slots[d_off[c, 0]:d_off[c, -1]].numpy(),
                                      h_slots[h_off[c, 0]:h_off[c, -1]])


def test_the_batch_moves_its_ell_pack_in_one_copy():
    """``GraphBatch.to`` copies ``ell_pack`` once, and ``ell_senders`` and
    ``ell_weights`` become views of the copy (here onto the meta device); a
    batch whose ELL arrays are replaced drops the stale pack."""
    g = _ring6_batches()[0]
    moved = g.to("meta")
    assert moved.ell_pack.device.type == "meta"
    size = moved.ell_pack.untyped_storage().nbytes()
    for name in ("ell_senders", "ell_weights"):
        a, b = getattr(g, name), getattr(moved, name)
        assert b.untyped_storage().nbytes() == size  # the pack's storage, no copy of its own
        assert b.shape == a.shape and b.dtype == a.dtype
    assert moved.ell_transpose()[1].shape == g.ell_transpose()[1].shape
    assert g.replace(ell_senders=g.ell_senders.clone()).ell_transpose() is None
    assert g.replace(ell_weights=g.ell_weights.clone()).ell_pack is None


def test_dx_launches_stay_zero_on_the_cpu():
    tes.spmm_ell_dx_gpu.launches = 0
    idx, w, x, _ = _ell_channels(2, 30, 3, 4, seed=70)
    xg = torch.from_numpy(x).requires_grad_(True)
    tspmm.ell_aggregate(torch.from_numpy(idx), torch.from_numpy(w), xg,
                        backend="pallas").sum().backward()
    assert xg.grad is not None and tes.spmm_ell_dx_gpu.launches == 0


def test_the_dx_kernel_wrapper_checks_its_operands():
    idx, w, x, _ = _ell_channels(1, 8, 2, 4, seed=71)
    offsets, slots = (torch.from_numpy(a) for a in tell.ell_transpose(idx, w, 8))
    w, g = torch.from_numpy(w), torch.from_numpy(x)
    with pytest.raises(TypeError, match="int32 indices"):
        tes._dx_launch(offsets, slots.long(), w, g, (8, 4))
    with pytest.raises(TypeError, match="int32 offsets"):
        tes._dx_launch(offsets.long(), slots, w, g, (8, 4))
    with pytest.raises(ValueError, match="do not fit"):
        tes._dx_launch(offsets, slots, w, g, (9, 4))
    with pytest.raises(ValueError, match="several devices"):
        tes._dx_launch(offsets.to("meta"), slots, w, g, (8, 4))
