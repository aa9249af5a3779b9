"""The port's batch prefetching (data/prefetch.py) and its native batch packer
(ops/csrc/batch_host.cc behind data/batcher.Batcher), on the CPU.

* ``prefetch``: the items in order, a producer's error raised in the
  consumer, the producer thread joined when the consumer abandons the
  generator, ``KGCN_PREFETCH=0`` turning it off;
* the packer: every array of a batch bitwise equal to the NumPy assembly
  (``graph/batch.batch_graphs``, the path it replaces) on the solubility,
  synthetic and ring6 datasets, full and partial batches, and its error
  codes (-1 edge budget, -2 node index out of range) raised as the JAX
  package's native wrapper raises them.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from kgcn_tpu_torch.data import prefetch as prefetch_mod
from kgcn_tpu_torch.data.batcher import Batcher, _batch_host
from kgcn_tpu_torch.graph.batch import batch_graphs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---- prefetch --------------------------------------------------------------------


def test_prefetch_keeps_the_order():
    assert list(prefetch_mod.prefetch(iter(range(50)), size=3)) == list(range(50))
    assert list(prefetch_mod.prefetch(iter([]))) == []


def test_prefetch_raises_the_producer_error_in_the_consumer():
    def items():
        yield 1
        yield 2
        raise KeyError("broken batch")

    got = []
    with pytest.raises(KeyError, match="broken batch"):
        for x in prefetch_mod.prefetch(items()):
            got.append(x)
    assert got == [1, 2]


def test_prefetch_joins_the_producer_when_the_consumer_leaves():
    started = threading.Event()

    def endless():
        i = 0
        while True:
            started.set()
            yield i
            i += 1

    before = threading.active_count()
    gen = prefetch_mod.prefetch(endless(), size=2)
    assert next(gen) == 0
    assert started.wait(5)
    assert threading.active_count() == before + 1
    gen.close()  # the consumer abandons the generator
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before


def test_prefetch_runs_ahead_in_a_thread_and_can_be_turned_off(monkeypatch):
    seen = []

    def items():
        for i in range(3):
            seen.append(threading.current_thread() is threading.main_thread())
            yield i

    assert list(prefetch_mod.prefetch(items())) == [0, 1, 2]
    assert seen == [False] * 3
    monkeypatch.setenv("KGCN_PREFETCH", "0")
    seen.clear()
    assert list(prefetch_mod.prefetch(items())) == [0, 1, 2]
    assert seen == [True] * 3


# ---- the native packer -------------------------------------------------------------


def _dataset(name):
    from kgcn_tpu_torch.data.dataset import build_dataset, load_jbl

    cfg = {"normalize_adj_flag": True}
    if name == "ring6":
        from kgcn_tpu_torch.data.synthetic import make_ring_dataset

        return build_dataset(make_ring_dataset(num_pairs=60, num_nodes=6, seed=0), cfg)
    path = {"solubility": "examples/solubility/solubility_cls.jbl",
            "synthetic": "example_jbl/synthetic.jbl"}[name]
    return load_jbl(os.path.join(REPO, path), cfg)


def _numpy_graph(b: Batcher, idx):
    """The batch's graph as ``batch_graphs`` assembles it in NumPy."""
    ds = b.ds
    adjs = [[(np.stack([r, c], axis=1), v, (b.max_nodes, b.max_nodes))
             for (r, c, v) in ds.adjs[i]] for i in idx]
    return batch_graphs(
        adjs, ds.features[idx] if ds.features is not None else None, b.max_nodes,
        node_ids=[ds.nodes[i] for i in idx] if ds.nodes is not None else None,
        n_nodes=ds.enabled_node_nums[idx] if ds.enabled_node_nums is not None else None,
        edge_budget=b.edge_budget, n_graph=b.batch_size)


@pytest.mark.parametrize("name", ["solubility", "synthetic", "ring6"])
def test_native_pack_equals_the_numpy_assembly(name):
    ds, info = _dataset(name)
    b = Batcher(ds, info, 25, seed=0)
    rng = np.random.RandomState(0)
    for idx in (rng.permutation(ds.num)[:25], rng.permutation(ds.num)[:11], np.arange(1)):
        got, want = b.make_batch(idx).graph, _numpy_graph(b, idx)
        for field in ("senders", "receivers", "edge_weights", "n_edge", "n_node",
                      "node_mask", "nodes", "node_ids"):
            a, w = getattr(got, field), getattr(want, field)
            if w is None:
                assert a is None, field
                continue
            assert a.dtype == w.dtype and a.shape == w.shape, field
            assert torch.equal(a, w), (name, field)


def test_native_pack_error_codes():
    """-1: a channel exceeds the edge budget; -2: a node index outside the
    graph's [0, max_nodes) (it would bleed into the next graph's block)."""
    ds, info = _dataset("ring6")
    b = Batcher(ds, info, 4, seed=0, edge_budget=8)
    with pytest.raises(RuntimeError, match="edge budget exceeded in native pack_edges"):
        b.make_batch(np.arange(4))
    lib = _batch_host()
    rows = np.array([0, 7], np.int32)
    cols = np.array([1, 2], np.int32)
    vals = np.ones(2, np.float32)
    off, length = np.zeros(1, np.int64), np.full(1, 2, np.int64)
    out = [np.empty(16, np.int32), np.empty(16, np.int32), np.empty(16, np.float32),
           np.empty(1, np.int32)]
    rc = lib.kgcn_pack_edges(rows.ctypes.data, cols.ctypes.data, vals.ctypes.data,
                             off.ctypes.data, length.ctypes.data, 1, 1, 6, 16,
                             *(a.ctypes.data for a in out))
    assert rc == -2
    rows[1] = 5
    rc = lib.kgcn_pack_edges(rows.ctypes.data, cols.ctypes.data, vals.ctypes.data,
                             off.ctypes.data, length.ctypes.data, 1, 1, 6, 16,
                             *(a.ctypes.data for a in out))
    assert rc == 0 and out[3][0] == 2 and list(out[1][:3]) == [0, 5, 0]


def test_native_gather_pad_features():
    lib = _batch_host()
    feats = np.random.RandomState(0).standard_normal((80, 4, 3)).astype(np.float32)
    for idx in (np.array([4, 0, 2]), np.random.RandomState(1).permutation(80)[:70]):
        B = len(idx) + 3
        out = np.full((B, 4, 3), np.nan, np.float32)
        lib.kgcn_gather_pad_features(feats.ctypes.data, np.ascontiguousarray(idx, np.int64)
                                     .ctypes.data, len(idx), B, 4, 3, out.ctypes.data)
        np.testing.assert_array_equal(out[:len(idx)], feats[idx])
        assert (out[len(idx):] == 0).all()


def test_the_jax_native_packer_agrees():
    """The JAX package's native ``pack_edges`` (where its library builds) on
    the same blocks gives the port's arrays."""
    from kgcn_tpu import native

    if not native.available(build=True):
        pytest.skip("the JAX package's native library could not be built here")
    ds, info = _dataset("solubility")
    b = Batcher(ds, info, 25, seed=0)
    idx = np.random.RandomState(3).permutation(ds.num)[:20]
    got = b.make_batch(idx).graph
    coo = b._coo
    s, r, w, n = native.pack_edges(coo["rows"], coo["cols"], coo["vals"],
                                   coo["off"][idx].reshape(-1), coo["len"][idx].reshape(-1),
                                   len(idx), coo["C"], b.max_nodes, b.edge_budget)
    for a, want in ((got.senders, s), (got.receivers, r), (got.edge_weights, w),
                    (got.n_edge, n)):
        np.testing.assert_array_equal(a.numpy(), want)
