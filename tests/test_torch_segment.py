"""The port's segment reductions (kgcn_tpu_torch/ops/segment.py) against the
JAX package's (kgcn_tpu/ops/segment.py: ``jax.ops.segment_sum`` and its
``segment_softmax``), on the CPU: values and gradients, with unsorted ids
and empty segments, and the fixed order of sums that makes a GPU run repeat
bitwise.

Inputs are made with numpy from a seed and fed to both packages.  Tolerance
rtol = atol = 1e-5 (float32; the order of the sums differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu.ops import segment as js
from kgcn_tpu_torch.ops import segment as ts

F32 = dict(rtol=1e-5, atol=1e-5)


def _ids(E, V, seed):
    """Unsorted ids in [0, V - 3): the last three segments stay empty."""
    return np.random.RandomState(seed).randint(0, V - 3, E).astype(np.int32)


@pytest.mark.parametrize("width", [None, 5])
@pytest.mark.parametrize("presorted", [False, True])
def test_segment_sum_value_and_gradient_match_jax(width, presorted):
    rng = np.random.RandomState(1)
    E, V = 300, 40
    ids = _ids(E, V, 2)
    shape = (E,) if width is None else (E, width)
    data = rng.standard_normal(shape).astype(np.float32)
    cot = rng.standard_normal((V,) + shape[1:]).astype(np.float32)

    def jloss(d):
        return jnp.sum(js.segment_sum(d, jnp.asarray(ids), V) * cot)

    want = js.segment_sum(jnp.asarray(data), jnp.asarray(ids), V)
    want_grad = jax.grad(jloss)(jnp.asarray(data))
    d = torch.tensor(data, requires_grad=True)
    tids = torch.from_numpy(ids)
    got = ts.segment_sum(d, tids, V, ts.sort_segments(tids, V) if presorted else None)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    assert not got[V - 3:].any()  # empty segments are 0
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(want_grad), **F32)


@pytest.mark.parametrize("heads", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_value_and_gradient_match_jax(heads, masked):
    rng = np.random.RandomState(3)
    E, V = 250, 30
    ids = _ids(E, V, 4)
    shape = (E,) if heads is None else (E, heads)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    mask = (rng.random_sample(E) > 0.2).astype(np.float32) if masked else None
    cot = rng.standard_normal(shape).astype(np.float32)

    def jsoftmax(lg):
        return js.segment_softmax(lg, jnp.asarray(ids), V,
                                  mask=None if mask is None else jnp.asarray(mask))

    want = jsoftmax(jnp.asarray(logits))
    want_grad = jax.grad(lambda lg: jnp.sum(jsoftmax(lg) * cot))(jnp.asarray(logits))
    lt = torch.tensor(logits, requires_grad=True)
    got = ts.segment_softmax(lt, torch.from_numpy(ids), V,
                             mask=None if mask is None else torch.from_numpy(mask))
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_grad), **F32)
    assert np.isfinite(got.detach().numpy()).all()


@pytest.mark.parametrize("presorted", [False, True])
def test_segment_sum_adds_each_segment_in_data_order(presorted):
    """segment_sum sums each segment from 0 in the order of its entries in
    data (a stable sort, then a sorted segment reduction): bitwise the
    sequential f32 sum, whatever order the ids come in, so a GPU run repeats
    bitwise; the same with the ids sorted beforehand (``sort_segments``).
    Gradients flow to every entry."""
    rng = np.random.RandomState(9)
    E, V, F = 300, 20, 3  # segment 19 gets nothing
    ids = rng.randint(0, V - 1, E)
    data = (rng.standard_normal((E, F)) * 10 ** rng.uniform(-3, 3, (E, 1))).astype(np.float32)
    want = np.zeros((V, F), np.float32)
    for i in range(E):
        want[ids[i]] = want[ids[i]] + data[i]
    d = torch.tensor(data, requires_grad=True)
    tids = torch.from_numpy(ids.astype(np.int32))
    got = ts.segment_sum(d, tids, V, ts.sort_segments(tids, V) if presorted else None)
    np.testing.assert_array_equal(got.detach().numpy(), want)
    cot = rng.standard_normal((V, F)).astype(np.float32)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(d.grad.numpy(), cot[ids])


def _gat_graph():
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.runtime.config import load_config

    cfg = load_config("example_config/gat.json", {})
    ds, info = load_jbl(cfg["dataset"], cfg)
    return Batcher(ds, info, 8).make_batch(np.arange(8)).graph


@pytest.mark.parametrize("channel", [0, None])
def test_receiver_segments_sorted_once_per_batch(channel):
    """GraphBatch.receiver_segments sorts a channel's receivers (or, with
    None, all channels' as one list, the xla scatter's) once per batch
    object, on the host (GAT's three layers share it); a replaced copy sorts
    its own.  The order is the stable sort of the ids, the offsets count
    each receiver's edges, as ``sort_segments`` finds them."""
    g = _gat_graph()
    first = g.receiver_segments(channel)
    assert g.receiver_segments(channel) is first
    ids, order, offsets = first
    r = g.receivers.reshape(-1) if channel is None else g.receivers[channel]
    np.testing.assert_array_equal(ids.numpy(), r.numpy())
    np.testing.assert_array_equal(np.diff(offsets.numpy()),
                                  np.bincount(ids.numpy(), minlength=g.total_nodes))
    np.testing.assert_array_equal(order.numpy(), np.argsort(ids.numpy(), kind="stable"))
    for want, got in zip(ts.sort_segments(r, g.total_nodes), first):
        assert torch.equal(want, got)
    assert g.replace().receiver_segments(channel) is not first


def test_moved_batch_sorts_its_receivers_on_the_host():
    """A move keeps the receivers' host array, and the moved batch's
    segments are built from it and sent to its device (here the meta
    device, which holds no values: nothing is read back); a replace of the
    receivers drops it."""
    g = _gat_graph()
    moved = g.to("meta")
    assert moved.receivers.is_meta
    assert np.shares_memory(moved.host_receivers, g.receivers.numpy())
    ids, order, offsets = moved.receiver_segments(0)
    assert ids.is_meta and order.is_meta and offsets.is_meta
    assert offsets.shape == (g.total_nodes + 1,) and order.shape == g.receivers[0].shape
    assert moved.replace(receivers=moved.receivers).host_receivers is None
    assert g.to("cpu") is g


@pytest.mark.parametrize("V", [40, 70_000])
def test_host_segments_match_sort_segments(V):
    """The host sort (16-bit keys below 2^16 segments, else the ids
    themselves) gives ``sort_segments``' permutation and offsets, empty
    segments included."""
    ids = np.random.RandomState(5).randint(0, V - 3, 3000)
    want = ts.sort_segments(torch.from_numpy(ids), V)
    for w, g in zip(want, ts.host_segments(ids.astype(np.int32), V)):
        np.testing.assert_array_equal(g, w.numpy())
