"""The port's layers and GCN (kgcn_tpu_torch/nn/layers.py,
models/standard.py) against the flax modules of kgcn_tpu, with the
weights carried across by ``params_from_jax``.

Inputs are made with numpy from a seed and fed to both packages.
Tolerance: float32 with rtol = atol = 1e-5 (summation order only).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu import nn as jnn
from kgcn_tpu.data import Batcher as JBatcher
from kgcn_tpu.data import build_dataset as j_build_dataset
from kgcn_tpu.data.synthetic import make_random_graphs
from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
from kgcn_tpu_torch.data.dataset import build_dataset as t_build_dataset
from kgcn_tpu_torch.nn import layers as tnn

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _batches(C=2, idx=(1, 3, 5, 7)):
    """The same partial batch built by both packages (C channels, 9 graphs
    of ≤ 8 nodes, 5 features, Kipf-normalised)."""
    data = make_random_graphs(9, 8, 5, num_channels=C, seed=4)
    cfg = {"normalize_adj_flag": True}
    jds, jinfo = j_build_dataset(dict(data), cfg)
    tds, tinfo = t_build_dataset(dict(data), cfg)
    jb = JBatcher(jds, jinfo, 6).make_batch(np.array(idx))
    tb = TBatcher(tds, tinfo, 6).make_batch(np.array(idx))
    return jb, tb


def _random_tree(tree, seed):
    """Replace every leaf with seeded noise of its shape (non-trivial
    weights and BN statistics; variances kept positive)."""
    rng = np.random.RandomState(seed)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    leaves = []
    for path, leaf in flat:
        a = rng.standard_normal(np.shape(leaf)).astype(np.float32) * 0.5
        if str(path[-1].key) == "var":
            a = np.abs(a) + 0.5
        leaves.append(jnp.asarray(a))
    return jax.tree_util.tree_unflatten(treedef, leaves)


def _load(module, params, batch_stats=None):
    tree = params_from_jax(jax.device_get(params), jax.device_get(batch_stats or {}))
    module.load_state_dict({**tree["params"], **tree["batch_stats"]}, strict=True)
    return module


def _jgraph(jb):
    return jb.graph.with_dense_adj()


def _tgraph(tb):
    return tb.graph.with_dense_adj()


def test_graph_conv_matches_flax():
    jb, tb = _batches()
    jg, tg = _jgraph(jb), _tgraph(tb)
    layer = jnn.GraphConv(7, channels=2)
    params = _random_tree(layer.init(jax.random.PRNGKey(0), jg.nodes, jg), 1)
    want = layer.apply(params, jg.nodes, jg)
    port = _load(tnn.GraphConv(5, 7, channels=2), params["params"])
    got = port(tg.nodes, tg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_graph_conv_without_dense_adj_raises():
    """GraphConv on a batch without a dense adjacency raised while the port
    had no edge-list path for it.  With the xla and pallas backends ported
    it takes the edge lists, as kgcn_tpu's GraphConv does, and matches the
    flax layer on the same batch."""
    jb, tb = _batches(C=1)
    layer = jnn.GraphConv(7, channels=1)
    params = _random_tree(layer.init(jax.random.PRNGKey(0), jb.graph.nodes, jb.graph), 3)
    want = layer.apply(params, jb.graph.nodes, jb.graph)
    port = _load(tnn.GraphConv(5, 7), params["params"])
    got = port(tb.graph.nodes, tb.graph)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_graph_dense_and_gather_match_flax():
    jb, tb = _batches()
    jg, tg = jb.graph, tb.graph
    dense = jnn.GraphDense(6)
    params = _random_tree(dense.init(jax.random.PRNGKey(0), jg.nodes, jg), 2)
    want = dense.apply(params, jg.nodes, jg)
    port = _load(tnn.GraphDense(5, 6), params["params"])
    got = port(tg.nodes, tg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    want_g = jnn.GraphGather().apply({}, want, jg)
    got_g = tnn.GraphGather()(got, tg)
    np.testing.assert_allclose(got_g.detach().numpy(), np.asarray(want_g), **TOL)


@pytest.mark.parametrize("use_running_average", [True, False])
def test_graph_batch_norm_matches_flax(use_running_average):
    jb, tb = _batches()
    jg, tg = jb.graph, tb.graph
    rng = np.random.RandomState(3)
    x = rng.standard_normal((jg.total_nodes, 5)).astype(np.float32)
    bn = jnn.GraphBatchNormalization()
    v = bn.init(jax.random.PRNGKey(0), jnp.asarray(x), jg, use_running_average=True)
    params = _random_tree(v["params"], 4)
    stats = _random_tree(v["batch_stats"], 5)
    want, upd = bn.apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(x), jg,
        use_running_average=use_running_average, mutable=["batch_stats"],
    )
    port = _load(tnn.GraphBatchNormalization(5), params, stats)
    got = port(torch.from_numpy(x), tg, use_running_average=use_running_average)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # running statistics: untouched with the running average, m·ra + (1-m)·batch
    # otherwise
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(port, name).numpy(),
            np.asarray(upd["batch_stats"][name]), err_msg=name, **TOL,
        )


def _gcn_pair(dropout_rate=0.2):
    from kgcn_tpu.models.registry import build_model as j_build_model
    from kgcn_tpu_torch.models.registry import build_model as t_build_model

    data = make_random_graphs(9, 8, 5, num_channels=2, seed=4)
    cfg = {"normalize_adj_flag": True, "dropout_rate": dropout_rate}
    jds, jinfo = j_build_dataset(dict(data), cfg)
    tds, tinfo = t_build_dataset(dict(data), cfg)
    idx = np.array([0, 2, 4, 6, 8])
    jb = JBatcher(jds, jinfo, 6).make_batch(idx)
    tb = TBatcher(tds, tinfo, 6).make_batch(idx)
    jm = j_build_model("gcn", jinfo, cfg)
    v = jm.init({"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
                jb, train=False)
    params = _random_tree(v["params"], 6)
    stats = _random_tree(v["batch_stats"], 7)
    tm = _load(t_build_model("gcn", tinfo, cfg), params, stats)
    return jm, params, stats, jb, tm, tb


def test_gcn_eval_matches_flax():
    jm, params, stats, jb, tm, tb = _gcn_pair()
    want = jm.apply({"params": params, "batch_stats": stats}, jb, train=False)
    with torch.no_grad():
        got = tm(tb, train=False)
    np.testing.assert_allclose(got.prediction.numpy(),
                               np.asarray(want.prediction), **TOL)
    np.testing.assert_allclose(float(got.cost_sum), float(want.cost_sum), **TOL)
    for k in ("correct_count", "count"):
        assert float(got.metrics[k]) == float(want.metrics[k])


def test_gcn_train_step_gradients_match_flax():
    """Train mode (dropout 0): the loss, the BN statistics update and the
    gradient of every parameter, through the port's autograd Function."""
    jm, params, stats, jb, tm, tb = _gcn_pair(dropout_rate=0.0)

    def loss(p):
        out, upd = jm.apply({"params": p, "batch_stats": stats}, jb, train=True,
                            rngs={"dropout": jax.random.PRNGKey(0)},
                            mutable=["batch_stats"])
        return out.cost_opt, upd

    (want_loss, upd), want_grads = jax.value_and_grad(loss, has_aux=True)(params)
    out = tm(tb, train=True)
    out.cost_opt.backward()
    np.testing.assert_allclose(float(out.cost_opt.detach()), float(want_loss), **TOL)
    want_g = params_from_jax(jax.device_get(want_grads), {})["params"]
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_g[name].numpy(),
                                   err_msg=name, **TOL)
    want_s = params_from_jax({}, jax.device_get(upd["batch_stats"]))["batch_stats"]
    for name, b in tm.named_buffers():
        np.testing.assert_allclose(b.numpy(), want_s[name].numpy(),
                                   err_msg=name, **TOL)


def test_per_channel_glorot_fan_is_last_two_dims():
    gen = torch.Generator().manual_seed(0)
    t = tnn.per_channel_glorot_(torch.empty(7, 30, 20), gen)
    limit = (6.0 / 50) ** 0.5
    assert float(t.abs().max()) <= limit
    assert float(t.abs().max()) > 0.9 * limit  # not a fan folded over C
