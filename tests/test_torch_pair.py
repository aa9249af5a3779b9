"""The port's pair engine (kgcn_tpu_torch/models/pair.py, cli/pair.py,
``segment_max`` and ``GraphMaxPooling``) against the JAX package's on the
CPU, from the same weights (``params_from_jax``):

* ``segment_max`` values and gradients, with ties, -inf entries and empty
  segments (-inf, as ``jax.ops.segment_max`` gives them);
* ``GraphMaxPooling`` values and gradients on rows with ties, a fully dense
  row (``deg == N``: no zero floor), an edgeless row, padding edges and two
  channels, and on a batch gathered on the device (padding edges
  interleaved);
* ``GCNPairRanker`` (dropout 0): scores, costs, metrics and gradients
  within 1e-5 / 1e-4;
* ``PairBatcher``'s shuffled batches equal to ``kgcn_tpu``'s;
* the resident pair batcher's gathers and scanned epochs equal to the
  streaming ones;
* ``cli.pair train`` and ``infer`` on example_config/pair.json (2 epochs,
  dropout 0) from kgcn_tpu's initial weights: costs and pair accuracies
  within 1e-4 relative, the CSV's header, each row's score gap within 1e-4
  (the scores themselves up to a shift shared by all rows: see the
  test); ``infer`` of the checkpoint ``kgcn_tpu`` wrote gives kgcn_tpu's
  scores (1e-5).
"""
import contextlib
import io
import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from test_torch_tiled import jax_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIR_JBL = os.path.join(REPO, "example_jbl", "pair.jbl")
TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def test_segment_max_matches_jax():
    from kgcn_tpu_torch.ops.segment import segment_max

    rng = np.random.RandomState(0)
    data = rng.randint(-3, 4, size=(40, 3)).astype(np.float32)  # many ties
    data[rng.rand(40, 3) < 0.2] = -np.inf
    ids = rng.randint(0, 12, size=40)
    ids[ids == 5] = 6  # segment 5 stays empty
    w = rng.randn(12, 3).astype(np.float32)

    def jloss(x):
        m = jax.ops.segment_max(x, ids, 12)
        return jnp.sum(jnp.where(jnp.isfinite(m), m, 0.0) * w)

    x = torch.tensor(data, requires_grad=True)
    m = segment_max(x, torch.from_numpy(ids), 12)
    np.testing.assert_array_equal(m.detach().numpy(),
                                  np.asarray(jax.ops.segment_max(data, ids, 12)))
    assert torch.isneginf(m[5]).all()
    (torch.where(torch.isfinite(m), m, torch.zeros_like(m)) * torch.from_numpy(w)).sum().backward()
    # a tie's gradient split into thirds: the quotients may round apart
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(data))),
                               rtol=1e-6, atol=0)


def _graphs():
    """Two graphs of N = 5 nodes, two channels, as (row, col, weight) COO:
    graph 0 channel 0 has node 0 joined to every node (deg == N), node 3
    without edges; channel 1 a few weighted edges; graph 1 a ring."""
    full = (np.zeros(5, np.int32), np.arange(5, dtype=np.int32), np.ones(5, np.float32))
    part = (np.array([1, 2, 4, 1], np.int32), np.array([2, 1, 1, 4], np.int32),
            np.array([0.5, 2.0, 1.0, 1.0], np.float32))
    ring_r = np.arange(5, dtype=np.int32)
    ring = (ring_r, (ring_r + 1) % 5, np.full(5, 0.5, np.float32))
    tail = (np.array([2, 3], np.int32), np.array([3, 2], np.int32), np.ones(2, np.float32))
    return [[full, part], [ring, tail]]


def _x():
    x = np.array([[-1, 2, 0], [-2, 2, 1], [-1, -3, 0], [3, 1, -1], [-4, 2, 5]], np.float32)
    return np.concatenate([x, x[::-1] * 0.5])  # [V = 10, 3], ties within rows


def _coo_tuples(graphs):
    return [[(np.stack([r, c], 1), v, (5, 5)) for r, c, v in gs] for gs in graphs]


def test_graph_max_pooling_matches_jax():
    from kgcn_tpu.graph.batch import batch_graphs as j_batch
    from kgcn_tpu.nn.layers import GraphMaxPooling as JPool
    from kgcn_tpu_torch.graph.batch import batch_graphs
    from kgcn_tpu_torch.nn.layers import GraphMaxPooling

    tuples = _coo_tuples(_graphs())
    jg = j_batch(tuples, None, 5, n_nodes=[5, 5], edge_budget=16)
    g = batch_graphs(tuples, None, 5, n_nodes=[5, 5], edge_budget=16)
    x = _x()
    w = np.random.RandomState(1).randn(*x.shape).astype(np.float32)
    pool = JPool(channels=2)
    jout = pool.apply({}, jnp.asarray(x), jg)
    jgrad = jax.grad(lambda a: jnp.sum(pool.apply({}, a, jg) * w))(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = GraphMaxPooling()(xt, g)
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    (out * torch.from_numpy(w)).sum().backward()
    assert torch.isfinite(xt.grad).all()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jgrad))
    # node 0 of graph 0, channel 0: its 5 neighbours, no zero floor; its
    # channel-1 row is empty and gives 0; node 3 of graph 0 has no edge
    np.testing.assert_array_equal(out[0].detach().numpy(), x[:5].max(axis=0))
    np.testing.assert_array_equal(out[3].detach().numpy(), np.zeros(3))


def test_graph_max_pooling_on_a_gathered_batch():
    """The resident gather interleaves padding edges and marks them in
    ``edge_valid``: the pool's values and gradients equal the packed
    batch's."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.nn.layers import GraphMaxPooling
    from kgcn_tpu_torch.runtime.resident import ResidentBatcher

    graphs = _graphs()
    data = {"adj": _coo_tuples(graphs) * 2, "feature": np.zeros((4, 5, 3), np.float32),
            "max_node_num": 5}
    ds, info = build_dataset(data, {})
    info.edge_budget_per_graph = 0
    idx = np.array([1, 0, 3])
    packed = Batcher(ds, info, 4).make_batch(idx).graph
    gathered = ResidentBatcher(ds, info, 4).make_batch(idx).graph
    assert gathered.edge_valid is not None
    x = np.concatenate([_x(), _x()])
    outs = []
    for g in (packed, gathered):
        xt = torch.tensor(x, requires_grad=True)
        out = GraphMaxPooling()(xt, g)
        out.sum().backward()
        outs.append((out.detach(), xt.grad))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _pair_both(bs=10, idx=None):
    """(JAX model, variables, JAX pair batch, port model with the same
    weights, port pair batch) on pair.jbl, dropout 0."""
    from kgcn_tpu.data import load_jbl as j_load
    from kgcn_tpu.models.pair import GCNPairRanker as JRanker
    from kgcn_tpu.models.pair import PairBatcher as JPairs
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.pair import GCNPairRanker, PairBatcher

    cfg = {"normalize_adj_flag": True}
    jds, jinfo = j_load(PAIR_JBL, cfg)
    ds, info = load_jbl(PAIR_JBL, cfg)
    pairs = np.asarray(ds.graph_index_list)
    idx = np.arange(bs - 3) if idx is None else idx
    jb = JPairs(jds, jinfo, pairs, bs).make_batch(idx)
    b = PairBatcher(ds, info, pairs, bs).make_batch(idx)
    jm = JRanker(channels=1, label_dim=2, dropout_rate=0.0)
    variables = jax.device_get(jm.init({"params": jax.random.PRNGKey(4),
                                        "dropout": jax.random.PRNGKey(5)}, jb))
    m = GCNPairRanker(in_features=info.feature_dim, label_dim=2, dropout_rate=0.0)
    tree = params_from_jax(variables["params"], variables["batch_stats"], m)
    m.load_state_dict({**tree["params"], **tree["batch_stats"]})
    return jm, variables, jb, m, b


@pytest.mark.parametrize("train", [False, True])
def test_pair_ranker_matches_jax(train):
    jm, variables, jb, m, b = _pair_both()

    def cost(params):
        return jm.apply({**variables, "params": params}, jb, train=train,
                        mutable=["batch_stats"])[0].cost_opt

    with jax_backend("dense"):
        jout, jstats = jm.apply(variables, jb, train=train, mutable=["batch_stats"])
        jgrad = jax.grad(cost)(jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    out = m(b, train=train)
    np.testing.assert_allclose(out.prediction.detach().numpy(), np.asarray(jout.prediction),
                               **TOL)
    for name in ("cost_opt", "cost_sum"):
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), **TOL)
    assert set(out.metrics) == set(jout.metrics) == {"correct_count", "miss_count", "count"}
    for k, v in jout.metrics.items():
        assert float(out.metrics[k]) == float(v), k
    if train:  # the two towers update the running statistics in turn
        want = params_from_jax({}, jax.device_get(jstats["batch_stats"]), m)["batch_stats"]
        for k, v in want.items():
            np.testing.assert_allclose(dict(m.named_buffers())[k].numpy(), v.numpy(), **TOL)
    names = [k for k, _ in m.named_parameters()]
    grads = torch.autograd.grad(out.cost_opt, [p for _, p in m.named_parameters()])
    want = params_from_jax(jax.device_get(jgrad), {}, m)["params"]
    assert set(want) == set(names)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)


def test_pair_batches_equal_jax():
    from kgcn_tpu.data import load_jbl as j_load
    from kgcn_tpu.models.pair import PairBatcher as JPairs
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.pair import PairBatcher

    cfg = {"normalize_adj_flag": True}
    jds, jinfo = j_load(PAIR_JBL, cfg)
    ds, info = load_jbl(PAIR_JBL, cfg)
    pairs = np.asarray(ds.graph_index_list)
    np.testing.assert_array_equal(pairs, np.asarray(jds.graph_index_list))
    jp, tp = JPairs(jds, jinfo, pairs, 7, seed=3), PairBatcher(ds, info, pairs, 7, seed=3)
    assert tp.batch_valid_counts() == jp.batch_valid_counts()
    for _ in range(2):  # two shuffled epochs
        jbs, tbs = list(jp.batches()), list(tp.batches())
        assert len(jbs) == len(tbs) == 9
        for jb, b in zip(jbs, tbs):
            np.testing.assert_array_equal(b.pad_mask.numpy(), np.asarray(jb.pad_mask))
            for side in ("a", "b"):
                jg, g = getattr(jb, side).graph, getattr(b, side).graph
                for f in ("nodes", "senders", "receivers", "edge_weights", "n_edge",
                          "node_mask"):
                    np.testing.assert_array_equal(getattr(g, f).numpy(),
                                                  np.asarray(getattr(jg, f)), err_msg=f)


def test_resident_pairs_equal_streaming():
    """The resident pair batcher's gathered batches give the streaming
    ones' scores; two scanned epochs give the streaming loop's costs (one
    seed, one order)."""
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.pair import GCNPairRanker, PairBatcher, ResidentPairBatcher
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg = {"normalize_adj_flag": True, "learning_rate": 0.01, "task": "classification"}
    ds, info = load_jbl(PAIR_JBL, cfg)
    pairs = np.asarray(ds.graph_index_list)
    m = GCNPairRanker(in_features=info.feature_dim, label_dim=2, dropout_rate=0.0)
    rp, sp = ResidentPairBatcher(ds, info, pairs, 8), PairBatcher(ds, info, pairs, 8)
    with torch.no_grad():
        for rb, sb in zip(rp.batches(shuffle=False), sp.batches(shuffle=False)):
            a, b = m(rb), m(sb)
            np.testing.assert_allclose(a.prediction.numpy(), b.prediction.numpy(), **TOL)
            np.testing.assert_allclose(float(a.cost_sum), float(b.cost_sum), **TOL)
    costs = []
    for batcher in (ResidentPairBatcher(ds, info, pairs, 8, seed=2),
                    PairBatcher(ds, info, pairs, 8, seed=2)):
        tr = Trainer(GCNPairRanker(in_features=info.feature_dim, label_dim=2,
                                   dropout_rate=0.0), cfg, info, device="cpu")
        state = tr.init_state(0)
        run = []
        for _ in range(2):
            state, cost, metrics, n = tr.run_epoch(state, batcher)
            assert n == len(pairs) and len(metrics) == 8
            run.append(cost)
        costs.append(run)
    np.testing.assert_allclose(costs[0], costs[1], rtol=1e-5)


def _config(tmp, side, **over):
    d = tmp / side
    d.mkdir(exist_ok=True)
    with open(os.path.join(REPO, "example_config", "pair.json")) as f:
        cfg = json.load(f)
    cfg.update(dataset=PAIR_JBL, epoch=2, dropout_rate=0.0,
               save_model_path=str(d / "model"), save_result_test=str(d / "scores.csv"))
    cfg.update(over)
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """kgcn_tpu's ``train`` and ``infer`` of pair.json (2 epochs, dropout
    0): (its output, the initial parameters it drew, the directory)."""
    from kgcn_tpu.cli.pair import cmd_infer as j_infer
    from kgcn_tpu.cli.pair import main as j_main
    from kgcn_tpu.runtime.config import load_config as j_config
    from kgcn_tpu.runtime.train import Trainer as JTrainer

    tmp = tmp_path_factory.mktemp("pair")
    initial = {}
    j_init = JTrainer.init_state

    def record(self, sample, seed=0):
        state = j_init(self, sample, seed=seed)
        initial.setdefault("tree", (jax.device_get(state.params),
                                    jax.device_get(state.batch_stats)))
        return state

    JTrainer.init_state = record
    buf = io.StringIO()
    try:
        with jax_backend("dense"), contextlib.redirect_stdout(buf):
            j_main(["train", "--config", _config(tmp, "jax"), "--cpu"])
            jev = j_infer(j_config(_config(tmp, "jax")))
    finally:
        JTrainer.init_state = j_init
    return buf.getvalue(), initial["tree"], tmp, np.asarray(jev["prediction"])


def _rows(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], np.array([[float(v) for v in line.split(",")] for line in lines[1:]])


def test_cli_train_and_infer_match_jax(jax_run, monkeypatch, capsys):
    from kgcn_tpu_torch.cli.pair import main as t_main
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    jout, (params, stats), tmp, jpred = jax_run
    monkeypatch.setattr(TTrainer, "init_state", lambda self, seed=0: self.state_from_tree(
        params_from_jax(params, stats, self.model), seed=seed))
    t_main(["train", "--config", _config(tmp, "port"), "--cpu"])
    tout = capsys.readouterr().out
    pattern = r"epoch \d+, training cost ([-\d.e+]+) \(pair acc=([\d.]+)\)"
    want = np.array(re.findall(pattern, jout), float)
    got = np.array(re.findall(pattern, tout), float)
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert os.listdir(tmp / "port" / "model") == ["model.last.ckpt"]
    ev = t_main(["infer", "--config", _config(tmp, "port"), "--cpu"])
    (th, trows), (jh, jrows) = _rows(tmp / "port" / "scores.csv"), _rows(tmp / "jax" / "scores.csv")
    assert th == jh == "score0,score1"
    assert trows.shape == jrows.shape == (60, 2)
    np.testing.assert_allclose(trows, ev["prediction"][:, :, 0], rtol=1e-5)  # 6 digits
    # RankNet reads only s1 - s0, so the head's bias has a gradient of 0:
    # rounding noise, which Adam turns into steps of the learning rate's
    # size in either package (ROADMAP C.9's mechanism) and which shifts
    # every score alike; the same noise on the other parameters moves the
    # gaps by a few 1e-5 over the 12 steps.  The gaps are held to the
    # costs' 1e-4, the scores to a shift shared by all rows.
    got, want = ev["prediction"][:, :, 0], jpred[:, :, 0]
    np.testing.assert_allclose(got[:, 1] - got[:, 0], want[:, 1] - want[:, 0],
                               rtol=1e-4, atol=1e-5)
    shift = got - want
    assert np.ptp(shift) <= 1e-4 and np.abs(shift).max() <= 0.01 * 12  # lr, 12 steps


def test_infer_reads_the_jax_checkpoint(jax_run, tmp_path):
    from kgcn_tpu_torch.cli.pair import main as t_main

    _, _, tmp, _ = jax_run
    t_main(["infer", "--config", _config(
        tmp_path, "port", load_model=str(tmp / "jax" / "model" / "model.last.ckpt")), "--cpu"])
    (th, trows), (jh, jrows) = _rows(tmp_path / "port" / "scores.csv"), _rows(
        tmp / "jax" / "scores.csv")
    assert th == jh
    np.testing.assert_allclose(trows, jrows, rtol=1e-5, atol=1e-6)
