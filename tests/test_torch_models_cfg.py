"""The models of the shipped configs that the port gained last
(kgcn_tpu_torch/models/multimodal.py ``GCNRegression``,
models/standard.py ``GCNNodeLabel`` and the node-embedding mode of ``gcn``,
``gcn_rxn_3layer``, ``gcn_multitask`` and ``gcn_node_label``, their
registry entries and ``convert.params_from_jax``), against the JAX package,
on the CPU.

Data: ``examples/solubility/solubility_reg.jbl`` (``gcn_regression``, 64
molecules spread over it), ``example_jbl/node_label.jbl``
(``gcn_node_label``) and a featureless ring dataset made from a seed with
NumPy (node ids into a vocabulary of 40, graph and node labels; the
node-embedding mode); both packages read the same dicts.  Tolerances (as
tests/test_torch_gin.py): the forward rtol = atol = 1e-5; three training
steps rtol 2e-4, atol 2e-5 with SGD at the config's learning rate (Adam
is held to optax in tests/test_torch_train.py; the regression head's
squared error moves its BN scale by ~10 in three steps at 0.1, where
summation order differs by 1e-3).  Each model also runs two epochs
through the resident runner (``capture=False``: on the CPU the runners run
eagerly) against the port's own streaming loop (1e-5).
"""
import os

import jax
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from test_torch_tiled import jax_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
VOCAB = 40


def featureless_rings(n_graphs=40, num_nodes=8, seed=0):
    """Ring graphs (``make_ring_dataset``) without features: each node an id
    of a vocabulary of ``VOCAB`` drawn from ``seed``, the graph's class and
    a node label (on the ring or a spare node) for every task."""
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    data = make_ring_dataset(num_pairs=n_graphs // 2, num_nodes=num_nodes, seed=seed)
    rng = np.random.RandomState(seed)
    G = len(data["label"])
    del data["feature"]
    ring = np.where(data["label"][:, :1] > 0, 6, 5)  # ring_a 6, ring_b 5 nodes
    on_ring = (np.arange(num_nodes)[None, :] < ring).astype(np.int64)
    node_label = np.stack([on_ring, 1 - on_ring], axis=-1).astype(np.float64)
    data.update(node=rng.randint(0, VOCAB, (G, num_nodes)), node_num=VOCAB,
                node_label=node_label, mask_node_label=np.ones_like(node_label))
    return data


def _load(path):
    from kgcn_tpu_torch.data import jbl

    return jbl.load(os.path.join(REPO, path))


CASES = {
    # name: (model, config, data, examples)
    "gcn_regression": ("gcn_regression", "solubility_reg.json",
                       lambda: _load("examples/solubility/solubility_reg.jbl"), 64),
    "gcn_node_label": ("gcn_node_label", "node_label.json",
                       lambda: _load("example_jbl/node_label.jbl"), 8),
    "gcn_embedding": ("gcn", "synth.json", featureless_rings, 40),
    "gcn_rxn_3layer_embedding": ("gcn_rxn_3layer", "synth.json", featureless_rings, 40),
    "gcn_multitask_embedding": ("gcn_multitask", "multitask.json", featureless_rings, 40),
    "gcn_node_label_embedding": ("gcn_node_label", "node_label.json",
                                 featureless_rings, 8),
}


def _config(case):
    from kgcn_tpu.runtime.config import load_config as j_config

    model, config, _, _ = CASES[case]
    over = {"model.py": model, "spmm_backend": "dense", "dropout_rate": 0.0,
            "optimizer": "sgd", "embedding_dim": 8}
    if case.endswith("_embedding"):
        over["with_node_embedding"] = True
    return j_config(os.path.join(REPO, "example_config", config), over)


def _pair(case):
    """JAX and port (config, info, batches) of a case's examples (spread
    over the dataset: the shipped ones are sorted by class), batched
    alike."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
    from kgcn_tpu_torch.data.dataset import build_dataset as t_build
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = _config(case)
    data = CASES[case][2]()
    jds, jinfo = j_build(dict(data), cfg)
    tds, tinfo = t_build(dict(data), cfg)
    idx = np.linspace(0, jds.num - 1, CASES[case][3]).astype(np.int64)
    bs = int(cfg["batch_size"])
    with jax_backend("dense"):
        jbatches = list(JBatcher(jds.subset(idx), jinfo, bs, seed=0).batches(shuffle=False))
    tb = TBatcher(tds.subset(idx), tinfo, bs, seed=0, backend=Backend("dense"))
    return cfg, jinfo, jbatches, tinfo, list(tb.batches(shuffle=False)), tds.subset(idx)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_train_steps_match_jax(case):
    """The forward (eval mode) at 1e-5, then three ``train_step``s from the
    same weights at 2e-4: parameters, BN statistics and costs."""
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.models.registry import build_model as t_build
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    model = CASES[case][0]
    cfg, jinfo, jbatches, tinfo, tbatches, _ = _pair(case)
    embedded = case.endswith("_embedding")
    assert (tbatches[0].graph.nodes is None) == embedded
    assert (tbatches[0].graph.node_ids is not None) == embedded
    order = [0, 1, 0]
    with jax_backend("dense"):
        jtr = JTrainer(j_build(model, jinfo, cfg), cfg, jinfo)
        jstate = jtr.init_state(jbatches[0], seed=0)
        tree = params_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
        jpred, jcost0, jmetrics = jtr.eval_step(jstate.params, jstate.batch_stats,
                                                jbatches[0])
        jcosts = []
        for i in order:
            jstate, cost, _ = jtr.train_step(jstate, jbatches[i])
            jcosts.append(float(cost))
        want = params_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    port = t_build(model, tinfo, cfg)
    assert set(tree["params"]) == {k for k, _ in port.named_parameters()}
    if embedded:
        assert tree["params"]["NodeEmbedding_0.Embed_0.embedding"].shape == (VOCAB, 8)
    ttr = TTrainer(port, cfg, tinfo, device="cpu")
    tstate = ttr.state_from_tree(tree)
    tpred, tcost0, tmetrics = ttr.eval_step(tstate.params, tstate.batch_stats, tbatches[0])
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), **TOL)
    np.testing.assert_allclose(float(tcost0), float(jcost0), **TOL)
    assert set(tmetrics) == set(jmetrics)
    for k, v in jmetrics.items():
        np.testing.assert_allclose(tmetrics[k].numpy(), np.asarray(v), err_msg=k, **TOL)
    tcosts = []
    for i in order:
        tstate, cost, _ = ttr.train_step(tstate, tbatches[i])
        tcosts.append(float(cost))
    np.testing.assert_allclose(tcosts, jcosts, **STEP_TOL)
    for group, got in (("params", tstate.params), ("batch_stats", tstate.batch_stats)):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[group][k].numpy(),
                                       err_msg=f"{group} {k}", **STEP_TOL)
    if embedded:  # the table's rows of the batches' ids moved
        moved = (tstate.params["NodeEmbedding_0.Embed_0.embedding"]
                 != torch.from_numpy(np.asarray(tree["params"][
                     "NodeEmbedding_0.Embed_0.embedding"])))
        assert bool(moved.any())


@pytest.mark.parametrize("case", sorted(CASES))
def test_resident_runner_matches_the_streaming_loop(case):
    """The resident gate admits the case's dataset as the JAX gate does;
    two shuffled epochs through the resident runner (``capture=False``)
    and the streaming loop from one seed: per-epoch costs and parameters
    within 1e-5, then an evaluation of both."""
    from kgcn_tpu.runtime.resident import resident_enabled as j_enabled
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import resident
    from kgcn_tpu_torch.runtime.backend import Backend
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg, jinfo, _, tinfo, _, tds = _pair(case)
    from kgcn_tpu.data import build_dataset as j_build

    jds, _ = j_build(dict(CASES[case][2]()), cfg)
    with jax_backend("dense"):
        assert j_enabled(cfg, jds, jinfo)
    assert resident.resident_enabled(cfg, tds, tinfo, "dense")
    bs = int(cfg["batch_size"])
    tr = Trainer(build_model(CASES[case][0], tinfo, cfg), cfg, tinfo, device="cpu",
                 capture=False)
    sb = Batcher(tds, tinfo, bs, seed=3, backend=Backend("dense"))
    rb = resident.ResidentBatcher(tds, tinfo, bs, seed=3, backend=Backend("dense"))
    s1, s2 = tr.init_state(0), tr.init_state(0)
    for ep in range(2):
        s1, c1, _, _ = tr.run_epoch(s1, sb, epoch=ep)
        s2, c2, _, _ = tr.run_epoch(s2, rb, epoch=ep)
        assert np.isfinite(c1) and abs(c1 - c2) < 1e-5
    for k in s1.params:
        np.testing.assert_allclose(s2.params[k].numpy(), s1.params[k].numpy(),
                                   atol=1e-5, err_msg=k)
    e1, e2 = tr.evaluate(s1, sb), tr.evaluate(s1, rb)
    assert abs(e1["cost"] - e2["cost"]) < 1e-5
    np.testing.assert_allclose(e2["prediction"], e1["prediction"], atol=1e-5)


def test_gin_and_regression_have_no_embedding_mode():
    """``gin`` (and ``gcn_regression``) read node features only, as in
    kgcn_tpu: a featureless dataset is refused when the model is built."""
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model

    _, info = build_dataset(featureless_rings(), {"with_node_embedding": True})
    assert not info.feature_enabled and info.all_node_num == VOCAB
    for name in ("gin", "gcn_regression"):
        with pytest.raises(ValueError, match="node features"):
            build_model(name, info, {})
