"""The KG route of ``visualize`` (``explain/kg_ig.py``) against the JAX
package's, on the CPU: the embedding IG (the 300-entity KG, the gcn
encoder on the stream backend, 10 steps, rtol 1e-4: the same sums in
another order), the subgraph's nodes and edge order against networkx's,
and the CSVs that ``visualize`` writes from a checkpoint ``kgcn_tpu``
wrote (read through ``runtime/flax_msgpack.py``): the same file names and
rows, the scores within 1e-4."""
import json
import os
import pickle

import jax
import networkx as nx
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from test_torch_kg import _config, _jax_side, _kg300, _port_side, jax_globals

torch.set_num_threads(1)
IG_RTOL = 1e-4


def _models(encoder="gcn"):
    """JAX model, variables and init batch; the port's model, variables
    (the same weights) and init batch; the triples."""
    from kgcn_tpu.models.kg import KGBatcher as JKG
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu_torch.models.kg import KGBatcher as TKG
    from kgcn_tpu_torch.models.registry import build_model as t_build

    cfg = _config(kg_encoder=encoder, embedding_dim=16, tiled_compute_dtype="float32")
    data = _kg300()
    jds, jinfo, jname = _jax_side(data, cfg)
    jm = j_build("kg_distmult", jinfo, cfg)
    jb = JKG(jds, jinfo, label_batch_size=64, seed=0).init_batch()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(3), jb))
    tds, tinfo, be = _port_side(data, cfg)
    assert be.name == jname == "stream"  # 300 entities: beyond the dense 256
    m = t_build("kg_distmult", tinfo, cfg).eval()
    tree = params_from_jax(variables["params"], {}, m)
    tb = TKG(tds, tinfo, label_batch_size=64, seed=0, backend=be).init_batch()
    triples = np.asarray(tds.label_list[0], dtype=np.int32)[:, :3]
    return jm, variables, jb, m, tree["params"], tb, triples


@pytest.mark.parametrize("encoder", ["gcn", "embedding"])
def test_embedding_ig_matches_jax(encoder):
    from kgcn_tpu.explain.kg_ig import embedding_ig as j_ig
    from kgcn_tpu_torch.explain.kg_ig import embedding_ig as t_ig

    with jax_globals():
        jm, variables, jb, m, params, tb, triples = _models(encoder)
        want = j_ig(jm, variables, jb, triples[3:5], steps=10)
    got = t_ig(m, params, tb, triples[3:5], steps=10)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=IG_RTOL, atol=IG_RTOL * np.abs(want).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_subgraph_within_equals_networkx(seed):
    """Node set, node order and edge order of ``kgcn_tpu``'s networkx
    graph, on multi-channel graphs with repeated edges, both directions of
    an edge, self-loops and a target outside the graph."""
    from kgcn_tpu.explain.kg_ig import subgraph_within as j_sub
    from kgcn_tpu_torch.explain.kg_ig import subgraph_within as t_sub

    rng = np.random.RandomState(seed)
    adjs = []
    for _ in range(3):
        n = 60
        r = rng.randint(0, 40, n)
        c = rng.randint(0, 40, n)
        c[:3] = r[:3]  # self-loops
        adjs.append((r, c, np.ones(n, np.float32)))
    targets = [int(adjs[0][0][5]), int(adjs[1][1][7]), 99]
    for hops in (0, 1, 2, 3):
        jnodes, jg = j_sub(adjs, targets, hops)
        tnodes, tg = t_sub(adjs, targets, hops)
        assert tnodes == jnodes
        assert list(tg.edges()) == list(jg.edges())
        assert list(tg.adj) == list(jg.nodes())
    assert isinstance(jg, nx.Graph)


def test_visualize_kg_from_a_jax_checkpoint_matches_jax(tmp_path, capsys):
    """``visualize`` on a KG config: ``kgcn_tpu`` writes the checkpoint and
    runs its ``visualize``; the port reads that checkpoint and writes the
    same files, the same node and edge rows and names, and the scores
    within 1e-4."""
    from kgcn_tpu.cli.main import cmd_visualize as j_visualize
    from kgcn_tpu.models.kg import KGBatcher as JKG
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime import checkpoint as jckpt
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.cli.main import main as t_main

    data = _kg300()
    assert data.get("node_vocab")
    with open(tmp_path / "kg.jbl", "wb") as f:
        pickle.dump(data, f, protocol=4)
    ckpt = tmp_path / "jax_model" / "model.last.ckpt"
    cfgs = {}
    for side in ("jax", "port"):
        cfgs[side] = _config(dataset=str(tmp_path / "kg.jbl"), kg_encoder="gcn",
                             embedding_dim=16, tiled_compute_dtype="float32",
                             save_model_path=str(tmp_path / "jax_model"),
                             visualize_path=str(tmp_path / side / "viz"),
                             visualize_num=2, ig_divide_number=10, graph_distance=1)
    with jax_globals():
        jcfg = dict(cfgs["jax"])
        jds, jinfo, _ = _jax_side(data, jcfg)
        jtr = JTrainer(j_build("kg_distmult", jinfo, jcfg), jcfg, jinfo)
        jkb = JKG(jds, jinfo, label_batch_size=64, seed=0)
        jstate = jtr.init_state(jkb.init_batch(), seed=0)
        for batch in list(jkb.batches())[:2]:  # two steps: trained weights
            jstate, _, _ = jtr.train_step(jstate, batch)
        jckpt.save_checkpoint(str(ckpt), jtr.state_tree(jstate, 0, 0.0))
        j_visualize(dict(jcfg))
    capsys.readouterr()
    path = tmp_path / "port.json"
    path.write_text(json.dumps(cfgs["port"]))
    written = t_main(["visualize", "--config", str(path), "--cpu"])
    out = capsys.readouterr().out
    assert f"[LOAD] {ckpt}" in out and "edge target = 1 =>" in out
    jfiles = sorted(os.listdir(tmp_path / "jax" / "viz"))
    assert sorted(os.path.basename(p) for p in written) == jfiles
    assert sorted(os.listdir(tmp_path / "port" / "viz")) == jfiles and len(jfiles) == 4
    for name in jfiles:
        with open(tmp_path / "jax" / "viz" / name) as f:
            jrows = [line.rstrip("\n").split(",") for line in f]
        with open(tmp_path / "port" / "viz" / name) as f:
            trows = [line.rstrip("\n").split(",") for line in f]
        assert trows[0] == jrows[0] and len(trows) == len(jrows) > 1
        score_col = jrows[0].index("ig_score")
        keep = [i for i in range(len(jrows[0])) if i != score_col]
        assert [[r[i] for i in keep] for r in trows] == [[r[i] for i in keep] for r in jrows]
        js = np.array([float(r[score_col]) for r in jrows[1:]])
        ts = np.array([float(r[score_col]) for r in trows[1:]])
        np.testing.assert_allclose(ts, js, rtol=IG_RTOL, atol=IG_RTOL * np.abs(js).max())
