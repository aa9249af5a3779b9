"""The port's knowledge-graph link prediction (kgcn_tpu_torch/models/kg.py,
cli/kg.py, the KG paths of cli/main.py, data/dataset.py and data/batcher.py,
the GIN / DistMult / embedding layers, convert.py) against the JAX package,
on the CPU.

Datasets are ``make_kg_dataset`` and a 300-entity, 3-relation KG made from
a seed; both packages read the same dict.  The JAX stream kernels run in
Pallas interpret mode.  Tolerances: datasets, batches and negatives equal;
three training steps rtol 2e-4, atol 2e-5 (the precedent of
tests/test_torch_train.py, three Adam steps; SGD with the bf16 payload, see
test_train_steps_match_jax); layers float32 1e-5, bf16 1e-4 × max; the
ranking metrics equal.  Every JAX process global a test sets (dense path,
spmm backend, compute dtypes) is restored after it.
"""
import contextlib
import importlib
import json
import os
import pickle

import jax
import jax.numpy as jnp
import joblib
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from test_torch_data import _assert_same
from test_torch_stream import assert_same_structure

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
TOL = dict(rtol=1e-5, atol=1e-5)


@contextlib.contextmanager
def jax_globals():
    """Restore the JAX package's backend globals to their defaults after
    the block (its CLI and ``apply_backend`` set them)."""
    from kgcn_tpu.graph.batch import set_dense_path
    from kgcn_tpu.ops import stream_spmm as js
    from kgcn_tpu.ops import tiled_spmm as jt

    spmm_mod = importlib.import_module("kgcn_tpu.ops.spmm")
    try:
        yield
    finally:
        spmm_mod.set_backend("xla")
        js.set_compute_dtype(jnp.bfloat16)
        jt.set_compute_dtype(jnp.bfloat16)
        set_dense_path(True)


def _triples(n=300, R=3, T=1500, seed=0):
    """Distinct (head, relation, tail) names: power-law heads, uniform
    tails and relations."""
    rng = np.random.RandomState(seed)
    heads = np.minimum((rng.pareto(1.5, T) * 20).astype(int), n - 1)
    tails = rng.randint(0, n, T)
    rels = rng.randint(0, R, T)
    out, seen = [], set()
    for h, r, t in zip(heads, rels, tails):
        if (h, r, t) not in seen:
            seen.add((h, r, t))
            out.append((f"e{h}", f"r{r}", f"e{t}"))
    return out


def _kg300():
    from kgcn_tpu_torch.cli.kg import build_kg

    return build_kg(_triples(), test_rate=0.1, seed=0)


def _data(source):
    if source == "make_kg_dataset":
        from kgcn_tpu.data.synthetic import make_kg_dataset

        return make_kg_dataset(num_entities=50, num_relations=2, seed=0)
    if source == "example_jbl/kg.jbl":
        return joblib.load(os.path.join(REPO, source))
    return _kg300()


def _config(**over):
    with open(os.path.join(REPO, "example_config", "kg.json")) as f:
        cfg = json.load(f)
    from kgcn_tpu_torch.runtime.config import default_config

    full = default_config()
    full.update(cfg)
    full.update(over)
    return full


def _jax_side(data, cfg):
    """JAX dataset, info and resolved backend (globals applied)."""
    from kgcn_tpu.data import build_dataset
    from kgcn_tpu.runtime.backend import apply_backend, choose_backend

    ds, info = build_dataset(data, dict(cfg))
    name = choose_backend(cfg, info)
    apply_backend(name, cfg, log=False)
    return ds, info, name


def _port_side(data, cfg):
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.runtime.backend import resolve

    ds, info = build_dataset(data, dict(cfg))
    return ds, info, resolve(dict(cfg), info, log=False)


# ---- dataset, batches, negatives --------------------------------------------


@pytest.mark.parametrize("source,backend", [("make_kg_dataset", "dense"),
                                            ("random 300 entities", "stream")])
def test_kg_dataset_and_batches_match_jax(source, backend):
    from kgcn_tpu.models.kg import KGBatcher as JKG
    from kgcn_tpu_torch.models.kg import KGBatcher as TKG

    cfg = _config(label_batch_size=64)
    with jax_globals():
        jds, jinfo, jname = _jax_side(_data(source), cfg)
        jkb = JKG(jds, jinfo, label_batch_size=64, seed=5)
        jepochs = [list(jkb.batches()) for _ in range(2)]
    tds, tinfo, be = _port_side(_data(source), cfg)
    tkb = TKG(tds, tinfo, label_batch_size=64, seed=5, backend=be)
    assert jname == be.name == backend
    assert tinfo.all_node_num == jinfo.all_node_num
    assert tinfo.graph_node_num == jinfo.graph_node_num
    assert tinfo.adj_channel_num == jinfo.adj_channel_num
    assert not tinfo.feature_enabled and tinfo.feature_dim == 0
    np.testing.assert_array_equal(tds.nodes, jds.nodes)
    np.testing.assert_array_equal(np.asarray(tds.label_list[0]), np.asarray(jds.label_list[0]))

    jg, tg = jkb.graph_batch.graph, tkb.graph_batch.graph
    for name in ("node_ids", "senders", "receivers", "edge_weights", "n_edge", "node_mask"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    assert (tg.stream_adj is None) == (jg.stream_adj is None) == (backend != "stream")
    if backend == "stream":
        assert len(tg.stream_adj) == tinfo.adj_channel_num
        for je, te in zip(jg.stream_adj, tg.stream_adj):
            assert_same_structure(je, te)
            assert te.oh is not None  # bf16 default payload: the static route

    assert tkb.valid_per_epoch == jkb.valid_per_epoch
    for epoch, jbatches in enumerate(jepochs):
        tbatches = list(tkb.batches(epoch=epoch))
        assert len(tbatches) == len(jbatches) == tkb.valid_per_epoch
        for jb, tb in zip(jbatches, tbatches):
            np.testing.assert_array_equal(tb.label_list.numpy(), np.asarray(jb.label_list))
            np.testing.assert_array_equal(tb.label_valid.numpy(), np.asarray(jb.label_valid))
    np.testing.assert_array_equal(tkb.init_batch().label_list.numpy(),
                                  np.asarray(jkb.init_batch().label_list))


def test_sample_negatives_matches_jax():
    from kgcn_tpu.models.kg import sample_negatives as j_neg
    from kgcn_tpu_torch.models.kg import sample_negatives as t_neg

    ll = np.random.RandomState(0).randint(0, 40, (33, 6)).astype(np.int32)
    nodes = np.arange(40, dtype=np.int32)
    for mode in ("both", "left", "right"):
        np.testing.assert_array_equal(
            t_neg(ll, nodes, np.random.RandomState(1), mode),
            j_neg(ll, nodes, np.random.RandomState(1), mode))


def test_test_mode_reads_the_test_triples():
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu_torch.data.dataset import build_dataset as t_build

    data = _kg300()
    cfg = _config()
    tds, _ = t_build(data, cfg, test_mode=True)
    jds, _ = j_build(data, cfg, test_mode=True)
    np.testing.assert_array_equal(np.asarray(tds.label_list[0]), np.asarray(jds.label_list[0]))
    assert len(tds.label_list[0]) == int(len(_triples()) * 0.1)


# ---- layers -------------------------------------------------------------------


def _stream_pair(dtype="float32"):
    """The 300-entity KG's graph batch on the stream backend, both sides."""
    from kgcn_tpu.models.kg import KGBatcher as JKG
    from kgcn_tpu_torch.models.kg import KGBatcher as TKG

    cfg = _config(tiled_compute_dtype=dtype)
    jds, jinfo, _ = _jax_side(_kg300(), cfg)
    jkb = JKG(jds, jinfo, label_batch_size=64, seed=0)
    tds, tinfo, be = _port_side(_kg300(), cfg)
    tkb = TKG(tds, tinfo, label_batch_size=64, seed=0, backend=be)
    return jkb, tkb, jinfo, tinfo


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gin_and_graph_conv_on_stream_match_flax(dtype):
    from kgcn_tpu import nn as jnn
    from kgcn_tpu_torch.nn import layers as tnn

    with jax_globals():
        jkb, tkb, jinfo, _ = _stream_pair(dtype)
        jg, tg = jkb.graph_batch.graph, tkb.graph_batch.graph
        V, C, F = tg.total_nodes, jinfo.adj_channel_num, 8
        x = np.random.RandomState(0).standard_normal((V, F)).astype(np.float32)
        eps = np.asarray([0.3, -0.1, 0.25], np.float32)[:C]
        want = jnn.GINAggregate(C).apply({"params": {"epsilon": jnp.asarray(eps)}},
                                         jnp.asarray(x), jg)
        gc = jnn.GraphConv(6, C)
        gparams = gc.init(jax.random.PRNGKey(1), jnp.asarray(x), jg)["params"]
        gparams = dict(gparams, bias=jnp.asarray(
            np.random.RandomState(2).standard_normal((C, 6)).astype(np.float32)))
        want_gc = gc.apply({"params": gparams}, jnp.asarray(x), jg)
    gin = tnn.GINAggregate(C)
    gin.load_state_dict({"epsilon": torch.from_numpy(eps)})
    got = gin(torch.from_numpy(x), tg)
    tgc = tnn.GraphConv(F, 6, C)
    tgc.load_state_dict(params_from_jax(jax.device_get(gparams), {})["params"])
    got_gc = tgc(torch.from_numpy(x), tg)
    for a, b in ((got, want), (got_gc, want_gc)):
        b = np.asarray(b)
        if dtype == "float32":
            np.testing.assert_allclose(a.detach().numpy(), b, **TOL)
        else:
            np.testing.assert_allclose(a.detach().numpy(), b, rtol=0,
                                       atol=1e-4 * float(np.abs(b).max()))


def test_gin_dense_and_xla_paths_match_flax():
    """GINAggregate's dense-adjacency and edge-list (xla) branches, ε quirk
    included: ``(Σ_c ε_c)·X + Σ_c A_c X``."""
    from kgcn_tpu import nn as jnn
    from kgcn_tpu_torch.nn import layers as tnn
    from test_torch_layers import _batches, _jgraph, _tgraph

    jb, tb = _batches(C=2)
    eps = np.asarray([0.4, -0.15], np.float32)
    x = np.random.RandomState(3).standard_normal((tb.graph.total_nodes, 5)).astype(np.float32)
    gin = tnn.GINAggregate(2)
    gin.load_state_dict({"epsilon": torch.from_numpy(eps)})
    for jg, tg in ((_jgraph(jb), _tgraph(tb)), (jb.graph, tb.graph)):
        want = jnn.GINAggregate(2).apply({"params": {"epsilon": jnp.asarray(eps)}},
                                         jnp.asarray(x), jg)
        np.testing.assert_allclose(gin(torch.from_numpy(x), tg).detach().numpy(),
                                   np.asarray(want), **TOL)


def test_distmult_and_node_embedding_match_flax():
    from kgcn_tpu import nn as jnn
    from kgcn_tpu_torch.nn import layers as tnn
    from test_torch_layers import _batches

    rng = np.random.RandomState(4)
    C, D, V = 3, 7, 20
    kernel = rng.standard_normal((C, D)).astype(np.float32)
    z = rng.standard_normal((V, D)).astype(np.float32)
    h, t, rel = rng.randint(0, V, 9), rng.randint(0, V, 9), rng.randint(0, C, 9)
    jdm = jnn.DistMult(dim=D, channels=C)
    variables = {"params": {"kernel": jnp.asarray(kernel)}}
    tdm = tnn.DistMult(D, C)
    tdm.load_state_dict(params_from_jax({"kernel": kernel}, {})["params"])
    zt = torch.from_numpy(z)
    pairs = (
        (tdm.score(zt[h], zt[t], torch.from_numpy(rel)),
         jdm.apply(variables, z[h], z[t], jnp.asarray(rel), method=jdm.score)),
        (tdm.left_prediction(zt, zt[t], torch.from_numpy(rel)),
         jdm.apply(variables, z, z[t], jnp.asarray(rel), method=jdm.left_prediction)),
        (tdm.right_prediction(zt[h], zt, torch.from_numpy(rel)),
         jdm.apply(variables, z[h], z, jnp.asarray(rel), method=jdm.right_prediction)),
    )
    for got, want in pairs:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)

    jb, tb = _batches(C=1)
    ids = rng.randint(0, 11, tb.graph.total_nodes).astype(np.int32)
    jg = jb.graph.replace(node_ids=jnp.asarray(ids))
    tg = tb.graph.replace(node_ids=torch.from_numpy(ids))
    table = rng.standard_normal((11, 4)).astype(np.float32)
    want = jnn.NodeEmbedding(11, 4).apply(
        {"params": {"Embed_0": {"embedding": jnp.asarray(table)}}}, jg)
    emb = tnn.NodeEmbedding(11, 4)
    emb.load_state_dict(params_from_jax({"Embed_0": {"embedding": table}}, {})["params"])
    np.testing.assert_allclose(emb(tg).detach().numpy(), np.asarray(want), **TOL)
    want_full = jdm.apply(variables, jnp.asarray(rng.standard_normal(
        (tb.graph.total_nodes, D)).astype(np.float32)), jb.graph)
    assert tuple(want_full.shape) == (tb.graph.n_graph, C, tb.graph.max_nodes,
                                      tb.graph.max_nodes)


def test_embedding_init_follows_flax():
    """N(0, 1/features) per entry, from the generator."""
    from kgcn_tpu_torch.nn import layers as tnn

    emb = tnn.Embed(4000, 16)
    emb.reset_parameters(torch.Generator().manual_seed(0))
    assert abs(float(emb.embedding.detach().std()) - 0.25) < 0.01
    again = tnn.Embed(4000, 16)
    again.reset_parameters(torch.Generator().manual_seed(0))
    torch.testing.assert_close(again.embedding, emb.embedding)


# ---- conversion ------------------------------------------------------------------


def test_params_from_jax_keeps_the_distmult_table():
    """``distmult.kernel`` [C, dim] is no Dense kernel: it keeps its name
    and layout, and the whole KG tree loads strictly into the port model."""
    from kgcn_tpu.models.kg import KGLinkPredictor as JKGP
    from kgcn_tpu_torch.models.kg import KGLinkPredictor as TKGP

    with jax_globals():
        jkb, tkb, jinfo, tinfo = _stream_pair()
        jm = JKGP(all_node_num=jinfo.all_node_num, embedding_dim=5,
                  channels=jinfo.adj_channel_num, encoder="gin")
        params = jm.init(jax.random.PRNGKey(0), jkb.init_batch())["params"]
    tree = params_from_jax(jax.device_get(params), {})["params"]
    assert tree["distmult.kernel"].shape == (jinfo.adj_channel_num, 5)
    np.testing.assert_array_equal(tree["distmult.kernel"].numpy(),
                                  np.asarray(params["distmult"]["kernel"]))
    model = TKGP(all_node_num=tinfo.all_node_num, embedding_dim=5,
                 channels=tinfo.adj_channel_num, encoder="gin")
    model.load_state_dict(tree, strict=True)
    assert sorted(tree) == ["conv1.epsilon", "conv2.epsilon", "distmult.kernel",
                            "embed.embedding"]


# ---- training steps -----------------------------------------------------------------


@pytest.mark.parametrize("encoder,dtype,source", [
    ("gcn", "float32", "random 300 entities"),
    ("gcn", "bfloat16", "random 300 entities"),
    ("gin", "float32", "random 300 entities"),
    ("gin", "bfloat16", "random 300 entities"),
    ("embedding", "float32", "example_jbl/kg.jbl"),
])
def test_train_steps_match_jax(encoder, dtype, source):
    """Three ``train_step``s of ``KGLinkPredictor`` from the same weights
    and the same label slices and negatives (seed 0): costs and parameters
    equal the JAX ``Trainer``'s.  The bf16 payload trains with SGD: its
    gradients agree to ~1e-5 relative (a rounding of f32 sums that differ
    in the last bit can flip), and Adam's normalisation turns such a
    difference on a near-zero gradient component into one of order the
    learning rate."""
    from kgcn_tpu.models.kg import KGBatcher as JKG
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.models.kg import KGBatcher as TKG
    from kgcn_tpu_torch.models.registry import build_model as t_build
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    cfg = _config(kg_encoder=encoder, tiled_compute_dtype=dtype, embedding_dim=16,
                  **({"optimizer": "sgd"} if dtype == "bfloat16" else {}))
    with jax_globals():
        jds, jinfo, jname = _jax_side(_data(source), cfg)
        jkb = JKG(jds, jinfo, label_batch_size=64, seed=0)
        jtr = JTrainer(j_build("kg_distmult", jinfo, cfg), cfg, jinfo)
        jstate = jtr.init_state(jkb.init_batch(), seed=0)
        tree = params_from_jax(jax.device_get(jstate.params), {})
        jcosts = []
        for batch in list(jkb.batches())[:3]:
            jstate, cost, _ = jtr.train_step(jstate, batch)
            jcosts.append(float(cost))
        want = params_from_jax(jax.device_get(jstate.params), {})["params"]
    tds, tinfo, be = _port_side(_data(source), cfg)
    assert be.name == jname == ("dense" if encoder == "embedding" else "stream")
    tkb = TKG(tds, tinfo, label_batch_size=64, seed=0, backend=be)
    ttr = TTrainer(t_build("kg_distmult", tinfo, cfg), cfg, tinfo, device="cpu")
    tstate = ttr.state_from_tree(tree)
    tcosts = []
    for batch in list(tkb.batches())[:3]:
        tstate, cost, _ = ttr.train_step(tstate, batch)
        tcosts.append(float(cost))
    np.testing.assert_allclose(tcosts, jcosts, **STEP_TOL)
    assert set(tstate.params) == set(want)
    for k, v in tstate.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **STEP_TOL)


# ---- the CLIs --------------------------------------------------------------------------


def _write_tsv(path):
    with open(path, "w") as f:
        for h, r, t in _triples():
            f.write(f"{h}\t{r}\t{t}\n")


def test_cli_kg_writes_what_the_jax_cli_writes(tmp_path):
    from kgcn_tpu.cli.kg import main as j_kg
    from kgcn_tpu_torch.cli.kg import main as t_kg
    from kgcn_tpu_torch.data import jbl

    tsv = tmp_path / "triples.tsv"
    _write_tsv(tsv)
    args = ["--input", str(tsv), "--test-rate", "0.2", "--seed", "3"]
    j_kg(args + ["--output", str(tmp_path / "jax.jbl")])
    t_kg(args + ["--output", str(tmp_path / "port.jbl")])
    with open(tmp_path / "port.jbl", "rb") as f:
        assert f.read(2) == pickle.dumps(0, protocol=4)[:2]  # a protocol-4 pickle
    want = joblib.load(tmp_path / "jax.jbl")
    _assert_same(joblib.load(tmp_path / "port.jbl"), want)
    _assert_same(jbl.load(str(tmp_path / "port.jbl")), want)


def _kg_config(tmp, dataset, **over):
    cfg = _config(dataset=str(dataset), save_model_path=str(tmp / "model"),
                  save_info_train=str(tmp / "info_train.json"),
                  save_info_test=str(tmp / "info_test.json"),
                  save_edge_result=str(tmp / "edges.csv"), **over)
    path = tmp / "config.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def test_infer_metrics_match_jax(tmp_path):
    """``infer`` on the same weights: the JAX CLI reads its checkpoint, the
    port's its conversion; metrics and per-triple ranks equal."""
    from kgcn_tpu.cli.main import cmd_infer as j_infer
    from kgcn_tpu.models.kg import KGBatcher as JKG
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime import checkpoint as jckpt
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.runtime import checkpoint as tckpt

    with open(tmp_path / "kg.jbl", "wb") as f:
        pickle.dump(_kg300(), f, protocol=4)
    over = dict(kg_encoder="gcn", tiled_compute_dtype="float32", embedding_dim=16)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jcfg, _ = _kg_config(tmp_path / "jax", tmp_path / "kg.jbl", **over)
    _, tpath = _kg_config(tmp_path / "port", tmp_path / "kg.jbl", **over)
    with jax_globals():
        jds, jinfo, _ = _jax_side(_kg300(), jcfg)
        jtr = JTrainer(j_build("kg_distmult", jinfo, jcfg), jcfg, jinfo)
        jstate = jtr.init_state(JKG(jds, jinfo, seed=0).init_batch(), seed=0)
        jckpt.save_checkpoint(str(tmp_path / "jax" / "model" / "model.last.ckpt"),
                              jtr.state_tree(jstate, 0, 0.0))
        want = j_infer(dict(jcfg))
    tree = params_from_jax(jax.device_get(jstate.params), {})
    tckpt.save_tree(str(tmp_path / "port" / "model" / "model.last.ckpt"), tree)
    got = t_main(["infer", "--config", tpath, "--cpu"])
    assert got == pytest.approx(want, rel=1e-12)
    for side in ("jax", "port"):
        assert (tmp_path / side / "info_test.json").exists()
    jrows = np.loadtxt(tmp_path / "jax" / "edges.csv", delimiter=",", skiprows=1)
    trows = np.loadtxt(tmp_path / "port" / "edges.csv", delimiter=",", skiprows=1)
    np.testing.assert_array_equal(trows[:, [0, 1, 2, 4]], jrows[:, [0, 1, 2, 4]])
    np.testing.assert_allclose(trows[:, 3], jrows[:, 3], rtol=1e-4, atol=1e-5)


def test_kg_train_and_infer_cli_on_the_cpu(tmp_path, capsys):
    """``cli.kg`` → ``train --cpu`` → ``infer --cpu`` on the 300-entity KG:
    the stream backend, a falling cost, every output file."""
    from kgcn_tpu_torch.cli.kg import main as t_kg
    from kgcn_tpu_torch.cli.main import main as t_main

    tsv = tmp_path / "triples.tsv"
    _write_tsv(tsv)
    t_kg(["--input", str(tsv), "--output", str(tmp_path / "kg.jbl"), "--test-rate", "0.1"])
    cfg, path = _kg_config(tmp_path, tmp_path / "kg.jbl", kg_encoder="gcn", epoch=3,
                           embedding_dim=16)
    t_main(["train", "--config", path, "--cpu"])
    out = capsys.readouterr().out
    assert "[spmm] backend: stream" in out
    costs = [float(line.split("training cost ")[1].split()[0])
             for line in out.splitlines() if line.startswith("epoch ")]
    assert len(costs) == 3 and np.isfinite(costs).all() and costs[-1] < costs[0]
    assert os.listdir(tmp_path / "model") == ["model.last.ckpt"]
    with open(cfg["save_info_train"]) as f:
        assert set(json.load(f)) == {"train_time", "ranking_accuracy"}
    result = t_main(["infer", "--config", path, "--cpu"])
    out = capsys.readouterr().out
    assert "[spmm] backend: stream" in out and "[LOAD]" in out
    assert result["num_test_triples"] == int(len(_triples()) * 0.1)
    for key in ("mrr", "hits@1", "hits@10"):
        assert 0.0 <= result[key] <= 1.0
    assert 1.0 <= result["mean_rank"] <= 300
    with open(cfg["save_info_test"]) as f:
        assert json.load(f) == pytest.approx(result)
    rows = np.loadtxt(cfg["save_edge_result"], delimiter=",", skiprows=1)
    assert rows.shape == (result["num_test_triples"], 5)


def test_kg_cli_refuses_what_is_not_ported(tmp_path):
    from kgcn_tpu_torch.cli.main import main as t_main

    with open(tmp_path / "kg.jbl", "wb") as f:
        pickle.dump(_kg300(), f, protocol=4)
    _, path = _kg_config(tmp_path, tmp_path / "kg.jbl", mesh={"data": 2})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        t_main(["train", "--config", path, "--cpu"])
