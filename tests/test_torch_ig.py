"""The port's integrated gradients (kgcn_tpu_torch/explain/ig.py:
``integrated_gradients`` over the stacked scaled copies,
``edge_ig_to_dense``, ``run_visualization``; cli/main.py ``visualize``)
against ``kgcn_tpu.explain.ig``, on the CPU.

Model: the GCN of example_config/synth.json on example_jbl/synthetic.jbl
(dropout 0), its weights those of the JAX package after one training step
(non-trivial BN statistics), carried over by ``params_from_jax``.  The IG
arrays (features and per-edge adjacency values, padding edges included)
and the completeness check of ``ig``, ``grad`` and ``grad_prod`` equal the
JAX package's to rtol 1e-4, atol 1e-7 (sums of 20 gradients in another
order), for the targets ``max``, ``label`` and ``index`` and for a batch of
one and of two molecules, on the dense backend and on the tiled one (its
kernels' plain versions); the stream backend's IG, whose adjacency gradient
the JAX package's stream layers do not give, is held to the dense one.
The smooth variants draw their noise from
another generator, so they are held at noise 0 to ``ig`` and ``grad`` and,
with noise, to completeness alone.  Completeness tightens from 20 to 200
steps, as tests/test_cli_and_ig.py:82 requires of the JAX package.
"""
import json
import os
import pickle

import jax
import joblib
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.explain import ig as tig
from test_torch_tiled import jax_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
IG_TOL = dict(rtol=1e-4, atol=1e-7)
STEPS = 20


@pytest.fixture(scope="module")
def pair():
    """(JAX model, variables, dataset, info; port model, variables,
    dataset, info, a batcher factory; the JAX training checkpoint tree)."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import load_jbl as j_load
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime.config import load_config as j_config
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
    from kgcn_tpu_torch.data.dataset import load_jbl as t_load
    from kgcn_tpu_torch.models.registry import build_model as t_build
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = j_config(os.path.join(REPO, "example_config/synth.json"), {"dropout_rate": 0.0})
    path = os.path.join(REPO, cfg["dataset"])
    jds, jinfo = j_load(path, cfg)
    tds, tinfo = t_load(path, cfg)
    with jax_backend("dense"):
        jmodel = j_build("gcn", jinfo, cfg)
        jtr = JTrainer(jmodel, cfg, jinfo)
        jb = JBatcher(jds, jinfo, 2)
        state = jtr.init_state(jb.make_batch(np.arange(2)), seed=0)
        state, _, _ = jtr.train_step(state, JBatcher(jds, jinfo, 25).make_batch(
            np.arange(25)))
        jvars = jax.device_get({"params": state.params, "batch_stats": state.batch_stats})
        jtree = jax.device_get(jtr.state_tree(state, 0, 0.0))
    tree = params_from_jax(jvars["params"], jvars["batch_stats"])
    tmodel = t_build("gcn", tinfo, cfg).eval()
    return (jmodel, jvars, jds, jinfo, tmodel,
            {**tree["params"], **tree["batch_stats"]}, tds, tinfo,
            lambda ds, info, bs: TBatcher(ds, info, bs, backend=Backend("dense")), jtree)


def _batches(pair, idx, backend="dense"):
    """The JAX package's and the port's batch of molecules ``idx`` on
    ``backend`` (the tiled and stream payloads in float32)."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
    from kgcn_tpu_torch.runtime.backend import Backend

    jmodel, jvars, jds, jinfo, tmodel, tvars, tds, tinfo, tbatcher, _ = pair
    idx = np.asarray(idx)
    with jax_backend(backend):
        jbatch = JBatcher(jds, jinfo, len(idx)).make_batch(idx)
    if backend == "dense":
        return jbatch, tbatcher(tds, tinfo, len(idx)).make_batch(idx)
    tb = TBatcher(tds, tinfo, len(idx), backend=Backend(backend, "float32"))
    return jbatch, tb.make_batch(idx)


def _jax_ig(pair, jbatch, backend="dense", **kw):
    from kgcn_tpu.explain.ig import integrated_gradients as j_ig

    with jax_backend(backend):
        return j_ig(jax.tree_util.Partial(pair[0].apply), pair[1], jbatch, **kw)


def _close(got, want):
    (gi, gc), (wi, wc) = got, want
    for key in ("features_IG", "adjs_IG"):
        assert gi[key].shape == wi[key].shape, key
        np.testing.assert_allclose(gi[key], wi[key], err_msg=key, **IG_TOL)
    for key in ("check_score", "sum_of_IG"):
        np.testing.assert_allclose(gc[key], wc[key], err_msg=key, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("idx", [[0], [3, 60]])
@pytest.mark.parametrize("target,label_index", [("max", None), ("label", None),
                                                ("index", 0), ("index", 1)])
@pytest.mark.parametrize("method", ["ig", "grad", "grad_prod"])
def test_ig_matches_jax(pair, method, target, label_index, idx):
    jbatch, tbatch = _batches(pair, idx)
    kw = dict(steps=STEPS, method=method, target=target, label_index=label_index)
    got = tig.integrated_gradients(pair[4], pair[5], tbatch, **kw)
    _close(got, _jax_ig(pair, jbatch, **kw))
    assert np.abs(got[0]["adjs_IG"]).sum() > 0  # the adjacency's gradient arrived


@pytest.mark.parametrize("chunk", [1, 7])
def test_chunks_sum_to_the_one_stack(pair, chunk, monkeypatch):
    """Copies stacked in chunks of 1 or 7 (three chunks, the last short)
    give the one stack's IG."""
    _, tbatch = _batches(pair, [5])
    kw = dict(steps=STEPS, target="max")
    want = tig.integrated_gradients(pair[4], pair[5], tbatch, **kw)
    per_copy = tig.CHUNK_ADJ_ELEMENTS // tig.chunk_copies(tbatch)
    monkeypatch.setattr(tig, "CHUNK_ADJ_ELEMENTS", chunk * per_copy)
    assert tig.chunk_copies(tbatch) == chunk
    _close(tig.integrated_gradients(pair[4], pair[5], tbatch, **kw), want)


@pytest.mark.parametrize("method", ["ig", "grad", "grad_prod"])
def test_tiled_ig_matches_jax(pair, method, monkeypatch):
    """On the tiled backend the copies carry tiled structures built from
    their own edges (``with_tiled``, as the Batcher builds them): the
    forward runs ``tiled_spmm`` and the adjacency's gradient comes from its
    backward (the tiled SDDMM), equal to the JAX package's tiled IG.  The
    plain versions stand in for the kernels on the CPU; they are counted
    to show the tiled route ran."""
    from kgcn_tpu_torch.ops import tiled_spmm

    calls = []
    for name in ("tiled_spmm_reference", "tiled_sddmm_edges_reference"):
        fn = getattr(tiled_spmm, name)
        monkeypatch.setattr(tiled_spmm, name,
                            lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    jbatch, tbatch = _batches(pair, [3, 60], backend="tiled")
    assert tbatch.graph.tiled_adj is not None
    kw = dict(steps=STEPS, method=method, target="max")
    got = tig.integrated_gradients(pair[4], pair[5], tbatch, **kw)
    _close(got, _jax_ig(pair, jbatch, backend="tiled", **kw))
    assert np.abs(got[0]["adjs_IG"]).sum() > 0
    assert {"tiled_spmm_reference", "tiled_sddmm_edges_reference"} <= set(calls)


def test_stream_ig_matches_the_dense_ig(pair):
    """On the stream backend the copies' structures are built from their
    own edges and the layers read the scaled weights (``live_weights``), so
    the adjacency's gradient comes from the stream weight gradient.  The
    JAX package's stream layers take the baked weights, whose gradient
    never reaches ``edge_weights``; the port's stream IG is held to the JAX
    package's dense IG of the same molecules instead."""
    jbatch, _ = _batches(pair, [3, 60])
    _, tbatch = _batches(pair, [3, 60], backend="stream")
    assert tbatch.graph.stream_adj is not None
    kw = dict(steps=STEPS, method="ig", target="label")
    got = tig.integrated_gradients(pair[4], pair[5], tbatch, **kw)
    _close(got, _jax_ig(pair, jbatch, **kw))
    assert np.abs(got[0]["adjs_IG"]).sum() > 0


def test_pallas_ell_ig_is_refused(pair):
    """IG on the pallas backend, which the port no longer refuses (the
    test keeps its name).  Without ELL arrays (the dataset's layout
    refused) the copies take the edge-list route the pallas training step
    takes, equal to JAX's; with them the copies carry the ELL arrays and
    their baked slot weights, which the layers read in place of
    ``edge_weights``: the adjacency's IG is 0 and F(1) − F(0) scales the
    features alone, as in ``kgcn_tpu`` (``test_visualize_on_ell_backends_
    writes_the_jax_dumps`` holds the dumps to JAX's on ring graphs)."""
    jbatch, tbatch = _batches(pair, [1])
    g = tbatch.graph.replace(backend="pallas")
    got = tig.integrated_gradients(pair[4], pair[5], tbatch.replace(graph=g), steps=STEPS)
    _close(got, _jax_ig(pair, jbatch, steps=STEPS))
    from kgcn_tpu_torch.ops.ell_spmm import coo_to_ell_device

    ell, w = coo_to_ell_device(g.senders[0], g.receivers[0], g.edge_weights[0],
                               g.total_nodes, 8)
    g = g.replace(ell_senders=ell[None], ell_weights=w[None])
    igs, check = tig.integrated_gradients(pair[4], pair[5], tbatch.replace(graph=g),
                                          steps=200)
    assert not np.any(igs["adjs_IG"])  # the baked weights are what is read
    assert np.any(igs["features_IG"])
    # completeness over the features alone
    assert check["sum_of_IG"] == pytest.approx(check["check_score"], rel=0.05)


@pytest.mark.parametrize("smooth,plain", [("smooth_ig", "ig"), ("smooth_grad", "grad")])
def test_smooth_variants(pair, smooth, plain):
    """At noise 0 the smooth variants are ``ig`` and ``grad`` (the latter
    averaged over ``steps`` equal copies), as in the JAX package; with
    noise, finite, and ``smooth_ig`` complete to within its noise."""
    jbatch, tbatch = _batches(pair, [2])
    kw = dict(steps=STEPS, target="label")
    got = tig.integrated_gradients(pair[4], pair[5], tbatch, method=smooth,
                                   noise_scale=0.0, **kw)
    _close(got, _jax_ig(pair, jbatch, method=plain, **kw))
    gen = torch.Generator().manual_seed(0)
    igs, check = tig.integrated_gradients(pair[4], pair[5], tbatch, method=smooth,
                                          generator=gen, steps=200, target="label")
    assert all(np.isfinite(v).all() for v in igs.values())
    if smooth == "smooth_ig":
        rel = abs(check["sum_of_IG"] - check["check_score"]) / abs(check["check_score"])
        assert rel < 0.5


def test_completeness_tightens_with_steps(pair):
    _, tbatch = _batches(pair, [0])
    rels = []
    for steps in (20, 200):
        _, check = tig.integrated_gradients(pair[4], pair[5], tbatch, steps=steps,
                                            target="index", label_index=1)
        rels.append(abs(check["sum_of_IG"] - check["check_score"])
                    / (abs(check["check_score"]) + 1e-12))
    assert rels[1] < rels[0] and rels[1] < 0.1


def test_edge_ig_to_dense_adds_duplicate_edges():
    """Duplicate (receiver, sender) pairs add up, as np.add.at does in the
    JAX package; padding edges (past n_edge) are left out."""
    from kgcn_tpu.explain.ig import edge_ig_to_dense as j_dense
    from kgcn_tpu.graph.batch import batch_graphs as j_batch
    from kgcn_tpu_torch.graph.batch import batch_graphs as t_batch

    adj = (np.array([[0, 1], [1, 0], [1, 0], [2, 2]]), np.ones(4, np.float32), (3, 3))
    feats = np.ones((2, 3, 1), np.float32)
    graphs = [[adj], [adj]]
    tg = t_batch(graphs, feats, 3, edge_budget=16)
    jg = j_batch(graphs, feats, 3, edge_budget=16)
    ig = np.random.RandomState(0).rand(1, 16).astype(np.float32)
    got = tig.edge_ig_to_dense(tg, ig)
    np.testing.assert_array_equal(got, np.asarray(j_dense(jg, ig)))
    assert got[0, 0, 1, 0] == pytest.approx(ig[0, 1] + ig[0, 2])
    assert got[0, 1, 1, 0] == pytest.approx(ig[0, 5] + ig[0, 6])
    assert got.sum() == pytest.approx(ig[0, :8].sum())


def _viz_config(tmp, side, **over):
    with open(os.path.join(REPO, "example_config/synth.json")) as f:
        cfg = json.load(f)
    d = tmp / side
    d.mkdir()
    cfg.update({"dataset": os.path.join(REPO, cfg["dataset"]), "dropout_rate": 0.0,
                "save_model_path": str(d / "model"), "visualize_path": str(d / "viz"),
                "visualize_num": 3, "ig_divide_number": STEPS}, **over)
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def _visualize_both(tmp_path, pair, backend="dense", **over):
    """``visualize`` through both CLIs on the same weights (the JAX
    checkpoint and its conversion): the same files, each with JAX's keys,
    shapes and values (rtol 1e-4)."""
    from kgcn_tpu.cli.main import cmd_visualize as j_visualize
    from kgcn_tpu.runtime import checkpoint as jckpt
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.runtime import checkpoint as tckpt

    jcfg, _ = _viz_config(tmp_path, "jax", **over)
    _, tpath = _viz_config(tmp_path, "port", **over)
    jvars = pair[1]
    os.makedirs(tmp_path / "jax" / "model")
    jckpt.save_checkpoint(str(tmp_path / "jax" / "model" / "model.best.ckpt"), pair[9])
    tckpt.save_tree(str(tmp_path / "port" / "model" / "model.best.ckpt"),
                    params_from_jax(jvars["params"], jvars["batch_stats"]))
    with jax_backend(backend):
        j_visualize(dict(jcfg))
    t_main(["visualize", "--config", tpath, "--cpu"])
    names = sorted(os.listdir(tmp_path / "jax" / "viz"))
    assert names and sorted(os.listdir(tmp_path / "port" / "viz")) == names
    for name in names:
        want = joblib.load(tmp_path / "jax" / "viz" / name)
        with open(tmp_path / "port" / "viz" / name, "rb") as f:
            got = pickle.load(f)
        assert set(got) == set(want)
        for key, w in want.items():
            g = np.asarray(got[key])
            assert g.shape == np.shape(w), key
            np.testing.assert_allclose(g, np.asarray(w), err_msg=f"{name} {key}",
                                       rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("visualize_type", [None, "1", "correct", "uncorrect", "all"])
def test_visualize_writes_the_jax_dumps(tmp_path, pair, visualize_type):
    over = {} if visualize_type is None else {"visualize_type": visualize_type}
    _visualize_both(tmp_path, pair, **over)


def test_visualize_tiled_config_writes_the_jax_dumps(tmp_path, pair, capsys):
    """A config on the tiled backend: the port's dumps equal the JAX
    package's tiled run's (the tiled kernels' plain versions on the CPU)."""
    _visualize_both(tmp_path, pair, backend="tiled", spmm_backend="tiled",
                    tiled_compute_dtype="float32")
    assert "[spmm] backend: tiled" in capsys.readouterr().out


def test_visualize_refuses_the_kg_route(tmp_path, monkeypatch):
    """The KG route of ``visualize``, which the port no longer refuses (the
    test keeps its name): ``cmd_visualize`` routes as ``kgcn_tpu``'s
    (``task: link_prediction``, an ``edge*`` ``visualize_type``, or a
    node-embedding dataset with KG triples) to ``explain/kg_ig.py``
    (tests/test_torch_kg_ig.py holds its output to JAX's)."""
    from kgcn_tpu_torch.cli import main as cli

    calls = []
    monkeypatch.setattr(cli, "run_kg_visualization",
                        lambda config, raw=None, device=None: calls.append(raw) or ["kg"])
    for over in ({"task": "link_prediction"}, {"visualize_type": "edge"}):
        cfg, _ = _viz_config(tmp_path, f"port{len(calls)}", **over)
        assert cli.cmd_visualize(cfg, device="cpu") == ["kg"]
    assert calls == [None, None]
    # a node-embedding graph dataset without triples stays on the graph route
    monkeypatch.setattr(cli, "run_visualization",
                        lambda config, device=None, raw=None: ["graph"])
    cfg, _ = _viz_config(tmp_path, "port2", with_node_embedding=True)
    assert cli.cmd_visualize(cfg, device="cpu") == ["graph"] and len(calls) == 2


# ---- ELL backends, vector modals, the sequence-embedding layer ---------------------


def _ring_viz_both(tmp_path, backend, model):
    """``kgcn_tpu`` trains ``model`` one epoch on ring6 graphs with
    ``backend`` and runs ``visualize``; the port runs ``visualize`` on that
    checkpoint.  → (JAX dump dir, port dump dir, port's stdout)."""
    from kgcn_tpu.cli.main import main as j_main
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    with open(tmp_path / "ring6.jbl", "wb") as f:
        pickle.dump(make_ring_dataset(num_pairs=20, num_nodes=6, seed=0), f, protocol=4)
    with open(os.path.join(REPO, "example_config/gin.json")) as f:
        cfg = json.load(f)
    cfg.update({"dataset": str(tmp_path / "ring6.jbl"), "spmm_backend": backend,
                "model.py": model, "epoch": 1, "save_model_path": str(tmp_path / "model"),
                "visualize_num": 2, "ig_divide_number": STEPS})
    paths = {}
    for side in ("jax", "port"):
        paths[side] = tmp_path / f"{side}.json"
        paths[side].write_text(json.dumps(dict(cfg, visualize_path=str(tmp_path / side))))
    with jax_backend(backend):
        j_main(["train", "--config", str(paths["jax"]), "--cpu"])
        j_main(["visualize", "--config", str(paths["jax"]), "--cpu"])
    t_main(["visualize", "--config", str(paths["port"]), "--cpu"])
    return tmp_path / "jax", tmp_path / "port"


@pytest.mark.parametrize("backend,model", [("pallas", "gin"), ("xla", "gin"),
                                           ("pallas", "gcn")])
def test_visualize_on_ell_backends_writes_the_jax_dumps(tmp_path, backend, model):
    """``visualize`` on ring graphs, whose batches carry ELL arrays on
    ``pallas`` and ``xla``: the port's dumps are ``kgcn_tpu``'s (its
    checkpoint read through the flax-msgpack reader), keys, shapes and
    values (rtol 1e-4), the adjacency's IG 0 as there (the ELL arrays'
    baked weights are what the layers read)."""
    jdir, tdir = _ring_viz_both(tmp_path, backend, model)
    names = sorted(os.listdir(jdir))
    assert len(names) == 2 and sorted(os.listdir(tdir)) == names
    for name in names:
        want = joblib.load(jdir / name)
        with open(tdir / name, "rb") as f:
            got = pickle.load(f)
        assert set(got) == set(want)
        assert not np.any(want["adjs_IG"]) and not np.any(got["adjs_IG"])
        for key, w in want.items():
            np.testing.assert_allclose(np.asarray(got[key]), np.asarray(w), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{name} {key}")


def _mm_pair(name, data_key):
    from test_torch_multimodal import DATA, _both

    jm, variables, jb, m, b, _ = _both(name, DATA[data_key](), "classification", bs=4)
    tvars = {**dict(m.named_parameters()), **dict(m.named_buffers())}
    return jm, variables, jb, m.eval(), {k: v.detach() for k, v in tvars.items()}, b


def test_vector_modal_ig_matches_jax():
    """The vector modals are scaled and attributed with the features and
    the adjacency (``gcn_vector_modal``, two modals): ``vector_modal_IG`` and
    the completeness check as ``kgcn_tpu``'s (rtol 1e-4)."""
    from kgcn_tpu.explain.ig import integrated_gradients as j_ig

    jm, jvars, jb, m, tvars, b = _mm_pair("gcn_vector_modal", "vm2")
    want = j_ig(jax.tree_util.Partial(jm.apply), jvars, jb, steps=STEPS)
    got = tig.integrated_gradients(m, tvars, b, steps=STEPS)
    _close(got, want)
    assert len(got[0]["vector_modal_IG"]) == 2
    for g, w in zip(got[0]["vector_modal_IG"], want[0]["vector_modal_IG"]):
        assert np.any(w)
        np.testing.assert_allclose(g, np.asarray(w), **IG_TOL)


@pytest.mark.parametrize("target,label_index", [("max", None), ("index", 1)])
def test_embedded_layer_ig_matches_jax(target, label_index):
    """IG of the sequence-embedding layer of ``multimodal.json``'s model
    (``gcn_multimodal`` on example_jbl/multimodal.jbl): the embedded layer,
    its IG and the check as ``kgcn_tpu``'s ``embedded_layer_ig`` (1e-4)."""
    from kgcn_tpu.explain.ig import embedded_layer_ig as j_emb

    jm, jvars, jb, m, tvars, b = _mm_pair("gcn_multimodal", "multimodal.jbl")
    wemb, wig, wcheck = j_emb(jm, jvars, jb, steps=STEPS, target=target,
                              label_index=label_index)
    temb, tig_, tcheck = tig.embedded_layer_ig(m, tvars, b, steps=STEPS, target=target,
                                               label_index=label_index)
    np.testing.assert_allclose(temb, wemb, rtol=1e-6)
    assert np.any(wig)
    np.testing.assert_allclose(tig_, wig, rtol=1e-4, atol=1e-4 * np.abs(wig).max())
    for key in ("check_score", "sum_of_IG"):
        np.testing.assert_allclose(tcheck[key], wcheck[key], rtol=1e-4, atol=1e-6)


def test_visualize_multimodal_writes_the_jax_dumps(tmp_path):
    """``visualize`` on ``multimodal.json``: the dumps carry the embedded
    layer, its IG and check beside the graph's, all as ``kgcn_tpu``'s."""
    from kgcn_tpu.cli.main import cmd_visualize as j_visualize
    from kgcn_tpu.runtime import checkpoint as jckpt
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.cli.main import main as t_main

    jm, jvars, jb, _, _, _ = _mm_pair("gcn_multimodal", "multimodal.jbl")
    with open(os.path.join(REPO, "example_config/multimodal.json")) as f:
        cfg = json.load(f)
    cfg.update({"dataset": os.path.join(REPO, cfg["dataset"]), "dropout_rate": 0.0,
                "save_model_path": str(tmp_path / "model"), "visualize_num": 2,
                "ig_divide_number": STEPS, "task": "classification",
                "normalize_adj_flag": True})
    jtr = JTrainer(jm, cfg, None)
    state = jtr.init_state(jb, seed=0).replace(params=jvars["params"])
    os.makedirs(tmp_path / "model")
    jckpt.save_checkpoint(str(tmp_path / "model" / "model.best.ckpt"),
                          jax.device_get(jtr.state_tree(state, 0, 0.0)))
    j_visualize(dict(cfg, visualize_path=str(tmp_path / "jax")))
    path = tmp_path / "port.json"
    path.write_text(json.dumps(dict(cfg, visualize_path=str(tmp_path / "port"))))
    t_main(["visualize", "--config", str(path), "--cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert len(names) == 2 and sorted(os.listdir(tmp_path / "port")) == names
    for name in names:
        want = joblib.load(tmp_path / "jax" / name)
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        assert set(got) == set(want) and "embedded_layer_IG" in got
        for key, w in want.items():
            if key == "mol":
                continue
            w = np.asarray(w)
            np.testing.assert_allclose(np.asarray(got[key]), w, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(w).max(), 1e-2),
                                       err_msg=f"{name} {key}")
