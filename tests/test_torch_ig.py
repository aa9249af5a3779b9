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
    """The ELL arrays bake each slot's weight in: IG on the pallas backend
    over a batch that carries them raises rather than take another route;
    without them (the dataset's layout refused) the copies take the
    edge-list route the pallas training step takes, equal to JAX's."""
    jbatch, tbatch = _batches(pair, [1])
    g = tbatch.graph.replace(backend="pallas")
    got = tig.integrated_gradients(pair[4], pair[5], tbatch.replace(graph=g), steps=STEPS)
    _close(got, _jax_ig(pair, jbatch, steps=STEPS))
    ell = torch.zeros((1, g.total_nodes, 1), dtype=torch.int32)
    g = g.replace(ell_senders=ell, ell_weights=ell.float())
    with pytest.raises(NotImplementedError, match="not yet ported.*A.5"):
        tig.integrated_gradients(pair[4], pair[5], tbatch.replace(graph=g), steps=STEPS)


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


def test_visualize_refuses_the_kg_route(tmp_path):
    from kgcn_tpu_torch.cli.main import cmd_visualize

    cfg, _ = _viz_config(tmp_path, "port", task="link_prediction")
    with pytest.raises(NotImplementedError, match="not yet ported.*A.10"):
        cmd_visualize(cfg, device="cpu")
