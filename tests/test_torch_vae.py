"""The port's graph VAE (kgcn_tpu_torch/models/vae.py, cli/gen.py, the
graph decoders, ``Batcher(epsilon_dim=…)`` and ``ResidentVAEBatcher``)
against the JAX package's on the CPU, from the same weights
(``params_from_jax``):

* ``GraphDecoderInnerProd`` and ``GraphDecoderDistMult``: values and
  gradients;
* ``GCNVAE`` with a given ε, both variants (feature + link, and link-only
  with ``pos_weight`` and ``norm``), eval and training mode: the
  prediction dict, ``cost_opt``, ``cost_sum`` and the metrics within 1e-5,
  gradients within 1e-4 (relative, and of the tensor's largest entry);
  ``generate`` for one ε; the registry's VAE names;
* the streaming ε equal to ``kgcn_tpu``'s bit for bit for one seed, over
  shuffled epochs, and the resident batcher's host draws equal to it;
* the link-only ``pos_weight`` and ``norm`` equal to ``kgcn_tpu``'s
  ``_setup``;
* the resident scanned epoch (ε drawn from the runner's generator: the same
  steps again from the same generator state, other steps from another) and
  the resident evaluation (dict predictions through the evaluation runner)
  against the streaming evaluation;
* ``cli.gen train``, ``reconstruct`` and ``generate`` on
  example_config/vae.json (2 epochs, the streaming batcher) from
  kgcn_tpu's initial weights: training costs within 1e-4 relative, the
  dumps' keys and shapes; ``reconstruct`` of the checkpoint ``kgcn_tpu``
  wrote gives kgcn_tpu's dump (1e-5).
"""
import contextlib
import io
import json
import os
import pickle
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
SYNTH = os.path.join(REPO, "example_jbl", "synthetic.jbl")
TOL = dict(rtol=1e-5, atol=1e-6)
LATENT = 16


def _datasets(cfg=None):
    from kgcn_tpu.data import load_jbl as j_load
    from kgcn_tpu_torch.data.dataset import load_jbl

    cfg = cfg or {"normalize_adj_flag": True}
    return j_load(SYNTH, dict(cfg)), load_jbl(SYNTH, dict(cfg))


def _batches(bs=8, n=6, seed=0):
    """A partial batch of synthetic.jbl in both packages, the same ε."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu_torch.data.batcher import Batcher

    (jds, jinfo), (ds, info) = _datasets()
    idx = np.arange(n)
    jb = JBatcher(jds, jinfo, bs, epsilon_dim=LATENT, seed=seed).make_batch(idx)
    b = Batcher(ds, info, bs, epsilon_dim=LATENT, seed=seed).make_batch(idx)
    np.testing.assert_array_equal(b.rng_normal.numpy(), np.asarray(jb.rng_normal))
    return jb, b, info


def _grads_match(jgrad, grads, names, m, tol=1e-4):
    want = params_from_jax(jax.device_get(jgrad), {}, m)["params"]
    assert set(want) == set(names)
    for k, g in zip(names, grads):
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=tol, atol=tol * max(np.abs(w).max(), 1e-3),
                                   err_msg=k)


@pytest.mark.parametrize("name", ["inner", "distmult"])
def test_decoders_match_jax(name):
    from kgcn_tpu.nn.layers import GraphDecoderDistMult as JDist
    from kgcn_tpu.nn.layers import GraphDecoderInnerProd as JInner
    from kgcn_tpu_torch.nn.layers import GraphDecoderDistMult, GraphDecoderInnerProd

    jb, b, _ = _batches()
    z = np.random.RandomState(2).randn(b.graph.total_nodes, 5).astype(np.float32)
    jdec = JInner() if name == "inner" else JDist()
    variables = jax.device_get(jdec.init(jax.random.PRNGKey(0), jnp.asarray(z), jb.graph))
    dec = GraphDecoderInnerProd() if name == "inner" else GraphDecoderDistMult(5)
    if name == "distmult":
        assert variables["params"]["kernel"].shape == (5,)
        dec.load_state_dict({"kernel": torch.from_numpy(np.asarray(variables["params"]["kernel"]))})
    w = np.random.RandomState(3).randn(8, 10, 10).astype(np.float32)
    jout = jdec.apply(variables, jnp.asarray(z), jb.graph)
    jgz = jax.grad(lambda a: jnp.sum(jdec.apply(variables, a, jb.graph) * w))(jnp.asarray(z))
    zt = torch.tensor(z, requires_grad=True)
    out = dec(zt, b.graph)
    assert out.shape == (8, 10, 10)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(jgz), **TOL)


def _vae_both(link_only, jb, info, pos_weight=3.0, norm=1.7):
    from kgcn_tpu.models.vae import GCNVAE as JVAE
    from kgcn_tpu_torch.models.vae import GCNVAE

    over = dict(link_only=link_only, pos_weight=pos_weight, norm=norm)
    jm = JVAE(channels=1, feature_dim=info.feature_dim, latent_dim=LATENT, **over)
    variables = jax.device_get(jm.init(jax.random.PRNGKey(7), jb))
    m = GCNVAE(in_features=info.feature_dim, feature_dim=info.feature_dim,
               latent_dim=LATENT, **over)
    tree = params_from_jax(variables["params"], variables["batch_stats"], m)
    assert set(tree["params"]) == {k for k, _ in m.named_parameters()}
    m.load_state_dict({**tree["params"], **tree["batch_stats"]})
    return jm, variables, m


@pytest.mark.parametrize("link_only", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_vae_matches_jax(link_only, train):
    jb, b, info = _batches()
    jm, variables, m = _vae_both(link_only, jb, info)

    def cost(params):
        return jm.apply({**variables, "params": params}, jb, train=train,
                        mutable=["batch_stats"])[0].cost_opt

    with jax_backend("dense"):
        jout, _ = jm.apply(variables, jb, train=train, mutable=["batch_stats"])
        jgrad = jax.grad(cost)(jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    out = m(b, train=train)
    assert set(out.prediction) == set(jout.prediction) == {"feature", "dense_adj"}
    assert out.prediction["dense_adj"].shape == (8, 1, 10, 10)
    for k, v in jout.prediction.items():
        np.testing.assert_allclose(out.prediction[k].detach().numpy(), np.asarray(v),
                                   err_msg=k, **TOL)
    for name in ("cost_opt", "cost_sum"):
        np.testing.assert_allclose(float(getattr(out, name).detach()),
                                   float(getattr(jout, name)), err_msg=name, **TOL)
    for k, v in jout.metrics.items():
        np.testing.assert_allclose(float(out.metrics[k]), float(v), err_msg=k, **TOL)
    names = [k for k, _ in m.named_parameters()]
    grads = torch.autograd.grad(out.cost_opt, [p for _, p in m.named_parameters()],
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for g, (_, p) in zip(grads, m.named_parameters())]
    _grads_match(jgrad, grads, names, m)


@pytest.mark.parametrize("name,link_only", [
    ("gcn_vae", False), ("example_model.model_vae:VAE", False),
    ("gcn_vae_onlylink", True), ("example_model.model_vae_onlylink:VAE", True)])
def test_registry_builds_the_vae_as_jax(name, link_only):
    """Every VAE name ``kgcn_tpu`` registers resolves, to the same
    parameters; an unknown name raises as ``kgcn_tpu``'s registry does."""
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu_torch.models.registry import build_model

    (_, jinfo), (_, info) = _datasets()
    cfg = {"latent_dim": LATENT, "pos_weight": 2.5, "norm": 1.5}
    jm, m = j_build(name, jinfo, cfg), build_model(name, info, cfg)
    assert m.link_only == jm.link_only == link_only
    assert (m.pos_weight, m.norm) == ((2.5, 1.5) if link_only else (1.0, 1.0))
    jb, _, _ = _batches()
    variables = jax.device_get(jm.init(jax.random.PRNGKey(0), jb))
    tree = params_from_jax(variables["params"], variables["batch_stats"], m)
    assert {k: tuple(v.shape) for k, v in tree["params"].items()} == {
        k: tuple(p.shape) for k, p in m.named_parameters()}
    with pytest.raises(KeyError, match="unknown model"):
        build_model("gcn_vae_nonexistent", info, cfg)


@pytest.mark.parametrize("link_only", [False, True])
def test_generate_matches_jax(link_only):
    jb, b, info = _batches()
    jm, variables, m = _vae_both(link_only, jb, info)
    with jax_backend("dense"):
        jout = jm.apply(variables, jb, method=jm.generate)
    with torch.no_grad():
        out = m.generate(b)
    assert set(out) == set(jout)
    for k, v in jout.items():
        np.testing.assert_allclose(out[k].numpy(), np.asarray(v), err_msg=k, **TOL)


def test_streaming_epsilon_equals_jax_bitwise():
    """One seed: every batch's ε over two shuffled epochs and over the
    (seed, epoch) order of fit, and the resident batcher's host draws."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.runtime.resident import ResidentVAEBatcher

    (jds, jinfo), (ds, info) = _datasets()
    jbt = JBatcher(jds, jinfo, 25, epsilon_dim=LATENT, seed=4)
    bt = Batcher(ds, info, 25, epsilon_dim=LATENT, seed=4)
    rb = ResidentVAEBatcher(ds, info, 25, LATENT, seed=4)
    for epoch in (None, None, 3):
        jbs = list(jbt.batches(epoch=epoch)) if epoch is not None else list(jbt.batches())
        bs = list(bt.batches(epoch=epoch))
        assert len(bs) == len(jbs) == 8
        for jb, b in zip(jbs, bs):
            assert b.rng_normal.shape == (25, 10, LATENT)
            np.testing.assert_array_equal(b.rng_normal.numpy(), np.asarray(jb.rng_normal))
            np.testing.assert_array_equal(b.graph.nodes.numpy(), np.asarray(jb.graph.nodes))
        if epoch is None:
            for jb, r in zip(jbs, rb.batches()):
                np.testing.assert_array_equal(r.rng_normal.numpy(), np.asarray(jb.rng_normal))


def test_link_statistics_equal_jax(tmp_path):
    from kgcn_tpu.cli.gen import _setup as j_setup
    from kgcn_tpu_torch.cli.gen import _setup

    cfg = {"dataset": SYNTH, "normalize_adj_flag": True, "model.py": "gcn_vae_onlylink",
           "batch_size": 25, "latent_dim": LATENT}
    jmodel = j_setup(dict(cfg), with_batcher=False)[2]
    model = _setup(dict(cfg), "cpu", with_batcher=False)[2]
    assert model.link_only and jmodel.link_only
    assert model.pos_weight == pytest.approx(jmodel.pos_weight, rel=1e-12)
    assert model.norm == pytest.approx(jmodel.norm, rel=1e-12)
    assert model.pos_weight > 1.0


def test_resident_vae_runner_and_evaluation():
    """The scanned epoch draws ε on the device from the runner's generator:
    two epochs from one state and one generator state repeat bitwise,
    another generator state draws other ε.  The VAE batcher offers no
    resident schedule, so ``evaluate`` streams its batches with the host ε
    and equals the streaming Batcher's of the same seed.  The resident
    evaluation runner's dict predictions (a ``ResidentBatcher``: ε 0, as
    ``kgcn_tpu``'s resident evaluation gathers no ε) equal the streaming
    evaluation's without ε."""
    import dataclasses

    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.models.vae import GCNVAE
    from kgcn_tpu_torch.runtime.resident import ResidentBatcher, ResidentVAEBatcher
    from kgcn_tpu_torch.runtime.train import Trainer

    _, (ds, info) = _datasets()
    cfg = {"learning_rate": 0.01, "task": "generation"}
    tr = Trainer(GCNVAE(in_features=3, feature_dim=3, latent_dim=LATENT), cfg, info,
                 device="cpu")
    rb = ResidentVAEBatcher(ds, info, 25, LATENT, seed=0)
    assert not hasattr(rb, "epoch_schedule")
    s0 = tr.init_state(0)
    g0 = s0.rng.get_state()
    runs = []
    for _ in range(2):
        s0.rng.set_state(g0)
        s1, costs, _ = tr.epoch_on_device(dataclasses.replace(s0), rb, epoch=0)
        runs.append((costs, s1))
    assert torch.equal(runs[0][0], runs[1][0]) and len(runs[0][0]) == 8
    for k in runs[0][1].params:
        assert torch.equal(runs[0][1].params[k], runs[1][1].params[k]), k
    _, other, _ = tr.epoch_on_device(dataclasses.replace(s0), rb, epoch=0)  # drawn on
    assert not torch.equal(other, runs[0][0])
    for got_b, want_b in (
            (ResidentVAEBatcher(ds, info, 25, LATENT, seed=3),
             Batcher(ds, info, 25, epsilon_dim=LATENT, seed=3)),
            (ResidentBatcher(ds, info, 25), Batcher(ds, info, 25))):
        ev = tr.evaluate(runs[0][1], got_b)
        want = tr.evaluate(runs[0][1], want_b)
        assert set(ev["prediction"]) == {"feature", "dense_adj"}
        assert ev["prediction"]["dense_adj"].shape == (200, 1, 10, 10)
        for k, v in want["prediction"].items():
            np.testing.assert_allclose(ev["prediction"][k], v, err_msg=k, **TOL)
        np.testing.assert_allclose(ev["cost"], want["cost"], **TOL)


def _config(tmp, side, **over):
    d = tmp / side
    d.mkdir(exist_ok=True)
    with open(os.path.join(REPO, "example_config", "vae.json")) as f:
        cfg = json.load(f)
    cfg.update(dataset=SYNTH, epoch=2, device_resident=False,
               save_model_path=str(d / "model"),
               reconstruction_output=str(d / "reconstruction.jbl"),
               generation_output=str(d / "generated.jbl"))
    cfg.update(over)
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """kgcn_tpu's ``train``, ``reconstruct`` and ``generate`` of vae.json (2
    epochs, the streaming batcher): (its output, the initial parameters it
    drew, the directory)."""
    from kgcn_tpu.cli.gen import main as j_main
    from kgcn_tpu.runtime.train import Trainer as JTrainer

    tmp = tmp_path_factory.mktemp("vae")
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
            for mode in ("train", "reconstruct", "generate"):
                j_main([mode, "--config", _config(tmp, "jax"), "--cpu"])
    finally:
        JTrainer.init_state = j_init
    return buf.getvalue(), initial["tree"], tmp


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def test_cli_train_reconstruct_generate_match_jax(jax_run, monkeypatch, capsys):
    import joblib

    from kgcn_tpu_torch.cli.gen import main as t_main
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    jout, (params, stats), tmp = jax_run
    monkeypatch.setattr(TTrainer, "init_state", lambda self, seed=0: self.state_from_tree(
        params_from_jax(params, stats, self.model), seed=seed))
    for mode in ("train", "reconstruct", "generate"):
        t_main([mode, "--config", _config(tmp, "port"), "--cpu"])
    tout = capsys.readouterr().out
    pattern = r"epoch \d+, training cost ([-\d.e+]+)"
    want = np.array(re.findall(pattern, jout), float)
    got = np.array(re.findall(pattern, tout), float)
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert {"model.best.ckpt", "model.last.ckpt"} <= set(os.listdir(tmp / "port" / "model"))
    for name, n in (("reconstruction.jbl", 200), ("generated.jbl", 10)):
        ours, theirs = _load(tmp / "port" / name), joblib.load(tmp / "jax" / name)
        assert set(ours) == set(theirs) == {"feature", "dense_adj"}
        for k in theirs:
            assert ours[k].shape == theirs[k].shape and len(ours[k]) == n, (name, k)
            assert np.isfinite(ours[k]).all()


def test_reconstruct_reads_the_jax_checkpoint(jax_run, tmp_path):
    import joblib

    from kgcn_tpu_torch.cli.gen import main as t_main

    _, _, tmp = jax_run
    path = _config(tmp_path, "port", load_model=str(tmp / "jax" / "model" / "model.best.ckpt"))
    for mode in ("reconstruct", "generate"):
        t_main([mode, "--config", path, "--cpu"])
    for name in ("reconstruction.jbl", "generated.jbl"):
        ours, theirs = _load(tmp_path / "port" / name), joblib.load(tmp / "jax" / name)
        for k in theirs:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{name} {k}")
