"""The port's big-graph KG trainer (kgcn_tpu_torch/parallel/big_graph.py)
against the JAX package, on the CPU.

The port runs as gloo ranks (D = 2 and 4, one launch a world size, tests/
torch_parallel_worker.py) over a 37-entity, 2-relation graph (the table
padded to 38 and 40 rows); kgcn_tpu's ``BigGraphKGTrainer`` runs here on
D virtual devices from the same parameters (``to_flax_variables`` →
``params_from_jax``) and triples.  Tolerances: the loss, the gradients and
the step's cost, rtol = atol = 1e-5; one Adam step's parameters and the
embeddings after it, ``STEP_TOL`` (rtol 2e-4, atol 2e-5, the precedent of
tests/test_torch_train.py for Adam steps: Adam's first step is ±lr·g/(|g|
+ ε), so a near-zero, cancelling gradient component's rounding moves its
step by up to lr·1e-3 where the gradients agree to 1e-5); ``fit`` with label slices (2 epochs of 3 Adam steps, the
host's negatives) and the clip route's ``fit``, 1e-5 on the epochs' costs
and accuracies and 1e-4 on the final parameters.  The sharded checkpoint
restores bitwise.  ``fit_resident`` draws its negatives on the device
from the port's own generators, so it is held to finite, falling costs
that agree across ranks.  The CLI's ``train`` (resident fit) → ``infer``
and ``retrain`` run under the launcher."""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.parallel.big_graph import EMBED
from torch_parallel_worker import launch_scenarios

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
FIT_PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
WORLDS = (2, 4)
V, C, DIM, E, L = 37, 2, 8, 150, 42
LABEL_BATCH = 16
# every encoder × halo once over the two world sizes (the embedding
# encoder aggregates nothing, so its halo is moot)
CASES = {2: [("embedding", "ring"), ("gcn", "ring"), ("gin", "allgather")],
         4: [("gin", "ring"), ("gcn", "allgather")]}
CLIP = {"gradient_clip": 0.05, "learning_rate": 0.01}


def _graph(seed):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, V, (C, E))
    r = rng.randint(0, V, (C, E))
    w = (rng.random_sample((C, E)) + 0.2).astype(np.float32)
    return s, r, w


def _labels():
    from kgcn_tpu.models.kg import sample_negatives

    rng = np.random.RandomState(3)
    pos = np.stack([rng.randint(0, V, L), rng.randint(0, C, L), rng.randint(0, V, L)], 1)
    return sample_negatives(np.concatenate([pos, pos], 1).astype(np.int32),
                            np.arange(V, dtype=np.int32), rng)


def _theta_name(k):
    """kgcn_tpu's theta key → the port's parameter name."""
    if k == "distmult":
        return "distmult.kernel"
    kind, i = k[:-1], int(k[-1])
    return f"conv{i + 1}." + {"w": "kernel", "b": "bias", "eps": "epsilon"}[kind]


def _flat(variables):
    return {k: v.numpy() for k, v in params_from_jax(variables["params"], {})["params"].items()}


def _jax_trainer(D, encoder, strategy, config=None):
    from kgcn_tpu.parallel.big_graph import BigGraphKGTrainer, _make_tx, _tx_shard_safe
    from kgcn_tpu.parallel.mesh import make_mesh

    cfg = config or {}
    bg = BigGraphKGTrainer(num_nodes=V, channels=C, embedding_dim=DIM,
                           mesh=make_mesh({"data": D}), encoder=encoder, strategy=strategy,
                           tx=_make_tx(cfg), tx_shard_safe=_tx_shard_safe(cfg))
    bg.partition_graph(*_graph(0))
    return bg


def _jax_side(D):
    ll = _labels()
    out, cases = {}, []
    for encoder, strategy in CASES[D]:
        bg = _jax_trainer(D, encoder, strategy)
        state = bg.init_state(seed=1)
        start = jax.device_get(bg.to_flax_variables(state))
        cases.append({"encoder": encoder, "strategy": strategy, "params": _flat(start)})
        g = bg.gradients(state, ll)
        grads = {EMBED: np.asarray(g["embed"])}
        grads.update({_theta_name(k): np.asarray(v) for k, v in g["theta"].items()})
        res = {"loss": bg.evaluate(state, ll)["cost"], "grads": grads}
        state, res["step"] = bg.train_step(state, ll)
        res["params"] = _flat(jax.device_get(bg.to_flax_variables(state)))
        res["z"] = bg.node_embeddings(state)
        out[f"{encoder}_{strategy}"] = res
    encoder, strategy = CASES[D][-1]
    bg = _jax_trainer(D, encoder, strategy)
    variables = jax.device_get(bg.to_flax_variables(bg.init_state(seed=1)))

    def start(trainer):  # the steps donate their input: fresh arrays each time
        return trainer.init_state(params=trainer.from_flax_variables(variables))

    state, out["fit"] = bg.fit(start(bg), ll[:, :3], epochs=2, seed=0,
                               label_batch_size=LABEL_BATCH)
    out["fit_params"] = _flat(jax.device_get(bg.to_flax_variables(state)))
    bg.partition_graph(*_graph(1))
    out["repartition_loss"] = bg.evaluate(start(bg), ll)["cost"]
    clip = _jax_trainer(D, encoder, strategy, CLIP)
    _, out["clip"] = clip.fit_resident(start(clip), ll[:, :3], epochs=2, seed=0)
    return out, cases


def _kg_configs(d, D):
    from kgcn_tpu_torch.data.synthetic import make_kg_dataset

    with open(d / "kg.jbl", "wb") as f:
        pickle.dump(make_kg_dataset(61, 3), f, protocol=4)
    with open(os.path.join(REPO, "example_config", "kg.json")) as f:
        cfg = json.load(f)
    cfg.pop("label_batch_size")
    cfg.update(dataset=str(d / "kg.jbl"), epoch=3, mesh={"data": D}, kg_encoder="gcn",
               learning_rate=0.05, save_model_path=str(d / "model"),
               save_info_train=str(d / "info_train.json"),
               save_info_test=str(d / "info_test.json"))
    (d / "kg.json").write_text(json.dumps(cfg))
    cfg.update(retrain=str(d / "model" / "model.big_graph.ckpt"), epoch=1,
               save_model_path=str(d / "model2"))
    (d / "kg_retrain.json").write_text(json.dumps(cfg))
    return str(d / "kg.json"), str(d / "kg_retrain.json")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    s2, r2, w2 = _graph(1)
    for D in WORLDS:
        d = tmp_path_factory.mktemp(f"bg{D}")
        jx, cases = _jax_side(D)
        s, r, w = _graph(0)
        config, retrain = _kg_configs(d, D)
        inputs = {"bg": {"kw": {"num_nodes": V, "channels": C, "embedding_dim": DIM},
                         "s": s, "r": r, "w": w, "s2": s2, "r2": r2, "w2": w2,
                         "ll": _labels(), "cases": cases, "label_batch": LABEL_BATCH,
                         "clip_config": CLIP, "dir": str(d)},
                  "bg_cli": {"config": config, "retrain_config": retrain}}
        out[D] = (jx, launch_scenarios(d, D, inputs), d)
    return out


def _rows(ranks, key, case):
    return np.concatenate([r[case][key][EMBED] for r in ranks])


@pytest.mark.parametrize("D,case", [(D, f"{e}_{s}") for D in WORLDS for e, s in CASES[D]])
def test_loss_gradients_and_a_step_match_jax(runs, D, case):
    jx, res, _ = runs[D]
    ranks, want = res["bg"], jx[case]
    r0 = ranks[0][case]
    np.testing.assert_allclose(r0["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(_rows(ranks, "grads", case), want["grads"][EMBED], **TOL)
    for k, v in want["grads"].items():
        if k != EMBED:
            for r in ranks:
                np.testing.assert_allclose(r[case]["grads"][k], v, err_msg=k, **TOL)
    np.testing.assert_allclose(r0["step"]["cost"], want["step"]["cost"], **TOL)
    assert r0["step"]["accuracy"] == pytest.approx(want["step"]["accuracy"])
    for k, v in want["params"].items():
        np.testing.assert_allclose(r0["params"][k], v, err_msg=k, **STEP_TOL)
    assert r0["params"][EMBED].shape == (V, DIM)  # padding rows stripped
    np.testing.assert_allclose(r0["z"], want["z"], **STEP_TOL)


@pytest.mark.parametrize("D", WORLDS)
def test_fit_with_label_slices_matches_jax(runs, D):
    jx, res, _ = runs[D]
    got = res["bg"][0]
    for g, w in zip(got["fit"], jx["fit"]):
        assert g["epoch"] == w["epoch"]
        np.testing.assert_allclose(g["train_cost"], w["train_cost"], **TOL)
        np.testing.assert_allclose(g["train_accuracy"], w["train_accuracy"], **TOL)
    for k, v in jx["fit_params"].items():
        np.testing.assert_allclose(got["fit_params"][k], v, err_msg=k, **FIT_PARAM_TOL)


@pytest.mark.parametrize("D", WORLDS)
def test_resident_fit_and_the_sharded_round_trip(runs, D):
    """fit_resident: finite costs, the same history on every rank; the
    sharded checkpoint (each rank its rows) restores bitwise."""
    _, res, d = runs[D]
    hists = [r["fit_resident"] for r in res["bg"]]
    assert len(hists[0]) == 2 and all(h == hists[0] for h in hists)
    assert all(np.isfinite(h["train_cost"]) for h in hists[0])
    for r in res["bg"]:
        rt = r["roundtrip"]
        assert rt["step"][0] == rt["step"][1] == 2

        def same(a, b):
            if isinstance(a, dict):
                assert set(a) == set(b)
                for k in a:
                    same(a[k], b[k])
            else:
                assert np.array_equal(np.asarray(a), np.asarray(b))

        same(rt["saved"], rt["back"])
        assert rt["saved"]["params"][EMBED].shape[0] == -(-V // D)
    assert len([f for f in os.listdir(d / "bg.ckpt") if f.endswith(".distcp")]) == D


@pytest.mark.parametrize("D", WORLDS)
def test_repartition_and_the_clip_route(runs, D):
    """A new partition replaces the old graph; a global-norm clip routes
    fit_resident to fit (kgcn_tpu's message) and matches kgcn_tpu's."""
    jx, res, _ = runs[D]
    got = res["bg"][0]
    np.testing.assert_allclose(got["repartition_loss"], jx["repartition_loss"], **TOL)
    assert "optimizer needs global norms" in got["clip"]["stdout"]
    for g, w in zip(got["clip"]["history"], jx["clip"]):
        np.testing.assert_allclose(g["train_cost"], w["train_cost"], **TOL)
        np.testing.assert_allclose(g["train_accuracy"], w["train_accuracy"], **TOL)


@pytest.mark.parametrize("D", WORLDS)
def test_cli_train_infer_retrain(runs, D):
    """``train`` with ``mesh``: the sharded checkpoint (one file a rank)
    and the single-device ``last`` checkpoint, which ``infer`` ranks with;
    ``retrain`` resumes from the sharded one."""
    _, res, d = runs[D]
    outs = [r["stdout"] for r in res["bg_cli"]]
    lines = [[ln for ln in o.splitlines() if ln.startswith("epoch")] for o in outs]
    assert len(lines[0]) == 4 and all(ls == lines[0] for ls in lines)
    assert f"[LOAD] {d / 'model' / 'model.big_graph.ckpt'}" in outs[0]
    assert "model.last.ckpt" in os.listdir(d / "model")
    assert len([f for f in os.listdir(d / "model" / "model.big_graph.ckpt")
                if f.endswith(".distcp")]) == D
    assert os.path.isdir(d / "model2" / "model.big_graph.ckpt")
    infer = res["bg_cli"][0]["infer"]
    assert infer["num_test_triples"] > 0 and 0.0 < infer["mrr"] <= 1.0
    assert json.loads((d / "info_train.json").read_text()).keys() == {
        "train_time", "ranking_accuracy"}
