"""The port's tensor-parallel trainer (kgcn_tpu_torch/parallel/tp.py)
against the JAX package's (kgcn_tpu/parallel/tp.py), on the CPU.

The port runs as gloo ranks (world 2: ``{"model": 2}`` at min_dim 128 and
8; world 4: ``{"model": 4}``, ``{"data": 2, "model": 2}`` and an Adam step
with ``gradient_clip`` at ``{"model": 4}``; every scenario of a world size
in one launch, tests/torch_parallel_worker.py); ``kgcn_tpu``'s TPTrainer
runs here on as many virtual devices (tests/conftest.py), both from the
same weights (``params_from_jax``), data and batch: the ``gcn_multitask``
tower on three-task ring labels, whose 256-wide layers shard.
Tolerances are tests/test_tp.py's: the cost rtol 1e-4, the parameters
rtol 1e-4 and atol 1e-5 (against ``kgcn_tpu`` and against the port's
single-device Trainer); at T = 1 the step is bitwise the Trainer's."""
import json
import os

import jax
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.parallel import mesh as pmesh
from test_torch_tiled import jax_backend
from torch_parallel_worker import launch_scenarios

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COST = dict(rtol=1e-4)
PARAMS = dict(rtol=1e-4, atol=1e-5)
RING = dict(num_pairs=10, seed=0)  # 20 ring graphs of 10 nodes
TASKS = 3
ROWS = list(range(12))
SGD = 0.05
CLIP = 1e-3  # small enough that the clip acts
# scenario → (world, mesh, min_dim, optimizer)
RUNS = {
    "tp-T2": (2, {"model": 2}, 128, "sgd"),
    "tp-T2m8": (2, {"model": 2}, 8, "sgd"),
    "tp-T4": (4, {"model": 4}, 128, "sgd"),
    "tp-D2T2": (4, {"data": 2, "model": 2}, 128, "sgd"),
    "tp-adamT4": (4, {"model": 4}, 128, "adam"),
}


def _cfg(opt="sgd"):
    from kgcn_tpu.runtime.config import default_config

    cfg = default_config()
    cfg.update({"model.py": "gcn_multitask", "task": "multitask_classification",
                "save_interval": 0, "learning_rate": 0.01, "normalize_adj_flag": True,
                "spmm_backend": "dense", "seed": 0})
    if opt == "adam":
        cfg.update({"optimizer": "adam", "gradient_clip": CLIP})
    return cfg


def _ring_data():
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    data = make_ring_dataset(**RING)
    y = np.concatenate([data["label"][:, :1]] * TASKS, axis=1)
    data["label"], data["mask_label"] = y, np.ones_like(y, dtype=np.int64)
    return data


def _port_model(cfg, data=None):
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model

    ds, info = build_dataset(_ring_data() if data is None else data, cfg)
    return build_model(cfg["model.py"], info, cfg), ds, info


def _jax_step(axes, min_dim, opt):
    """kgcn_tpu's TPTrainer: (the initial tree, the step's cost, the tree
    after it), both trees in the port's layout."""
    import optax

    from kgcn_tpu.data import Batcher, build_dataset
    from kgcn_tpu.models.registry import build_model
    from kgcn_tpu.parallel.mesh import make_mesh
    from kgcn_tpu.parallel.tp import TPTrainer

    cfg = _cfg(opt)
    model, _, _ = _port_model(cfg)
    with jax_backend("dense"):
        ds, info = build_dataset(_ring_data(), cfg)
        tx = optax.sgd(SGD) if opt == "sgd" else None
        tp = TPTrainer(build_model("gcn_multitask", info, cfg), cfg, info, tx=tx,
                       mesh=make_mesh(axes), min_dim=min_dim)
        batch = Batcher(ds, info, len(ROWS), seed=0).make_batch(np.asarray(ROWS))
        state = tp.init_state(batch, seed=0)
        before = params_from_jax(jax.device_get(state.params),
                                 jax.device_get(state.batch_stats), model)
        state, cost, _ = tp.train_step(state, batch)
        after = params_from_jax(jax.device_get(state.params),
                                jax.device_get(state.batch_stats), model)
    return before, float(cost), after


# cli.main's mesh with a model axis: data parallel over "data" (of size 1
# where the mesh lacks it), the ranks of a model group replicas
# (kgcn_tpu/cli/main.py:119-145); case → (world, mesh)
CLI_MESHES = {"2": (2, {"data": 1, "model": 2}), "4": (4, {"data": 2, "model": 2}),
              "2-model": (2, {"model": 2})}


def _write_cli_config(d, mesh):
    import pickle

    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    d.mkdir()
    with open(d / "ring.jbl", "wb") as f:
        pickle.dump(make_ring_dataset(**RING), f, protocol=4)
    with open(os.path.join(REPO, "example_config", "synth.json")) as f:
        cfg = json.load(f)
    cfg.update(dataset=str(d / "ring.jbl"), epoch=2, batch_size=3, mesh=mesh,
               dropout_rate=0.0, make_plot=False)

    def write(name, **over):
        c = dict(cfg, save_model_path=str(d / name / "model"),
                 save_info_train=str(d / name / "info_train.json"),
                 save_info_valid=str(d / name / "info_valid.json"),
                 save_result_valid=str(d / name / "result_valid.csv"), **over)
        (d / name).mkdir()
        (d / name / "config.json").write_text(json.dumps(c))
        return str(d / name / "config.json")
    return write("port"), write("plain", mesh=None)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{scenario: (the JAX side, the ranks' outputs, the checkpoint)}; and
    ``"cli", case``: (the ranks' outputs, the mesh run's directory, the
    same run's without ``mesh``, in this process)."""
    from kgcn_tpu_torch.cli.main import main as port_main

    out, by_world = {}, {}
    for name, (world, axes, min_dim, opt) in RUNS.items():
        before, cost, after = _jax_step(axes, min_dim, opt)
        by_world.setdefault(world, {})[name] = (before, cost, after)
    for world, jx in by_world.items():
        d = tmp_path_factory.mktemp(f"tp{world}")
        inputs = {name: {"cfg": _cfg(RUNS[name][3]), "ring": RING, "tasks": TASKS,
                         "tree": before, "rows": ROWS, "mesh": RUNS[name][1],
                         "min_dim": RUNS[name][2], "ckpt": str(d / f"{name}.ckpt"),
                         "sgd": SGD if RUNS[name][3] == "sgd" else None}
                  for name, (before, _, _) in jx.items()}
        cli = {case: _write_cli_config(d / case, mesh)
               for case, (w, mesh) in CLI_MESHES.items() if w == world}
        for case, (mesh_cfg, _) in cli.items():
            inputs[f"dp_cli-{case}"] = {"config": mesh_cfg}
        res = launch_scenarios(d, world, inputs)
        for name in jx:
            out[name] = (jx[name], res[name], inputs[name]["ckpt"])
        for case, (_, plain_cfg) in cli.items():
            port_main(["train", "--config", plain_cfg, "--cpu"])
            out["cli", case] = (res[f"dp_cli-{case}"], d / case / "port", d / case / "plain")
    return out


def _single_step(tree, opt, tp_axes=None, min_dim=128):
    """The port's single-device Trainer (or, with ``tp_axes``, a TPTrainer
    in this plain process) one step from ``tree``."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.parallel.tp import TPTrainer
    from kgcn_tpu_torch.runtime.backend import Backend
    from kgcn_tpu_torch.runtime.optim import make_optimizer
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg = _cfg(opt)
    model, ds, info = _port_model(cfg)
    tx = make_optimizer({"optimizer": "sgd", "learning_rate": SGD}) if opt == "sgd" else None
    if tp_axes is None:
        tr = Trainer(model, cfg, info, device="cpu", tx=tx, capture=False)
    else:
        tr = TPTrainer(model, cfg, info, device="cpu", tx=tx,
                       mesh=pmesh.make_mesh(tp_axes), min_dim=min_dim)
    state = tr.state_from_tree(tree)
    batch = Batcher(ds, info, len(ROWS), seed=0,
                    backend=Backend("dense", "float32")).make_batch(np.asarray(ROWS))
    state, cost, _ = tr.train_step(state, batch)
    return tr, state, float(cost)


def _close(got, want, what):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), err_msg=f"{what} {k}", **PARAMS)


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_step_matches_jax(runs, name):
    """One step's cost and the gathered parameters and BN statistics on
    every rank against kgcn_tpu's TPTrainer on the same mesh."""
    (_, cost, after), ranks, _ = runs[name]
    for r in ranks:
        np.testing.assert_allclose(r["cost"], cost, **COST)
        _close(r["params"], after["params"], "params")
        _close(r["stats"], after["batch_stats"], "batch_stats")


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_step_matches_single_device(runs, name):
    """The same step against the port's single-device Trainer."""
    (before, _, _), ranks, _ = runs[name]
    _, state, cost = _single_step(before, RUNS[name][3])
    for r in ranks:
        np.testing.assert_allclose(r["cost"], cost, **COST)
        _close(r["params"], {k: v.numpy() for k, v in state.params.items()}, "params")


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_tp_at_one_rank_is_the_trainer_bitwise(runs, opt):
    """``{"model": 1}`` in a plain process: the column-parallel path with
    collectives of one rank gives the single-device Trainer's step bit for
    bit (min_dim 8: every wide-enough leaf takes the sharded route)."""
    before = runs["tp-T2"][0][0]
    _, s1, c1 = _single_step(before, opt)
    tr, s2, c2 = _single_step(before, opt, {"model": 1}, min_dim=8)
    assert sum(v is not None for v in tr.rules.values()) >= 5
    assert c1 == c2
    for k in s1.params:
        assert torch.equal(s1.params[k], s2.params[k]), k
    for k in s1.batch_stats:
        assert torch.equal(s1.batch_stats[k], s2.batch_stats[k]), k


def test_tp_adam_clip_shards_a_quarter(runs):
    """The Adam step with gradient_clip at T = 4: each rank holds a quarter
    of the sharded leaves' parameter and moment bytes (the clip's global
    norm sums each sharded leaf once over the model group: the step
    matches above)."""
    (before, _, _), ranks, _ = runs["tp-adamT4"]
    sharded = [k for k, v in ranks[0]["rules"].items() if v]
    assert {k.split(".")[0] for k in sharded} == {"GraphConv_0", "GraphConv_1",
                                                  "GraphDense_0"}
    whole = sum(before["params"][k].numel() * 4 for k in sharded)
    for r in ranks:
        assert r["local_bytes"]["params"] * 4 == whole
        assert r["local_bytes"]["moments"] * 4 == 2 * whole


@pytest.mark.parametrize("name", ["tp-T2", "tp-adamT4"])
def test_tp_checkpoint_loads_into_the_trainer(runs, name):
    """Rank 0 wrote the gathered full tree: the single-device Trainer
    restores it, parameters and optimizer state, as the ranks held them."""
    from kgcn_tpu_torch.runtime.optim import make_optimizer
    from kgcn_tpu_torch.runtime.train import Trainer

    _, ranks, path = runs[name]
    opt = RUNS[name][3]
    cfg = _cfg(opt)
    model, _, info = _port_model(cfg)
    tx = make_optimizer({"optimizer": "sgd", "learning_rate": SGD}) if opt == "sgd" else None
    state = Trainer(model, cfg, info, device="cpu", tx=tx).restore(path)
    for k, v in state.params.items():
        assert np.array_equal(v.numpy(), ranks[0]["params"][k]), k
    assert state.step == 1


@pytest.mark.parametrize("min_dim", [128, 8])
@pytest.mark.parametrize("T", [2, 4])
def test_param_sharding_rules_match_jax(min_dim, T):
    """The shard/replicate choice on gcn_multitask and gcn: the port's rule
    on its own leaves against kgcn_tpu's on the flax leaves (an
    ``nn.Linear`` weight decides by its output dim, flax's last)."""
    from jax.sharding import PartitionSpec as P

    from kgcn_tpu.data import Batcher, build_dataset
    from kgcn_tpu.data.synthetic import make_ring_dataset
    from kgcn_tpu.models.registry import build_model
    from kgcn_tpu.parallel.mesh import make_mesh
    from kgcn_tpu.parallel.tp import param_sharding_rules as jax_rules
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.parallel.tp import param_sharding_rules

    for model_name in ("gcn_multitask", "gcn"):
        cfg = dict(_cfg(), **{"model.py": model_name})
        if model_name == "gcn":
            cfg["task"] = "classification"
        data = _ring_data() if model_name == "gcn_multitask" else make_ring_dataset(**RING)
        port, _, _ = _port_model(cfg, data)
        with jax_backend("dense"):
            ds, info = build_dataset(data, cfg)
            tr = JTrainer(build_model(model_name, info, cfg), cfg, info)
            state = tr.init_state(Batcher(ds, info, 4, seed=0).make_batch(np.arange(4)),
                                  seed=0)
            specs = jax_rules(jax.device_get(state.params), make_mesh({"model": T}),
                              min_dim=min_dim)
        want = params_from_jax(jax.tree_util.tree_map(lambda s: float(s.spec != P()), specs),
                               {}, port)["params"]
        mesh = pmesh.Mesh(shape={"model": T}, rank=0)
        got = param_sharding_rules(dict(port.named_parameters()), mesh, min_dim=min_dim,
                                   model=port)
        assert set(got) == set(want)
        for k, w in want.items():
            assert (got[k] is not None) == bool(w.reshape(-1)[0]), (model_name, k)


@pytest.mark.parametrize("case", list(CLI_MESHES))
def test_cli_mesh_with_a_model_axis(runs, case):
    """``cli.main train`` with ``{"data": 1, "model": 2}``, ``{"model": 2}``
    and ``{"data": 2, "model": 2}``: every rank prints the same epochs (a
    model group's ranks are replicas of one data-parallel rank) and rank 0
    writes the files; at a data axis of 1, or none, the costs are the
    run's without ``mesh`` (1e-6, tests/test_torch_parallel.py's
    ``SAME``)."""
    ranks, mesh_run, plain = runs["cli", case]
    epochs = [[ln for ln in r["stdout"].splitlines() if ln.startswith("epoch")]
              for r in ranks]
    assert len(epochs[0]) == 2 and all(e == epochs[0] for e in epochs)
    assert "[SAVE]" in ranks[0]["stdout"]
    assert all("[SAVE]" not in r["stdout"] for r in ranks[1:])
    assert sorted(os.listdir(mesh_run / "model")) == ["model.best.ckpt",
                                                      "model.last.ckpt", "serve_info.json"]
    got, want = (json.loads((p / "info_train.json").read_text()) for p in (mesh_run, plain))
    assert np.isfinite(got["training_cost"]).all()
    if CLI_MESHES[case][1].get("data", 1) == 1:
        np.testing.assert_allclose(got["training_cost"], want["training_cost"], rtol=1e-6)
