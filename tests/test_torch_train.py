"""The port's training path (runtime/optim.py, runtime/train.py,
runtime/checkpoint.py, cli/main.py) against the JAX package, on the CPU.

* optimizers and schedules against optax over a few updates (float32,
  rtol 1e-5: the same formulas, evaluated in another order);
* three ``train_step``s of the GCN (solubility, 64 molecules, full width)
  on the tiled and the dense backend and of the GAT (synthetic.jbl) on the
  tiled backend, from the same weights (``params_from_jax``), dropout 0 and
  the float32 payload: parameters at rtol 2e-4, atol 2e-5, the precedent of
  tests/test_tiled_spmm.py:264 for three Adam steps;
* ``fit``'s checkpoints and resume, and ``cli.main train --cpu``'s files.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.runtime import optim as topt
from test_torch_tiled import jax_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = dict(rtol=2e-4, atol=2e-5)


# ---- optimizers ------------------------------------------------------------

OPTIMIZERS = {
    "adam": {},
    "adam_weight_decay": {"weight_decay": 0.01},
    "adamw": {"optimizer": "adamw", "weight_decay": 0.01},
    "adam_clip": {"gradient_clip": 0.1},
    "sgd": {"optimizer": "sgd"},
    "sgd_decay_clip": {"optimizer": "sgd", "weight_decay": 0.05, "gradient_clip": 0.5},
    "momentum": {"optimizer": "momentum"},
    "rmsprop": {"optimizer": "rmsprop"},
    "lamb": {"optimizer": "lamb", "weight_decay": 0.01},
    "grad_accum": {"grad_accum_steps": 3},
    "cosine": {"lr_schedule": "cosine", "decay_steps": 4},
    "warmup_cosine": {"lr_schedule": "warmup_cosine", "warmup_steps": 2, "decay_steps": 6},
    "exponential": {"optimizer": "sgd", "lr_schedule": "exponential", "decay_steps": 2,
                    "decay_rate": 0.5},
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizer_matches_optax(name):
    from kgcn_tpu.runtime.optim import make_optimizer as j_make

    cfg = dict(OPTIMIZERS[name], learning_rate=0.1)
    rng = np.random.RandomState(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": np.zeros(5, np.float32)}  # a zero tensor: LAMB's ratio of 1
    jtx, ttx = j_make(cfg), topt.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    jstate, tstate = jtx.init(jp), ttx.init(tp)
    for step in range(7):
        grads = {k: (rng.standard_normal(v.shape) * (step + 1)).astype(np.float32)
                 for k, v in params.items()}
        upd, jstate = jtx.update({k: jnp.asarray(g) for k, g in grads.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tupd, tstate = ttx.update({k: torch.from_numpy(g) for k, g in grads.items()},
                                  tstate, tp)
        tp = {k: tp[k] + tupd[k] for k in tp}
        for k in params:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{name} step {step} {k}")


@pytest.mark.parametrize("kind,cfg", [
    ("cosine", {"decay_steps": 7}),
    ("warmup_cosine", {"warmup_steps": 3, "decay_steps": 9}),
    ("exponential", {"decay_steps": 3, "decay_rate": 0.7}),
])
def test_schedule_matches_optax(kind, cfg):
    from kgcn_tpu.runtime.optim import make_schedule as j_sched

    cfg = dict(cfg, lr_schedule=kind, learning_rate=0.05)
    js, ts = j_sched(cfg), topt.make_schedule(cfg)
    for count in range(12):
        assert ts(count) == pytest.approx(float(js(jnp.asarray(count, jnp.int32))),
                                          rel=1e-6, abs=1e-9)
    assert topt.make_schedule({"learning_rate": 0.3}) == 0.3


# ---- train steps against the JAX Trainer --------------------------------------


def _spread(num, n):
    """``n`` example indices spread over a dataset of ``num`` (the shipped
    datasets are sorted by class, so their first examples are one class)."""
    return np.linspace(0, num - 1, n).astype(np.int64)


def _pair(config_file, backend, n, overrides=None):
    """The JAX and port (config, info, batches) of ``n`` examples spread
    over a shipped config's dataset, batched alike."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import load_jbl as j_load
    from kgcn_tpu.runtime.config import load_config as j_config
    from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
    from kgcn_tpu_torch.data.dataset import load_jbl as t_load
    from kgcn_tpu_torch.runtime.backend import Backend

    over = dict(dropout_rate=0.0, spmm_backend=backend,
                tiled_compute_dtype="float32", **(overrides or {}))
    cfg = j_config(os.path.join(REPO, config_file), over)
    bs = int(cfg["batch_size"])
    path = os.path.join(REPO, cfg["dataset"])
    jds, jinfo = j_load(path, cfg)
    tds, tinfo = t_load(path, cfg)
    idx = _spread(jds.num, n)
    jds, tds = jds.subset(idx), tds.subset(idx)
    with jax_backend(backend, "float32"):
        jb = JBatcher(jds, jinfo, bs, seed=0)
        jbatches = list(jb.batches(shuffle=False))
    tb = TBatcher(tds, tinfo, bs, seed=0, backend=Backend(backend, "float32"))
    tbatches = list(tb.batches(shuffle=False))
    return cfg, jinfo, jbatches, tinfo, tbatches


@pytest.mark.parametrize("config_file,model,backend,n", [
    ("example_config/solubility_cls.json", "gcn", "tiled", 64),
    ("example_config/solubility_cls.json", "gcn", "dense", 64),
    ("example_config/gat.json", "gat", "tiled", 50),
])
def test_train_steps_match_jax(config_file, model, backend, n):
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.models.registry import build_model as t_build
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    cfg, jinfo, jbatches, tinfo, tbatches = _pair(config_file, backend, n)
    assert cfg["model.py"] == model
    if backend == "tiled":
        assert tbatches[0].graph.tiled_adj is not None
    order = [0, 1, 0]
    with jax_backend(backend, "float32"):
        jtr = JTrainer(j_build(model, jinfo, cfg), cfg, jinfo)
        jstate = jtr.init_state(jbatches[0], seed=0)
        tree = params_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
        jcosts = []
        for i in order:
            jstate, cost, _ = jtr.train_step(jstate, jbatches[i])
            jcosts.append(float(cost))
        want = params_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    ttr = TTrainer(t_build(model, tinfo, cfg), cfg, tinfo, device="cpu")
    tstate = ttr.state_from_tree(tree)
    tcosts = []
    for i in order:
        tstate, cost, _ = ttr.train_step(tstate, tbatches[i])
        tcosts.append(float(cost))
    np.testing.assert_allclose(tcosts, jcosts, **STEP_TOL)
    assert set(tstate.params) == set(want["params"])
    for group, got in (("params", tstate.params), ("batch_stats", tstate.batch_stats)):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[group][k].numpy(),
                                       err_msg=f"{group} {k}", **STEP_TOL)
    assert tstate.step == 3


# ---- fit, checkpoints, resume -------------------------------------------------


def _port_fit(tmp, epochs, resume_from=None):
    """Fit the solubility GCN (64 molecules, dropout 0.2 from the state's
    generator, tiled backend) for ``epochs`` epochs into ``tmp``."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import load_jbl, split_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import backend
    from kgcn_tpu_torch.runtime.config import load_config
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg = load_config(os.path.join(REPO, "example_config/solubility_cls.json"), {
        "spmm_backend": "tiled", "epoch": epochs, "save_interval": 1,
        "shuffle_data": True, "save_model_path": str(tmp)})
    ds, info = load_jbl(os.path.join(REPO, cfg["dataset"]), cfg)
    be = backend.resolve(cfg, info, log=False)
    train, valid, _, _ = split_dataset(ds.subset(_spread(ds.num, 64)), 0.25, seed=0)
    trainer = Trainer(build_model("gcn", info, cfg), cfg, info, device="cpu")
    state = trainer.init_state(seed=0)
    if resume_from:
        state = trainer.restore(resume_from)
    logs = []
    trainer.fit(state, Batcher(train, info, 32, backend=be),
                Batcher(valid, info, 32, backend=be), log=logs.append)
    return logs


def test_fit_writes_checkpoints_and_resumes_the_same_trajectory(tmp_path):
    from kgcn_tpu_torch.runtime import checkpoint as ckpt

    straight = _port_fit(tmp_path / "straight", 4)
    names = sorted(os.listdir(tmp_path / "straight"))
    assert names == ["model.00001.ckpt", "model.00002.ckpt", "model.00003.ckpt",
                     "model.00004.ckpt", "model.best.ckpt", "model.last.ckpt"]
    assert any(line.startswith("[restore] best epoch") for line in straight)
    last = ckpt.load_checkpoint(str(tmp_path / "straight" / "model.last.ckpt"))
    assert set(last) == ckpt.FULL_KEYS and int(last["epoch"]) == 3

    _port_fit(tmp_path / "resumed", 2)
    resumed = _port_fit(tmp_path / "resumed", 4,
                        resume_from=str(tmp_path / "resumed" / "model.last.ckpt"))
    assert [line.split(",")[0] for line in resumed if line.startswith("epoch")] == [
        "epoch 2", "epoch 3"]
    def epochs(logs):
        # the epoch lines' costs and accuracies; the early-stopping count
        # restarts with a resumed fit, as in kgcn_tpu
        return [line.split(" (count=")[0] for line in logs if line.startswith("epoch")]

    assert epochs(resumed) == epochs(straight)[2:]
    again = ckpt.load_checkpoint(str(tmp_path / "resumed" / "model.last.ckpt"))
    assert int(again["step"]) == int(last["step"]) == 8
    for group in ("params", "batch_stats"):
        for k, v in last[group].items():
            torch.testing.assert_close(again[group][k], v, rtol=0, atol=0)


def test_serving_checkpoints_still_load(tmp_path):
    """A ``{"params", "batch_stats"}`` file (what the serving slice wrote)
    restores with a fresh optimizer state."""
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import checkpoint as ckpt
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg = {"model.py": "gcn", "normalize_adj_flag": True}
    _, info = load_jbl(os.path.join(REPO, "example_jbl/synthetic.jbl"), cfg)
    trainer = Trainer(build_model("gcn", info, cfg), cfg, info, device="cpu")
    state = trainer.init_state(seed=1)
    path = ckpt.save_checkpoint(str(tmp_path / "m.ckpt"), state.params, state.batch_stats)
    back = trainer.restore(path)
    assert back.epoch == 0 and back.step == 0
    for k, v in state.params.items():
        torch.testing.assert_close(back.params[k], v)


def test_a_gpu_training_checkpoint_restores_on_the_cpu(tmp_path):
    """A CUDA generator's state is 16 bytes, a CPU one's 5056: a training
    checkpoint written on the card restores on the CPU with every other
    part of its state, and the CPU generator stays seeded."""
    from kgcn_tpu_torch.data.dataset import load_jbl
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import checkpoint as ckpt
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg = {"model.py": "gat", "normalize_adj_flag": True}
    _, info = load_jbl(os.path.join(REPO, "example_jbl/synthetic.jbl"), cfg)
    trainer = Trainer(build_model("gat", info, cfg), cfg, info, device="cpu")
    state = trainer.init_state(seed=3)
    tree = trainer.state_tree(state, epoch=4, best_cost=0.5)
    tree["rng"] = torch.zeros(16, dtype=torch.uint8)  # a CUDA generator's state
    tree["step"] = torch.tensor(11)
    path = ckpt.save_tree(str(tmp_path / "gpu.ckpt"), tree)
    back = trainer.restore(path)
    assert (back.epoch, back.step) == (5, 11)
    torch.testing.assert_close(back.rng.get_state(),
                               torch.Generator().manual_seed(0).get_state())
    for k, v in state.params.items():
        torch.testing.assert_close(back.params[k], v)


# ---- the CLI ----------------------------------------------------------------


def _write_config(tmp, name, **over):
    with open(os.path.join(REPO, "example_config", name)) as f:
        cfg = json.load(f)
    cfg.update(over)
    cfg.update({
        "dataset": os.path.join(REPO, cfg["dataset"]),
        "save_model_path": str(tmp / "model"),
        "save_info_valid": str(tmp / "info_valid.json"),
        "save_result_valid": str(tmp / "result_valid.csv"),
        "save_info_train": str(tmp / "info_train.json"),
    })
    path = tmp / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_cli_train_writes_the_jax_runs_files(tmp_path, capsys):
    """``train --cpu`` on the GAT config writes the JAX CLI's files with its
    keys, the metric battery (``valid_metrics``) included."""
    from kgcn_tpu.cli.main import cmd_train as j_cmd_train
    from kgcn_tpu.runtime.config import load_config as j_config
    from kgcn_tpu_torch.cli.main import main as t_main

    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    j_cmd_train(j_config(_write_config(tmp_path / "jax", "gat.json", epoch=1)))
    t_main(["train", "--config", _write_config(tmp_path / "port", "gat.json", epoch=2,
                                               spmm_backend="tiled"), "--cpu"])
    out = capsys.readouterr().out
    assert "[spmm] backend: tiled" in out and "[restore] best epoch" in out
    assert f"[SAVE] {tmp_path / 'port' / 'info_valid.json'}" in out

    def load(side, name):
        with open(tmp_path / side / name) as f:
            return json.load(f)

    jv, tv = load("jax", "info_valid.json"), load("port", "info_valid.json")
    assert set(tv) == set(jv)
    assert set(tv["validation_accuracy"]) == set(jv["validation_accuracy"])
    assert set(tv["valid_metrics"]) == set(jv["valid_metrics"])
    assert set(load("port", "info_train.json")) == set(load("jax", "info_train.json"))
    jrows = np.loadtxt(tmp_path / "jax" / "result_valid.csv", delimiter=",")
    trows = np.loadtxt(tmp_path / "port" / "result_valid.csv", delimiter=",")
    assert trows.shape == jrows.shape
    np.testing.assert_allclose(trows.sum(axis=1), 1.0, atol=1e-4)
    assert sorted(os.listdir(tmp_path / "port" / "model")) == [
        "model.best.ckpt", "model.last.ckpt", "serve_info.json"]

    # the Predictor serves the training checkpoint the run wrote
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.runtime.serve import Predictor

    data = jbl.load(os.path.join(REPO, "example_jbl/synthetic.jbl"))
    body = {"feature": data["feature"][:3], "dense_adj": data["dense_adj"][:3],
            "max_node_num": data["max_node_num"]}
    served = Predictor({"save_model_path": str(tmp_path / "port" / "model"),
                        "normalize_adj_flag": True}, device="cpu").predict_data(body)
    assert served["checkpoint"].endswith("model.best.ckpt")
    np.testing.assert_allclose(np.sum(served["prediction"], axis=1), 1.0, atol=1e-5)


def test_cli_refuses_what_is_not_ported(tmp_path):
    """What the port still refuses (TensorFlow's SavedModel; a ``mesh``
    larger than the world, naming the launcher); ``fold_parallel``
    ``"force"``, ``precision`` and the KG route of ``visualize`` now run
    (tests/test_torch_fold_parallel.py, test_torch_precision.py,
    test_torch_kg_ig.py)."""
    from kgcn_tpu_torch.cli.main import main as t_main

    cfg = _write_config(tmp_path, "gat.json", epoch=1, fold_parallel="force",
                        **{"k-fold_num": 2})
    summary = t_main(["train_cv", "--config", cfg, "--cpu"])
    assert [f["fold"] for f in summary["folds"]] == [0, 1]
    assert {"model.0.best.ckpt", "model.1.last.ckpt"} <= set(os.listdir(tmp_path / "model"))
    with pytest.raises(NotImplementedError, match="not ported"):
        t_main(["train", "--config", _write_config(
            tmp_path, "gat.json", epoch=1, export_savedmodel=str(tmp_path / "m")), "--cpu"])
    with pytest.raises(ValueError, match="world of 1.*kgcn-torch-launch --nprocs 2"):
        t_main(["train", "--config", _write_config(tmp_path, "gat.json", epoch=1,
                                                   mesh={"data": 2}), "--cpu"])
    from kgcn_tpu_torch.runtime.device import set_precision

    try:
        for precision in ("bfloat16", "highest", "default"):
            result = t_main(["train", "--config", _write_config(
                tmp_path, "gat.json", epoch=1, precision=precision), "--cpu"])
            assert np.isfinite(result["validation_cost"]), precision
    finally:
        set_precision("float32")
