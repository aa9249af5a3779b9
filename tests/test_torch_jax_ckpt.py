"""Checkpoints that the JAX package (``kgcn_tpu``) wrote, read by the port
(runtime/flax_msgpack.py, runtime/checkpoint.py, convert.py), on the CPU:

* ``cli.main infer`` of the port on a checkpoint of ``kgcn_tpu``'s
  ``train`` against ``kgcn_tpu``'s ``infer`` (predictions within 1e-5) for
  the GCN of solubility (the committed fixture), gcn_multimodal and the KG
  link predictor (its ranking metrics equal);
* the ``Predictor`` over a model directory of ``kgcn_tpu`` against
  ``kgcn_tpu``'s ``Predictor`` (1e-5), and ``retrain`` from the fixture;
* resuming: from one ``kgcn_tpu`` training checkpoint (dropout 0), the
  port's next 2 steps against ``kgcn_tpu``'s next 2 steps for every
  optimizer and chain the config allows (parameters within rtol 1e-5,
  atol 1e-5 = 1e-3 × the learning rate: the gradients agree to float32
  noise, 1e-8 on GraphConv_0's bias, which the adaptive optimizers divide
  by √ν, down to 1e-6 there, so two steps of Adam differ by up to 2e-6;
  step and epoch equal), and a mutation check: with the Adam moments of
  the Dense kernels left untransposed, the steps differ.
"""
import json
import os
import pickle
import sys

import jax
import joblib
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_gcn_solubility")
sys.path.insert(0, os.path.join(REPO, "tests", "fixtures"))
PRED_TOL = dict(rtol=1e-5, atol=1e-5)
RESUME_TOL = dict(rtol=1e-5, atol=1e-5)


def _config(src, tmp, side, **over):
    with open(os.path.join(REPO, "example_config", src)) as f:
        cfg = json.load(f)
    cfg.update(dataset=os.path.join(REPO, cfg["dataset"]),
               save_model_path=str(tmp / "model"),
               prediction_data=str(tmp / f"pred_{side}.jbl"),
               save_info_test=str(tmp / f"info_test_{side}.json"),
               save_info_valid=str(tmp / f"info_valid_{side}.json"), **over)
    path = tmp / f"{side}.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def _infer_both(tmp, src, **over):
    from kgcn_tpu.cli.main import main as j_main
    from kgcn_tpu_torch.cli.main import main as t_main

    _, jpath = _config(src, tmp, "jax", **over)
    tcfg, tpath = _config(src, tmp, "port", **over)
    j_main(["infer", "--config", jpath, "--cpu"])
    t_main(["infer", "--config", tpath, "--cpu"])
    with open(tmp / "info_test_jax.json") as f:
        want = json.load(f)
    with open(tmp / "info_test_port.json") as f:
        got = json.load(f)
    return got, want, tcfg


def test_infer_on_the_fixture_equals_kgcn_tpu_infer(tmp_path):
    """The committed checkpoint of ``kgcn_tpu train`` (solubility_cls.json,
    2 epochs): the whole dataset through both ``infer``s."""
    got, want, cfg = _infer_both(tmp_path, "solubility_cls.json",
                                 load_model=os.path.join(FIXTURE, "model.best.ckpt"))
    with open(cfg["prediction_data"], "rb") as f:
        pred = pickle.load(f)
    np.testing.assert_allclose(pred, joblib.load(tmp_path / "pred_jax.jbl"), **PRED_TOL)
    assert got["test_cost"] == pytest.approx(want["test_cost"], rel=1e-5)
    assert got["test_metrics"]["auc"] == pytest.approx(want["test_metrics"]["auc"],
                                                       rel=1e-5)


def test_multimodal_train_of_kgcn_tpu_infers_in_the_port(tmp_path):
    from kgcn_tpu.cli.main import main as j_main

    _, jpath = _config("multimodal.json", tmp_path, "jax", epoch=1, save_interval=0)
    j_main(["train", "--config", jpath, "--cpu"])
    assert os.path.exists(tmp_path / "model" / "model.best.ckpt")
    got, want, cfg = _infer_both(tmp_path, "multimodal.json")
    with open(cfg["prediction_data"], "rb") as f:
        pred = pickle.load(f)
    np.testing.assert_allclose(pred, joblib.load(tmp_path / "pred_jax.jbl"), **PRED_TOL)
    assert got["test_cost"] == pytest.approx(want["test_cost"], rel=1e-5)


def test_kg_train_of_kgcn_tpu_infers_in_the_port(tmp_path):
    from kgcn_tpu.cli.main import main as j_main
    from kgcn_tpu_torch.cli.main import main as t_main
    from test_torch_kg import _config as kg_config
    from test_torch_kg import _kg300, jax_globals

    with open(tmp_path / "kg.jbl", "wb") as f:
        pickle.dump(_kg300(), f, protocol=4)
    cfg = kg_config(dataset=str(tmp_path / "kg.jbl"), save_model_path=str(tmp_path / "model"),
                    kg_encoder="gcn", embedding_dim=16, epoch=1,
                    tiled_compute_dtype="float32")
    path = tmp_path / "kg.json"
    path.write_text(json.dumps(dict(cfg, save_info_test=str(tmp_path / "jax.json"))))
    with jax_globals():
        j_main(["train", "--config", str(path), "--cpu"])
        j_main(["infer", "--config", str(path), "--cpu"])
    with open(tmp_path / "jax.json") as f:
        want = json.load(f)
    path.write_text(json.dumps(cfg))
    got = t_main(["infer", "--config", str(path), "--cpu"])
    assert got["num_test_triples"] == want["num_test_triples"]
    for key in ("mean_rank", "mrr", "hits@1", "hits@10"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key


def test_predictor_over_a_kgcn_tpu_model_directory(tmp_path):
    """``save_model_path`` at the fixture: serve_info.json and the msgpack
    checkpoint as ``kgcn_tpu train`` left them; the recorded answers and
    ``kgcn_tpu``'s Predictor on other molecules."""
    from kgcn_tpu.runtime.serve import Predictor as JPredictor
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.runtime.serve import Predictor
    from make_jax_gcn_solubility import payload

    with open(os.path.join(REPO, "example_config", "solubility_cls.json")) as f:
        cfg = dict(json.load(f), save_model_path=FIXTURE)
    data = jbl.load(os.path.join(REPO, cfg["dataset"]))
    with open(os.path.join(FIXTURE, "predictions.json")) as f:
        recorded = json.load(f)
    port = Predictor(cfg, device="cpu")
    got = port.predict(payload(data, recorded["molecules"]))
    np.testing.assert_allclose(got["prediction"], recorded["prediction"], **PRED_TOL)
    body = payload(data, list(range(100, 141)))
    np.testing.assert_allclose(port.predict(body)["prediction"],
                               JPredictor(cfg).predict(body)["prediction"], **PRED_TOL)
    assert port.health()["checkpoint"] == os.path.join(FIXTURE, "model.best.ckpt")


def test_retrain_from_the_fixture_resumes_its_step_and_epoch(tmp_path, capsys):
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.runtime import checkpoint as ckpt
    from kgcn_tpu_torch.runtime import flax_msgpack

    raw = flax_msgpack.load(os.path.join(FIXTURE, "model.best.ckpt"))
    cfg, path = _config("solubility_cls.json", tmp_path, "port", epoch=int(raw["epoch"]) + 2,
                        save_interval=0, retrain=os.path.join(FIXTURE, "model.best.ckpt"))
    t_main(["train", "--config", path, "--cpu"])
    out = capsys.readouterr().out
    epochs = [line for line in out.splitlines() if line.startswith("epoch ")]
    assert [e.split(",")[0] for e in epochs] == [f"epoch {int(raw['epoch']) + 1}"]
    tree = ckpt.load_checkpoint(str(tmp_path / "model" / "model.last.ckpt"))
    from kgcn_tpu_torch.data.dataset import load_jbl

    num = load_jbl(cfg["dataset"], cfg)[0].num
    steps = -(-(num - int(num * 0.2)) // 32)  # one epoch of the training split
    assert int(tree["step"]) == int(raw["step"]) + steps
    assert np.isfinite(float(epochs[0].split("training cost ")[1].split()[0]))


# ---- resuming ---------------------------------------------------------------------

RESUME = {
    "adam": {},
    "adamw": {"optimizer": "adamw", "weight_decay": 0.01},
    "sgd": {"optimizer": "sgd"},
    "momentum": {"optimizer": "momentum"},
    "rmsprop": {"optimizer": "rmsprop"},
    "lamb": {"optimizer": "lamb", "weight_decay": 0.01},
    "adam_clip": {"gradient_clip": 0.05},
    "adam_weight_decay": {"weight_decay": 0.01},
    "adam_cosine": {"lr_schedule": "cosine", "decay_steps": 8},
    "adam_accum": {"grad_accum_steps": 2},
}
RESUME_CFG = {"model.py": "gcn", "task": "classification", "normalize_adj_flag": True,
              "learning_rate": 0.01, "dropout_rate": 0.0, "seed": 0}


def _resume_setup(tmp_path, name):
    """A JAX checkpoint after 3 steps (epoch 4), the JAX state's next two
    steps, and the batches: (path, jax params after, step, batches, cfg)."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset
    from kgcn_tpu.data.synthetic import make_ring_dataset
    from kgcn_tpu.models.registry import build_model
    from kgcn_tpu.runtime import checkpoint as jckpt
    from kgcn_tpu.runtime.train import Trainer

    cfg = dict(RESUME_CFG, **RESUME[name])
    data = make_ring_dataset(num_pairs=20, num_nodes=10, seed=0)
    ds, info = build_dataset(dict(data), cfg)
    jb = JBatcher(ds, info, 8)
    idx = [np.arange(s, s + 8) for s in range(0, 40, 8)]
    trainer = Trainer(build_model("gcn", info, cfg), cfg, info)
    state = trainer.init_state(jb.make_batch(idx[0]), seed=0)
    step = trainer.train_step
    for i in range(3):
        state, _, _ = step(state, jb.make_batch(idx[i]))
    path = jckpt.save_checkpoint(str(tmp_path / "jax.ckpt"),
                                 trainer.state_tree(state, 4, 0.5))
    for i in (3, 4):
        state, _, _ = step(state, jb.make_batch(idx[i]))
    return path, state, data, idx, cfg


def _port_steps(path, data, idx, cfg, mutate=None):
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    ds, info = build_dataset(dict(data), cfg)
    trainer = Trainer(build_model("gcn", info, cfg), cfg, info, device="cpu")
    state = trainer.restore(path)
    if mutate:
        mutate(trainer, state)
    start = (state.step, state.epoch)
    b = Batcher(ds, info, 8)
    for i in (3, 4):
        state, _, _ = trainer.train_step(state, b.make_batch(idx[i]))
    return trainer, state, start


def _assert_params(trainer, state, jstate):
    want = params_from_jax(jax.device_get(jstate.params), {}, trainer.model)["params"]
    for k, v in state.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k, **RESUME_TOL)


@pytest.mark.parametrize("name", sorted(RESUME))
def test_resume_from_a_kgcn_tpu_checkpoint_gives_its_next_two_steps(tmp_path, name):
    path, jstate, data, idx, cfg = _resume_setup(tmp_path, name)
    trainer, state, (step, epoch) = _port_steps(path, data, idx, cfg)
    assert (step, epoch) == (3, 5)
    assert state.step == int(jstate.step) == 5
    _assert_params(trainer, state, jstate)


def test_resume_fails_with_the_moments_left_untransposed(tmp_path):
    """The mutation check of the test above: Adam's mu of every Dense
    kernel in flax's [in, out] layout read as the port's [out, in] (the
    transposition dropped); the two steps then miss kgcn_tpu's."""
    path, jstate, data, idx, cfg = _resume_setup(tmp_path, "adam")

    def drop_mu_transpose(trainer, state):
        mu = state.opt_state["0"]["0"]["mu"]
        linear = {n + ".weight" for n, m in trainer.model.named_modules()
                  if isinstance(m, torch.nn.Linear)}
        assert linear and linear <= set(mu)
        for k in linear:
            mu[k] = mu[k].t().contiguous().reshape(mu[k].shape)

    trainer, state, _ = _port_steps(path, data, idx, cfg, mutate=drop_mu_transpose)
    with pytest.raises(AssertionError):
        _assert_params(trainer, state, jstate)


def test_orbax_directories_and_other_files_are_refused_clearly(tmp_path):
    """A directory is read as orbax (tests/test_torch_orbax.py) or refused
    as a big-graph DCP checkpoint; an empty one is neither and says so."""
    from kgcn_tpu_torch.runtime import checkpoint as ckpt

    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="neither an orbax checkpoint.*nor a big-graph"):
        ckpt.load_checkpoint(str(tmp_path / "orbax"))
    (tmp_path / "junk.ckpt").write_bytes(b"\xc1not a checkpoint")
    with pytest.raises(ValueError, match="neither"):
        ckpt.load_checkpoint(str(tmp_path / "junk.ckpt"))
    (tmp_path / "list.ckpt").write_bytes(b"\x91\x01")  # a msgpack array [1]
    with pytest.raises(ValueError, match="no checkpoint tree"):
        ckpt.load_checkpoint(str(tmp_path / "list.ckpt"))
    with pytest.raises(FileNotFoundError):
        ckpt.load_checkpoint(str(tmp_path / "missing.ckpt"))
