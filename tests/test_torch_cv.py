"""The port's cross-validation (kgcn_tpu_torch/data/dataset.py
``kfold_indices``, cli/main.py ``cmd_train_cv``) against the JAX package,
on the CPU.

The folds are the data: ``kfold_indices``, plain and stratified, must give
``kgcn_tpu.data.kfold_indices``'s (scikit-learn's ``KFold`` /
``StratifiedKFold`` with ``shuffle=True``) index for index, for several n,
k and seeds.  ``train_cv`` through the port's CLI (2 folds, 1 epoch,
dropout 0) writes the JAX run's files and keys; with each fold's initial
weights carried over from the JAX run's (``params_from_jax``: the two
packages draw different weights from one seed), the per-fold test costs
agree to 1e-4 and the per-fold predictions to 1e-4, the precedent of
tests/test_torch_resident.py for whole epochs.  The JAX side trains the
folds one after another (``fold_parallel`` false: its default "auto" takes
the fold-parallel path on the test suite's 8 virtual devices).
"""
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.data.dataset import kfold_indices
from test_torch_tiled import jax_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLITS = [(2, 2, 0), (10, 3, 0), (100, 5, 7), (101, 3, 1), (623, 3, 0), (37, 4, 123)]


def _same_folds(got, want):
    assert len(got) == len(want)
    for (tr, te), (jtr, jte) in zip(got, want):
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(te, jte)


@pytest.mark.parametrize("n,k,seed", SPLITS)
def test_kfold_matches_jax(n, k, seed):
    from kgcn_tpu.data import kfold_indices as j_kfold

    got = kfold_indices(n, k, seed)
    _same_folds(got, j_kfold(n, k, seed=seed))
    test = np.concatenate([te for _, te in got])
    assert sorted(test.tolist()) == list(range(n))


@pytest.mark.parametrize("n,k,seed", SPLITS[1:])
@pytest.mark.parametrize("classes", [2, 3])
def test_stratified_kfold_matches_jax(n, k, seed, classes):
    from kgcn_tpu.data import kfold_indices as j_kfold

    rng = np.random.RandomState(seed + classes)
    y = rng.randint(0, classes, n)
    y[:k] = 0  # every split has enough of class 0
    _same_folds(kfold_indices(n, k, seed, stratify=y), j_kfold(n, k, seed=seed, stratify=y))


def test_kfold_refuses_as_sklearn_does():
    from sklearn.model_selection import KFold, StratifiedKFold

    for n, k in ((3, 4), (5, 1)):
        with pytest.raises(ValueError):
            list(KFold(k, shuffle=True, random_state=0).split(np.zeros(n)))
        with pytest.raises(ValueError):
            kfold_indices(n, k)
    y = np.array([0, 0, 0, 1, 1, 1])  # fewer members than splits in every class
    with pytest.raises(ValueError):
        list(StratifiedKFold(4, shuffle=True, random_state=0).split(np.zeros(6), y))
    with pytest.raises(ValueError):
        kfold_indices(6, 4, stratify=y)


def _subset_file(tmp, path, n):
    """The first ``n`` examples (spread over the dataset) as a plain pickle."""
    from kgcn_tpu_torch.data import jbl

    data = jbl.load(os.path.join(REPO, path))
    num = len(data["label"])
    idx = np.linspace(0, num - 1, n).astype(np.int64)
    out = {}
    for key, val in data.items():
        if isinstance(val, list):
            out[key] = [val[i] for i in idx]
        elif isinstance(val, np.ndarray) and val.ndim and len(val) == num:
            out[key] = val[idx]
        else:
            out[key] = val
    target = tmp / "data.jbl"
    with open(target, "wb") as f:
        pickle.dump(out, f, protocol=4)
    return str(target)


def _cv_config(tmp, side, src, dataset):
    with open(os.path.join(REPO, "example_config", src)) as f:
        cfg = json.load(f)
    d = tmp / side
    d.mkdir()
    cfg.update({"dataset": dataset, "k-fold_num": 2, "epoch": 1, "dropout_rate": 0.0,
                "fold_parallel": False, "make_plot": False,
                "save_model_path": str(d / "model"),
                "save_info_cv": str(d / "info_cv.json"),
                "save_result_cv": str(d / "result_cv.json"),
                "save_result_test": str(d / "result_test.csv")})
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("src,data,n,metric", [
    ("synth.json", "example_jbl/synthetic.jbl", None, "accuracy"),
    ("solubility_reg.json", "examples/solubility/solubility_reg.jbl", 96, "mse"),
])
def test_train_cv_matches_jax(tmp_path, monkeypatch, src, data, n, metric):
    from kgcn_tpu.cli.main import cmd_train_cv as j_train_cv
    from kgcn_tpu.runtime.config import load_config as j_config
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    dataset = (_subset_file(tmp_path, data, n) if n else os.path.join(REPO, data))
    initial = {}
    j_init = JTrainer.init_state

    def record(self, sample, seed=0):
        state = j_init(self, sample, seed=seed)
        initial[seed] = params_from_jax(jax.device_get(state.params),
                                        jax.device_get(state.batch_stats))
        return state

    monkeypatch.setattr(JTrainer, "init_state", record)
    cfg = j_config(_cv_config(tmp_path, "jax", src, dataset))
    with jax_backend("dense"):
        want = j_train_cv(cfg)
    seed = int(cfg["seed"])
    assert sorted(initial) == [seed, seed + 1]  # fold f draws from seed + f

    monkeypatch.setattr(TTrainer, "init_state",
                        lambda self, seed=0: self.state_from_tree(initial[seed], seed=seed))
    got = t_main(["train_cv", "--config", _cv_config(tmp_path, "port", src, dataset),
                  "--cpu"])

    assert set(got) == set(want) == {"folds", f"mean_{metric}", f"std_{metric}"}
    for side, result in (("jax", want), ("port", got)):
        for name in ("info_cv.json", "result_cv.json"):
            with open(tmp_path / side / name) as f:
                assert json.load(f).keys() == result.keys()
    for g, w in zip(got["folds"], want["folds"]):
        assert set(g) == set(w) == {"fold", "test_cost", f"test_{metric}", "test_metrics"}
        assert set(g["test_metrics"]) == set(w["test_metrics"])
        np.testing.assert_allclose(g["test_cost"], w["test_cost"], rtol=1e-4)
        np.testing.assert_allclose(g[f"test_{metric}"], w[f"test_{metric}"], rtol=1e-4)
        f = g["fold"]
        rows = [np.loadtxt(tmp_path / side / f"result_test.fold{f}.csv", delimiter=",")
                for side in ("port", "jax")]
        np.testing.assert_allclose(rows[0], rows[1], atol=1e-4)
    # the folds' checkpoints are named by fold
    names = set(os.listdir(tmp_path / "port" / "model"))
    assert {"model.0.best.ckpt", "model.1.best.ckpt", "model.0.last.ckpt",
            "model.1.last.ckpt"} <= names


def test_train_cv_refuses_fold_parallel_force(tmp_path, monkeypatch, capsys):
    """``fold_parallel: "force"`` (which the port no longer refuses) trains
    the folds through ``parallel/cv.FoldParallelCV`` in a world of one and
    writes the sequential protocol's files (the folds' checkpoints, the
    summary's keys, each fold's test predictions); from kgcn_tpu's initial
    states its folds' test costs are kgcn_tpu's fold-parallel ones (1e-4:
    two folds of one epoch of Adam steps)."""
    from kgcn_tpu.cli.main import cmd_train_cv as j_train_cv
    from kgcn_tpu.runtime.config import load_config as j_config
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.cli.main import cmd_train_cv
    from kgcn_tpu_torch.runtime.config import load_config as t_config
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    dataset = os.path.join(REPO, "example_jbl/synthetic.jbl")
    initial = {}
    j_init = JTrainer.init_state

    def record(self, sample, seed=0):
        state = j_init(self, sample, seed=seed)
        initial[seed] = params_from_jax(jax.device_get(state.params),
                                        jax.device_get(state.batch_stats))
        return state

    monkeypatch.setattr(JTrainer, "init_state", record)
    jcfg = j_config(_cv_config(tmp_path, "jax", "synth.json", dataset))
    jcfg["fold_parallel"] = "force"
    with jax_backend("dense"):
        want = j_train_cv(jcfg)
    monkeypatch.setattr(TTrainer, "init_state",
                        lambda self, seed=0: self.state_from_tree(initial[seed], seed=seed))
    results = {}
    for side, flag in (("sequential", False), ("port", "force")):
        cfg = t_config(_cv_config(tmp_path, side, "synth.json", dataset))
        cfg["fold_parallel"] = flag
        results[side] = cmd_train_cv(cfg, device="cpu")
    assert "[fold_parallel] 2 folds over 1 rank(s)" in capsys.readouterr().out
    got, seq = results["port"], results["sequential"]
    assert set(got) == set(seq) == set(want)
    for side in ("port", "sequential"):
        assert sorted(os.listdir(tmp_path / side / "model")) == [
            "model.0.best.ckpt", "model.0.last.ckpt", "model.1.best.ckpt",
            "model.1.last.ckpt"]
        assert sorted(f for f in os.listdir(tmp_path / side) if f != "model") == [
            "config.json", "info_cv.json", "result_cv.json", "result_test.fold0.csv",
            "result_test.fold1.csv"]
    for g, s_, w in zip(got["folds"], seq["folds"], want["folds"]):
        assert set(g) == set(s_) == set(w)
        np.testing.assert_allclose(g["test_cost"], w["test_cost"], rtol=1e-4, atol=1e-4)


def test_make_plot_writes_the_jax_plots(tmp_path):
    """``train`` with ``make_plot`` (synth.json, 1 epoch) writes the plots
    that the JAX CLI writes for the same config (the cost curve and the
    ROC curves, PNG); ``plot_r2`` writes the R² scatter.  The GPU machine
    may lack matplotlib, so the plot files are checked here."""
    from kgcn_tpu.cli.main import cmd_train as j_cmd_train
    from kgcn_tpu.runtime.config import load_config as j_config
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.tools import plots

    paths = {}
    for side in ("jax", "port"):
        d = tmp_path / side
        d.mkdir()
        with open(os.path.join(REPO, "example_config/synth.json")) as f:
            cfg = json.load(f)
        cfg.update({"dataset": os.path.join(REPO, cfg["dataset"]), "epoch": 1,
                    "plot_path": str(d / "plots"), "save_model_path": str(d / "model")})
        for key in ("save_result_valid", "save_info_valid", "save_info_train"):
            cfg[key] = str(d / os.path.basename(cfg[key]))
        paths[side] = d / "config.json"
        paths[side].write_text(json.dumps(cfg))
    with jax_backend("dense"):
        j_cmd_train(j_config(str(paths["jax"])))
    t_main(["train", "--config", str(paths["port"]), "--cpu"])
    names = sorted(os.listdir(tmp_path / "jax" / "plots"))
    assert names == ["auc.png", "cost.png"]
    assert sorted(os.listdir(tmp_path / "port" / "plots")) == names
    for name in names:
        with open(tmp_path / "port" / "plots" / name, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    rng = np.random.RandomState(0)
    out = plots.plot_r2({"plot_path": str(tmp_path / "r2")}, rng.randn(20, 1),
                        rng.randn(20, 1), name="_x")
    assert out == str(tmp_path / "r2" / "r2_x.png") and os.path.getsize(out) > 0
