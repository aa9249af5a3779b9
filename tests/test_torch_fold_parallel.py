"""The port's fold-parallel cross-validation (kgcn_tpu_torch/parallel/
cv.py) against the JAX package, on the CPU.

k = 4 uneven folds (``kfold_indices`` of 26 ring graphs: 7, 7, 6 and 6
held out), patience 1 (folds stop at different epochs), the GCN with Adam:
kgcn_tpu's ``FoldParallelCV`` trains all four at once on its virtual
devices; the port trains fold f on rank f mod W, at W = 1 (in this
process) and W = 2 (gloo ranks, one launch), each fold from kgcn_tpu's
initial state of that fold (``params_from_jax``).  Every fold's history
(per epoch: training and validation cost and accuracy), its best epoch
and its stopping epoch against kgcn_tpu's; costs and accuracies rtol =
atol = 1e-4 over up to 4 epochs of Adam steps (tests/test_torch_kg.py's
bound for epochs of Adam), the best epoch and the history's length
exactly.  The gate's declines and ``cmd_train_cv``'s ``"force"`` path are
held to the sequential protocol's files in tests/test_torch_cv.py."""
import jax
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from test_torch_tiled import jax_backend
from torch_parallel_worker import launch_scenarios

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
RING = dict(num_pairs=13, seed=0)
K = 4
KEYS = ("training_cost", "validation_cost", "training_accuracy", "validation_accuracy")


def _cfg(tmp):
    from kgcn_tpu.runtime.config import default_config

    cfg = default_config()
    cfg.update({"model.py": "gcn", "task": "classification", "batch_size": 4,
                "learning_rate": 0.01, "dropout_rate": 0.0, "normalize_adj_flag": True,
                "shuffle_data": True, "seed": 0, "epoch": 4, "patience": 1,
                "save_model_path": str(tmp), "spmm_backend": "dense"})
    return cfg


def _folds():
    from kgcn_tpu.data import kfold_indices

    return [(np.asarray(a), np.asarray(b)) for a, b in kfold_indices(26, K, seed=0)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """kgcn_tpu's run: (initial trees, fit_infos)."""
    from kgcn_tpu.data import build_dataset
    from kgcn_tpu.data.synthetic import make_ring_dataset
    from kgcn_tpu.parallel.cv import FoldParallelCV

    cfg = _cfg(tmp_path_factory.mktemp("jax_cv"))
    with jax_backend("dense"):
        ds, info = build_dataset(make_ring_dataset(**RING), cfg)
        cv = FoldParallelCV(cfg, info, ds, _folds())
        assert cv.D == K
        initial = {f: params_from_jax(jax.device_get(s.params),
                                      jax.device_get(s.batch_stats))
                   for f, s in enumerate(cv._init_states(list(range(K))))}
        results = cv.run(log=lambda msg: None)
    return initial, [info_ for _, _, info_ in results]


@pytest.fixture(scope="module")
def port_runs(jax_run, tmp_path_factory):
    """{W: [(history, best epoch) of each fold]}: W = 1 here, W = 2 on
    gloo ranks."""
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.parallel.cv import FoldParallelCV
    from kgcn_tpu_torch.runtime.backend import Backend

    initial, _ = jax_run
    cfg = _cfg(tmp_path_factory.mktemp("port_cv1"))
    ds, info = build_dataset(make_ring_dataset(**RING), cfg)
    cv = FoldParallelCV(cfg, info, ds, _folds(), backend=Backend("dense"), device="cpu",
                        initial=initial)
    runs = {1: [(i["history"], i["best_epoch"]) for _, _, i in cv.run(log=lambda m: None)]}
    d = tmp_path_factory.mktemp("port_cv2")
    out = launch_scenarios(d, 2, {"cv": {"cfg": dict(cfg, save_model_path=str(d)),
                                         "ring": RING, "folds": _folds(),
                                         "initial": initial}})["cv"]
    assert [r["mine"] for r in out] == [[0, 2], [1, 3]]
    assert out[0]["histories"] == out[1]["histories"]  # every rank has every fold
    runs[2] = list(zip(out[0]["histories"], out[0]["best_epochs"]))
    return runs


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("fold", range(K))
def test_fold_histories_match_jax(jax_run, port_runs, W, fold):
    _, infos = jax_run
    want = infos[fold]
    hist, best = port_runs[W][fold]
    assert len(hist) == len(want["history"])
    assert best == want["best_epoch"]
    for g, w in zip(hist, want["history"]):
        assert g["epoch"] == w["epoch"]
        for k in KEYS:
            np.testing.assert_allclose(g[k], w[k], err_msg=f"fold {fold} {k}", **TOL)


def test_folds_stop_at_different_epochs(jax_run):
    """The case holds what it is meant to: patience stops some fold early
    and not all folds at once."""
    _, infos = jax_run
    lengths = [len(i["history"]) for i in infos]
    assert min(lengths) < 4 and len(set(lengths)) > 1


def test_gate(monkeypatch):
    from kgcn_tpu_torch.parallel import cv

    assert cv.fold_parallel_flag({}) == "auto"
    assert cv.fold_parallel_flag({"fold_parallel": False}) == "off"
    assert cv.fold_parallel_flag({"fold_parallel": "force"}) == "force"
    assert not cv.fold_parallel_plausible({})  # a world of one
    assert cv.fold_parallel_plausible({"fold_parallel": "force"})
    assert not cv.fold_parallel_plausible({"fold_parallel": "force", "retrain": "x"})
    monkeypatch.setattr(cv.pmesh, "world_size", lambda: 2)
    assert cv.fold_parallel_plausible({})
    assert not cv.fold_parallel_plausible({"mesh": {"data": 2}})
