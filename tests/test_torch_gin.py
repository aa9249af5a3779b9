"""The port's GIN, and the GCN family on the ELL backends (kgcn_tpu_torch/
models/standard.py, the ELL branches of nn/layers.py, models/registry.py,
cli/main.py's graph ``infer``), against the JAX package, on the CPU.

Data: the ring dataset with 6-node graphs (``make_ring_dataset(num_nodes=6)``,
which the ELL gate admits), ``example_jbl/synthetic.jbl`` (which it refuses:
the edge-list path) and ``example_jbl/multitask.jbl``; both packages read
the same dict.  The JAX Pallas ELL kernel runs in interpret mode; its probe
cache and the JAX package's globals are reset after every test.
Tolerances: the forward float32 rtol = atol = 1e-5; three training steps
rtol 2e-4, atol 2e-5 (the precedent of tests/test_torch_train.py) with SGD
at learning rate 0.1: Adam divides each update by the gradient's own scale,
so on a near-zero component (sigmoid GCNs have many) a 1e-5 relative
difference of summation order becomes one of order the learning rate, as
tests/test_torch_kg.py found for its bf16 steps; Adam itself is held to
optax in tests/test_torch_train.py.  ``infer``'s cost and metrics 1e-5.
"""
import contextlib
import functools
import importlib
import json
import os
import pickle

import jax
import joblib
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.data.synthetic import make_ring_dataset
from test_torch_tiled import jax_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
CONFIGS = {"gin": "gin.json", "gcn": "synth.json", "gcn_rxn_3layer": "synth.json",
           "gcn_multitask": "multitask.json"}


@pytest.fixture(autouse=True)
def jax_state():
    """Restore the JAX package's globals and clear the Pallas ELL probe
    cache after each test (xdist runs a whole file in one process)."""
    yield
    from kgcn_tpu.graph.batch import set_dense_path
    from kgcn_tpu.ops import pallas_spmm

    importlib.import_module("kgcn_tpu.ops.spmm").set_backend("xla")
    set_dense_path(True)
    pallas_spmm._KERNEL_OK.clear()


@contextlib.contextmanager
def pallas_interpret():
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig


def _data(source):
    if source == "ring6":
        return make_ring_dataset(num_pairs=50, num_nodes=6, seed=0)
    from kgcn_tpu_torch.data import jbl

    return jbl.load(os.path.join(REPO, "example_jbl", source))


def _config(model, backend, **over):
    from kgcn_tpu.runtime.config import load_config as j_config

    return j_config(os.path.join(REPO, "example_config", CONFIGS[model]), dict(
        {"model.py": model, "spmm_backend": backend, "dropout_rate": 0.0,
         "tiled_compute_dtype": "float32", "optimizer": "sgd",
         "learning_rate": 0.1}, **over))


def _pair(model, source, backend, n_batches=2):
    """JAX and port (config, info, batches) of the first ``n_batches``
    batches of a dataset, batched alike."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
    from kgcn_tpu_torch.data.dataset import build_dataset as t_build
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = _config(model, backend)
    data = _data(source)
    jds, jinfo = j_build(dict(data), cfg)
    tds, tinfo = t_build(dict(data), cfg)
    bs = int(cfg["batch_size"])
    # the shipped datasets are sorted by class: take examples spread over them
    idx = np.linspace(0, jds.num - 1, n_batches * bs).astype(np.int64)
    with jax_backend(backend, "float32"):
        jb = JBatcher(jds.subset(idx), jinfo, bs, seed=0)
        jbatches = list(jb.batches(shuffle=False))
    tb = TBatcher(tds.subset(idx), tinfo, bs, seed=0, backend=Backend(backend, "float32"))
    return cfg, jinfo, jbatches, tinfo, list(tb.batches(shuffle=False))


CASES = [
    ("gin", "ring6", "pallas"),
    ("gin", "ring6", "xla"),
    ("gcn", "ring6", "pallas"),
    ("gcn", "ring6", "xla"),
    ("gin", "synthetic.jbl", "pallas"),
    ("gin", "synthetic.jbl", "dense"),
    ("gcn_rxn_3layer", "ring6", "pallas"),
    ("gcn_multitask", "multitask.jbl", "xla"),
    ("gcn_multitask", "multitask.jbl", "dense"),
]


@pytest.mark.parametrize("model,source,backend", CASES)
def test_forward_and_train_steps_match_jax(model, source, backend):
    """The forward (eval mode) at 1e-5, then three ``train_step``s from the
    same weights at 2e-4: parameters, BN statistics and costs."""
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.models.registry import build_model as t_build
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    cfg, jinfo, jbatches, tinfo, tbatches = _pair(model, source, backend)
    ell = source == "ring6" and backend in ("xla", "pallas")
    assert (tbatches[0].graph.ell_senders is not None) == ell
    assert (jbatches[0].graph.ell_senders is not None) == (source == "ring6")
    order = [0, 1, 0]
    with jax_backend(backend, "float32"), pallas_interpret():
        jtr = JTrainer(j_build(model, jinfo, cfg), cfg, jinfo)
        jstate = jtr.init_state(jbatches[0], seed=0)
        tree = params_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
        jpred, jcost0, _ = jtr.eval_step(jstate.params, jstate.batch_stats, jbatches[0])
        jcosts = []
        for i in order:
            jstate, cost, _ = jtr.train_step(jstate, jbatches[i])
            jcosts.append(float(cost))
        want = params_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    ttr = TTrainer(t_build(model, tinfo, cfg), cfg, tinfo, device="cpu")
    tstate = ttr.state_from_tree(tree)
    tpred, tcost0, _ = ttr.eval_step(tstate.params, tstate.batch_stats, tbatches[0])
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), **TOL)
    np.testing.assert_allclose(float(tcost0), float(jcost0), **TOL)
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


def test_gin_parameter_names_follow_flax():
    """``params_from_jax`` maps the flax GIN tree by rule onto the port's
    module: ``GINAggregate_<n>.epsilon``, ``GraphDense_<n>.Dense_0``, the
    last ``Dense_0`` (its kernel transposed)."""
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu_torch.models.registry import build_model as t_build

    cfg, jinfo, jbatches, tinfo, _ = _pair("gin", "ring6", "xla", n_batches=1)
    with jax_backend("xla"):
        variables = j_build("example_model.model_gin:GIN", jinfo, cfg).init(
            {"params": jax.random.PRNGKey(0)}, jbatches[0])
    tree = params_from_jax(jax.device_get(variables["params"]), {})["params"]
    port = t_build("example_model.model_gin:GIN", tinfo, cfg)
    assert set(tree) == {k for k, _ in port.named_parameters()}
    assert {"GINAggregate_0.epsilon", "GINAggregate_1.epsilon",
            "GraphDense_3.Dense_0.weight", "Dense_0.weight"} <= set(tree)
    port.load_state_dict(tree, strict=True)
    np.testing.assert_array_equal(
        port.Dense_0.weight.detach().numpy(),
        np.asarray(variables["params"]["Dense_0"]["kernel"]).T)


# ---- the CLI ------------------------------------------------------------------


def _write(tmp, model, backend, source="ring6", **over):
    """The dataset as a plain pickle and a config pointing at it."""
    data = tmp / "data.jbl"
    if not data.exists():
        with open(data, "wb") as f:
            pickle.dump(_data(source), f, protocol=4)
    with open(os.path.join(REPO, "example_config", CONFIGS[model])) as f:
        cfg = json.load(f)
    cfg.update({"model.py": model, "spmm_backend": backend, "dataset": str(data),
                "save_model_path": str(tmp / "model"), "make_plot": False,
                "save_info_train": str(tmp / "info_train.json"),
                "save_info_valid": str(tmp / "info_valid.json"),
                "save_result_valid": str(tmp / "result_valid.csv"),
                "save_info_test": str(tmp / "info_test.json"),
                "save_result_test": str(tmp / "result_test.csv"),
                "prediction_data": str(tmp / "prediction.jbl")}, **over)
    path = tmp / "config.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


@pytest.mark.parametrize("model,backend", [("gin", "pallas"), ("gcn", "xla")])
def test_infer_matches_jax(tmp_path, model, backend):
    """``infer`` on the same weights: the JAX CLI reads its checkpoint, the
    port's its conversion; cost, metrics and predictions agree."""
    from kgcn_tpu.cli.main import cmd_infer as j_infer
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime import checkpoint as jckpt
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.runtime import checkpoint as tckpt

    for side in ("jax", "port"):
        (tmp_path / side).mkdir()
    same = dict(optimizer="sgd", learning_rate=0.1)  # the checkpoint's optimizer
    jcfg, _ = _write(tmp_path / "jax", model, backend, **same)
    _, tpath = _write(tmp_path / "port", model, backend, **same)
    cfg, jinfo, jbatches, _, _ = _pair(model, "ring6", backend, n_batches=1)
    with jax_backend(backend, "float32"), pallas_interpret():
        jtr = JTrainer(j_build(model, jinfo, cfg), cfg, jinfo)
        jstate = jtr.init_state(jbatches[0], seed=0)
        jstate, _, _ = jtr.train_step(jstate, jbatches[0])  # non-trivial BN stats
        jckpt.save_checkpoint(str(tmp_path / "jax" / "model" / "model.best.ckpt"),
                              jtr.state_tree(jstate, 0, 0.0))
        want = j_infer(dict(jcfg))
    tckpt.save_tree(str(tmp_path / "port" / "model" / "model.best.ckpt"),
                    params_from_jax(jax.device_get(jstate.params),
                                    jax.device_get(jstate.batch_stats)))
    got = t_main(["infer", "--config", tpath, "--cpu"])
    assert set(got) == set(want) - {"test_metrics"}
    np.testing.assert_allclose(got["test_cost"], want["test_cost"], **TOL)
    assert set(got["test_metrics_protocol"]) == set(want["test_metrics_protocol"])
    for k, v in want["test_metrics_protocol"].items():
        np.testing.assert_allclose(got["test_metrics_protocol"][k], v, err_msg=k, **TOL)
    jrows = np.loadtxt(tmp_path / "jax" / "result_test.csv", delimiter=",")
    trows = np.loadtxt(tmp_path / "port" / "result_test.csv", delimiter=",")
    np.testing.assert_allclose(trows, jrows, **TOL)
    np.testing.assert_allclose(joblib.load(tmp_path / "port" / "prediction.jbl"),
                               joblib.load(tmp_path / "jax" / "prediction.jbl"), **TOL)
    with open(tmp_path / "port" / "info_test.json") as f:
        assert set(json.load(f)) == set(got)


def test_cli_train_then_infer_gin_on_pallas(tmp_path, capsys):
    """``train --cpu`` then ``infer --cpu`` for gin on the ring6 data with
    ``spmm_backend: pallas``: the ELL route (no fallback message), a falling
    training cost, the checkpoints, and ``infer`` on the best one."""
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.ops import ell_spmm

    cfg, path = _write(tmp_path, "gin", "pallas", epoch=3, save_interval=0)
    t_main(["train", "--config", path, "--cpu"])
    out = capsys.readouterr().out
    assert "[spmm] backend: pallas" in out and "[restore] best epoch" in out
    assert "[spmm] pallas backend requested" not in out
    with open(cfg["save_info_train"]) as f:
        costs = json.load(f)["training_cost"]
    assert len(costs) == 3 and np.isfinite(costs).all() and costs[-1] < costs[0]
    assert sorted(os.listdir(tmp_path / "model")) == [
        "model.best.ckpt", "model.last.ckpt", "serve_info.json"]
    result = t_main(["infer", "--config", path, "--cpu"])
    out = capsys.readouterr().out
    assert f"[LOAD] {tmp_path / 'model' / 'model.best.ckpt'}" in out
    assert np.isfinite(result["test_cost"])
    assert 0.0 <= result["test_metrics_protocol"]["test_accuracy"] <= 1.0
    assert result["test_metrics_protocol"]["test_count"] == 100
    pred = joblib.load(tmp_path / "prediction.jbl")
    assert pred.shape == (100, 2)
    np.testing.assert_allclose(pred.sum(axis=1), 1.0, atol=1e-5)
    assert ell_spmm.spmm_ell_gpu.launches == 0


def test_cli_gin_on_synthetic_takes_the_scatter_and_says_so(tmp_path, capsys):
    """The gate refuses ELL on synthetic.jbl: ``pallas`` trains through the
    edge-list scatter and prints the JAX package's message."""
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.ops import spmm as tspmm

    tspmm._PALLAS_FALLBACK_WARNED[0] = False
    cfg, path = _write(tmp_path, "gin", "pallas", source="synthetic.jbl", epoch=1)
    t_main(["train", "--config", path, "--cpu"])
    out = capsys.readouterr().out
    assert out.count("[spmm] pallas backend requested") == 1
    with open(cfg["save_info_train"]) as f:
        assert np.isfinite(json.load(f)["training_cost"]).all()
