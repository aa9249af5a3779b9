"""Scenarios of the port's parallel layer, run as gloo ranks by the
multi-rank tests (tests/test_torch_parallel.py, test_torch_edge_partition.py,
test_torch_big_graph.py, test_torch_fold_parallel.py):

    python -m kgcn_tpu_torch.parallel.launch --nprocs D --cpu \\
        --init-method file:///tmp/x/rdzv -- \\
        python tests/torch_parallel_worker.py OUTDIR SCENARIO [SCENARIO ...]

A scenario reads its inputs from ``OUTDIR/<scenario>.in.pt`` (written by
the test) and writes ``OUTDIR/<scenario>.r<rank>.pt``.  It imports the port
only (no JAX); the tests hold the outputs against ``kgcn_tpu``."""
import contextlib
import io
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from kgcn_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from kgcn_tpu_torch.parallel.launch import initialize_from_env  # noqa: E402


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _ring(inp):
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.runtime.backend import Backend

    ds, info = build_dataset(make_ring_dataset(**inp["ring"]), inp["cfg"])
    return ds, info, Backend("dense", "float32")


def _dp_trainer(inp, info, cfg=None):
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.parallel.dp import DPTrainer

    cfg = cfg or inp["cfg"]
    tr = DPTrainer(build_model(cfg["model.py"], info, cfg), cfg, info, device="cpu",
                   mesh=pmesh.make_mesh({"data": -1}))
    return tr, tr.state_from_tree(inp["tree"])


def scenario_dp(inp, out):
    """Steps, the streaming and resident epochs, the evaluation and a bf16
    step of the data-parallel trainer."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.parallel.dp import ShardedBatcher, ShardedResidentBatcher
    from kgcn_tpu_torch.runtime.resident import ResidentBatcher

    ds, info, be = _ring(inp)
    D, B = pmesh.world_size(), inp["cfg"]["batch_size"]
    tr, state = _dp_trainer(inp, info)
    sb = ShardedBatcher(Batcher(ds, info, B, seed=0, backend=be), D)
    costs, metrics = [], []
    for idx in inp["steps"]:
        state, c, m = tr.train_step(state, sb.make_batch(np.asarray(idx)))
        costs.append(float(c))
        metrics.append(_np(m))
    out["step_costs"], out["step_metrics"] = costs, metrics
    out["step_params"] = _np(state.params)
    out["step_stats"] = _np(state.batch_stats)
    for name, batcher in (
            ("stream", sb),
            ("resident", ShardedResidentBatcher(
                ResidentBatcher(ds, info, B, seed=0, backend=be, device="cpu"), D))):
        tr, state = _dp_trainer(inp, info)
        state, cost, _, _ = tr.run_epoch(state, batcher, shuffle=True, epoch=0)
        out[f"{name}_epoch_cost"] = cost
        out[f"{name}_epoch_params"] = _np(state.params)
        out[f"{name}_epoch_stats"] = _np(state.batch_stats)
    valid = ds.subset(np.asarray(inp["valid_rows"]))
    ev = tr.evaluate(state, ShardedBatcher(Batcher(valid, info, B, backend=be), D), "v_")
    out["eval"] = {"cost": ev["cost"], "prediction": ev["prediction"], "num": ev["num"],
                   "metrics": {k: np.asarray(v) for k, v in ev["metrics"].items()}}
    out["eval_state"] = {"params": _np(state.params), "stats": _np(state.batch_stats)}
    bcfg = dict(inp["cfg"], precision="bfloat16")
    tr, state = _dp_trainer(inp, info, bcfg)
    state, c, _ = tr.train_step(state, sb.make_batch(np.asarray(inp["steps"][0])))
    out["bf16_cost"] = float(c)


def scenario_dp_cli(inp, out):
    """``cli.main train`` with ``mesh``: rank 0 writes the files."""
    from kgcn_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["train", "--config", inp["config"], "--cpu"])
    out["stdout"] = buf.getvalue()


def scenario_ep(inp, out):
    """Ring and allgather halos: values and gradients of this rank's rows."""
    from kgcn_tpu_torch.parallel.edge_partition import (DevicePartition, partition_edges,
                                                        spmm_edge_partitioned)

    D, rk = pmesh.world_size(), pmesh.rank()
    V = inp["V"]
    part = DevicePartition.of(partition_edges(inp["s"], inp["r"], inp["w"], V, D), rk,
                              "cpu")
    v = V // D
    for strategy in ("ring", "allgather"):
        x = torch.from_numpy(inp["x"][rk * v:(rk + 1) * v].copy()).requires_grad_(True)
        y = spmm_edge_partitioned(part, x, strategy)
        g = torch.from_numpy(inp["cot"][rk * v:(rk + 1) * v].copy())
        (dx,) = torch.autograd.grad(y, x, g)
        out[strategy] = {"y": y.detach().numpy(), "dx": dx.numpy()}


def _bg(inp, **over):
    from kgcn_tpu_torch.parallel.big_graph import BigGraphKGTrainer, make_tx, tx_shard_safe

    kw = dict(inp["kw"], **over)
    cfg = kw.pop("config", {})
    bg = BigGraphKGTrainer(**kw, tx=make_tx(cfg), tx_shard_safe=tx_shard_safe(cfg),
                           device="cpu")
    bg.partition_graph(inp["s"], inp["r"], inp["w"])
    return bg


def scenario_bg(inp, out):
    """Per encoder × halo: loss, gradients and one Adam step from the
    given parameters; then (on the last case) fit with label slices, the
    resident fit, a repartition, the sharded round trip and the clip
    route."""
    for case in inp["cases"]:
        bg = _bg(inp, encoder=case["encoder"], strategy=case["strategy"])
        state = bg.init_state(params=bg.from_flax_variables({"params": case["params"]}))
        res = {"loss": bg.evaluate(state, inp["ll"])["cost"],
               "grads": bg.gradients(state, inp["ll"])}
        state, m = bg.train_step(state, inp["ll"])
        res["step"] = m
        res["params"] = bg.to_flax_variables(state)["params"]
        res["z"] = bg.node_embeddings(state)
        out[f"{case['encoder']}_{case['strategy']}"] = _np(res)
    case = inp["cases"][-1]
    bg = _bg(inp, encoder=case["encoder"], strategy=case["strategy"])
    start = bg.from_flax_variables({"params": case["params"]})
    state, hist = bg.fit(bg.init_state(params=start), inp["ll"][:, :3], epochs=2, seed=0,
                         label_batch_size=inp["label_batch"])
    out["fit"] = hist
    out["fit_params"] = _np(bg.to_flax_variables(state)["params"])
    res_state, res_hist = bg.fit_resident(bg.init_state(params=start), inp["ll"][:, :3],
                                          epochs=2, seed=0)
    out["fit_resident"] = res_hist
    path = os.path.join(inp["dir"], "bg.ckpt")
    bg.save(path, res_state)
    back = bg.restore(path, bg.init_state(seed=5))
    out["roundtrip"] = {"saved": _np({k: res_state[k] for k in ("params", "opt_state")}),
                        "back": _np({k: back[k] for k in ("params", "opt_state")}),
                        "step": (res_state["step"], back["step"])}
    # a new partition replaces the old one: the second graph's loss
    bg.partition_graph(inp["s2"], inp["r2"], inp["w2"])
    out["repartition_loss"] = bg.evaluate(bg.init_state(params=start), inp["ll"])["cost"]
    clip = _bg(inp, encoder=case["encoder"], strategy=case["strategy"],
               config=inp["clip_config"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _, hist = clip.fit_resident(clip.init_state(params=start), inp["ll"][:, :3],
                                    epochs=2, seed=0)
    out["clip"] = {"stdout": buf.getvalue(), "history": hist}


def scenario_bg_cli(inp, out):
    """``cli.main train`` of a KG with ``mesh`` (fit_resident), ``retrain``
    from its sharded checkpoint, then ``infer`` on rank 0."""
    from kgcn_tpu_torch.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(["train", "--config", inp["config"], "--cpu"])
        main(["train", "--config", inp["retrain_config"], "--cpu"])
        if pmesh.is_main_process():
            out["infer"] = main(["infer", "--config", inp["config"], "--cpu"])
    out["stdout"] = buf.getvalue()


def scenario_cv(inp, out):
    """FoldParallelCV over the ranks from the given initial states."""
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.parallel.cv import FoldParallelCV
    from kgcn_tpu_torch.runtime.backend import Backend

    ds, info = build_dataset(make_ring_dataset(**inp["ring"]), inp["cfg"])
    cv = FoldParallelCV(inp["cfg"], info, ds, inp["folds"], backend=Backend("dense"),
                        device="cpu", initial=inp["initial"])
    runs = cv.run(log=lambda msg: None)
    out["histories"] = [info_["history"] for _, _, info_ in runs]
    out["best_epochs"] = [info_["best_epoch"] for _, _, info_ in runs]
    out["params"] = [_np(state.params) for _, state, _ in runs]
    out["mine"] = cv.mine()


LAUNCH_TIMEOUT = 240  # seconds a multi-rank run may take before it is ended


def launch_scenarios(outdir, world: int, inputs: dict):
    """Write each scenario's inputs, run them all in ONE launch of
    ``world`` gloo ranks (rendezvous through a file under ``outdir``; a
    collective waits at most 120 s) and return ``{scenario: [output of
    rank 0, …]}``.  A failed or hung rank fails the caller."""
    from kgcn_tpu_torch.parallel.launch import first_failure, launch

    outdir = str(outdir)
    for name, inp in inputs.items():
        torch.save(inp, os.path.join(outdir, f"{name}.in.pt"))
    env = {"KGCN_TORCH_DIST_TIMEOUT": "120", "PYTHONPATH": REPO}
    results = launch(world, [sys.executable, os.path.abspath(__file__), outdir,
                             *inputs], cpu=True,
                     init_method="file://" + os.path.join(outdir, "rdzv"), env=env,
                     timeout=LAUNCH_TIMEOUT, stream=False)
    rc = first_failure(results)
    assert rc == 0, "\n".join(r.stdout[-4000:] for r in results)
    return {name: [torch.load(os.path.join(outdir, f"{name}.r{r}.pt"), weights_only=False)
                   for r in range(world)] for name in inputs}


def main(argv):
    outdir, names = argv[0], argv[1:]
    torch.set_num_threads(1)
    initialize_from_env(cpu=True)
    for name in names:
        inp = torch.load(os.path.join(outdir, f"{name}.in.pt"), weights_only=False)
        out = {}
        globals()[f"scenario_{name}"](inp, out)
        torch.save(out, os.path.join(outdir, f"{name}.r{pmesh.rank()}.pt"))
        print(f"[OK] {name}", flush=True)
    pmesh.finalize()


if __name__ == "__main__":
    main(sys.argv[1:])
