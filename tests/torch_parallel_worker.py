"""Scenarios of the port's parallel layer, run as gloo ranks by the
multi-rank tests (tests/test_torch_parallel.py, test_torch_edge_partition.py,
test_torch_big_graph.py, test_torch_fold_parallel.py, test_torch_tp.py,
test_torch_pp.py, test_torch_orbax.py):

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

    data = make_ring_dataset(**inp["ring"])
    if inp.get("tasks"):  # the multitask tower's labels: the first column repeated
        y = np.concatenate([data["label"][:, :1]] * inp["tasks"], axis=1)
        data["label"], data["mask_label"] = y, np.ones_like(y, dtype=np.int64)
    ds, info = build_dataset(data, inp["cfg"])
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


def _model_state(state):
    return {"params": _np(state.params), "stats": _np(state.batch_stats)}


def scenario_ckpt(inp, out):
    """The distributed resume at the config's dropout: 2 epochs, the
    checkpoint written by rank 0 (``save_tree``), 1 more epoch (continued);
    a fresh trainer of another seed restores the file and trains the same
    epoch (resumed).  Then ``inp["other"]``, a checkpoint written at another
    world size, restored here and trained an epoch."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.parallel.dp import DPTrainer, ShardedBatcher

    ds, info, be = _ring(inp)
    D, B = pmesh.world_size(), inp["cfg"]["batch_size"]
    sb = ShardedBatcher(Batcher(ds, info, B, seed=0, backend=be), D)

    def trainer(cfg):
        return DPTrainer(build_model(cfg["model.py"], info, cfg), cfg, info, device="cpu",
                         mesh=pmesh.make_mesh({"data": -1}))

    tr = trainer(inp["cfg"])
    state = tr.init_state(seed=0)
    for epoch in (0, 1):
        state, _, _, _ = tr.run_epoch(state, sb, shuffle=True, epoch=epoch)
    tr.save_tree(inp["path"], tr.state_tree(state, 1, np.inf))
    out["rng_saved"] = state.rng.get_state().numpy()
    state, cost, _, _ = tr.run_epoch(state, sb, shuffle=True, epoch=2)
    out["continued"] = dict(_model_state(state), cost=cost)
    fresh = trainer(dict(inp["cfg"], seed=123))
    fresh.init_state(seed=123)
    state = fresh.restore(inp["path"])
    out["rng_restored"], epoch = state.rng.get_state().numpy(), state.epoch
    state, cost, _, _ = fresh.run_epoch(state, sb, shuffle=True, epoch=epoch)
    out["resumed"] = dict(_model_state(state), cost=cost, epoch=epoch)
    out["path"], out["other_path"] = inp["path"], inp.get("other")
    if inp.get("other"):
        other = trainer(inp["cfg"])
        state = other.restore(inp["other"])
        out["other"] = dict(_model_state(state), step=state.step,
                            rng=state.rng.get_state().numpy())
        _, out["other"]["cost"], _, _ = other.run_epoch(state, sb, shuffle=True,
                                                        epoch=state.epoch)


def scenario_ingest(inp, out):
    """Per-rank ingest: this rank's slice (``shard_for_host``) behind the
    shard mode of the sharded batcher; the epoch's local order and steps,
    the valid rows it yields, one training epoch and an evaluation."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import shard_for_host
    from kgcn_tpu_torch.parallel.dp import ShardedBatcher

    full, info, be = _ring(inp)
    D, rk, B = pmesh.world_size(), pmesh.rank(), inp["cfg"]["batch_size"]
    local = shard_for_host(full, rk, D)
    gb = ShardedBatcher(Batcher(local, info, B, seed=rk, backend=be), D, mode="shard",
                        global_num=full.num)
    out["features"], out["labels"] = local.features, local.labels
    out["perm"] = gb.b.epoch_indices(shuffle=True, epoch=0)
    masks = [b.pad_mask.numpy() for b in gb.batches(shuffle=True, epoch=0)]
    out["steps"], out["seen"] = len(masks), float(np.sum(masks))
    out["valid_counts"], out["valid_per_epoch"] = gb.batch_valid_counts(), gb.valid_per_epoch
    tr, state = _dp_trainer(inp, info)
    state, out["epoch_cost"], _, out["n"] = tr.run_epoch(state, gb, shuffle=True, epoch=0)
    out["epoch"] = _model_state(state)
    ev = tr.evaluate(state, gb)
    out["eval"] = {"num": ev["num"], "cost": ev["cost"], "rows": len(ev["prediction"])}


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


def scenario_tp(inp, out):
    """One step of the tensor-parallel trainer on ``inp["mesh"]`` from the
    whole tree ``inp["tree"]`` (the optimizer: SGD at ``inp["sgd"]``, or
    the config's chain), then its gathered checkpoint."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.parallel.tp import TPTrainer
    from kgcn_tpu_torch.runtime.optim import make_optimizer

    ds, info, be = _ring(inp)
    cfg = inp["cfg"]
    tx = make_optimizer({"optimizer": "sgd", "learning_rate": inp["sgd"]}) \
        if inp.get("sgd") else None
    tr = TPTrainer(build_model(cfg["model.py"], info, cfg), cfg, info, device="cpu",
                   tx=tx, mesh=pmesh.make_mesh(inp["mesh"]), min_dim=inp["min_dim"])
    state = tr.state_from_tree(inp["tree"])
    batch = Batcher(ds, info, len(inp["rows"]), seed=0, backend=be).make_batch(
        np.asarray(inp["rows"]))
    state, cost, metrics = tr.train_step(state, batch)
    out["cost"], out["metrics"] = float(cost), _np(metrics)
    out["rules"] = {k: v is not None for k, v in tr.rules.items()}
    sharded = [k for k, v in tr.rules.items() if v is not None]
    moments = [t for name in ("mu", "nu") for t in _find(state.opt_state, name, sharded)]
    out["local_bytes"] = {"params": sum(state.params[k].nbytes for k in sharded),
                          "moments": sum(t.nbytes for t in moments)}
    tree = tr.state_tree(state, 0, 0.0)
    out["params"] = _np(tree["params"])
    out["stats"] = _np(tree["batch_stats"])
    tr.save_tree(inp["ckpt"], tree)


def _find(tree, name, keys):
    """The tensors of ``keys`` in every ``name`` dict inside ``tree``."""
    if not isinstance(tree, dict):
        return []
    here = [tree[name][k] for k in keys] if isinstance(tree.get(name), dict) else []
    return here + [t for k, v in tree.items() if k != name for t in _find(v, name, keys)]


def scenario_pp(inp, out):
    """The pipeline's loss and this stage's gradients on the toy
    microbatches, then steps of PPTrainer on the ring batch."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.parallel.pp import (PPConfig, PPTrainer, init_pipeline_params,
                                            sequential_logits)

    def trainer(cfg, params, feature_dim):
        tr = PPTrainer(PPConfig(**cfg), pmesh.make_mesh({"pipe": cfg["stages"]}),
                       learning_rate=inp["lr"], device="cpu")
        full = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in params.items()}
        return tr, tr.init_state(feature_dim, params=full)

    arrays = tuple(torch.from_numpy(a) for a in inp["toy"])
    tr, state = trainer(inp["toy_pp"], inp["toy_params"], arrays[0].shape[-1])
    loss, _, _, grads = tr.loss_and_grads(state["params"], arrays)
    out["loss"], out["grads"], out["stage"] = float(loss), _np(grads), tr.pipe.s
    tr, state = trainer(inp["pp"], inp["params"], inp["feature_dim"])
    try:
        tr.prepare_batch(Batcher(*_ring(inp)[:2], inp["odd"], seed=0).make_batch(
            np.arange(inp["odd"])))
        out["odd_raises"] = False
    except ValueError:
        out["odd_raises"] = True
    ds, info, be = _ring(inp)
    batch = Batcher(ds, info, len(inp["rows"]), seed=0, backend=be).make_batch(
        np.asarray(inp["rows"]))
    costs = []
    for _ in range(inp["steps"]):
        state, c, _ = tr.train_step(state, batch)
        costs.append(float(c))
    out["costs"], out["final"] = costs, _np(state["params"])
    out["logits"] = tr.logits(state, batch).numpy()
    # one stage on a mesh without a pipe axis: each rank's logits are its own
    solo = PPConfig(**dict(inp["toy_pp"], stages=1))
    x, adj, nmask = arrays[:3]  # [M, mb, N, F], [M, C, mb, N, N], [M, mb, N]
    G, C, N = x.shape[0] * x.shape[1], adj.shape[1], x.shape[2]
    full = init_pipeline_params(torch.Generator().manual_seed(0), solo, x.shape[-1])
    tr = PPTrainer(solo, pmesh.make_mesh({"data": pmesh.world_size()}), device="cpu")
    with torch.no_grad():
        got = tr.pipeline_logits(tr.init_state(x.shape[-1], params=full)["params"],
                                 x, adj, nmask)
        want = sequential_logits(full, x.reshape(G, N, -1),
                                 adj.transpose(1, 2).reshape(G, C, N, N),
                                 nmask.reshape(G, N), cfg=solo)
    out["solo"], out["solo_want"] = got.reshape(G, -1).numpy(), want.numpy()


def scenario_bgorbax(inp, out):
    """kgcn_tpu's orbax big-graph checkpoint restored at this world size."""
    from kgcn_tpu_torch.parallel.big_graph import BigGraphKGTrainer

    bg = BigGraphKGTrainer(device="cpu", **inp["trainer"])
    before = bg.init_state(0)
    from kgcn_tpu_torch.runtime import orbax

    orbax.bytes_read = 0
    state = bg.restore(inp["path"], before)
    out["params"], out["opt_state"] = _np(state["params"]), _np(state["opt_state"])
    out["step"], out["bytes_read"] = state["step"], orbax.bytes_read


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
    """Run each named scenario (``name`` or ``name-variant``: the function
    ``scenario_<name>`` on the variant's inputs)."""
    outdir, names = argv[0], argv[1:]
    torch.set_num_threads(1)
    initialize_from_env(cpu=True)
    for name in names:
        inp = torch.load(os.path.join(outdir, f"{name}.in.pt"), weights_only=False)
        out = {}
        globals()[f"scenario_{name.split('-')[0]}"](inp, out)
        torch.save(out, os.path.join(outdir, f"{name}.r{pmesh.rank()}.pt"))
        print(f"[OK] {name}", flush=True)
    pmesh.finalize()


if __name__ == "__main__":
    main(sys.argv[1:])
