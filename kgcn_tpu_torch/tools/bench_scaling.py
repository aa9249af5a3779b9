"""Scaling harness of the parallel layer — the port's counterpart of
``kgcn_tpu/tools/bench_scaling.py``.

Measures, at the world size of the job it runs in (D ranks: run it under
``kgcn-torch-launch --nprocs D [--cpu]``, or alone for D 1), the
edge-partitioned aggregation's edges/s (``spmm``), a full big-graph KG
training step's triples/s (``kg_step``: encoder, halo, DistMult, backward,
Adam) or a data-parallel GNN step's edges/s (``dp_gin``/``dp_gcn``: the
global batch grows with D), and prints ``kgcn_tpu``'s JSON line
(``{"workload", "strategy", "results": {D: {unit: rate, "efficiency"}}}``;
the efficiency against linear scaling needs the rate at D 1 of another
job: 1.0 at D 1, null beyond).  ``--model`` prints the analytic model instead.  Times
are wall times around synchronised steps (``torch.cuda.synchronize`` on
the GPU).

    python -m kgcn_tpu_torch.parallel.launch --nprocs 2 --cpu -- \\
        python -m kgcn_tpu_torch.tools.bench_scaling --workload kg_step --cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from kgcn_tpu_torch.parallel import mesh as pmesh


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def bench_one(V: int, E: int, F: int, strategy: str, iters: int = 20, device=None):
    """Edges/s of ``spmm_edge_partitioned`` over the world (one step's
    output fed back as the next step's input)."""
    from kgcn_tpu_torch.parallel.edge_partition import (DevicePartition,
                                                        partition_edges,
                                                        spmm_edge_partitioned)
    from kgcn_tpu_torch.runtime.device import device_from_arg

    dev = device_from_arg(device)
    D, rk = pmesh.world_size(), pmesh.rank()
    V = -(-V // D) * D
    rng = np.random.RandomState(0)
    s = rng.randint(0, V, E).astype(np.int32)
    r = rng.randint(0, V, E).astype(np.int32)
    w = rng.random_sample(E).astype(np.float32) + 0.1
    x = rng.standard_normal((V, F)).astype(np.float32)
    part = DevicePartition.of(partition_edges(s, r, w, V, D), rk, dev)
    v_loc = V // D
    cur = torch.from_numpy(x[rk * v_loc:(rk + 1) * v_loc]).to(dev)
    with torch.no_grad():
        spmm_edge_partitioned(part, cur, strategy)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(iters):
            cur = spmm_edge_partitioned(part, cur, strategy)
        _sync(dev)
    return E / ((time.perf_counter() - t0) / iters)


def bench_kg_step(V: int, E: int, dim: int, strategy: str, encoder: str = "gcn",
                  iters: int = 10, device=None):
    """Triples/s of ``BigGraphKGTrainer``'s training step on a random
    one-channel graph whose edges are also the triples."""
    from kgcn_tpu_torch.models.kg import sample_negatives
    from kgcn_tpu_torch.parallel.big_graph import BigGraphKGTrainer

    D = pmesh.world_size()
    rng = np.random.RandomState(0)
    V = -(-V // D) * D
    s = rng.randint(0, V, E).astype(np.int32)
    r = rng.randint(0, V, E).astype(np.int32)
    ll = np.stack([s, np.zeros(E, np.int32), r] * 2, axis=1)
    ll = sample_negatives(ll, np.arange(V, dtype=np.int32), rng)
    bg = BigGraphKGTrainer(num_nodes=V, channels=1, embedding_dim=dim, encoder=encoder,
                           strategy=strategy, device=device)
    bg.partition_graph(s, r, np.ones(E, np.float32))
    state = bg.init_state(seed=0)
    lls, lv, n = bg._shard_labels(ll)
    for _ in range(2):
        state, _ = bg._step(state, lls, lv, 1.0 / n)
    _sync(bg.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, _ = bg._step(state, lls, lv, 1.0 / n)
    _sync(bg.device)
    return len(ll) / ((time.perf_counter() - t0) / iters)


def bench_dp_gnn(model_name: str, per_device_batch: int = 32, num_nodes: int = 64,
                 features: int = 32, iters: int = 10, device=None):
    """Edges/s of ``DPTrainer``'s step (weak scaling: the global batch is
    ``per_device_batch`` a rank)."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_random_graphs
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.parallel.dp import DPTrainer, ShardedBatcher
    from kgcn_tpu_torch.runtime import backend as backend_mod

    D = pmesh.world_size()
    cfg = {"task": "classification", "learning_rate": 1e-3, "model.py": model_name}
    B = per_device_batch * D
    ds, info = build_dataset(make_random_graphs(B, num_nodes, features, avg_degree=8,
                                                seed=0), cfg)
    be = backend_mod.resolve(cfg, info, log=False)
    trainer = DPTrainer(build_model(model_name, info, cfg), cfg, info, device=device,
                        mesh=pmesh.make_mesh({"data": D}))
    sb = ShardedBatcher(Batcher(ds, info, per_device_batch, seed=0, backend=be), D)
    batch = sb.make_batch(np.arange(B)).to(trainer.device)
    n_edges = int(torch.sum(batch.graph.edge_weights != 0)) * D
    state = trainer.init_state(seed=0)
    for _ in range(2):
        state, cost, _ = trainer.train_step(state, batch)
    _sync(trainer.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, cost, _ = trainer.train_step(state, batch)
    _sync(trainer.device)
    return n_edges / ((time.perf_counter() - t0) / iters)


def analytic_model(D: int, workload: str, *, V: int = 1 << 17, E: int = 1 << 20,
                   F: int = 128, params: int = 60_000, boundary_frac: float = 1.0,
                   t_step_chip: float = 290e-6, edges_per_s_chip: float = 1.29e8,
                   link_bw: float = 4.5e10) -> dict:
    """``kgcn_tpu``'s analytic scaling model (its anchors are its own
    defaults, not measurements of this port): a rank's step time is
    max(compute, comms); DP (weak scaling) all-reduces
    ``2·params·4·(D-1)/D`` bytes, the edge partition computes ``E/D``
    edges and moves D − 1 hops of the boundary rows of a ``[V/D, F]``
    block over a link of ``link_bw`` bytes/s."""
    if workload.startswith("dp"):
        t_comp = t_step_chip
        t_comm = 2 * params * 4 * (D - 1) / D / link_bw
    else:
        t_comp = (E / D) / edges_per_s_chip
        t_comm = (D - 1) * (V / D) * boundary_frac * F * 4 / link_bw
    t_step = max(t_comp, t_comm)
    return {"D": D, "t_compute_us": t_comp * 1e6, "t_comms_us": t_comm * 1e6,
            "efficiency_overlapped": t_comp / t_step,
            "efficiency_serial": t_comp / (t_comp + t_comm)}


def main(argv=None):
    from kgcn_tpu_torch.parallel.launch import initialize_from_env

    p = argparse.ArgumentParser(prog="kgcn-torch-bench-scaling")
    p.add_argument("--nodes", type=int, default=1 << 14)
    p.add_argument("--edges", type=int, default=1 << 18)
    p.add_argument("--features", type=int, default=64)
    p.add_argument("--strategy", default="ring", choices=["ring", "allgather"])
    p.add_argument("--workload", default="spmm",
                   choices=["spmm", "kg_step", "dp_gin", "dp_gcn"])
    p.add_argument("--batch", type=int, default=32, help="per-rank batch of dp_*")
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--model", action="store_true",
                   help="print the analytic scaling model instead of measuring")
    args = p.parse_args(argv)
    if args.model:
        kind = "dp" if args.workload.startswith("dp") else "edge_partition"
        out = {}
        for beta in ((None,) if kind == "dp" else (1.0, 0.3, 0.1)):
            kw = {} if beta is None else {"boundary_frac": beta}
            rows = [analytic_model(D, kind, F=args.features, V=args.nodes, E=args.edges,
                                   **kw) for D in (1, 2, 4, 8, 16, 32)]
            out["dp" if beta is None else f"boundary_frac={beta}"] = rows
        print(json.dumps({"workload": args.workload, "model": out}))
        return out
    joined = initialize_from_env(args.cpu)
    device = "cpu" if args.cpu else None
    D = pmesh.world_size()
    if args.workload == "spmm":
        rate = bench_one(args.nodes, args.edges, args.features, args.strategy,
                         device=device)
    elif args.workload == "kg_step":
        rate = bench_kg_step(args.nodes, args.edges, args.features, args.strategy,
                             device=device)
    else:
        rate = bench_dp_gnn(args.workload.removeprefix("dp_"), per_device_batch=args.batch,
                            features=args.features, device=device)
    unit = "triples_per_s" if args.workload == "kg_step" else "edges_per_s"
    line = {"workload": args.workload, "strategy": args.strategy,
            "results": {D: {unit: rate, "efficiency": 1.0 if D == 1 else None}}}
    if pmesh.is_main_process():
        print(json.dumps(line))
    if joined:
        pmesh.finalize()
    return line


if __name__ == "__main__":
    main()
