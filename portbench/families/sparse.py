"""The reaction-template family: kGCN's SparseGCN (``cli.sparse``'s model)
trained on molecules that stay on the card (``runtime/resident.
ResidentBatcher``, the resident runner ``cli.sparse train`` takes where the
gate admits the data), with the traffic of ``traffic.molecules``.

A family's module provides a ``Workload``: ``build`` makes the data from the
seed, the port's trainer, batcher (wrapped in a ``bench.Feed``) and state
with weights drawn on the card; the window calls ``trainer.run_epoch``
with ``epoch_kwargs``; ``step_stats`` gives each step's work from the
per-step inputs the feed gave; ``check_rows`` and ``reference`` judge the
check's epoch; ``free`` lets the program's memory go.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench import bench, traffic
from portbench.reference import common
from portbench.reference import sparse_gcn as ref


class Workload:
    rate = ("graphs_per_s", "graphs/s")

    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed = config, cell, int(seed)
        self.device = torch.device(device)
        self.program = dict(config["program"], **cell.get("settings", {}))

    def build(self) -> None:
        from kgcn_tpu_torch.cli import sparse as cli_sparse
        from kgcn_tpu_torch.cli.main import _maybe_resident
        from kgcn_tpu_torch.data.dataset import build_dataset
        from kgcn_tpu_torch.runtime import backend as backend_mod
        from kgcn_tpu_torch.runtime.device import set_precision
        from kgcn_tpu_torch.runtime.train import Trainer

        data = self.config["data"]
        self.mols = traffic.molecules(self.cell["mix"], data["atom_features"],
                                      self.program["num_classes"],
                                      traffic.rng_for(self.seed))
        prog = self.program
        set_precision(prog.get("precision", "float32"))
        ds, info = build_dataset(traffic.port_data_molecules(self.mols), prog)
        be = backend_mod.resolve(prog, info, log=False)
        self.trainer = Trainer(cli_sparse._model(prog, info), prog, info, device=self.device)
        rb = _maybe_resident(prog, ds, info, int(prog["batch_size"]), be, self.trainer.device,
                             seed=traffic.port_seed(self.seed))
        if rb is None:
            raise RuntimeError("the resident gate declined the cell's molecules")
        self.items_per_epoch = rb.valid_per_epoch
        self.feed = bench.feed_for(rb)
        self.weights = bench.draw_weights(self.weight_spec(info.feature_dim,
                                                           info.adj_channel_num),
                                          self.seed, self.device)
        d = int(prog["dense_dim"])
        stats = {"GraphBatchNormalization_0.mean": torch.zeros(d, device=self.device),
                 "GraphBatchNormalization_0.var": torch.ones(d, device=self.device)}
        self.state = self.trainer.state_from_tree(
            {"params": self.weights, "batch_stats": stats}, seed=traffic.port_seed(self.seed))
        self.weights = {k: v.cpu() for k, v in self.weights.items()}  # the reference's copy

    def weight_spec(self, features: int, channels: int) -> Dict[str, tuple]:
        spec = {}
        for name, shape in ref.leaves(self.config, features, channels).items():
            if name.endswith(".bias"):
                init = "zeros"
            elif name.endswith(".scale"):
                init = "ones"
            elif name.endswith(".kernel"):  # per-channel Glorot
                init = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            else:  # a dense [out, in] kernel: variance 1/fan_in
                init = math.sqrt(3.0 / shape[1])
            spec[name] = (shape, init)
        return spec

    def epoch_kwargs(self, epoch: int) -> dict:
        return {"epoch": epoch}

    def step_stats(self, xs) -> List[dict]:
        """Each step's real graphs, atoms and bonds (directed entries)."""
        sched, valid = (np.asarray(x) for x in xs)
        sizes = self.mols["sizes"]
        edges = np.diff(self.mols["edge_ptr"])
        v = valid > 0
        graphs = v.sum(axis=1)
        atoms = (sizes[sched] * v).sum(axis=1)
        nnz = (edges[sched] * v).sum(axis=1)
        return [{"graphs": int(g), "atoms": int(a), "edges": int(e)}
                for g, a, e in zip(graphs, atoms, nnz)]

    def graph_stats(self):
        return None

    def check_rows(self, rows) -> List[str]:
        """What is wrong with the epoch the program's feed gave (``[S, B]``
        graph indices and validity): every graph of the data once, each
        step but the last a full batch."""
        sched, valid = (np.asarray(x) for x in rows)
        out = []
        if not (valid[:-1] == 1).all() or not (valid[-1] > 0).any():
            out.append("a step that is not a full batch")
        if not np.array_equal(np.sort(sched[valid > 0]), np.arange(len(self.mols["sizes"]))):
            out.append("the epoch's graphs are not every graph of the data once")
        return out

    def reference(self, rows, precision: str = "float32", half_batch: bool = False,
                  frozen: bool = False) -> dict:
        sched = np.asarray(rows[0])
        batches = (ref.make_batch(self.mols, s, self.device) for s in sched)
        weights = {k: v.to(self.device) for k, v in self.weights.items()}
        return common.train_readings(
            lambda p, b: ref.loss(p, b, precision, half_batch), weights, batches,
            float(self.program["learning_rate"]), bench.CHECK_STEPS, frozen)

    def free(self) -> None:
        for name in ("trainer", "feed", "state"):
            self.__dict__.pop(name, None)
