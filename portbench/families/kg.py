"""The link-prediction family: kGCN's ``kg_distmult`` with the ``gcn``
encoder (``models/registry.build_model``, as ``cli.main train`` builds
it), the whole knowledge graph every step on the stream backend, trained
on label slices with fresh negatives by ``models/kg.KGBatcher``'s scanned
epoch, over a graph of ``traffic.knowledge_graph``'s shape.  Its ``Workload``
has the methods of ``families/sparse.py``'s.

The graph is one draw, from the configuration's ``graph_seed``, as a
dataset is one: its stream structures, and so the memory and the work of
a step, are the same in every run.  ``--seed`` draws the weights, and the
port's batcher draws the order of the triples and their negatives from
it."""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench import bench, traffic
from portbench.reference import common
from portbench.reference import kg_gcn as ref


class Workload:
    rate = ("triples_per_s", "triples/s")

    def __init__(self, config: dict, cell: dict, seed: int, device):
        self.config, self.cell, self.seed = config, cell, int(seed)
        self.device = torch.device(device)
        self.program = dict(config["program"], **cell.get("settings", {}))

    def build(self) -> None:
        from kgcn_tpu_torch.data.dataset import build_dataset
        from kgcn_tpu_torch.models.kg import KGBatcher
        from kgcn_tpu_torch.models.registry import build_model
        from kgcn_tpu_torch.runtime import backend as backend_mod
        from kgcn_tpu_torch.runtime.device import set_precision
        from kgcn_tpu_torch.runtime.train import Trainer

        prog = self.program
        data = self.config["data"]
        self.kg = traffic.knowledge_graph(data, traffic.rng_for(int(data["graph_seed"])))
        set_precision(prog.get("precision", "float32"))
        self.port_data = traffic.port_data_kg(self.kg)
        ds, info = build_dataset(self.port_data, prog)
        be = backend_mod.resolve(prog, info, log=False)
        self.trainer = Trainer(build_model(prog["model.py"], info, prog), prog, info,
                               device=self.device)
        kb = KGBatcher(ds, info, label_batch_size=int(prog["label_batch_size"]),
                       pair_mode=self.cell["mix"]["pair_mode"],
                       seed=traffic.port_seed(self.seed), backend=be,
                       device=self.trainer.device)
        self.items_per_epoch = kb.num_labels
        self.feed = bench.feed_for(kb)
        self.weights = bench.draw_weights(self.weight_spec(), self.seed, self.device)
        self.state = self.trainer.state_from_tree(
            {"params": self.weights, "batch_stats": {}}, seed=traffic.port_seed(self.seed))
        self.weights = {k: v.cpu() for k, v in self.weights.items()}  # the reference's copy

    def weight_spec(self) -> Dict[str, tuple]:
        spec = {}
        for name, shape in ref.leaves(self.config, self.kg["entities"],
                                      self.kg["relations"]).items():
            if name.endswith(".bias"):
                init = "zeros"
            elif name == "embed.embedding":  # variance 1/dim
                init = math.sqrt(3.0 / shape[1])
            else:  # per-channel Glorot over the last two axes
                init = math.sqrt(6.0 / (shape[-2] + shape[-1]))
            spec[name] = (shape, init)
        return spec

    def epoch_kwargs(self, epoch: int) -> dict:
        return {}

    def step_stats(self, xs) -> List[dict]:
        """Each step's real label rows (positive triples) of its slice."""
        valid = np.asarray(xs[1])
        return [{"labels": int(v.sum()), "rows": int(v.size)} for v in valid]

    def graph_stats(self) -> dict:
        """Per relation channel: its edges, and the entities that send and
        that receive along them (every entity, by the self loops)."""
        chans = []
        for idx, _, _ in self.port_data["adj"][0]:
            chans.append({"edges": len(idx), "receivers": len(np.unique(idx[:, 0])),
                          "senders": len(np.unique(idx[:, 1]))})
        return {"entities": self.kg["entities"], "channels": chans,
                "payload": self.program.get("tiled_compute_dtype", "bfloat16"),
                "dim": int(self.program["embedding_dim"])}

    def check_rows(self, rows) -> List[str]:
        """What is wrong with the epoch of label rows the program's feed
        gave (``[S, 1, L, 6]`` rows, ``[S, 1, L]`` validity): every
        training triple once among the real rows, each negative a copy of
        its positive with one side replaced by an entity."""
        ll, lv = np.asarray(rows[0])[:, 0].astype(np.int64), np.asarray(rows[1])[:, 0]
        train = self.kg["train"]
        n, R = self.kg["entities"], self.kg["relations"]
        real = lv > 0
        pos, neg = ll[real][:, :3], ll[real][:, 3:]
        keys = np.sort((pos[:, 0] * R + pos[:, 1]) * n + pos[:, 2])
        want = np.sort((train[:, 0] * R + train[:, 1]) * n + train[:, 2])
        out = []
        if not np.array_equal(keys, want):
            out.append("the epoch's real rows are not every training triple once")
        same_r = neg[:, 1] == pos[:, 1]
        one_side = (neg[:, 0] == pos[:, 0]) | (neg[:, 2] == pos[:, 2])
        in_range = (neg[:, [0, 2]] >= 0).all() and (neg[:, [0, 2]] < n).all()
        if not (same_r & one_side).all() or not in_range:
            out.append("a negative row that is no corruption of its positive")
        if not real.any(axis=1).all():
            out.append("a step with no real rows")
        return out

    def reference(self, rows, precision: str = "float32", half_batch: bool = False,
                  frozen: bool = False) -> dict:
        adj = ref.adjacency(self.kg, self.device)
        payload = self.program.get("tiled_compute_dtype", "bfloat16")
        ll, lv = np.asarray(rows[0])[:, 0], np.asarray(rows[1])[:, 0]
        batches = ({"adj": adj, "payload": payload,
                    "rows": torch.as_tensor(ll[i], dtype=torch.long, device=self.device),
                    "valid": torch.as_tensor(lv[i], dtype=torch.float32, device=self.device)}
                   for i in range(len(ll)))
        weights = {k: v.to(self.device) for k, v in self.weights.items()}
        return common.train_readings(
            lambda p, b: ref.loss(p, b, precision, half_batch), weights, batches,
            float(self.program["learning_rate"]), bench.CHECK_STEPS, frozen)

    def free(self) -> None:
        for name in ("trainer", "feed", "state"):
            self.__dict__.pop(name, None)
