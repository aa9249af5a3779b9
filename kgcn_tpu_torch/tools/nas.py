"""Neural architecture search over the GCN layer space — the port's copy of
``kgcn_tpu/tools/nas.py`` (reference: neural_architecture_search/
gcn_nas.py:129-196, DBONAS over kGCN layer graphs).

The search space is a parameterised GCN (depth, width, activation, batch
norm, dense tail, learning rate), explored by the Gaussian-process
optimiser of ``kgcn-torch-opt`` (``tools/hpo.py``): the same domain, so a
seed proposes the same candidates as ``kgcn_tpu``.

``SearchedGCN`` is built from the port's layers (``nn/layers.py``); its
submodules carry the scope names flax gives ``kgcn_tpu``'s ``SearchedGCN``
(``GraphConv_<i>``, ``GraphBatchNormalization_<i>``, ``GraphDense_<j>``,
``GraphGather_0``, ``Dense_0``), so ``convert.params_from_jax`` carries a
flax model's weights over by rule.  ``search`` trains each candidate with
the port's ``Trainer`` and Adam (``runtime/optim.py``) on batchers built
once.  With ``parallel > 1`` on one device the candidates train one at a
time, as in ``kgcn_tpu``; on several devices they train on the device
trial pool (``tools/parallel_trials.DeviceTrialPool``), one a device.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.models.base import ModelOutput
from kgcn_tpu_torch.models.standard import softmax_ce_cost
from kgcn_tpu_torch.nn import layers as knn
from kgcn_tpu_torch.tools.hpo import Domain, optimize

NAS_DOMAIN = [
    {"name": "num_gcn_layer", "type": "discrete", "domain": (1, 2, 3, 4),
     "data_type": "int"},
    {"name": "hidden", "type": "discrete", "domain": (16, 32, 50, 64, 128),
     "data_type": "int"},
    {"name": "activation", "type": "discrete", "domain": (0, 1, 2),
     "data_type": "int"},  # 0=sigmoid 1=relu 2=tanh
    {"name": "use_bn", "type": "discrete", "domain": (0, 1), "data_type": "int"},
    {"name": "num_dense_layer", "type": "discrete", "domain": (0, 1, 2),
     "data_type": "int"},
    {"name": "learning_rate", "type": "continuous", "domain": (1e-4, 3e-2)},
]

_ACTS = [torch.sigmoid, torch.relu, torch.tanh]


class SearchedGCN(nn.Module):
    """A GCN instantiated from a NAS parameter dict: ``num_gcn`` ×
    (GraphConv, optional BN, activation), ``num_dense`` × activated
    GraphDense, GraphGather, a final Dense and the softmax-CE head."""

    def __init__(self, in_features: int, channels: int, label_dim: int,
                 arch: Tuple):
        super().__init__()
        self.arch = tuple(int(a) for a in arch)
        num_gcn, hidden, _, use_bn, num_dense = self.arch
        for i in range(num_gcn):
            setattr(self, f"GraphConv_{i}",
                    knn.GraphConv(in_features if i == 0 else hidden, hidden, channels))
            if use_bn:
                setattr(self, f"GraphBatchNormalization_{i}",
                        knn.GraphBatchNormalization(hidden))
        for j in range(num_dense):
            setattr(self, f"GraphDense_{j}", knn.GraphDense(hidden, hidden))
        self.GraphGather_0 = knn.GraphGather()
        self.Dense_0 = knn.Dense(hidden, label_dim)
        self.reset_parameters()

    def reset_parameters(self, generator=None) -> None:
        """Draw every parameter from ``generator`` (layer order fixed)."""
        for _, m in self.named_children():
            if isinstance(m, knn.Dense):
                knn.reset_linear_(m, generator)
            elif hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, batch: Batch, train: bool = False,
                generator=None) -> ModelOutput:
        num_gcn, _, act_idx, use_bn, num_dense = self.arch
        act = _ACTS[act_idx]
        g = batch.graph.with_dense_adj()
        x = g.nodes
        for i in range(num_gcn):
            x = getattr(self, f"GraphConv_{i}")(x, g)
            if use_bn:
                x = getattr(self, f"GraphBatchNormalization_{i}")(
                    x, g, use_running_average=not train)
            x = act(x)
        for j in range(num_dense):
            x = act(getattr(self, f"GraphDense_{j}")(x, g))
        h = self.GraphGather_0(x, g)
        logits = self.Dense_0(h)
        cost_opt, cost_sum, pred, metrics = softmax_ce_cost(
            logits, batch.labels, batch.pad_mask)
        return ModelOutput(pred, cost_opt, cost_sum, metrics)


def build_from_params(params: Dict, info) -> SearchedGCN:
    return SearchedGCN(
        in_features=info.feature_dim,
        channels=info.adj_channel_num,
        label_dim=info.label_dim or 2,
        arch=(
            int(params["num_gcn_layer"]),
            int(params["hidden"]),
            int(params["activation"]),
            int(params["use_bn"]),
            int(params["num_dense_layer"]),
        ),
    )


def search(train_ds, valid_ds, info, config, max_iter: int = 10, seed: int = 0,
           log=print, parallel: int = 1, device=None, devices=None):
    """NAS loop: each candidate trains ``config["epoch"]`` epochs (default
    10) and reports its validation cost (inf once an epoch's cost is not
    finite) → (best params, best value, history), as ``tools/hpo.optimize``.
    ``device``: None for the GPU (raises without one) or "cpu".
    ``parallel`` > 1 on several devices (``devices``, default the visible
    GPUs; a device may repeat) trains that many candidates at once, one a
    device (``tools/parallel_trials.DeviceTrialPool``, proposals from
    ``tools/hpo.optimize_parallel``)."""
    from kgcn_tpu_torch.cli.opt import trial_devices, trial_end
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.runtime import optim
    from kgcn_tpu_torch.runtime.device import device_from_arg
    from kgcn_tpu_torch.runtime.train import Trainer

    device = device_from_arg(device)
    if int(parallel or 1) > 1:
        devices = list(devices) if devices is not None else trial_devices(device)
        if len(devices) > 1:
            from kgcn_tpu_torch.tools.hpo import optimize_parallel
            from kgcn_tpu_torch.tools.parallel_trials import DeviceTrialPool

            pool = DeviceTrialPool(dict(config), train_ds, info, valid_ds=valid_ds,
                                   model_builder=lambda cfg, params, inf:
                                       build_from_params(params, inf),
                                   devices=devices)
            k = min(int(parallel), len(devices))
            log(f"[nas] {k} candidates per round, one per device")
            return optimize_parallel(pool.run_batch, Domain(NAS_DOMAIN), max_iter=max_iter,
                                     batch=k, seed=seed, log=log)
        log("[nas] single device — sequential candidates")

    # batchers are data-only — built once, not per candidate (only the
    # model and its Trainer are per-candidate state)
    bs = int(config.get("batch_size", 10))
    tb = Batcher(train_ds, info, bs, seed=seed)
    vb = Batcher(valid_ds, info, bs)

    def objective(params: Dict) -> float:
        try:
            model = build_from_params(params, info)
            cfg = dict(config)
            cfg["learning_rate"] = float(params["learning_rate"])
            cfg["save_interval"] = 0
            tx = optim.chain(optim.scale_by_adam(),
                             optim.scale_by_learning_rate(cfg["learning_rate"]))
            trainer = Trainer(model, cfg, info, device=device, tx=tx)
            state = trainer.init_state(seed=seed)
            for _ in range(int(cfg.get("epoch", 10))):
                state, cost, _, _ = trainer.run_epoch(state, tb)
                if not np.isfinite(cost):
                    return float("inf")
            return trainer.evaluate(state, vb)["cost"]
        finally:
            if device.type == "cuda":
                trial_end(device)

    return optimize(objective, Domain(NAS_DOMAIN), max_iter=max_iter,
                    seed=seed, log=log)
