"""Model state and evaluation — the counterpart of the ``Trainer`` in
``kgcn_tpu/runtime/train.py:145-263, 423-475``.

This slice serves predictions, so the Trainer holds ``init_state``,
``eval_step``, ``evaluate`` and ``restore``.  ``fit``, the optimizer,
early stopping and the checkpoint policy come with the training slice
(ROADMAP.md queue A).

As in the JAX package, the state is data (``TrainState``: flat dicts of
parameters and BN statistics) and the model is a function of it: each step
runs the module through ``torch.func.functional_call`` on the state's
tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch
from torch.func import functional_call

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.runtime import checkpoint as ckpt
from kgcn_tpu_torch.runtime.device import device_from_arg
from kgcn_tpu_torch.runtime.metrics import aggregate_metrics


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]


class Trainer:
    """Runs a model of the :class:`ModelOutput` protocol on ``device``
    (CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(self, model: torch.nn.Module, config: Dict[str, Any],
                 info=None, device=None):
        self.device = device_from_arg(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.info = info

    # ---- state ---------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters drawn from ``torch.Generator().manual_seed(seed)``
        (on the CPU, so a seed gives the same weights on every device)."""
        gen = torch.Generator().manual_seed(int(seed))
        self.model.to("cpu").reset_parameters(gen)
        self.model.to(self.device)
        return self.state_from_tree({
            "params": dict(self.model.named_parameters()),
            "batch_stats": dict(self.model.named_buffers()),
        })

    def state_from_tree(self, tree: ckpt.Tree) -> TrainState:
        """A TrainState on this device from a ``{"params", "batch_stats"}``
        tree; the names must be exactly the model's."""
        want_p = {k for k, _ in self.model.named_parameters()}
        want_b = {k for k, _ in self.model.named_buffers()}
        got_p, got_b = set(tree["params"]), set(tree["batch_stats"])
        if got_p != want_p or got_b != want_b:
            raise ValueError(
                "state does not fit the model: missing "
                f"{sorted((want_p - got_p) | (want_b - got_b))}, unexpected "
                f"{sorted((got_p - want_p) | (got_b - want_b))}"
            )

        def put(d):
            return {k: v.detach().to(self.device, torch.float32).clone()
                    for k, v in d.items()}

        return TrainState(params=put(tree["params"]),
                          batch_stats=put(tree["batch_stats"]))

    def restore(self, path: str) -> TrainState:
        """Parameters and BN statistics from a port checkpoint."""
        return self.state_from_tree(ckpt.load_checkpoint(path))

    # ---- steps ---------------------------------------------------------
    @torch.no_grad()
    def eval_step(self, params, batch_stats, batch: Batch):
        """(prediction, cost_sum, metrics) of one batch, on the device."""
        out = functional_call(
            self.model, {**params, **batch_stats}, (batch.to(self.device),),
            {"train": False},
        )
        return out.prediction, out.cost_sum, out.metrics

    def evaluate(self, state: TrainState, batcher, key_prefix: str = ""):
        """Every batch of ``batcher`` in order; device outputs are copied to
        the host once at the end.  Padding rows are trimmed."""
        counts = batcher.batch_valid_counts()
        preds, costs, metric_list = [], [], []
        for batch in batcher.batches(shuffle=False):
            pred, cost_sum, metrics = self.eval_step(
                state.params, state.batch_stats, batch
            )
            preds.append(pred)
            costs.append(cost_sum)
            metric_list.append(metrics)
        preds = [p.cpu().numpy()[:n] for p, n in zip(preds, counts)]
        costs = [float(c) for c in costs]
        metric_list = [{k: v.cpu().numpy() for k, v in m.items()} for m in metric_list]
        n_total = sum(counts)
        agg = aggregate_metrics(
            metric_list, n_total, self.config.get("task", ""), key_prefix
        )
        return {
            "cost": float(np.sum(costs)) / max(n_total, 1),
            "metrics": agg or {},
            "prediction": np.concatenate(preds) if preds else None,
            "num": n_total,
        }
