"""Training runtime — the counterpart of ``kgcn_tpu/runtime/train.py``:
train and eval steps, the streaming epoch loop, early stopping, the
checkpoint policy and the non-finite abort.

As in the JAX package, the state is data (``TrainState``: flat dicts of
parameters and BN statistics, the optimizer state, the step count, the
dropout generator and the epoch to start from) and the model is a function
of it: each step runs the module through ``torch.func.functional_call`` on
the state's tensors, ``torch.autograd.grad`` gives the gradients, and the
optimizer (``runtime/optim.py``, optax's update rules) the new parameters.

Only the streaming path is ported: the JAX package's device-resident epoch
(``runtime/resident.py``) is off for the tiled backend there too
(``resident.py:102-108``), and on the dense path it is later work
(ROADMAP.md A.11).  Validation batches are built once and replayed
(``CachedBatches``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.runtime import checkpoint as ckpt
from kgcn_tpu_torch.runtime.device import device_from_arg
from kgcn_tpu_torch.runtime.metrics import aggregate_metrics
from kgcn_tpu_torch.runtime.optim import make_optimizer


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    batch_stats: Dict[str, torch.Tensor]
    opt_state: Any = None
    step: int = 0
    rng: Optional[torch.Generator] = None  # dropout draws, on the device
    epoch: int = 0  # the epoch fit() starts from


class EarlyStopping:
    """Stop when the validation cost fails to improve ``patience``
    consecutive epochs (reference: kgcn/core.py:15-76)."""

    def __init__(self, patience: int = 0, task: str = "classification"):
        self.patience = patience
        self.task = task
        self.prev_cost: Optional[float] = None
        self.count = 0

    def update(self, validation_cost: float) -> bool:
        stop = False
        if self.prev_cost is not None and self.prev_cost < validation_cost:
            self.count += 1
            if self.patience > 0 and self.count >= self.patience:
                stop = True
        else:
            self.count = 0
        self.prev_cost = validation_cost
        return stop


class EarlyStoppingMultiTask(EarlyStopping):
    """The same stopping rule, with per-task accuracies on the epoch line
    (config ``early_stopping: "multitask"``; reference kgcn/core.py:78-117)."""

    @staticmethod
    def each_bit(metrics: Optional[Dict[str, Any]], key: str) -> str:
        if not metrics or key not in metrics:
            return ""
        vals = np.asarray(metrics[key]).ravel()
        return " (each acc=[" + " ".join(f"{v:.3g}" for v in vals) + "])"


class CachedBatches:
    """A batcher's shuffle=False batches, built and moved to the device
    once, then replayed (validation batches are the same every epoch)."""

    def __init__(self, batcher, device):
        self._batcher = batcher
        self._device = device
        self._cache = None
        self.ds = batcher.ds

    def batch_valid_counts(self):
        return self._batcher.batch_valid_counts()

    def batches(self, shuffle: bool = False):
        if shuffle:
            raise ValueError("CachedBatches replays a fixed shuffle=False order")
        if self._cache is None:
            self._cache = [b.to(self._device) for b in self._batcher.batches(shuffle=False)]
        return iter(self._cache)


def _generator_state(gen: Optional[torch.Generator]) -> torch.Tensor:
    return gen.get_state() if gen is not None else torch.zeros(0, dtype=torch.uint8)


class Trainer:
    """Runs a model of the :class:`ModelOutput` protocol on ``device``
    (CUDA unless the caller passes ``device="cpu"``)."""

    def __init__(self, model: torch.nn.Module, config: Dict[str, Any],
                 info=None, device=None, tx=None):
        self.device = device_from_arg(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.info = info
        self.tx = tx if tx is not None else make_optimizer(config)
        self._restored_best_cost = np.inf

    # ---- state ---------------------------------------------------------
    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def init_state(self, seed: int = 0) -> TrainState:
        """Fresh parameters drawn from ``torch.Generator().manual_seed(seed)``
        (on the CPU, so a seed gives the same weights on every device), a
        fresh optimizer state, and the dropout generator seeded alike."""
        gen = torch.Generator().manual_seed(int(seed))
        self.model.to("cpu").reset_parameters(gen)
        self.model.to(self.device)
        return self.state_from_tree({
            "params": dict(self.model.named_parameters()),
            "batch_stats": dict(self.model.named_buffers()),
        }, seed=seed)

    def state_from_tree(self, tree: ckpt.Tree, seed: int = 0) -> TrainState:
        """A TrainState on this device from a checkpoint tree; the names must
        be exactly the model's.  A ``{"params", "batch_stats"}`` tree gets a
        fresh optimizer state; a full training tree resumes after its saved
        epoch."""
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

        params = put(tree["params"])
        state = TrainState(params=params, batch_stats=put(tree["batch_stats"]),
                           opt_state=self.tx.init(params),
                           rng=self._generator(seed))
        if "opt_state" not in tree:
            return state
        state.opt_state = _opt_to(tree["opt_state"], self.device)
        state.step = int(tree["step"])
        # a CUDA generator's state and a CPU one's differ in size: a
        # checkpoint written on the other device type keeps the fresh
        # seeded generator (the dropout masks differ across devices anyway)
        if tree["rng"].numel() == state.rng.get_state().numel():
            state.rng.set_state(tree["rng"])
        # resume AFTER the saved epoch; with the (seed, epoch) shuffle this
        # replays the exact data order
        state.epoch = int(tree["epoch"]) + 1
        return state

    def state_tree(self, state: TrainState, epoch: int, best_cost: float) -> ckpt.Tree:
        return {
            "params": state.params,
            "batch_stats": state.batch_stats,
            "opt_state": state.opt_state,
            "step": torch.tensor(state.step, dtype=torch.int64),
            "rng": _generator_state(state.rng),
            "epoch": torch.tensor(int(epoch), dtype=torch.int32),
            "best_cost": torch.tensor(float(best_cost), dtype=torch.float32),
        }

    def restore(self, path: str) -> TrainState:
        """The state of a checkpoint: parameters and BN statistics, and, for
        a training checkpoint, the optimizer state, step, generator and
        epoch (its best validation cost carries into the next ``fit``)."""
        tree = ckpt.load_checkpoint(path)
        if "best_cost" in tree:
            self._restored_best_cost = float(tree["best_cost"])
        return self.state_from_tree(tree)

    # ---- steps ---------------------------------------------------------
    def train_step(self, state: TrainState, batch: Batch):
        """One optimizer step → (new state, cost_sum, metrics), on the
        device.  The BN running statistics are updated in copies of the
        state's buffers (the layers update them in place)."""
        batch = batch.to(self.device)
        names = list(state.params)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        stats = {k: v.clone() for k, v in state.batch_stats.items()}
        out = functional_call(self.model, {**params, **stats}, (batch,),
                              {"train": True, "generator": state.rng})
        grads = torch.autograd.grad(out.cost_opt, [params[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        with torch.no_grad():
            updates, opt_state = self.tx.update(grads, state.opt_state, state.params)
            new_params = {k: state.params[k] + updates[k] for k in names}
        new_state = dataclasses.replace(state, params=new_params, batch_stats=stats,
                                        opt_state=opt_state, step=state.step + 1)
        metrics = {k: v.detach() for k, v in out.metrics.items()}
        return new_state, out.cost_sum.detach(), metrics

    @torch.no_grad()
    def eval_step(self, params, batch_stats, batch: Batch):
        """(prediction, cost_sum, metrics) of one batch, on the device."""
        out = functional_call(
            self.model, {**params, **batch_stats}, (batch.to(self.device),),
            {"train": False},
        )
        return out.prediction, out.cost_sum, out.metrics

    # ---- loops ---------------------------------------------------------
    def run_epoch(self, state: TrainState, batcher, shuffle=True,
                  epoch: Optional[int] = None):
        """One pass over ``batcher`` → (state, mean cost, per-step metric
        dicts, examples); device outputs are read once at the end."""
        costs, metric_list = [], []
        for batch in batcher.batches(shuffle=shuffle, epoch=epoch):
            state, cost_sum, metrics = self.train_step(state, batch)
            costs.append(cost_sum)
            metric_list.append(metrics)
        costs = torch.stack(costs).cpu().numpy() if costs else np.zeros(0)
        metric_list = [{k: v.cpu().numpy() for k, v in m.items()} for m in metric_list]
        n_total = batcher.valid_per_epoch
        return state, float(np.sum(costs)) / max(n_total, 1), metric_list, n_total

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

    def fit(self, state: TrainState, train_batcher, valid_batcher=None,
            fold: Optional[int] = None, log: Callable[[str], None] = print):
        """Epoch loop with validation, early stopping and checkpoints
        (``kgcn_tpu``'s ``Trainer.fit``; reference kgcn/core.py:211-370):
        ``best`` on each validation improvement, ``<NNNNN>`` every
        ``save_interval`` epochs, ``last`` at the end (the final state,
        taken before the best one is restored for the final evaluation);
        a non-finite training cost aborts."""
        cfg = self.config
        epochs = int(cfg.get("epoch", 50))
        patience = int(cfg.get("patience", 0))
        save_interval = int(cfg.get("save_interval", 10) or 0)
        model_dir = cfg.get("save_model_path") or "model"
        task = cfg.get("task", "multitask_classification")

        if str(cfg.get("early_stopping", "")) == "multitask":
            es = EarlyStoppingMultiTask(patience, task)
        else:
            es = EarlyStopping(patience, task)
        if valid_batcher is not None and hasattr(valid_batcher, "batch_valid_counts"):
            valid_batcher = CachedBatches(valid_batcher, self.device)
        # a resumed run keeps the checkpointed best validation cost, so it
        # cannot overwrite a better best checkpoint with a worse model
        best_cost = float(self._restored_best_cost)
        self._restored_best_cost = np.inf
        best_epoch = -1
        aborted = False
        history: List[Dict[str, Any]] = []
        t0 = time.time()

        start_epoch = int(state.epoch or 0)
        last_epoch = start_epoch - 1
        for epoch in range(start_epoch, epochs):
            state, train_cost, train_metrics, n_train = self.run_epoch(
                state, train_batcher, shuffle=cfg.get("shuffle_data", True),
                epoch=epoch,
            )
            if not np.isfinite(train_cost):
                log(f"[abort] non-finite training cost at epoch {epoch}")
                aborted = True
                break
            last_epoch = epoch
            train_agg = aggregate_metrics(train_metrics, n_train, task, "training_")

            row = {"epoch": epoch, "training_cost": train_cost}
            if train_agg:
                row.update({k: v for k, v in train_agg.items() if np.asarray(v).ndim == 0})
            valid_cost = None
            if valid_batcher is not None and valid_batcher.ds.num > 0:
                ev = self.evaluate(state, valid_batcher, "validation_")
                valid_cost = ev["cost"]
                row["validation_cost"] = valid_cost
                row.update({k: float(np.asarray(v)) for k, v in ev["metrics"].items()
                            if np.asarray(v).ndim == 0})
                if valid_cost < best_cost:
                    best_cost = valid_cost
                    best_epoch = epoch
                    ckpt.save_tree(ckpt.ckpt_name(model_dir, "best", fold),
                                   self.state_tree(state, epoch, best_cost))
            history.append(row)

            save_path = None
            if save_interval and (epoch + 1) % save_interval == 0:
                save_path = ckpt.save_tree(
                    ckpt.ckpt_name(model_dir, f"{epoch + 1:05d}", fold),
                    self.state_tree(state, epoch, best_cost),
                )

            acc_bit = ""
            if "training_accuracy" in row:
                acc_bit = f" (acc={row['training_accuracy']:.4g})"
            if isinstance(es, EarlyStoppingMultiTask):
                acc_bit += es.each_bit(train_agg, "training_each_accuracy")
            v_bit = ""
            if valid_cost is not None:
                vacc = row.get("validation_accuracy")
                v_bit = f", validation cost {valid_cost:.6g}" + (
                    f" (acc={vacc:.4g})" if vacc is not None else "")
                if isinstance(es, EarlyStoppingMultiTask):
                    v_bit += es.each_bit(ev["metrics"], "validation_each_accuracy")
            s_bit = f" ([SAVE] {save_path})" if save_path else ""
            stop = valid_cost is not None and es.update(valid_cost)
            log(f"epoch {epoch}, training cost {train_cost:.6g}{acc_bit}"
                f"{v_bit} (count={es.count}){s_bit}")
            if stop:
                log("[stop] by validation")
                break

        last_tree = self.state_tree(state, last_epoch, best_cost)
        # restore the best state before the final evaluation
        if best_epoch >= 0:
            tree = ckpt.load_checkpoint(ckpt.ckpt_name(model_dir, "best", fold))
            best = self.state_from_tree(tree)
            state = dataclasses.replace(state, params=best.params,
                                        batch_stats=best.batch_stats)
            log(f"[restore] best epoch {best_epoch} (cost {best_cost:.6g})")
            if aborted:
                # the final state is non-finite: the best checkpoint's whole
                # tree is the only resumable state
                last_tree = tree
        if aborted and best_epoch < 0:
            log("[abort] skipping the 'last' checkpoint (non-finite state); "
                "resume from an interval/best checkpoint instead")
        else:
            ckpt.save_tree(ckpt.ckpt_name(model_dir, "last", fold), last_tree)
        return state, {
            "history": history,
            "best_epoch": best_epoch,
            "best_validation_cost": None if best_epoch < 0 else float(best_cost),
            "training_time": time.time() - t0,
        }


def _opt_to(tree, device):
    """An optimizer state on ``device``; step counters stay on the host."""
    if isinstance(tree, dict):
        return {k: _opt_to(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor) and tree.dtype.is_floating_point:
        return tree.to(device)
    return tree
