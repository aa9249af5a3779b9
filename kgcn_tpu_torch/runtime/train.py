"""Training runtime — the counterpart of ``kgcn_tpu/runtime/train.py``:
train and eval steps, the epoch runners, early stopping, the checkpoint
policy and the non-finite abort.

As in the JAX package, the state is data (``TrainState``: flat dicts of
parameters and BN statistics, the optimizer state, the step count, the
dropout generator and the epoch to start from) and the model is a function
of it: each step runs the module through ``torch.func.functional_call`` on
the state's tensors, ``torch.autograd.grad`` gives the gradients, and the
optimizer (``runtime/optim.py``, optax's update rules) the new parameters.

``run_epoch`` dispatches as the JAX trainer does (``train.py:358-363``): a
batcher with ``epoch_schedule`` (``runtime/resident.ResidentBatcher``)
runs the whole-epoch resident runner, one with ``epoch_scan_inputs``
(``models/kg.KGBatcher``, ``models/pair.ResidentPairBatcher``,
``runtime/resident.ResidentVAEBatcher``) the scanned epoch, and any other
the streaming loop, its batches assembled ahead in a thread
(``data/prefetch.py``) and moved to the device one by one.  A batch is a
``Batch``, or a ``models/pair.PairBatch`` of two; a prediction is a
tensor, or a dict of tensors (the VAE's).
``evaluate`` runs the resident evaluation runner for a resident batcher
(``Trainer`` itself, not a subclass, as there).  The runners
(``runtime/runner.py``) replay each step from one captured CUDA graph on
the card, unless the trainer was made with ``capture=False``; on the CPU
they run eagerly.  Validation batches of the
streaming path are built once and replayed (``CachedBatches``), where the
resident memory budget admits them.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch.func import functional_call

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.data.prefetch import prefetch
from kgcn_tpu_torch.runtime import checkpoint as ckpt
from kgcn_tpu_torch.runtime.device import device_from_arg
from kgcn_tpu_torch.runtime.metrics import aggregate_metrics
from kgcn_tpu_torch.runtime.optim import make_optimizer
from kgcn_tpu_torch.runtime.resident import (
    DEFAULT_RESIDENT_BUDGET, estimate_bytes, gather_batch,
)
from kgcn_tpu_torch.runtime.runner import EvalRunner, TrainRunner, read_back


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


def _cache_fits(batcher) -> bool:
    """Gate ``CachedBatches`` on the resident memory budget: pinning a large
    validation split's device batches for the whole fit would take memory
    on datasets the resident path itself declines."""
    ds = getattr(batcher, "ds", None)
    if ds is None or getattr(ds, "adjs", None) is None:
        return True  # batchers without a graph dataset: small by construction
    max_nodes = int(getattr(batcher, "max_nodes", 0) or 0) or 1
    return estimate_bytes(ds, max_nodes) <= DEFAULT_RESIDENT_BUDGET


def _scan_batch(batcher, const_batch):
    """A scanned epoch's step batch: the batcher type's ``make_scan_batch``
    of the constant batch, step ``i``'s row of each per-step input and the
    runner's generator (what the batch draws on the device)."""
    def make(i, xs, generator=None):
        return type(batcher).make_scan_batch(
            const_batch, tuple(x.index_select(0, i)[0] for x in xs), generator)
    return make


def _schedule_batch(device_data):
    """A resident epoch's step batch: schedule row ``i`` gathered from the
    device dataset (``resident.gather_batch``)."""
    def make(i, xs, generator=None):
        return gather_batch(device_data, xs[0].index_select(0, i)[0],
                            xs[1].index_select(0, i)[0])
    return make


def _trimmed(preds, counts):
    """Per-step predictions ``[S, B, ...]`` (or a dict of them) without the
    padding rows, the steps concatenated."""
    if isinstance(preds, dict):
        return {k: _trimmed(v, counts) for k, v in preds.items()}
    return np.concatenate([np.asarray(preds[s])[:n] for s, n in enumerate(counts)])


def _metric_list(metrics: Dict[str, np.ndarray], n_steps: int):
    return [{k: v[s] for k, v in metrics.items()} for s in range(n_steps)]


def _generator_state(gen: Optional[torch.Generator]) -> torch.Tensor:
    return gen.get_state() if gen is not None else torch.zeros(0, dtype=torch.uint8)


class Trainer:
    """Runs a model of the :class:`ModelOutput` protocol on ``device``
    (CUDA unless the caller passes ``device="cpu"``).  ``capture``: on CUDA
    the epoch runners replay each step from a captured CUDA graph; False
    runs the same steps eagerly (the yardstick of the captured ones)."""

    def __init__(self, model: torch.nn.Module, config: Dict[str, Any],
                 info=None, device=None, tx=None, capture: bool = True):
        self.device = device_from_arg(device)
        self.model = model.to(self.device).eval()
        self.config = config
        self.info = info
        self.tx = tx if tx is not None else make_optimizer(config)
        # debug_nan (kgcn_tpu's jax_debug_nans): the run stops at the first
        # non-finite cost or gradient; each step is checked, so the runners
        # run eagerly (a captured step cannot read the card)
        self.debug_nan = bool(config.get("debug_nan"))
        self.capture = (bool(capture) and self.device.type == "cuda"
                        and not self.debug_nan)
        # mixed precision (kgcn_tpu/runtime/train.py:162-169): "precision":
        # "bfloat16" casts each step's batch payload to bf16 (``_cast``);
        # parameters, optimizer state and losses stay float32
        self.compute_dtype = (torch.bfloat16
                              if str(config.get("precision", "float32")) == "bfloat16"
                              else None)
        self._restored_best_cost = np.inf
        self._runners: Dict[tuple, Any] = {}

    def _cast(self, batch):
        """``batch`` with its compute payload in ``compute_dtype``
        (``Batch.cast_compute``), as ``kgcn_tpu``'s ``Trainer._cast``: a
        batch type without ``cast_compute`` (the pair engine's) stays as it
        is."""
        if self.compute_dtype is not None and hasattr(batch, "cast_compute"):
            return batch.cast_compute(self.compute_dtype)
        return batch

    def check_finite(self, cost, grads) -> None:
        """With ``debug_nan``: raise ``FloatingPointError`` if the step's cost
        or a gradient is not finite (one read of the device a step)."""
        if not self.debug_nan:
            return
        cost = cost.detach()
        bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
        if not bool(torch.isfinite(cost).all()) or bad:
            raise FloatingPointError(
                f"debug_nan: non-finite {'gradient of ' + ', '.join(bad) if bad else 'cost'}"
                f" (cost {float(cost)})")

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
        # checkpoint written on the other device type, or by kgcn_tpu (whose
        # PRNG key comes back empty), keeps the fresh seeded generator (the
        # dropout masks differ across devices anyway)
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
        epoch (its best validation cost carries into the next ``fit``).  A
        flax-msgpack checkpoint of ``kgcn_tpu`` is read and converted for
        this model and optimizer; its dropout generator is the fresh one
        seeded from the config's ``seed`` (JAX's PRNG key does not map onto
        a ``torch.Generator``)."""
        tree = ckpt.load_checkpoint(path, model=self.model, tx=self.tx)
        if "best_cost" in tree:
            self._restored_best_cost = float(tree["best_cost"])
        return self.state_from_tree(tree, seed=int(self.config.get("seed", 0)))

    # ---- steps ---------------------------------------------------------
    def reduce_step(self, grads, batch_stats, cost_sum, metrics):
        """A step's gradients, BN statistics (updated in place), cost sum
        and metrics as the update and the records take them: this device's
        own here; ``parallel/dp.DPTrainer`` reduces them across ranks."""
        return grads, cost_sum, metrics

    def save_tree(self, path: str, tree: ckpt.Tree) -> str:
        """Write a checkpoint of ``fit`` (``DPTrainer``: rank 0 writes, the
        others wait)."""
        return ckpt.save_tree(path, tree)

    def apply(self, params, batch_stats, batch, **kwargs):
        """The model's output on ``batch`` with these parameters and BN
        statistics (``functional_call``): every step and evaluation runs
        the model here (``parallel/tp.TPTrainer`` runs its sharded layers
        column-parallel)."""
        return functional_call(self.model, {**params, **batch_stats}, (batch,), kwargs)

    def train_step(self, state: TrainState, batch: Batch):
        """One optimizer step → (new state, cost_sum, metrics), on the
        device.  The BN running statistics are updated in copies of the
        state's buffers (the layers update them in place)."""
        batch = self._cast(batch.to(self.device))
        names = list(state.params)
        params = {k: v.detach().requires_grad_(True) for k, v in state.params.items()}
        stats = {k: v.clone() for k, v in state.batch_stats.items()}
        out = self.apply(params, stats, batch, train=True, generator=state.rng)
        grads = torch.autograd.grad(out.cost_opt, [params[k] for k in names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        grads, cost_sum, metrics = self.reduce_step(grads, stats, out.cost_sum,
                                                    out.metrics)
        self.check_finite(out.cost_opt, grads)
        with torch.no_grad():
            updates, opt_state = self.tx.update(grads, state.opt_state, state.params)
            new_params = {k: state.params[k] + updates[k] for k in names}
        new_state = dataclasses.replace(state, params=new_params, batch_stats=stats,
                                        opt_state=opt_state, step=state.step + 1)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_state, cost_sum.detach(), metrics

    @torch.no_grad()
    def eval_step(self, params, batch_stats, batch: Batch):
        """(prediction, cost_sum, metrics) of one batch, on the device."""
        out = self.apply(params, batch_stats, self._cast(batch.to(self.device)),
                         train=False)
        return out.prediction, out.cost_sum, out.metrics

    # ---- whole-epoch runners -------------------------------------------
    def _runner(self, kind, key, n_steps, make, xs, keep_alive):
        """The runner of ``kind`` for one batcher's data (``key``) and epoch
        length, made (and on the card captured) at its first epoch.  Its
        step batches are cast (``_cast``) where they are made, inside the
        step, as ``kgcn_tpu`` casts inside its scanned step."""
        full = (kind, key, n_steps)
        runner = self._runners.get(full)
        if runner is None:
            cls = TrainRunner if kind != "eval" else EvalRunner

            def cast_make(i, xs, generator=None):
                return self._cast(make(i, xs, generator))

            runner = self._runners[full] = cls(self, n_steps, cast_make, xs, keep_alive)
        return runner

    def epoch_on_device(self, state: TrainState, batcher, shuffle=True,
                        epoch: Optional[int] = None):
        """One epoch through a whole-epoch runner: a resident batcher's
        schedule (``epoch_schedule``) or a scanned batcher's per-step inputs
        (``epoch_scan_inputs``) → (state, costs ``[S]``, metrics ``{name:
        [S, ...]}``), the outputs left on the device and nothing read
        back."""
        if hasattr(batcher, "epoch_schedule"):
            xs = batcher.epoch_schedule(shuffle=shuffle, epoch=epoch)
            dd = batcher.device_data
            runner = self._runner("train", id(dd), len(xs[0]), _schedule_batch(dd), xs, dd)
        else:
            const, xs = batcher.epoch_scan_inputs(shuffle=shuffle, epoch=epoch)
            runner = self._runner("scan", id(const), len(xs[0]), _scan_batch(batcher, const),
                                  xs, const)
        return runner.run(state, xs)

    def eval_on_device(self, state: TrainState, batcher):
        """A resident batcher's evaluation through the evaluation runner →
        (predictions ``{name: [S, B, ...]}``, costs ``[S]``, metrics
        ``{name: [S, ...]}``), left on the device, nothing read back."""
        xs = batcher.epoch_schedule(shuffle=False)
        dd = batcher.device_data
        runner = self._runner("eval", id(dd), len(xs[0]), _schedule_batch(dd), xs, dd)
        return runner.run(state.params, state.batch_stats, xs)

    def _run_epoch_runner(self, state, batcher, shuffle, epoch):
        state, costs, metrics = self.epoch_on_device(state, batcher, shuffle, epoch)
        names = list(metrics)
        costs, *values = read_back(costs, *(metrics[k] for k in names))
        n_total = batcher.valid_per_epoch
        return (state, float(np.sum(costs)) / max(n_total, 1),
                _metric_list(dict(zip(names, values)), len(costs)), n_total)

    def _evaluate_resident(self, state: TrainState, batcher, key_prefix=""):
        """The whole evaluation through the resident evaluation runner;
        padding rows trimmed by ``batch_valid_counts``."""
        preds, costs, metrics = self.eval_on_device(state, batcher)
        names, keys = list(metrics), list(preds)
        costs, *values = read_back(costs, *(metrics[k] for k in names),
                                   *(preds[k] for k in keys))
        preds = dict(zip(keys, values[len(names):]))
        counts = batcher.batch_valid_counts()
        n_total = sum(counts)
        agg = aggregate_metrics(_metric_list(dict(zip(names, values)), len(costs)),
                                n_total, self.config.get("task", ""), key_prefix)
        return {
            "cost": float(np.sum(costs)) / max(n_total, 1),
            "metrics": agg or {},
            "prediction": _trimmed(preds[None] if keys == [None] else preds, counts),
            "num": n_total,
        }

    # ---- loops ---------------------------------------------------------
    def run_epoch(self, state: TrainState, batcher, shuffle=True,
                  epoch: Optional[int] = None):
        """One pass over ``batcher`` → (state, mean cost, per-step metric
        dicts, examples); device outputs are read once at the end.  A
        resident or scanned batcher takes its whole-epoch runner; any other
        the streaming loop, with its batches prefetched."""
        if hasattr(batcher, "epoch_schedule") or hasattr(batcher, "epoch_scan_inputs"):
            return self._run_epoch_runner(state, batcher, shuffle, epoch)
        costs, metric_list = [], []
        for batch in prefetch(batcher.batches(shuffle=shuffle, epoch=epoch)):
            state, cost_sum, metrics = self.train_step(state, batch)
            costs.append(cost_sum)
            metric_list.append(metrics)
        costs = torch.stack(costs).cpu().numpy() if costs else np.zeros(0)
        metric_list = [{k: v.cpu().numpy() for k, v in m.items()} for m in metric_list]
        n_total = batcher.valid_per_epoch
        return state, float(np.sum(costs)) / max(n_total, 1), metric_list, n_total

    def evaluate(self, state: TrainState, batcher, key_prefix: str = ""):
        """Every batch of ``batcher`` in order; device outputs are copied to
        the host once at the end.  Padding rows are trimmed.  A resident
        batcher (also inside ``CachedBatches``) takes the evaluation
        runner."""
        inner = getattr(batcher, "_batcher", batcher)
        if hasattr(inner, "epoch_schedule") and type(self) is Trainer:
            return self._evaluate_resident(state, inner, key_prefix)
        counts = batcher.batch_valid_counts()
        preds, costs, metric_list = [], [], []
        for batch in prefetch(batcher.batches(shuffle=False)):
            pred, cost_sum, metrics = self.eval_step(
                state.params, state.batch_stats, batch
            )
            preds.append(pred)
            costs.append(cost_sum)
            metric_list.append(metrics)
        costs = [float(c) for c in costs]
        metric_list = [{k: v.cpu().numpy() for k, v in m.items()} for m in metric_list]
        n_total = sum(counts)
        agg = aggregate_metrics(
            metric_list, n_total, self.config.get("task", ""), key_prefix
        )
        if preds and isinstance(preds[0], dict):
            preds = {k: [p[k].cpu().numpy() for p in preds] for k in preds[0]}
        else:
            preds = [p.cpu().numpy() for p in preds]
        return {
            "cost": float(np.sum(costs)) / max(n_total, 1),
            "metrics": agg or {},
            "prediction": _trimmed(preds, counts) if counts else None,
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
        if (valid_batcher is not None and hasattr(valid_batcher, "batch_valid_counts")
                and _cache_fits(valid_batcher)):
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
                    self.save_tree(ckpt.ckpt_name(model_dir, "best", fold),
                                   self.state_tree(state, epoch, best_cost))
            history.append(row)

            save_path = None
            if save_interval and (epoch + 1) % save_interval == 0:
                save_path = self.save_tree(
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
            self.save_tree(ckpt.ckpt_name(model_dir, "last", fold), last_tree)
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
