"""Fold-parallel cross-validation — the counterpart of
``kgcn_tpu/parallel/cv.py``: the folds of a k-fold split trained at once,
fold f on rank f mod W (W the world size), each through the port's own
``Trainer`` and its resident runners.

The schedule law is ``kgcn_tpu``'s fold-parallel one: fold f shuffles its
training rows each epoch with its own ``RandomState(seed + f)``
(``rngs[f].permutation``) into steps of ``batch_size``, the last one
partial; there a group of folds shares the longest fold's step count and a
shorter or stopped fold's extra steps are dead (no update at all), so each
fold's training is its own steps alone, which is what a rank runs here.
Each epoch evaluates the fold's held-out rows; per-fold early stopping is
the sequential protocol's ``EarlyStopping`` (a stopped fold trains no
more), and the best-validation state is tracked and restored before the
test evaluation, as ``kgcn_tpu`` does (``:334-525``).  Each rank writes its
folds' ``best`` and ``last`` checkpoints; after a barrier every rank has
every fold's result (histories gathered, other ranks' states read from
their ``last`` checkpoints), and rank 0 writes ``cmd_train_cv``'s files."""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from kgcn_tpu_torch.parallel import mesh as pmesh
from kgcn_tpu_torch.runtime import checkpoint as ckpt
from kgcn_tpu_torch.runtime import resident
from kgcn_tpu_torch.runtime.metrics import aggregate_metrics
from kgcn_tpu_torch.runtime.runner import read_back


def fold_parallel_flag(config) -> str:
    """Config ``fold_parallel`` as 'off' | 'force' | 'auto'."""
    flag = config.get("fold_parallel", "auto")
    if flag in (False, "false", "off", 0, "0"):
        return "off"
    if flag in (True, "true", "force", 1, "1"):
        return "force"
    return "auto"


def fold_parallel_enabled(config, ds, info, n_folds: int, backend) -> bool:
    """The gate, as ``kgcn_tpu``'s: ``off`` wins; ``retrain`` (a resume is
    the sequential protocol's) and a dataset the resident gate declines
    train sequentially (said under ``force``); ``force`` runs (a ``mesh``
    config is then ignored, and said); ``auto`` needs a world of more than
    one rank, more than one fold and no ``mesh``."""
    flag = fold_parallel_flag(config)
    if flag == "off":
        return False
    if config.get("retrain"):
        if flag == "force":
            print("[fold_parallel] retrain (resume) set; sequential")
        return False
    if not resident.resident_enabled(config, ds, info, backend):
        if flag == "force":
            print("[fold_parallel] dataset not device-resident; sequential")
        return False
    if flag == "force":
        if config.get("mesh"):
            print("[fold_parallel] forced; the 'mesh' (data-parallel) config is "
                  "ignored on the fold-parallel path")
        return True
    return pmesh.world_size() > 1 and n_folds > 1 and not config.get("mesh")


def fold_parallel_plausible(config) -> bool:
    """The config-only pre-gate: can ``fold_parallel_enabled`` return True?
    (Lets ``cli/sparse.py`` skip loading the dataset when it cannot.)"""
    flag = fold_parallel_flag(config)
    if flag == "off" or config.get("retrain"):
        return False
    return flag == "force" or (pmesh.world_size() > 1 and not config.get("mesh"))


class _FoldData:
    """One schedule over the shared device dataset, for the runners."""

    def __init__(self, device_data, sched, valid, counts):
        self.device_data = device_data
        self._xs = (sched, valid)
        self._counts = counts

    def epoch_schedule(self, shuffle: bool = False, epoch=None):
        return self._xs

    def batch_valid_counts(self):
        return self._counts


def _schedule(rows: np.ndarray, B: int):
    """``[S, B]`` int32 rows (zero-padded) and float32 validity."""
    S = max(-(-len(rows) // B), 1)
    sched = np.zeros(S * B, np.int32)
    sched[:len(rows)] = rows
    valid = (np.arange(S * B) < len(rows)).astype(np.float32)
    return sched.reshape(S, B), valid.reshape(S, B)


def _metric_rows(metrics: Dict[str, np.ndarray], n_steps: int):
    return [{k: v[s] for k, v in metrics.items()} for s in range(n_steps)]


def _scalars(agg) -> Dict[str, float]:
    return {k: float(np.asarray(v)) for k, v in (agg or {}).items()
            if np.asarray(v).ndim == 0}


class FoldParallelCV:
    """Train the folds of ``folds`` (``[(train rows, test rows), ...]``)
    over the ranks.  ``run()`` returns, per fold, ``(trainer, state,
    fit_info)`` with ``Trainer.fit``'s ``fit_info`` keys, on every rank.

    ``model``: the model to train (default: the registry's
    ``config["model.py"]``); ``initial``: optional ``{fold: checkpoint
    tree}`` to start a fold from instead of the seed ``seed + f``."""

    def __init__(self, config: Dict[str, Any], info, ds, folds, *, backend,
                 device=None, seed: Optional[int] = None, model=None,
                 initial: Optional[Dict[int, Any]] = None):
        from kgcn_tpu_torch.runtime.train import Trainer

        self.config = config
        self.info = info
        self.ds = ds
        self.folds = [(np.asarray(tr), np.asarray(te)) for tr, te in folds]
        self.k = len(self.folds)
        self.B = int(config["batch_size"])
        self.seed = int(config.get("seed", 0)) if seed is None else int(seed)
        self.epochs = int(config.get("epoch", 50))
        self.task = config.get("task", "multitask_classification")
        if model is None:
            from kgcn_tpu_torch.models.registry import build_model

            model = build_model(config["model.py"], info, config)
        self.trainer = Trainer(model, config, info, device=device)
        self.initial = dict(initial or {})
        self.W, self.rank = pmesh.world_size(), pmesh.rank()
        # one upload of the dataset, shared by this rank's folds
        self.dd = resident.build_device_dataset(ds, info, backend=backend,
                                                device=self.trainer.device)

    def mine(self) -> List[int]:
        return [f for f in range(self.k) if f % self.W == self.rank]

    def _initial_state(self, f: int):
        if f in self.initial:
            return self.trainer.state_from_tree(self.initial[f], seed=self.seed + f)
        return self.trainer.init_state(self.seed + f)

    def _eval(self, state, rows):
        sched, valid = _schedule(rows, self.B)
        counts = [int(v.sum()) for v in valid]
        return self.trainer.evaluate(state, _FoldData(self.dd, sched, valid, counts),
                                     "validation_")

    def train_fold(self, f: int, log=print):
        """Fold ``f`` on this rank: (final state with the best parameters
        restored, fit_info); writes the fold's checkpoints."""
        from kgcn_tpu_torch.runtime.train import EarlyStopping, EarlyStoppingMultiTask

        cfg, tr = self.config, self.trainer
        train_rows, test_rows = self.folds[f]
        shuffle = bool(cfg.get("shuffle_data", True))
        patience = int(cfg.get("patience", 0) or 0)
        es = (EarlyStoppingMultiTask(patience, self.task)
              if str(cfg.get("early_stopping", "")) == "multitask"
              else EarlyStopping(patience, self.task))
        rng = np.random.RandomState(self.seed + f)
        state = self._initial_state(f)
        n_tr, n_va = len(train_rows), len(test_rows)
        history: List[Dict[str, Any]] = []
        best_cost, best_epoch, best_tree = np.inf, -1, None
        last_epoch = self.epochs - 1
        t0 = time.time()
        for epoch in range(self.epochs):
            perm = rng.permutation(train_rows) if shuffle else train_rows
            sched, valid = _schedule(perm, self.B)
            state, costs, metrics = tr.epoch_on_device(
                state, _FoldData(self.dd, sched, valid, None))
            names = list(metrics)
            costs, *values = read_back(costs, *(metrics[k] for k in names))
            ev = self._eval(state, test_rows)
            row = {"epoch": epoch,
                   "training_cost": float(np.sum(costs)) / max(n_tr, 1),
                   "validation_cost": float(ev["cost"])}
            row.update(_scalars(aggregate_metrics(
                _metric_rows(dict(zip(names, values)), len(costs)), n_tr, self.task,
                "training_")))
            row.update(_scalars(ev["metrics"]))
            history.append(row)
            if row["validation_cost"] < best_cost:
                best_cost, best_epoch = row["validation_cost"], epoch
                best_tree = ckpt._to_cpu(tr.state_tree(state, epoch, best_cost))
            log(f"epoch {epoch}, fold {f} training cost {row['training_cost']:.6g}, "
                f"validation cost {row['validation_cost']:.6g}")
            if es.update(row["validation_cost"]):
                last_epoch = epoch
                log(f"[stop] fold {f} by validation (epoch {epoch})")
                break
        wall = time.time() - t0
        model_dir = cfg.get("save_model_path") or "model"
        if best_epoch >= 0:
            best_tree = dict(best_tree, best_cost=torch.tensor(float(best_cost)))
            ckpt.save_tree(ckpt.ckpt_name(model_dir, "best", f), best_tree)
            best = tr.state_from_tree(best_tree)
            state = dataclasses.replace(state, params=best.params,
                                        batch_stats=best.batch_stats)
        ckpt.save_tree(ckpt.ckpt_name(model_dir, "last", f),
                       tr.state_tree(state, last_epoch, best_cost))
        return state, {
            "history": history,
            "best_epoch": best_epoch,
            "best_validation_cost": float(best_cost) if best_epoch >= 0 else None,
            "training_time": wall,
            "fold_parallel": self.W,
        }

    def run(self, log=print):
        own = {}
        for f in self.mine():
            own[f] = self.train_fold(f, log=log)
        pmesh.barrier()  # every fold's checkpoints are written
        infos = {}
        for part in pmesh.host_view({f: info for f, (_, info) in own.items()}):
            infos.update(part)
        model_dir = self.config.get("save_model_path") or "model"
        results = []
        for f in range(self.k):
            if f in own:
                state = own[f][0]
            else:
                state = self.trainer.restore(ckpt.ckpt_name(model_dir, "last", f))
            results.append((self.trainer, state, infos[f]))
        return results


def run_fold_parallel_cv(config, info, ds, folds, *, backend, device=None, log=print,
                         model=None):
    """``cmd_train_cv``'s entry: the folds over the ranks."""
    cv = FoldParallelCV(config, info, ds, folds, backend=backend, device=device,
                        model=model)
    log(f"[fold_parallel] {cv.k} folds over {cv.W} rank(s) (this rank: folds "
        f"{cv.mine()})")
    return cv.run(log=log)
