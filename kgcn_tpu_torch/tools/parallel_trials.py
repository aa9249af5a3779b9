"""Device-parallel HPO/NAS trials — the port's counterpart of
``kgcn_tpu/tools/parallel_trials.py``: one trial a device, in one process.

Trials may differ in architecture, so they cannot share one program; each
trial's state and resident dataset live on its own device, and each epoch
of every live trial (the training epoch through the resident runner, then
the evaluation of the validation split) is issued before any trial's
numbers are read, so the devices work at once (CUDA launches are
asynchronous).  A device may appear twice in the list (two trials on one
card, or on the CPU, run one after the other within an epoch); each trial
has its own trainer and runners, so its numbers are those of the same
trial run alone.

Used by ``cli/opt.py --parallel-trials k`` (with the batch acquisition of
``tools/hpo.optimize_parallel``) and by ``tools/nas.search(parallel=k)``.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch


def visible_devices() -> List[str]:
    """The visible GPUs, ``["cuda:0", …]``."""
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


class DeviceTrialPool:
    """Train k configs at once, trial i on ``devices[i]``.

    The datasets go to each device once (kept across rounds); each round
    trains its trials epoch by epoch with per-trial early stopping and
    returns each trial's best validation cost, the objective of the
    sequential ``run_trial`` (``cmd_train``: its split, its batch order from
    seed 0, its parameters from the config's seed; ``kgcn_tpu``'s pool
    splits 0.2 by default and shuffles from the config's seed instead).
    ``model_builder(cfg, params, info)`` builds a trial's model (default:
    the registry's ``cfg["model.py"]``); ``devices`` defaults to the
    visible GPUs; ``backend`` to the config's resolved one."""

    def __init__(self, base_config: Dict[str, Any], ds, info, valid_ds=None,
                 model_builder=None, devices: Optional[Sequence] = None, backend=None):
        from kgcn_tpu_torch.runtime import backend as backend_mod

        self.base = base_config
        self.info = info
        self.model_builder = model_builder
        if valid_ds is None:
            from kgcn_tpu_torch.data.dataset import split_dataset

            ds, valid_ds, _, _ = split_dataset(  # cmd_train's split
                ds, base_config.get("validation_data_rate", 0.3),
                seed=int(base_config.get("seed", 0)),
                shuffle=bool(base_config.get("shuffle_data", True)))
        self.train_ds = ds
        self.valid_ds = valid_ds
        self.devices = [torch.device(d) for d in (devices if devices is not None
                                                   else visible_devices())]
        if not self.devices:
            raise RuntimeError("no CUDA device visible: give the pool its devices "
                               "(e.g. ['cpu', 'cpu'])")
        self.backend = backend or backend_mod.resolve(base_config, info, log=False)
        self._dd_cache: Dict[torch.device, Any] = {}

    def _device_data(self, device: torch.device):
        if device not in self._dd_cache:
            from kgcn_tpu_torch.runtime.resident import build_device_dataset

            self._dd_cache[device] = tuple(
                build_device_dataset(d, self.info, backend=self.backend, device=device)
                for d in (self.train_ds, self.valid_ds))
        return self._dd_cache[device]

    def _trial_config(self, params: Dict[str, Any]) -> Dict[str, Any]:
        config = copy.deepcopy(self.base)
        config["param"] = dict(params)
        for key in ("learning_rate", "batch_size", "dropout_rate", "epoch"):
            if key in params:
                config[key] = params[key]
        return config

    def _build(self, i: int, params: Dict[str, Any]) -> Dict[str, Any]:
        from kgcn_tpu_torch.models.registry import build_model
        from kgcn_tpu_torch.runtime.resident import ResidentBatcher
        from kgcn_tpu_torch.runtime.train import EarlyStopping, Trainer

        cfg = self._trial_config(params)
        device = self.devices[i]
        dd_tr, dd_va = self._device_data(device)
        info = copy.copy(self.info)
        info.param = dict(params)
        model = (self.model_builder(cfg, params, info) if self.model_builder is not None
                 else build_model(cfg["model.py"], info, cfg))
        trainer = Trainer(model, cfg, info, device=device)
        B = int(cfg["batch_size"])
        seed = int(cfg.get("seed", 0))
        # the batches shuffled from seed 0 and the parameters drawn from the
        # config's seed, as cmd_train's _fit_once does: a trial here is the
        # sequential trial
        return {
            "cfg": cfg, "trainer": trainer,
            "rb": ResidentBatcher(self.train_ds, info, B, seed=0, device_data=dd_tr),
            "vb": ResidentBatcher(self.valid_ds, info, B, device_data=dd_va),
            "state": trainer.init_state(seed),
            "es": EarlyStopping(int(cfg.get("patience", 0) or 0), cfg.get("task", "")),
            "best": np.inf, "done": False, "epochs": int(cfg.get("epoch", 20)),
        }

    def run_batch(self, param_dicts: List[Dict[str, Any]], log=print) -> List[float]:
        """Train one round of trials at once; each trial's best validation
        cost (inf for a trial that raised, as the sequential ``run_trial``
        scores it)."""
        k = len(param_dicts)
        if k > len(self.devices):
            raise ValueError(f"{k} trials for {len(self.devices)} devices")
        trials = []
        for i, params in enumerate(param_dicts):
            try:
                trials.append(self._build(i, params))
            except Exception as e:  # the trial's outcome, not the pool's
                log(f"[opt] trial {i} failed to build ({type(e).__name__}: {e}) — "
                    "scoring inf")
                trials.append({"done": True, "best": np.inf, "epochs": 0})
        n_va = max(self.valid_ds.num, 1)
        for epoch in range(max((t["epochs"] for t in trials), default=0)):
            pend = []
            for i, t in enumerate(trials):  # issue every live trial's epoch
                if t["done"] or epoch >= t["epochs"]:
                    continue
                try:
                    tr = t["trainer"]
                    t["state"], costs, _ = tr.epoch_on_device(
                        t["state"], t["rb"], shuffle=bool(t["cfg"].get("shuffle_data", True)),
                        epoch=epoch)
                    _, v_costs, _ = tr.eval_on_device(t["state"], t["vb"])
                except Exception as e:
                    log(f"[opt] trial {i} failed at epoch {epoch} ({type(e).__name__}: "
                        f"{e}) — scoring inf")
                    t["best"], t["done"] = np.inf, True
                    continue
                pend.append((t, costs, v_costs))
            if not pend:
                break
            for t, costs, v_costs in pend:  # then read them
                tc = float(np.sum(costs.cpu().numpy()))
                vc = float(np.sum(v_costs.cpu().numpy())) / n_va
                if not np.isfinite(tc):
                    t["done"] = True
                    continue
                t["best"] = min(t["best"], vc)
                if t["es"].update(vc):
                    t["done"] = True
        return [float(t["best"]) for t in trials]
