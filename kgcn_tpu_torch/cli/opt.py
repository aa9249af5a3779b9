"""``kgcn-torch-opt`` — hyper-parameter optimisation, the port's copy of
``kgcn_tpu/cli/opt.py`` (reference: ``kgcn-opt``, opt_hyperparam.py):

    python -m kgcn_tpu_torch.cli.opt --config cfg.json --domain domain.json \\
        [--max-itr 10] [--output-dir opt_result] [--seed 123] [--cpu]

Per trial, the param dict goes into the config as ``"param"`` (and its
common tunables onto their config keys), and the port's ``cmd_train`` runs
in this process, minimising ``validation_cost`` (then ``-ranking_accuracy``,
then the last ``training_cost``; a trial that raises scores inf).  The
best param and config and the history are written to ``--output-dir``
(``best_param.json``, ``best_config.json``, ``history.json``), as
``kgcn_tpu`` writes them.

On the GPU each trial frees its trainer, captured step graphs and static
buffers before the next (``gc.collect`` and the caching allocator
emptied), and prints its peak device memory, reset per trial.  With
``--parallel-trials k`` (k > 1) and several devices (the visible GPUs, or
``--trial-devices cuda:0,cuda:1`` / ``cpu,cpu``: a device may repeat) k
trials train at once, one a device (``tools/parallel_trials.
DeviceTrialPool``, proposals from ``tools/hpo.optimize_parallel``), where
the resident gate admits the dataset, as ``kgcn_tpu``'s ``_maybe_pool``;
on one device, or a dataset the gate declines, they run one at a time
(said).
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import os
from typing import List, Optional

import numpy as np
import torch


def run_trial(base_config, params, device=None) -> float:
    """One training run; returns its score (the HPO objective)."""
    from kgcn_tpu_torch.cli.main import cmd_train

    config = copy.deepcopy(base_config)
    config["param"] = dict(params)
    # common tunables map straight onto config keys
    for key in ("learning_rate", "batch_size", "dropout_rate", "epoch"):
        if key in params:
            config[key] = params[key]
    config["make_plot"] = False
    for k in list(config):
        if k.startswith("save_result") or k.startswith("save_info"):
            config[k] = None
    try:
        result = cmd_train(config, device)
    except Exception as e:
        # a diverged or raising trial must not abort the search and discard
        # the completed trials; the GP clamps inf to "very bad"
        print(f"[opt] trial failed ({type(e).__name__}: {e}) — scoring inf")
        return float(np.inf)
    if "validation_cost" in result:
        return float(result["validation_cost"])
    if "ranking_accuracy" in result:  # KG runs report accuracy, not cost
        return -float(result["ranking_accuracy"])
    # a completed run without a validation split: the final training cost,
    # so the GP still ranks the trials
    hist = result.get("training_cost")
    if hist:
        print("[opt] no validation split — scoring trial by final "
              "training cost (add validation_data_rate for proper HPO)")
        return float(hist[-1] if isinstance(hist, (list, tuple)) else hist)
    return float(np.inf)


def trial_end(device) -> None:
    """Free what the finished trial left (its trainer, captured graphs and
    static buffers are garbage once ``cmd_train`` returns) and, on the
    GPU, print the trial's peak device memory and reset the peak."""
    gc.collect()
    if device is None or torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        print(f"[opt] trial peak device memory: {peak} bytes")


def trial_devices(device, listed: Optional[str] = None) -> List[str]:
    """The devices of parallel trials: ``listed`` (comma-separated), else
    the visible GPUs (the CPU alone with ``--cpu``)."""
    from kgcn_tpu_torch.tools.parallel_trials import visible_devices

    if listed:
        return [d.strip() for d in listed.split(",") if d.strip()]
    if device is not None and torch.device(device).type == "cpu":
        return ["cpu"]
    return visible_devices()


def maybe_pool(base, parallel_trials: int, devices: List[str]):
    """The trial pool, or None for sequential trials (``parallel_trials``
    ≤ 1, one device, or a dataset the resident gate declines; the last two
    said), as ``kgcn_tpu``'s ``_maybe_pool``.  Building the pool raises on
    failure."""
    if int(parallel_trials or 1) <= 1:
        return None
    if len(devices) < 2:
        print("[opt] single device — sequential trials")
        return None
    from kgcn_tpu_torch.cli.main import _prepare
    from kgcn_tpu_torch.runtime.resident import resident_enabled
    from kgcn_tpu_torch.tools.parallel_trials import DeviceTrialPool

    ds, info, backend = _prepare(base)
    if not resident_enabled(base, ds, info, backend):
        print("[opt] dataset not device-resident — sequential trials")
        return None
    return DeviceTrialPool(base, ds, info, devices=devices, backend=backend)


def main(argv=None):
    p = argparse.ArgumentParser(prog="kgcn-torch-opt", description=__doc__)
    p.add_argument("--config", required=True)
    p.add_argument("--domain", required=True, help="domain JSON (reference format)")
    p.add_argument("--max-itr", type=int, default=10)
    p.add_argument("--output-dir", default="opt_result")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--parallel-trials", type=int, default=1,
                   help="trials trained concurrently, one per device (one "
                        "device: sequential)")
    p.add_argument("--trial-devices", default=None,
                   help="devices of the parallel trials, comma-separated "
                        "(default: the visible GPUs)")
    args = p.parse_args(argv)
    from kgcn_tpu_torch.runtime.config import load_config
    from kgcn_tpu_torch.runtime.device import device_from_arg, set_precision
    from kgcn_tpu_torch.tools.hpo import Domain, optimize, optimize_parallel

    from kgcn_tpu_torch.parallel.launch import initialize_from_env

    base = load_config(args.config)
    initialize_from_env(args.cpu)
    set_precision(base.get("precision", "float32"))
    device = "cpu" if args.cpu else None
    device_from_arg(device)  # no GPU and no --cpu: raise before any trial
    domain = Domain.from_json(args.domain)
    devices = trial_devices(device, args.trial_devices)
    pool = maybe_pool(base, args.parallel_trials, devices)
    if pool is not None:
        k = min(args.parallel_trials, len(devices))
        print(f"[opt] {k} trials per round, one per device ({devices[:k]})")
        best_params, best_value, history = optimize_parallel(
            pool.run_batch, domain, max_iter=args.max_itr, batch=k, seed=args.seed)
    else:
        def objective(params):
            try:
                return run_trial(base, params, device)
            finally:
                trial_end(device)

        best_params, best_value, history = optimize(
            objective, domain, max_iter=args.max_itr, seed=args.seed)
    os.makedirs(args.output_dir, exist_ok=True)
    with open(os.path.join(args.output_dir, "best_param.json"), "w") as f:
        json.dump(best_params, f, indent=2)
    best_config = dict(base)
    best_config["param"] = best_params
    with open(os.path.join(args.output_dir, "best_config.json"), "w") as f:
        json.dump(best_config, f, indent=2, default=str)
    with open(os.path.join(args.output_dir, "history.json"), "w") as f:
        json.dump(history, f, indent=2)
    print(f"[opt] best validation_cost={best_value:.6g} params={best_params}")
    print(f"[SAVE] {args.output_dir}/best_param.json")


if __name__ == "__main__":
    main()
