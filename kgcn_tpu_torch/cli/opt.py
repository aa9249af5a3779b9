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
``--parallel-trials > 1`` and one visible device the trials run one at a
time, as in ``kgcn_tpu``; several devices need the parallel layer, which
the port does not have yet (ROADMAP.md A.11).
"""
from __future__ import annotations

import argparse
import copy
import gc
import json
import os

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


def sequential_only(parallel_trials: int, device) -> None:
    """``--parallel-trials``: on one visible device (or the CPU) the trials
    run one at a time, as ``kgcn_tpu`` runs them there; several devices
    need the trial pool of the parallel layer, not yet ported."""
    if int(parallel_trials or 1) <= 1:
        return
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if on_cpu or torch.cuda.device_count() < 2:
        print("[opt] single device — sequential trials")
        return
    from kgcn_tpu_torch.cli.main import _not_ported

    _not_ported("trials on several devices (kgcn_tpu's DeviceTrialPool, "
                "tools/parallel_trials.py)", "A.11")


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
    args = p.parse_args(argv)
    from kgcn_tpu_torch.runtime.config import load_config
    from kgcn_tpu_torch.runtime.device import device_from_arg, set_precision
    from kgcn_tpu_torch.tools.hpo import Domain, optimize

    base = load_config(args.config)
    set_precision(base.get("precision", "float32"))
    device = "cpu" if args.cpu else None
    device_from_arg(device)  # no GPU and no --cpu: raise before any trial
    domain = Domain.from_json(args.domain)
    sequential_only(args.parallel_trials, device)

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
