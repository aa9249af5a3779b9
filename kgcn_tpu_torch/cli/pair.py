"""The pairwise preference-ranking engine — the counterpart of
``kgcn_tpu/cli/pair.py`` (reference: gcn_pair.py, ``train`` / ``infer``).

    python -m kgcn_tpu_torch.cli.pair train --config example_config/pair.json [--cpu]
    python -m kgcn_tpu_torch.cli.pair infer --config example_config/pair.json [--cpu]

RankNet over the graph pairs of the dataset's ``graph_index_list`` (the
second graph of a pair preferred).  ``train`` runs ``epoch`` epochs (the
resident pair batcher where the gate admits the dataset: both towers
gathered on the device, each step replayed from one captured CUDA graph on
the card; else the streaming one), prints each epoch's cost and pair
accuracy and writes ``model.last.ckpt`` under ``save_model_path``;
``infer`` restores ``load_model`` (default that checkpoint; a checkpoint
of the port or one ``kgcn_tpu`` wrote) and writes both towers' scores of
every pair to ``save_result_test`` (default ``result/pair_scores.csv``,
header ``score0,score1``).  Runs on the GPU unless ``--cpu``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from kgcn_tpu_torch.data.dataset import load_jbl
from kgcn_tpu_torch.models.pair import GCNPairRanker, PairBatcher, ResidentPairBatcher
from kgcn_tpu_torch.runtime import backend as backend_mod
from kgcn_tpu_torch.runtime import checkpoint as ckpt
from kgcn_tpu_torch.runtime import resident
from kgcn_tpu_torch.runtime.config import load_config
from kgcn_tpu_torch.runtime.device import device_from_arg, set_precision
from kgcn_tpu_torch.runtime.train import Trainer


def _setup(config, device=None):
    """(dataset, info, trainer, pair batcher) of a config."""
    device = device_from_arg(device)
    ds, info = load_jbl(config["dataset"], config)
    if ds.graph_index_list is None:
        raise ValueError("pair engine needs graph_index_list in the dataset")
    pairs = np.asarray(ds.graph_index_list).reshape(-1, 2)
    backend = backend_mod.resolve(config, info)
    model = GCNPairRanker(in_features=info.feature_dim, channels=info.adj_channel_num,
                          label_dim=info.label_dim or 1,
                          dropout_rate=float(config.get("dropout_rate", 0.2)))
    trainer = Trainer(model, config, info, device=device)
    bs, seed = int(config["batch_size"]), int(config.get("seed", 0))
    # the engine consumes graph_index_list itself: it does not disqualify
    # the dataset here
    if resident.resident_enabled(config, ds, info, backend, allow_index_list=True):
        pb = ResidentPairBatcher(ds, info, pairs, bs, seed=seed, backend=backend,
                                 device=trainer.device)
    else:
        pb = PairBatcher(ds, info, pairs, bs, seed=seed, backend=backend)
    return ds, info, trainer, pb


def cmd_train(config, device=None):
    _, _, trainer, pb = _setup(config, device)
    state = trainer.init_state(int(config.get("seed", 0)))
    t0 = time.time()
    for epoch in range(int(config.get("epoch", 50))):
        state, cost, metrics, _ = trainer.run_epoch(state, pb)
        tc = sum(float(m["correct_count"]) for m in metrics)
        tn = sum(float(m["count"]) for m in metrics)
        print(f"epoch {epoch}, training cost {cost:.6g} (pair acc={tc / max(tn, 1):.4g})")
    print(f"training time: {time.time() - t0}[sec]")
    path = ckpt.save_tree(ckpt.ckpt_name(config.get("save_model_path") or "model", "last"),
                          trainer.state_tree(state, 0, 0.0))
    print(f"[SAVE] {path}")
    return state


def cmd_infer(config, device=None):
    _, _, trainer, pb = _setup(config, device)
    path = config.get("load_model") or os.path.join(
        config.get("save_model_path", "model"), "model.last.ckpt")
    state = trainer.restore(path)
    print(f"[LOAD] {path}")
    ev = trainer.evaluate(state, pb)
    out_path = config.get("save_result_test") or "result/pair_scores.csv"
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("score0,score1\n")
        for row in np.asarray(ev["prediction"]):  # [P, 2, label_dim]
            f.write(f"{row[0, 0]:.6g},{row[1, 0]:.6g}\n")
    print(f"[SAVE] {out_path}")
    return ev


def main(argv=None):
    p = argparse.ArgumentParser(prog="kgcn-tpu-torch-pair", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["train", "infer"])
    p.add_argument("--config", required=True)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    config = load_config(args.config)
    set_precision(config.get("precision", "float32"))  # as cli.main's main()
    device = "cpu" if args.cpu else None
    return (cmd_train if args.mode == "train" else cmd_infer)(config, device=device)


if __name__ == "__main__":
    main()
