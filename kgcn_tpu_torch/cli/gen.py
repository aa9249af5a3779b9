"""The generative (graph VAE) engine — the counterpart of
``kgcn_tpu/cli/gen.py`` (reference: gcn_gen.py:292-298, ``kgcn-gen``).

    python -m kgcn_tpu_torch.cli.gen train --config example_config/vae.json [--cpu]
    python -m kgcn_tpu_torch.cli.gen reconstruct --config example_config/vae.json [--cpu]
    python -m kgcn_tpu_torch.cli.gen generate --config example_config/vae.json [--cpu]

``train`` splits off ``validation_data_rate`` of the dataset and fits the
VAE (``model.py`` ``gcn_vae``, or ``gcn_vae_onlylink`` for the link-only
variant, whose ``pos_weight`` and ``norm`` come from each graph's true node
count and edge count, gcn_gen.py:51-74): the resident VAE batcher where the
gate admits the data (ε drawn on the device each step; each step replayed
from one captured CUDA graph on the card), else the streaming one (ε from
the batcher's ``RandomState``, as ``kgcn_tpu`` draws it); the validation
batches draw ε from seed 1.  ``reconstruct`` restores ``model.best.ckpt``
(else ``model.last.ckpt``, or ``load_model``; a checkpoint of the port or
one ``kgcn_tpu`` wrote) and dumps ``{"feature", "dense_adj"}`` of every
graph to ``reconstruction_output``; ``generate`` decodes
``generation_num`` graphs from the prior (ε as the latent) to
``generation_output``.  The dumps are plain pickles (``joblib.load`` reads
them).  Runs on the GPU unless ``--cpu``.
"""
from __future__ import annotations

import argparse
import os
import pickle
import time

import numpy as np
import torch

from kgcn_tpu_torch.data.batcher import Batcher
from kgcn_tpu_torch.data.dataset import load_jbl, split_dataset
from kgcn_tpu_torch.models.vae import GCNVAE
from kgcn_tpu_torch.runtime import backend as backend_mod
from kgcn_tpu_torch.runtime import resident
from kgcn_tpu_torch.runtime.config import load_config
from kgcn_tpu_torch.runtime.device import device_from_arg, set_precision
from kgcn_tpu_torch.runtime.train import Trainer

_ONLYLINK = ("gcn_vae_onlylink", "vae_onlylink", "example_model.model_vae_onlylink:VAE")


def link_statistics(ds):
    """(pos_weight, norm) of the link-only variant: the means over graphs
    and channels of ``neg / pos`` and ``2 · all / neg``, ``all`` the graph's
    true node count squared (gcn_gen.py:51-74)."""
    pw, nm = [], []
    for g, adj in enumerate(ds.adjs):
        n = float(ds.enabled_node_nums[g] if ds.enabled_node_nums is not None
                  else ds.max_node_num)
        num_all = n * n
        for (_row, _col, val) in adj:
            num_pos = float(len(val))
            num_neg = num_all - num_pos
            pw.append(num_neg / max(num_pos, 1.0))
            nm.append(num_all / max(num_neg, 1.0) * 2.0)
    return float(np.mean(pw)), float(np.mean(nm))


def _setup(config, device=None, with_batcher: bool = True):
    """(dataset, info, model, trainer, backend, the whole dataset's
    streaming batcher with ε or None)."""
    device = device_from_arg(device)
    ds, info = load_jbl(config["dataset"], config)
    backend = backend_mod.resolve(config, info)
    # the canonical "model.py" key (or its reference alias) and the short
    # "model" key: either naming a link-only model wins
    link_only = any(str(config.get(k)) in _ONLYLINK for k in ("model.py", "model"))
    pos_weight, norm = link_statistics(ds) if link_only else (1.0, 1.0)
    model = GCNVAE(in_features=info.feature_dim, channels=info.adj_channel_num,
                   feature_dim=info.feature_dim, latent_dim=int(config.get("latent_dim", 64)),
                   link_only=link_only, pos_weight=pos_weight, norm=norm)
    trainer = Trainer(model, config, info, device=device)
    batcher = None
    if with_batcher:
        batcher = Batcher(ds, info, int(config["batch_size"]), epsilon_dim=model.latent_dim,
                          seed=int(config.get("seed", 0)), backend=backend)
    return ds, info, model, trainer, backend, batcher


def cmd_train(config, device=None):
    ds, info, model, trainer, backend, _ = _setup(config, device, with_batcher=False)
    train_ds, valid_ds, _, _ = split_dataset(ds, config.get("validation_data_rate", 0.3),
                                             seed=int(config.get("seed", 0)))
    bs = int(config["batch_size"])
    if resident.resident_enabled(config, train_ds, info, backend):
        tb = resident.ResidentVAEBatcher(train_ds, info, bs, model.latent_dim, seed=0,
                                         backend=backend, device=trainer.device)
    else:
        tb = Batcher(train_ds, info, bs, epsilon_dim=model.latent_dim, seed=0,
                     backend=backend)
    vb = (Batcher(valid_ds, info, bs, epsilon_dim=model.latent_dim, seed=1, backend=backend)
          if valid_ds.num > 0 else None)
    _init_draw(tb, bs)
    state = trainer.init_state(int(config.get("seed", 0)))
    t0 = time.time()
    state, fit_info = trainer.fit(state, tb, vb)
    print(f"training time: {time.time() - t0}[sec]")
    return state, fit_info


def _init_draw(batcher, bs: int) -> None:
    """``kgcn_tpu`` builds its parameters from a first batch of the engine's
    batcher, which draws one ε from the batcher's ``RandomState``; the
    same draw here keeps every later batch's ε ``kgcn_tpu``'s."""
    batcher.make_batch(np.arange(min(bs, batcher.ds.num)))


def _restore(config, trainer, batcher):
    _init_draw(batcher, int(config["batch_size"]))
    model_dir = config.get("save_model_path", "model")
    path = config.get("load_model") or os.path.join(model_dir, "model.best.ckpt")
    if not os.path.exists(path):
        path = os.path.join(model_dir, "model.last.ckpt")
    state = trainer.restore(path)
    print(f"[LOAD] {path}")
    return state


def _dump(path: str, obj) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:  # a plain pickle: joblib.load reads it too
        pickle.dump(obj, f, protocol=4)
    print(f"[SAVE] {path}")


def cmd_reconstruct(config, device=None):
    _, _, _, trainer, _, batcher = _setup(config, device)
    ev = trainer.evaluate(_restore(config, trainer, batcher), batcher)
    _dump(config.get("reconstruction_output", "result/reconstruction.jbl"), ev["prediction"])
    return ev


@torch.no_grad()
def cmd_generate(config, device=None):
    ds, _, model, trainer, _, batcher = _setup(config, device)
    state = _restore(config, trainer, batcher)
    model.load_state_dict({**state.params, **state.batch_stats})
    num, bs = int(config.get("generation_num", 10)), int(config["batch_size"])
    outs, made = [], 0
    while made < num:
        batch = batcher.make_batch(np.arange(min(bs, ds.num))).to(trainer.device)
        take = min(bs, num - made)
        outs.append({k: v[:take].cpu().numpy() for k, v in model.generate(batch).items()})
        made += take
    result = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    _dump(config.get("generation_output", "result/generated.jbl"), result)
    return result


def main(argv=None):
    p = argparse.ArgumentParser(prog="kgcn-tpu-torch-gen", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["train", "reconstruct", "generate"])
    p.add_argument("--config", required=True)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    config = load_config(args.config)
    set_precision(config.get("precision", "float32"))  # as cli.main's main()
    device = "cpu" if args.cpu else None
    return {"train": cmd_train, "reconstruct": cmd_reconstruct,
            "generate": cmd_generate}[args.mode](config, device=device)


if __name__ == "__main__":
    main()
