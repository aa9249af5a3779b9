"""The TFRecord sparse-GCN engine — the counterpart of
``kgcn_tpu/cli/sparse.py`` (reference: task_sparse_gcn.py, ``kgcn-sparse``).

    python -m kgcn_tpu_torch.cli.sparse train --config cfg.json [--fold F] [--cpu]
    python -m kgcn_tpu_torch.cli.sparse train_cv --config cfg.json [--cpu]
    python -m kgcn_tpu_torch.cli.sparse infer --config cfg.json [--cpu]

``dataset`` (and for ``infer`` ``test_dataset``) is a glob of TFRecord files
in the reference's molecular schema, read by the host parser
(``data/tfrecord.py``); ``spmm_backend`` ``auto`` resolves from the graphs'
size (dense up to 256 padded nodes, the tiled kernel beyond).  ``train``
trains fold ``--fold`` of the modulo split (example ``i`` validates in fold
``i % num_folds``, task_sparse_gcn.py:248-268) through the port's
``Trainer`` (the resident runner where the gate admits the data, else the
streaming loop), then reports the validation cost, accuracy and top-k
rates (``save_info_valid``); ``train_cv`` runs every fold, one after
another, or with ``fold_parallel`` ``"force"`` (``"auto"`` in a world of
more than one rank) the folds over the ranks (``parallel/cv.py``, as
``kgcn_tpu/cli/sparse.py:182-198``); ``infer`` restores ``load_model`` (default
``model.0.best.ckpt``; a checkpoint of the port or one ``kgcn_tpu``
wrote) and reports on ``test_dataset`` (``save_info_test``), with the
predictions as a plain pickle at ``prediction_output``.  A ``tasks_file``
lists the task names, one a line.  Runs on the GPU unless ``--cpu``.

``"precision": "bfloat16"`` casts each step's payload to bf16 (the
dense aggregation runs the bf16 gconv kernel), as ``kgcn_tpu``'s trainer
does.  ``mesh`` (``{"data": N}``) trains data parallel over the N ranks of
``kgcn-torch-launch --nprocs N`` (``parallel/dp.py``; ``batch_size`` per
rank), rank 0 writing the files.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import time

import numpy as np

from kgcn_tpu_torch.cli.main import _maybe_resident
from kgcn_tpu_torch.data.batcher import Batcher
from kgcn_tpu_torch.data.tfrecord import load_tfrecord_dataset
from kgcn_tpu_torch.models.sparse import SparseGCN
from kgcn_tpu_torch.parallel import cv as pcv
from kgcn_tpu_torch.parallel import dp as pdp
from kgcn_tpu_torch.parallel import mesh as pmesh
from kgcn_tpu_torch.parallel.launch import initialize_from_env
from kgcn_tpu_torch.runtime import backend as backend_mod
from kgcn_tpu_torch.runtime.config import load_config
from kgcn_tpu_torch.runtime.device import device_from_arg, set_precision
from kgcn_tpu_torch.runtime.train import Trainer


def _load(config, test=False):
    """(Dataset, info, resolved backend) of the config's TFRecord glob."""
    pattern = config["test_dataset" if test else "dataset"]
    paths = sorted(glob.glob(pattern))
    if not paths:
        raise FileNotFoundError(f"no tfrecords match {pattern}")
    ds, info = load_tfrecord_dataset(paths, config)
    return ds, info, backend_mod.resolve(config, info)


def _model(config, info) -> SparseGCN:
    return SparseGCN(
        in_features=info.feature_dim,
        channels=info.adj_channel_num,
        num_classes=int(config["num_classes"]),
        out_dims=tuple(config.get("out_dims", (256, 256, 256))),
        dense_dim=int(config.get("dense_dim", 256)),
        batch_normalize=bool(config.get("batch_normalize", True)),
    )


def split_fold(n: int, fold: int, num_folds: int):
    """The modulo split (the reference's enumerate + filter,
    task_sparse_gcn.py:248-268): example i validates in fold i % num_folds."""
    idx = np.arange(n)
    return idx[idx % num_folds != fold], idx[idx % num_folds == fold]


def _report(config, ev, tag):
    """The cost, accuracy and top-k rates of an evaluation (``kgcn_tpu``'s
    keys), printed as JSON and written to ``save_info_<tag>``."""
    m = {k: float(np.asarray(v)) for k, v in ev["metrics"].items()
         if np.asarray(v).ndim == 0}
    n = max(ev["num"], 1)
    out = {f"{tag}_cost": ev["cost"]}
    for key, v in m.items():
        # the top-k counters, not the correct count nor the bare pad count
        # '{tag}_count', whose rate is always 1
        if (key.endswith("_count") and not key.endswith("correct_count")
                and key != f"{tag}_count"):
            out[key.replace("_count", "")] = v / n
    if f"{tag}_accuracy" in m:
        out[f"{tag}_accuracy"] = m[f"{tag}_accuracy"]
    print(json.dumps(out))
    path = config.get(f"save_info_{tag}")
    if path and pmesh.is_main_process():
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=2)
        print(f"[SAVE] {path}")
    return out


def cmd_train(config, fold: int = 0, device=None):
    """Train fold ``fold``; returns (state, trainer, info, validation
    evaluation)."""
    device = device_from_arg(device)
    ds, info, backend = _load(config)
    tr_idx, va_idx = split_fold(ds.num, fold, int(config.get("num_folds", 5)))
    train_ds, valid_ds = ds.subset(tr_idx), ds.subset(va_idx)
    bs = int(config["batch_size"])
    seed = int(config.get("seed", 0))
    if config.get("mesh"):
        mesh = pmesh.make_mesh(dict(config["mesh"]))
        trainer = pdp.DPTrainer(_model(config, info), config, info, device=device,
                                mesh=mesh)
        rb = _maybe_resident(config, train_ds, info, bs, backend, trainer.device,
                             seed=seed)
        d = mesh.coord("data")
        tb = (pdp.ShardedResidentBatcher(rb, mesh.size, d) if rb is not None else
              pdp.ShardedBatcher(Batcher(train_ds, info, bs, seed=seed, backend=backend),
                                 mesh.size, d))
        vb = pdp.ShardedBatcher(Batcher(valid_ds, info, bs, backend=backend), mesh.size, d)
    else:
        trainer = Trainer(_model(config, info), config, info, device=device)
        tb = (_maybe_resident(config, train_ds, info, bs, backend, trainer.device,
                              seed=seed)
              or Batcher(train_ds, info, bs, seed=seed, backend=backend))
        vb = Batcher(valid_ds, info, bs, backend=backend)
    state = trainer.init_state(seed)
    t0 = time.time()
    state, _ = trainer.fit(state, tb, vb, fold=fold)
    print(f"training time: {time.time() - t0}[sec]")
    ev = trainer.evaluate(state, vb, "valid_")
    _report(config, ev, "valid")
    return state, trainer, info, ev


def cmd_train_cv(config, device=None):
    """Every fold of the modulo split: over the ranks where the
    fold-parallel gate admits it (the dataset is loaded first only when
    ``fold_parallel_plausible``), else one after another."""
    num_folds = int(config.get("num_folds", 5))
    if pcv.fold_parallel_plausible(config):
        ds, info, backend = _load(config)
        folds = [split_fold(ds.num, f, num_folds) for f in range(num_folds)]
        if pcv.fold_parallel_enabled(config, ds, info, num_folds, backend):
            print(f"[fold_parallel] {num_folds} folds over the ranks")
            runs = pcv.run_fold_parallel_cv(config, info, ds, folds, backend=backend,
                                            device=device, model=_model(config, info))
            results = []
            for fold, (trainer, state, _) in enumerate(runs):
                print(f"=== fold {fold} ===")
                vb = Batcher(ds.subset(folds[fold][1]), info, int(config["batch_size"]),
                             backend=backend)
                ev = trainer.evaluate(state, vb, "valid_")
                _report(config, ev, "valid")
                results.append(ev)
            return results
    results = []
    for fold in range(num_folds):
        print(f"=== fold {fold} ===")
        results.append(cmd_train(config, fold=fold, device=device)[3])
    return results


def cmd_infer(config, device=None):
    """Evaluate ``test_dataset`` with a restored checkpoint."""
    device = device_from_arg(device)
    ds, info, backend = _load(config, test=True)
    trainer = Trainer(_model(config, info), config, info, device=device)
    b = Batcher(ds, info, int(config["batch_size"]), backend=backend)
    path = config.get("load_model") or os.path.join(
        config.get("save_model_path", "model"), "model.0.best.ckpt")
    state = trainer.restore(path)
    print(f"[LOAD] {path}")
    ev = trainer.evaluate(state, b, "test_")
    _report(config, ev, "test")
    out = config.get("prediction_output")
    if out:
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "wb") as f:  # a plain pickle: joblib.load reads it too
            pickle.dump(ev["prediction"], f, protocol=4)
        print(f"[SAVE] {out}")
    return ev


def main(argv=None):
    p = argparse.ArgumentParser(prog="kgcn-tpu-torch-sparse", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["train", "train_cv", "infer"])
    p.add_argument("--config", required=True)
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    args = p.parse_args(argv)
    config = load_config(args.config)
    initialize_from_env(args.cpu)
    set_precision(config.get("precision", "float32"))  # as cli.main's main()
    device = "cpu" if args.cpu else None
    if "tasks_file" in config and os.path.exists(config["tasks_file"]):
        with open(config["tasks_file"]) as f:
            config["task_names"] = [line.strip() for line in f if line.strip()]
    if args.mode == "train":
        return cmd_train(config, fold=args.fold, device=device)
    if args.mode == "train_cv":
        return cmd_train_cv(config, device=device)
    return cmd_infer(config, device=device)


if __name__ == "__main__":
    main()
    pmesh.finalize()  # not on a failure: the others may be waiting in a collective
