"""Command-line entry point of the port — the counterpart of
``kgcn_tpu/cli/main.py`` for the ``train`` and ``infer`` subcommands.

    python -m kgcn_tpu_torch.cli.main train --config example_config/gat.json [--cpu]
    python -m kgcn_tpu_torch.cli.main infer --config example_config/gat.json [--cpu]
    python -m kgcn_tpu_torch.cli.main train --config kg.json [--cpu]
    python -m kgcn_tpu_torch.cli.main infer --config kg.json [--cpu]

Same JSON configs and the same outputs as ``kgcn-tpu``: per-epoch lines,
best / interval / last checkpoints under ``save_model_path`` (the port's
own format, ``runtime/checkpoint.py``), ``serve_info.json`` beside them, and
``save_info_train`` / ``save_info_valid`` / ``save_result_valid``.  A
``task: link_prediction`` dataset with a ``label_list`` trains the KG link
predictor (``cmd_train_kg``: preference pairs, the ``last`` checkpoint,
``save_info_train``), and ``infer`` ranks its held-out triples
(``cmd_infer_kg``: mean rank, MRR, hits@1/10; ``save_edge_result`` or
``save_result_test``, ``save_info_test``).  On any other dataset ``infer``
evaluates the whole dataset with the ``best`` checkpoint (``last`` when
there is no best): ``infer_time``, ``test_cost`` and
``test_metrics_protocol``, ``save_result_test``, ``save_info_test`` and
``prediction_data`` (a plain pickle).  Runs on the GPU unless ``--cpu`` is
given.

The config's ``spmm_backend`` picks the path: ``"auto"`` resolves as in
``kgcn_tpu`` (dense up to 256 padded nodes, the CUDA gconv kernel; stream
for whole-graph work beyond, the CUDA stream kernels), ``"tiled"`` takes the
tiled SpMM/SDDMM kernels, ``"pallas"`` the CUDA ELL gather kernel where the
dataset's degree layout admits ELL arrays (else the edge-list scatter, said
once), ``"xla"`` the same routes without a kernel; the tiled and stream
payload dtype is ``tiled_compute_dtype`` (``"bfloat16"`` default, or
``"float32"``).

Not ported yet, each raising "not yet ported" (ROADMAP.md A.2): the
``train_cv`` and ``visualize`` subcommands, ``mesh`` (data parallel; KG:
the sharded and resident training), ``make_plot``, ``export_model`` and
``"precision": "bfloat16"``.  The offline scikit-learn battery
(``valid_metrics`` in ``save_info_valid``, ``test_metrics`` in
``infer``'s result) is left out: the GPU machine has no scikit-learn.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import Any, Dict

import numpy as np
import torch

from kgcn_tpu_torch.data.batcher import Batcher
from kgcn_tpu_torch.data.dataset import load_jbl, split_dataset
from kgcn_tpu_torch.models.kg import KGBatcher
from kgcn_tpu_torch.models.registry import build_model
from kgcn_tpu_torch.runtime import backend as backend_mod
from kgcn_tpu_torch.runtime import checkpoint as ckpt
from kgcn_tpu_torch.runtime.config import load_config
from kgcn_tpu_torch.runtime.device import device_from_arg
from kgcn_tpu_torch.runtime.train import Trainer


class NumpyEncoder(json.JSONEncoder):
    """JSON for numpy scalars and arrays (reference: NumPyArangeEncoder)."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def _save_json(path: str, payload: Dict[str, Any]) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    print(f"[SAVE] {path}")
    with open(path, "w") as fp:
        json.dump(payload, fp, indent=4, cls=NumpyEncoder)


def save_prediction(filename: str, prediction) -> None:
    """CSV prediction dump, one row per example (reference: gcn.py:59-81)."""
    d = os.path.dirname(filename)
    if d:
        os.makedirs(d, exist_ok=True)
    pred = np.asarray(prediction)
    print(f"[SAVE] {filename}")
    with open(filename, "w") as fp:
        for row in pred.reshape(len(pred), -1):
            fp.write(",".join(f"{v:.6g}" for v in row) + "\n")


def _metric_name(task: str) -> str:
    return ("mse" if task == "regression"
            else "gmfe" if task == "regression_gmfe" else "accuracy")


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not yet ported to kgcn_tpu_torch "
                              "(ROADMAP.md A.2)")


def _prepare(config, dataset_key="dataset", test_mode=False):
    """Dataset, info and the resolved backend (pinned in the config)."""
    ds, info = load_jbl(config[dataset_key], config, test_mode=test_mode)
    return ds, info, backend_mod.resolve(config, info)


def _is_kg(config) -> bool:
    return (config.get("task") == "link_prediction"
            or bool(config.get("with_node_embedding")))


def _kg_model_name(config) -> str:
    name = config.get("model.py", "kg_distmult")
    return "kg_distmult" if name in ("model", "gcn") else name


def cmd_train_kg(config, ds, info, backend, device) -> Dict[str, Any]:
    """Whole-graph link-prediction training (``kgcn_tpu``'s
    ``cmd_train_kg``): batch 1, preference pairs over ``label_batch_size``
    slices with negatives resampled every step, one line per epoch, the
    ``last`` checkpoint, ``save_info_train``."""
    if config.get("mesh"):
        _not_ported("sharded KG training (config 'mesh': kgcn_tpu's "
                    "_train_kg_sharded and its resident fit)")
    model = build_model(_kg_model_name(config), info, config)
    trainer = Trainer(model, config, info, device=device)
    seed = int(config.get("seed", 0))
    kb = KGBatcher(ds, info, label_batch_size=config.get("label_batch_size"),
                   pair_mode=config.get("preference_pair_mode", "both"),
                   seed=seed, backend=backend, device=trainer.device)
    state = trainer.init_state(seed)
    t0 = time.time()
    best_acc = 0.0
    for epoch in range(int(config.get("epoch", 50))):
        state, cost, metrics, _ = trainer.run_epoch(state, kb)
        tc = sum(float(m["correct_count"]) for m in metrics)
        tn = sum(float(m["count"]) for m in metrics)
        acc = tc / max(tn, 1)
        best_acc = max(best_acc, acc)
        print(f"epoch {epoch}, training cost {cost:.6g} (rank acc={acc:.4g})")
    train_time = time.time() - t0
    print(f"training time: {train_time}[sec]")
    model_dir = config.get("save_model_path") or "model"
    path = ckpt.save_tree(ckpt.ckpt_name(model_dir, "last"),
                          trainer.state_tree(state, 0, 0.0))
    print(f"[SAVE] {path}")
    result = {"train_time": train_time, "ranking_accuracy": best_acc}
    if config.get("save_info_train"):
        _save_json(config["save_info_train"], result)
    return result


def cmd_infer_kg(config, ds, info, backend, device) -> Dict[str, Any]:
    """KG link-prediction inference (``kgcn_tpu``'s ``cmd_infer_kg``): the
    checkpoint's model scores every entity as head of each held-out triple
    (``left_prediction``); ranks over the real entities give mean rank,
    MRR, hits@1 and hits@10."""
    model = build_model(_kg_model_name(config), info, config)
    trainer = Trainer(model, config, info, device=device)
    kb = KGBatcher(ds, info, label_batch_size=config.get("label_batch_size"),
                   seed=0, test=True, backend=backend, device=trainer.device)
    load_path = config.get("load_model") or os.path.join(
        config.get("save_model_path", "model"), "model.last.ckpt")
    state = trainer.restore(load_path)
    print(f"[LOAD] {load_path}")

    triples = kb.label_list
    heads, rels, tails = triples[:, 0], triples[:, 1], triples[:, 2]
    model = trainer.model
    model.load_state_dict({**state.params, **state.batch_stats})
    dev = trainer.device
    with torch.no_grad():
        scores = model.left_prediction(
            kb.init_batch(), torch.from_numpy(tails).to(dev),
            torch.from_numpy(rels).to(dev)).cpu().numpy()  # [K, V padded]
    # the node axis is padded past the true entity count; padding rows score
    # exactly 0 and would outrank any negative true score
    scores = scores[:, : int(info.all_node_num)]
    true_scores = scores[np.arange(len(heads)), heads]
    ranks = (scores > true_scores[:, None]).sum(axis=1) + 1
    result = {
        "mean_rank": float(ranks.mean()),
        "mrr": float((1.0 / ranks).mean()),
        "hits@1": float((ranks <= 1).mean()),
        "hits@10": float((ranks <= 10).mean()),
        "num_test_triples": int(len(triples)),
    }
    print(json.dumps(result))
    out_path = config.get("save_edge_result") or config.get("save_result_test")
    if out_path:
        d = os.path.dirname(out_path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(out_path, "w") as f:
            f.write("head,relation,tail,score,head_rank\n")
            for h, r, t, sc, rk in zip(heads, rels, tails, true_scores, ranks):
                f.write(f"{h},{r},{t},{sc:.6g},{rk}\n")
        print(f"[SAVE] {out_path}")
    if config.get("save_info_test"):
        _save_json(config["save_info_test"], result)
    return result


def cmd_infer(config, device=None) -> Dict[str, Any]:
    """``infer`` / ``predict`` (``kgcn_tpu``'s ``cmd_infer``): the ranking
    of a KG's held-out triples, or on a graph dataset the evaluation of all
    of it with a restored checkpoint (reference: gcn.py:527-621)."""
    device = device_from_arg(device)
    ds, info, backend = _prepare(config, test_mode=True)
    if ds.label_list is not None and _is_kg(config):
        return cmd_infer_kg(config, ds, info, backend, device)
    model = build_model(config["model.py"], info, config)
    trainer = Trainer(model, config, info, device=device)
    batcher = Batcher(ds, info, int(config["batch_size"]), backend=backend)
    model_dir = config.get("save_model_path", "model")
    load_path = config.get("load_model") or os.path.join(model_dir, "model.best.ckpt")
    if not os.path.exists(load_path):
        alt = os.path.join(model_dir, "model.last.ckpt")
        if os.path.exists(alt):
            load_path = alt
    state = trainer.restore(load_path)
    print(f"[LOAD] {load_path}")

    t0 = time.time()
    ev = trainer.evaluate(state, batcher, "test_")
    infer_time = time.time() - t0
    print(f"infer time: {infer_time}[sec]")
    result: Dict[str, Any] = {"infer_time": infer_time, "test_cost": ev["cost"]}
    result["test_metrics_protocol"] = {
        k: np.asarray(v).tolist() for k, v in ev["metrics"].items()
    }
    if (ds.labels is not None and config.get("task") != "link_prediction"
            and ds.node_label is None):
        print("[metrics] test_metrics (the scikit-learn battery) is not yet "
              "ported; left out")
    if config.get("save_result_test"):
        save_prediction(config["save_result_test"], ev["prediction"])
    if config.get("save_info_test"):
        _save_json(config["save_info_test"], result)
    path = config.get("prediction_data") or config.get("save_prediction_data")
    if path:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "wb") as f:  # a plain pickle: joblib.load reads it too
            pickle.dump(ev["prediction"], f, protocol=4)
        print(f"[SAVE] {path}")
    return result


def _fit_once(config, train_ds, valid_ds, info, backend, device):
    """The single-device streaming branch of ``kgcn_tpu``'s ``_fit_once``
    (its ``fold``/``seed`` arguments come with ``train_cv``)."""
    if config.get("mesh"):
        _not_ported("data-parallel training (config 'mesh')")
    bs = int(config["batch_size"])
    model = build_model(config["model.py"], info, config)
    trainer = Trainer(model, config, info, device=device)
    tb = Batcher(train_ds, info, bs, seed=0, backend=backend)
    vb = None
    if valid_ds is not None and valid_ds.num > 0:
        vb = Batcher(valid_ds, info, bs, backend=backend)
    state = trainer.init_state(int(config.get("seed", 0)))
    if config.get("retrain"):
        state = trainer.restore(config["retrain"])
        print(f"[LOAD] {config['retrain']}")
    state, fit_info = trainer.fit(state, tb, vb)
    return trainer, state, fit_info, vb


def _save_serve_info(config, info) -> None:
    """The sidecar the serving runtime reads beside the checkpoints."""
    model_dir = config.get("save_model_path") or "model"
    payload = {
        "model.py": config.get("model.py", "gcn"),
        "task": config.get("task", ""),
        "label_dim": int(info.label_dim or 0),
        "graph_node_num": int(info.graph_node_num or 0),
        "adj_channel_num": int(info.adj_channel_num or 1),
        "feature_dim": int(getattr(info, "feature_dim", 0) or 0),
    }
    try:
        os.makedirs(model_dir, exist_ok=True)
        with open(os.path.join(model_dir, "serve_info.json"), "w") as f:
            json.dump(payload, f, indent=2)
    except OSError as e:
        print(f"[serve_info] skipped ({e})")


def cmd_train(config, device=None) -> Dict[str, Any]:
    """Train, evaluate the validation split, write the result files
    (``kgcn_tpu``'s ``cmd_train``, graph-level tasks).  ``device``: None
    for the GPU (raises without one) or "cpu"."""
    device = device_from_arg(device)
    task = config.get("task", "")
    for key in ("make_plot", "export_model", "export_savedmodel"):
        if config.get(key):
            _not_ported(f"config {key!r}")
    if str(config.get("precision", "float32")) != "float32":
        _not_ported(f"config precision {config['precision']!r} (ROADMAP.md A.4)")
    preloaded = None
    if _is_kg(config):
        preloaded = _prepare(config)
        if preloaded[0].label_list is not None:
            return cmd_train_kg(config, *preloaded, device)
    if config.get("validation_dataset"):
        train_ds, info, backend = preloaded or _prepare(config)
        valid_ds, valid_info, _ = _prepare(config, dataset_key="validation_dataset")
        info.graph_node_num = max(info.graph_node_num, valid_info.graph_node_num)
        valid_ds.max_node_num = train_ds.max_node_num = max(
            train_ds.max_node_num, valid_ds.max_node_num)
    else:
        ds, info, backend = preloaded or _prepare(config)
        train_ds, valid_ds, _, _ = split_dataset(
            ds, config.get("validation_data_rate", 0.3),
            seed=int(config.get("seed", 0)),
            shuffle=bool(config.get("shuffle_data", True)),
        )

    t0 = time.time()
    trainer, state, fit_info, vb = _fit_once(config, train_ds, valid_ds, info,
                                             backend, device)
    train_time = time.time() - t0
    print(f"training time: {train_time}[sec]")
    _save_serve_info(config, info)

    result: Dict[str, Any] = {"train_time": train_time}
    metric_name = _metric_name(task)
    if vb is not None and valid_ds.num > 0:
        t0 = time.time()
        ev = trainer.evaluate(state, vb, "validation_")
        infer_time = time.time() - t0
        valid_metrics = {k: v for k, v in ev["metrics"].items() if np.asarray(v).ndim <= 1}
        print(f"final cost = {ev['cost']}\n"
              f"{metric_name} = {valid_metrics.get('validation_' + metric_name)}\n"
              f"validation time: {infer_time}[sec]")
        result.update(validation_cost=ev["cost"], validation_accuracy=valid_metrics,
                      infer_time=infer_time)
        if valid_ds.labels is not None and valid_ds.node_label is None:
            print("[metrics] valid_metrics (the scikit-learn battery) is not "
                  "yet ported; left out")
        if config.get("save_result_valid"):
            save_prediction(config["save_result_valid"], ev["prediction"])
        if config.get("save_info_valid"):
            _save_json(config["save_info_valid"], result)

    if config.get("save_info_train"):
        hist = fit_info["history"]
        _save_json(config["save_info_train"], {
            "training_cost": [h["training_cost"] for h in hist],
            "validation_cost": [h.get("validation_cost") for h in hist],
            "training_acc": [h.get("training_accuracy") for h in hist],
            "validation_acc": [h.get("validation_accuracy") for h in hist],
            "train_time": train_time,
        })
    return result


def build_argparser():
    p = argparse.ArgumentParser(prog="kgcn-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["train", "train_cv", "infer", "predict",
                                    "visualize"])
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--dataset", default=None)
    p.add_argument("--model", default=None, help="model registry name")
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    config = load_config(args.config, {
        "dataset": args.dataset,
        "model.py": args.model,
        "epoch": args.epoch,
        "batch_size": args.batch_size,
        "learning_rate": args.learning_rate,
        "seed": args.seed,
    })
    device = "cpu" if args.cpu else None
    if args.mode == "train":
        return cmd_train(config, device=device)
    if args.mode in ("infer", "predict"):
        return cmd_infer(config, device=device)
    _not_ported(f"the {args.mode!r} subcommand")


if __name__ == "__main__":
    main()
