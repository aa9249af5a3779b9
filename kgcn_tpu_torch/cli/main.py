"""Command-line entry point of the port — the counterpart of
``kgcn_tpu/cli/main.py``: the ``train``, ``train_cv``, ``infer`` and
``visualize`` subcommands.

    python -m kgcn_tpu_torch.cli.main train --config example_config/gat.json [--cpu]
    python -m kgcn_tpu_torch.cli.main infer --config example_config/gat.json [--cpu]
    python -m kgcn_tpu_torch.cli.main train_cv --config example_config/solubility_reg.json [--cpu]
    python -m kgcn_tpu_torch.cli.main visualize --config example_config/synth.json [--cpu]
    python -m kgcn_tpu_torch.cli.main train --config kg.json [--cpu]
    python -m kgcn_tpu_torch.cli.main infer --config kg.json [--cpu]

Same JSON configs and the same outputs as ``kgcn-tpu``: per-epoch lines,
best / interval / last checkpoints under ``save_model_path`` (the port's
own format, ``runtime/checkpoint.py``), ``serve_info.json`` beside them, and
``save_info_train`` / ``save_info_valid`` (with the metric battery,
``valid_metrics``) / ``save_result_valid``; with ``make_plot`` the cost
curve and, for classification, the ROC curves under ``plot_path``
(``tools/plots.py``; matplotlib).  ``train_cv`` trains ``k-fold_num``
folds (``kfold_indices``; ``stratified_kfold``), fold ``f`` from seed
``seed + f`` with its checkpoints named by fold, and writes each fold's
test cost and battery to ``save_info_cv`` / ``save_result_cv`` (and
``save_result_test`` per fold); ``fold_parallel`` ``"auto"`` trains the
folds one after another on the one card, as ``kgcn_tpu``'s gate does on
one device.  ``visualize`` writes the integrated gradients of each
molecule (``explain/ig.py``) under ``visualize_path``.  A
``task: link_prediction`` dataset with a ``label_list`` trains the KG link
predictor (``cmd_train_kg``: preference pairs, the ``last`` checkpoint,
``save_info_train``), and ``infer`` ranks its held-out triples
(``cmd_infer_kg``: mean rank, MRR, hits@1/10; ``save_edge_result`` or
``save_result_test``, ``save_info_test``).  On any other dataset ``infer``
evaluates the whole dataset with the ``best`` checkpoint (``last`` when
there is no best): ``infer_time``, ``test_cost`` and
``test_metrics_protocol`` and the battery (``test_metrics``),
``save_result_test``, ``save_info_test`` and ``prediction_data`` (a plain
pickle).  Runs on the GPU unless ``--cpu`` is given.

The config's ``spmm_backend`` picks the path: ``"auto"`` resolves as in
``kgcn_tpu`` (dense up to 256 padded nodes, the CUDA gconv kernel; stream
for whole-graph work beyond, the CUDA stream kernels), ``"tiled"`` takes the
tiled SpMM/SDDMM kernels, ``"pallas"`` the CUDA ELL gather kernel where the
dataset's degree layout admits ELL arrays (else the edge-list scatter, said
once), ``"xla"`` the same routes without a kernel; the tiled and stream
payload dtype is ``tiled_compute_dtype`` (``"bfloat16"`` default, or
``"float32"``).

``device_resident`` (``"auto"`` by default, ``true``/``"force"``,
``false``) keeps a dense or ELL dataset on the device and runs whole
epochs of training and evaluation through the resident runners
(``runtime/resident.py``, ``runtime/runner.py``: on the GPU each step
replayed from a captured CUDA graph), as ``kgcn_tpu`` does; the tiled and
stream backends decline it (said when it was forced).  KG training runs
the scanned epoch.

``precision`` (``runtime/device.set_precision``): ``"float32"`` (the
default) and ``"highest"`` keep float32 library products in full float32;
``"default"`` allows TF32 for them; ``"bfloat16"`` allows it too and casts
each step's payload to bf16 (``Trainer.compute_dtype``: the dense
aggregation then runs the bf16 gconv kernel).  ``debug_nan`` stops the run
at the first non-finite cost or gradient (``FloatingPointError``; the
steps run eagerly, each checked), ``deterministic`` sets
``torch.use_deterministic_algorithms(True)``, and ``profile`` (or
``--profile``) writes a ``torch.profiler`` trace of the whole command to
``profile_dir`` (``logs/torch_trace`` by default); ``--save-config PATH``
writes the merged config.

``export_model`` (a path) has ``train`` write the trained model as a
``torch.export`` artifact traced at a batch of the training split
(``runtime/export.py``; dense backend only), which ``kgcn_tpu_torch.cli.
serve --export`` serves.  ``retrain``, ``load_model`` and ``infer`` take a
checkpoint of the port or a flax-msgpack one that ``kgcn_tpu`` wrote.

``visualize`` routes as ``kgcn_tpu``'s: a KG config (``task:
link_prediction``, an ``edge*`` ``visualize_type``, or a node-embedding
dataset with KG triples) to the embedding IG of ``explain/kg_ig.py``, any
other to ``explain/ig.py`` (with the IG of the vector modals and of the
sequence-embedding layer where the dataset has them).

Not ported yet, each raising "not yet ported" with its ROADMAP.md item:
``mesh`` (data parallel; KG: the sharded and resident training, A.11) and
``fold_parallel`` ``"force"`` (A.11).  The
sparse, pair and VAE engines have their own entry points, as in
``kgcn_tpu``: ``cli/sparse.py``, ``cli/pair.py`` and ``cli/gen.py``.  ``export_savedmodel`` (a TensorFlow SavedModel)
is refused: it needs TensorFlow, which the port does not use.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from kgcn_tpu_torch.data import jbl
from kgcn_tpu_torch.data.batcher import Batcher
from kgcn_tpu_torch.data.dataset import (kfold_indices, load_jbl,
                                         split_dataset)
from kgcn_tpu_torch.explain.ig import run_visualization
from kgcn_tpu_torch.explain.kg_ig import run_kg_visualization
from kgcn_tpu_torch.models.kg import KGBatcher
from kgcn_tpu_torch.models.registry import build_model
from kgcn_tpu_torch.runtime import backend as backend_mod
from kgcn_tpu_torch.runtime import checkpoint as ckpt
from kgcn_tpu_torch.runtime import resident
from kgcn_tpu_torch.runtime.config import load_config, save_config
from kgcn_tpu_torch.runtime.device import device_from_arg, set_precision
from kgcn_tpu_torch.runtime.export import export_model
from kgcn_tpu_torch.runtime.metrics import compute_metrics
from kgcn_tpu_torch.runtime.train import Trainer
from kgcn_tpu_torch.tools import plots


def fold_parallel_flag(config) -> str:
    """Config ``fold_parallel`` as 'off' | 'force' | 'auto' (``kgcn_tpu``'s
    ``parallel/cv.fold_parallel_flag``)."""
    flag = config.get("fold_parallel", "auto")
    if flag in (False, "false", "off", 0, "0"):
        return "off"
    if flag in (True, "true", "force", 1, "1"):
        return "force"
    return "auto"


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


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"{what} is not yet ported to kgcn_tpu_torch "
                              f"(ROADMAP.md {item})")


def _prepare(config, dataset_key="dataset", test_mode=False):
    """Dataset, info and the resolved backend (pinned in the config).  The
    config's ``"param"`` (a dict, or the path of a JSON file; ``cli/opt.py``
    sets it on every trial) goes into ``info.param``, as in ``kgcn_tpu``'s
    ``_prepare`` (``kgcn_tpu/cli/main.py:77-82``)."""
    ds, info = load_jbl(config[dataset_key], config, test_mode=test_mode)
    if config.get("param"):
        param = config["param"]
        if isinstance(param, str):
            with open(param) as f:
                param = json.load(f)
        info.param = param
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
                    "_train_kg_sharded and its resident fit)", "A.11")
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
    bs = int(config["batch_size"])
    batcher = (_maybe_resident(config, ds, info, bs, backend, trainer.device)
               or Batcher(ds, info, bs, backend=backend))
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
    if _battery_applies(config, ds):
        result["test_metrics"] = compute_metrics(config, ds.labels, ev["prediction"],
                                                 ds.mask_label)
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


def _battery_applies(config, ds) -> bool:
    """The offline battery scores graph-level labels (not KG ranking, not
    per-node predictions)."""
    return (config.get("task") != "link_prediction" and ds.labels is not None
            and ds.node_label is None)


def _maybe_resident(config, ds, info, bs, backend, device, seed=0):
    """A device-resident batcher (whole epochs through the resident runners)
    where the gate admits the dataset (``resident.resident_enabled``), else
    None.  A failure to build it raises: there is no quiet fallback to the
    streaming batcher."""
    if not resident.resident_enabled(config, ds, info, backend):
        return None
    return resident.ResidentBatcher(ds, info, bs, seed=seed, backend=backend,
                                    device=device)


def _fit_once(config, train_ds, valid_ds, info, backend, device,
              fold: Optional[int] = None, seed: Optional[int] = None):
    """The single-device branch of ``kgcn_tpu``'s ``_fit_once``: the batches
    shuffled from ``seed`` (0 when None), the parameters drawn from it (the
    config's seed when None), the checkpoints named by ``fold``."""
    if config.get("mesh"):
        _not_ported("data-parallel training (config 'mesh')", "A.11")
    bs = int(config["batch_size"])
    model = build_model(config["model.py"], info, config)
    trainer = Trainer(model, config, info, device=device)
    tb = (_maybe_resident(config, train_ds, info, bs, backend, trainer.device,
                          seed=seed or 0)
          or Batcher(train_ds, info, bs, seed=seed or 0, backend=backend))
    vb = None
    if valid_ds is not None and valid_ds.num > 0:
        vb = (_maybe_resident(config, valid_ds, info, bs, backend, trainer.device)
              or Batcher(valid_ds, info, bs, backend=backend))
    state = trainer.init_state(seed if seed is not None else int(config.get("seed", 0)))
    if config.get("retrain"):
        state = trainer.restore(config["retrain"])
        print(f"[LOAD] {config['retrain']}")
    state, fit_info = trainer.fit(state, tb, vb, fold=fold)
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
    if config.get("export_savedmodel"):
        raise NotImplementedError(
            "config 'export_savedmodel' (a TensorFlow SavedModel, kgcn_tpu's "
            "jax2tf bridge) is not ported: it needs TensorFlow, which "
            "kgcn_tpu_torch does not use; 'export_model' writes a torch.export "
            "artifact")
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
        if _battery_applies(config, valid_ds):
            result["valid_metrics"] = compute_metrics(
                config, valid_ds.labels, ev["prediction"], valid_ds.mask_label)
        if config.get("save_result_valid"):
            save_prediction(config["save_result_valid"], ev["prediction"])
        if config.get("save_info_valid"):
            _save_json(config["save_info_valid"], result)

    if config.get("export_model"):
        bs = int(config["batch_size"])
        sample = Batcher(train_ds, info, bs, backend=backend).make_batch(
            np.arange(min(bs, train_ds.num)))
        export_model(trainer.model, state.params, state.batch_stats, sample,
                     config["export_model"])

    if config.get("save_info_train"):
        hist = fit_info["history"]
        _save_json(config["save_info_train"], {
            "training_cost": [h["training_cost"] for h in hist],
            "validation_cost": [h.get("validation_cost") for h in hist],
            "training_acc": [h.get("training_accuracy") for h in hist],
            "validation_acc": [h.get("validation_accuracy") for h in hist],
            "train_time": train_time,
        })
    if config.get("make_plot"):
        plots.plot_cost(config, fit_info["history"])
        if vb is not None and valid_ds.labels is not None and task not in (
                "regression", "regression_gmfe", "link_prediction"):
            plots.plot_auc(config, valid_ds.labels, np.asarray(ev["prediction"]),
                           mask_label=valid_ds.mask_label)
    return result


def cmd_train_cv(config, device=None) -> Dict[str, Any]:
    """K-fold cross-validation (``kgcn_tpu``'s ``cmd_train_cv``; reference
    gcn.py:355-524): fold ``f`` trains on the other folds from seed
    ``seed + f``, validating on its own test fold (the best checkpoint is
    restored), then evaluates that fold: its cost, the task metric and the
    battery, and the summary's mean and spread of the task metric."""
    device = device_from_arg(device)
    if fold_parallel_flag(config) == "force":
        _not_ported("fold_parallel 'force' (the folds trained at once across "
                    "devices, kgcn_tpu/parallel/cv.py)", "A.11")
    ds, info, backend = _prepare(config)
    k = int(config.get("k-fold_num", 2))
    strat = None
    if config.get("stratified_kfold") and ds.labels is not None:
        strat = np.argmax(ds.labels, axis=1)
    seed = int(config.get("seed", 0))
    folds = kfold_indices(ds.num, k, seed=seed, stratify=strat)
    metric_name = _metric_name(config.get("task", ""))
    fold_results = []
    for fold, (train_idx, test_idx) in enumerate(folds):
        print(f"[fold {fold}] train={len(train_idx)} test={len(test_idx)}")
        train_ds, test_ds = ds.subset(train_idx), ds.subset(test_idx)
        trainer, state, _, _ = _fit_once(config, train_ds, test_ds, info, backend,
                                         device, fold=fold, seed=seed + fold)
        ev = trainer.evaluate(state, Batcher(test_ds, info, int(config["batch_size"]),
                                             backend=backend), "test_")
        entry = {
            "fold": fold,
            "test_cost": ev["cost"],
            f"test_{metric_name}": float(
                np.asarray(ev["metrics"].get(f"test_{metric_name}", np.nan)).mean()),
        }
        if _battery_applies(config, test_ds):
            entry["test_metrics"] = compute_metrics(
                config, test_ds.labels, ev["prediction"], test_ds.mask_label)
        fold_results.append(entry)
        if config.get("save_result_test"):
            base, ext = os.path.splitext(config["save_result_test"])
            save_prediction(f"{base}.fold{fold}{ext}", ev["prediction"])

    values = [r.get(f"test_{metric_name}", np.nan) for r in fold_results]
    summary = {
        "folds": fold_results,
        f"mean_{metric_name}": float(np.nanmean(values)),
        f"std_{metric_name}": float(np.nanstd(values)),
    }
    print(f"cv {metric_name}: mean={summary[f'mean_{metric_name}']:.4f} "
          f"std={summary[f'std_{metric_name}']:.4f}")
    for key in ("save_info_cv", "save_result_cv"):
        if config.get(key):
            _save_json(config[key], summary)
    return summary


def cmd_visualize(config, device=None) -> list:
    """Integrated-gradients visualisation (``kgcn_tpu``'s ``cmd_visualize``,
    reference gcn.py:637-657): the KG route (``task: link_prediction``, an
    ``edge*`` ``visualize_type``, or a node-embedding dataset that carries
    KG triples) runs the embedding IG of ``explain/kg_ig.
    run_kg_visualization``; any other the compound IG of ``explain/ig.
    run_visualization``.  Returns the paths written."""
    device = device_from_arg(device)
    vt = str(config.get("visualize_type", "graph") or "graph")
    # the train dispatch's rule: a node-embedding config is a KG run only
    # when its dataset carries KG triples
    kg_route = config.get("task") == "link_prediction" or vt.startswith("edge")
    raw = None
    if not kg_route and config.get("with_node_embedding"):
        raw = jbl.load(config["dataset"])
        kg_route = isinstance(raw, dict) and raw.get("label_list") is not None
    if kg_route:
        return run_kg_visualization(config, raw=raw, device=device)
    return run_visualization(config, device=device, raw=raw)


def build_argparser():
    p = argparse.ArgumentParser(prog="kgcn-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("mode", choices=["train", "train_cv", "infer", "predict",
                                    "visualize"])
    p.add_argument("--config", default=None, help="JSON config file")
    p.add_argument("--save-config", default=None, help="dump merged config")
    p.add_argument("--dataset", default=None)
    p.add_argument("--model", default=None, help="model registry name")
    p.add_argument("--epoch", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--cpu", action="store_true", help="run on the CPU")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace of the command")
    return p


def _run(args, config, device):
    if args.mode == "train":
        return cmd_train(config, device=device)
    if args.mode == "train_cv":
        return cmd_train_cv(config, device=device)
    if args.mode in ("infer", "predict"):
        return cmd_infer(config, device=device)
    return cmd_visualize(config, device=device)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    overrides = {
        "dataset": args.dataset,
        "model.py": args.model,
        "epoch": args.epoch,
        "batch_size": args.batch_size,
        "learning_rate": args.learning_rate,
        "seed": args.seed,
    }
    if args.profile:
        overrides["profile"] = True
    config = load_config(args.config, overrides)
    if args.save_config:
        save_config(config, args.save_config)
    device = "cpu" if args.cpu else None
    # the switches of kgcn_tpu's main() (kgcn_tpu/cli/main.py:681-716):
    # precision, determinism, the profiler trace; debug_nan is read by the
    # Trainer
    set_precision(config.get("precision", "float32"))
    if config.get("deterministic"):
        # cuBLAS repeats its sums only with a fixed workspace
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
    if not config.get("profile"):
        return _run(args, config, device)
    prof_dir = config.get("profile_dir", "logs/torch_trace")
    os.makedirs(prof_dir, exist_ok=True)
    print(f"[PROFILE] tracing to {prof_dir}")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if not args.cpu:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        return _run(args, config, device)
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(prof_dir, "trace.json"))
        print(f"[PROFILE] trace written to {prof_dir}")


if __name__ == "__main__":
    main()
