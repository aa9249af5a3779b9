"""Layered JSON config system — the port's own copy of
``kgcn_tpu/runtime/config.py``, same keys and defaults.

Same three-layer precedence as the reference: hardcoded defaults ← JSON config
file ← CLI overrides (reference: gcn.py:84-132 defaults, :731-737 merge,
:789-793 --save-config round trip).  Keys keep the reference's names so
existing kGCN config files work unchanged.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Optional


def default_config() -> Dict[str, Any]:
    """Defaults mirroring reference gcn.py:84-132 (+ TPU-build additions)."""
    return {
        "model.py": "model",
        "dataset": "data.jbl",
        "validation_dataset": None,
        # optimisation
        "epoch": 50,
        "batch_size": 10,
        "patience": 0,
        "learning_rate": 0.3,
        "validation_data_rate": 0.3,
        "shuffle_data": False,
        "k-fold_num": 2,
        "dropout_rate": 0.2,  # reference hardcodes 0.2 in fit (kgcn/core.py:267)
        # model parameters
        "with_feature": True,
        "with_node_embedding": False,
        "embedding_dim": 10,
        "normalize_adj_flag": False,
        "split_adj_flag": False,
        "order": 1,
        "param": None,
        # checkpoints
        "save_interval": 10,
        "save_model_path": "model",
        "save_model": None,
        "load_model": None,
        "retrain": None,
        # results
        "save_result_train": None,
        "save_result_valid": None,
        "save_result_test": None,
        "save_result_cv": None,
        "save_info_train": None,
        "save_info_valid": None,
        "save_info_test": None,
        "save_info_cv": None,
        "save_prediction_data": None,
        "make_plot": False,
        "plot_path": "./result/",
        "visualize_path": "./visualization/",
        "plot_multitask": False,
        "task": "multitask_classification",
        "profile": False,
        "export_model": None,
        "visualize_kg": None,
        "stratified_kfold": False,
        "prediction_data": None,
        "seed": 1234,
        # --- TPU-build additions (not in reference) ---
        "precision": "float32",  # or "bfloat16" for MXU-friendly compute
        "spmm_backend": "auto",  # auto | dense | xla | pallas | tiled | stream
        "mesh": None,  # e.g. {"data": 8} for pjit data parallelism
        "label_batch_size": None,  # KG: inner label batching (core.py:219-222)
    }


def load_config(path: Optional[str] = None, overrides: Optional[Dict] = None):
    cfg = default_config()
    if path:
        with open(path) as f:
            cfg.update(json.load(f))
    if overrides:
        cfg.update({k: v for k, v in overrides.items() if v is not None})
    return cfg
