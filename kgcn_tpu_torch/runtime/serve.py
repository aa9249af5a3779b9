"""Serving runtime — the counterpart of ``kgcn_tpu/runtime/serve.py:25-200``.

A ``Predictor`` restores a checkpoint once, on the first request, and
answers every request by padding it into fixed-shape batches
(``serve_max_nodes`` × ``batch_size``) that run through the model on the
device.  ``cli/serve.py`` wraps it in an HTTP JSON API.  The JAX package's
``DynamicBatcher`` and ``ExportPredictor`` are still to be ported
(ROADMAP.md queue A).
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from kgcn_tpu_torch.data.batcher import Batcher
from kgcn_tpu_torch.data.dataset import build_dataset
from kgcn_tpu_torch.graph.batch import pad_edge_budget
from kgcn_tpu_torch.models.registry import build_model
from kgcn_tpu_torch.runtime.device import device_from_arg
from kgcn_tpu_torch.runtime.train import Trainer


def payload_to_data(payload: Dict[str, Any]) -> Dict[str, Any]:
    """Convert a JSON request body (nested lists) into the in-memory jbl
    schema ``build_dataset`` consumes (docs/dataset_file.md)."""
    data: Dict[str, Any] = {}
    for key, val in payload.items():
        if key == "adj":
            data[key] = [
                [
                    (
                        np.asarray(t[0], np.int32),
                        np.asarray(t[1], np.float32),
                        tuple(int(x) for x in t[2]),
                    )
                    for t in graph_channels
                ]
                for graph_channels in val
            ]
        elif key == "graph_index_list":
            data[key] = [tuple(int(x) for x in pair) for pair in val]
        elif key in ("max_node_num", "node_num"):
            data[key] = int(val)
        elif key == "mol_info":
            data[key] = val
        elif key in ("node", "label_list", "test_label_list"):
            data[key] = [np.asarray(v, np.int32) for v in val]
        elif key in ("sequence", "sequence_length", "sequence_symbol_num"):
            data[key] = np.asarray(val, np.int32)
        else:
            data[key] = np.asarray(val, np.float32)
    return data


class Predictor:
    """Checkpoint-backed batched predictor with pinned static shapes.

    Parameters
    ----------
    config: the TRAINING config (model.py, task, feature flags …).  Serving
        adds ``serve_max_nodes`` (node padding; defaults to the first
        request's), ``label_dim`` (head width when requests carry no labels)
        and ``batch_size``.
    checkpoint: path override; defaults to ``load_model`` or
        ``<save_model_path>/model.best.ckpt`` (falling back to ``.last``).
        A checkpoint of the port (``runtime/checkpoint.py``).
    device: ``None`` for the GPU (raises without one), or ``"cpu"``.
    """

    def __init__(self, config: Dict[str, Any],
                 checkpoint: Optional[str] = None, device=None):
        self.device = device_from_arg(device)
        self.config = dict(config)
        self._load_serve_info()
        self.batch_size = int(self.config.get("batch_size", 32))
        self.max_nodes = int(self.config.get("serve_max_nodes", 0)) or None
        self._ckpt = checkpoint or self._default_ckpt()
        self._lock = threading.Lock()
        self._trainer = None
        self._state = None
        self._info = None
        self.requests = 0
        self.graphs_served = 0

    def _load_serve_info(self) -> None:
        """Merge the train-time sidecar (<save_model_path>/serve_info.json)
        under the explicit config: the shape contract label-less requests
        cannot carry."""
        path = os.path.join(
            self.config.get("save_model_path", "model"), "serve_info.json"
        )
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                side = json.load(f)
        except (OSError, ValueError):
            return
        for src, dst in (("label_dim", "label_dim"),
                         ("graph_node_num", "serve_max_nodes"),
                         ("model.py", "model.py"), ("task", "task")):
            if side.get(src) and not self.config.get(dst):
                self.config[dst] = side[src]

    def _default_ckpt(self) -> str:
        if self.config.get("load_model"):
            return self.config["load_model"]
        base = self.config.get("save_model_path", "model")
        best = os.path.join(base, "model.best.ckpt")
        return best if os.path.exists(best) else os.path.join(
            base, "model.last.ckpt"
        )

    @staticmethod
    def _ensure_labels(ds, label_dim: int):
        """Inference requests carry no labels; the models still compute a
        (meaningless) cost term, so give them zeros of the trained head
        width."""
        if ds.labels is None and ds.node_label is None:
            ds.labels = np.zeros((ds.num, max(label_dim, 1)), np.float32)
            if ds.mask_label is None:
                ds.mask_label = np.zeros_like(ds.labels)
        return ds

    def _pinned(self, data: Dict[str, Any]) -> Dict[str, Any]:
        if self.max_nodes:
            data = dict(data)
            data["max_node_num"] = self.max_nodes
        return data

    # ------------------------------------------------------------------ #
    def _build(self, data: Dict[str, Any]) -> None:
        """Build model + restore checkpoint from the first request's schema."""
        ds, info = build_dataset(self._pinned(data), self.config, test_mode=True)
        if self.config.get("label_dim"):
            info.label_dim = int(self.config["label_dim"])
        ds = self._ensure_labels(ds, info.label_dim)
        model = build_model(self.config.get("model.py", "gcn"), info, self.config)
        trainer = Trainer(model, self.config, info, device=self.device)
        b = Batcher(ds, info, self.batch_size)
        sample = b.make_batch(np.arange(min(self.batch_size, ds.num)))
        state = trainer.restore(self._ckpt)
        self.max_nodes = b.max_nodes
        self._trainer, self._state, self._info = trainer, state, info
        # one warm-up batch, so the first real request finds the kernels
        # built and the device's libraries initialised
        trainer.eval_step(state.params, state.batch_stats, sample)

    # ------------------------------------------------------------------ #
    def predict_data(self, data: Dict[str, Any]) -> Dict[str, Any]:
        """Run inference on an in-memory jbl-schema dict; returns prediction
        (list-of-lists) + timing."""
        t0 = time.time()
        with self._lock:
            if self._trainer is None:
                self._build(data)
            ds, req_info = build_dataset(self._pinned(data), self.config,
                                         test_mode=True)
            ds = self._ensure_labels(ds, self._info.label_dim)
            # the edge budget follows THIS request's molecules: the first
            # request's budget (what kgcn_tpu's Predictor keeps) overflows
            # on any later request with a denser molecule (ROADMAP.md C)
            b = Batcher(ds, self._info, self.batch_size, edge_budget=pad_edge_budget(
                req_info.edge_budget_per_graph * self.batch_size))
            ev = self._trainer.evaluate(self._state, b)
            self.requests += 1
            self.graphs_served += int(ds.num)
        return {
            "prediction": np.asarray(ev["prediction"]).tolist(),
            "num": int(ds.num),
            "latency_ms": (time.time() - t0) * 1000.0,
            "checkpoint": self._ckpt,
        }

    def predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """JSON request body → prediction response."""
        return self.predict_data(payload_to_data(payload))

    def health(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "model": self.config.get("model.py", "gcn"),
            "checkpoint": self._ckpt,
            "ready": self._trainer is not None,
            "requests": self.requests,
            "graphs_served": self.graphs_served,
            "backend": (torch.cuda.get_device_name(self.device)
                        if self.device.type == "cuda" else "cpu"),
            "batch_size": self.batch_size,
            "max_nodes": self.max_nodes,
        }
