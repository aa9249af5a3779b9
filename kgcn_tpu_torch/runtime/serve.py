"""Serving runtime — the counterpart of ``kgcn_tpu/runtime/serve.py``.

* ``Predictor`` restores a checkpoint once, on the first request — the
  port's own or a flax-msgpack one that ``kgcn_tpu`` wrote — and answers
  every request by padding it into fixed-shape batches (``serve_max_nodes``
  × ``batch_size``) that run through the model on the device.
* ``DynamicBatcher`` coalesces concurrent requests into one ``Predictor``
  call: it holds arrivals for a window, merges requests of one schema and
  splits the prediction rows back per request (``kgcn-tpu-serve
  --dynamic-batching``).
* ``ExportPredictor`` serves a ``torch.export`` artifact
  (``runtime/export.py``): parameters baked in, batch and node shapes fixed
  by the trace.

``cli/serve.py`` wraps them in an HTTP JSON API.  Each runs on the GPU
unless given ``device="cpu"``.
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
from kgcn_tpu_torch.runtime import export as export_mod
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


def _request_nodes(data: Dict[str, Any]) -> int:
    """The most nodes a request's graphs span: its ``max_node_num``, its
    per-graph arrays' node axis, its COO shapes."""
    n = int(data.get("max_node_num", 0) or 0)
    for key in ("feature", "dense_adj"):
        if key in data and np.ndim(data[key]) >= 2:
            n = max(n, np.shape(data[key])[1])
    for gs in data.get("adj", []):
        for ch in (gs if gs and isinstance(gs[0], (list, tuple)) else [gs]):
            n = max(n, int(ch[2][0]))
    return n


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
        A checkpoint of the port, or of ``kgcn_tpu`` (``runtime/
        checkpoint.py``): ``--config`` over a model directory that
        ``kgcn_tpu train`` wrote serves it as it is.
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


class DynamicBatcher:
    """Coalesces concurrent requests into one device call
    (``kgcn_tpu/runtime/serve.py:203-376``, the same rules).

    Arrivals are held for ``window_ms``; requests whose key sets and
    per-graph shapes agree (``_schema``) and that carry only mergeable keys
    (``_coalescable``) are merged into one jbl dict (``_MERGE_AXIS0`` along
    the first axis, ``adj``/``node`` as lists, ``max_node_num`` the largest,
    ``_SCALAR_KEYS`` kept), up to ``max_graphs`` graphs a call; ONE
    ``Predictor.predict_data`` runs them and the prediction rows are split
    back per request, each reply marked ``"coalesced"``.  A merged call that
    fails is retried one request at a time, so a bad request fails alone.
    The worker thread calls the ``Predictor`` the server thread built (its
    lock serialises the device work); ``close()`` refuses new requests."""

    _MERGE_AXIS0 = ("feature", "dense_adj", "multi_dense_adj", "label",
                    "mask_label", "vector_modal", "sequence", "sequence_length")
    # keys whose merged semantics are defined above; a request carrying any
    # OTHER per-graph key (graph_index_list pairings, mol_info, ad-hoc modal
    # matrices) must not coalesce — keeping vals[0] would misalign graphs
    _SCALAR_KEYS = ("max_node_num", "node_num", "sequence_symbol_num")

    def __init__(self, predictor: Predictor, *, window_ms: float = 5.0,
                 max_graphs: int = 256):
        self.p = predictor
        self.window = float(window_ms) / 1000.0
        self.max_graphs = int(max_graphs)
        self._cv = threading.Condition()
        self._queue: list = []
        self._alive = True
        self.coalesced_calls = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- request side ---------------------------------------------------- #
    def predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        data = payload_to_data(payload)
        slot = {"data": data, "n": self._num_graphs(data),
                "event": threading.Event(), "result": None, "error": None}
        with self._cv:
            if not self._alive:
                # the worker is gone: an enqueued request would wait forever
                raise RuntimeError("DynamicBatcher is closed")
            self._queue.append(slot)
            self._cv.notify()
        slot["event"].wait()
        if slot["error"] is not None:
            raise slot["error"]
        return slot["result"]

    def health(self) -> Dict[str, Any]:
        h = self.p.health()
        h["dynamic_batching"] = {
            "window_ms": self.window * 1000.0,
            "max_graphs": self.max_graphs,
            "coalesced_calls": self.coalesced_calls,
        }
        return h

    def close(self) -> None:
        """Refuse new requests; the worker answers what is queued, then
        ends."""
        with self._cv:
            self._alive = False
            self._cv.notify()

    # -- worker side ------------------------------------------------------ #
    @staticmethod
    def _num_graphs(data: Dict[str, Any]) -> int:
        for key in ("feature", "dense_adj", "multi_dense_adj", "adj"):
            if key in data:
                return len(data[key])
        raise ValueError("request carries no adjacency/feature arrays")

    @staticmethod
    def _schema(data: Dict[str, Any]):
        """Requests merge only when their key sets and per-graph shapes
        agree."""
        sig = []
        for k in sorted(data):
            v = data[k]
            if isinstance(v, np.ndarray):
                sig.append((k, v.shape[1:], str(v.dtype)))
            else:
                sig.append((k, None, type(v).__name__))
        return tuple(sig)

    def _merge(self, datas):
        out: Dict[str, Any] = {}
        for k in datas[0]:
            vals = [d[k] for d in datas]
            if k in self._MERGE_AXIS0:
                out[k] = np.concatenate(vals, axis=0)
            elif k in ("adj", "node"):
                out[k] = [g for v in vals for g in v]
            elif k == "max_node_num":
                out[k] = max(int(v) for v in vals)
            else:  # scalars that must agree (schema-matched already)
                out[k] = vals[0]
        return out

    def _coalescable(self, data) -> bool:
        for k, v in data.items():
            if k in self._MERGE_AXIS0 or k in ("adj", "node"):
                continue
            if k in self._SCALAR_KEYS or np.ndim(v) == 0:
                continue
            return False
        return True

    def _run(self) -> None:
        while True:
            with self._cv:
                while self._alive and not self._queue:
                    self._cv.wait()
                if not self._alive and not self._queue:
                    return
            time.sleep(self.window)  # let concurrent arrivals land
            with self._cv:
                batch, self._queue = self._queue, []
            # group by schema, arrival order kept inside a group; requests
            # with unmergeable per-graph keys run alone
            groups: Dict[Any, list] = {}
            for si, slot in enumerate(batch):
                key = (self._schema(slot["data"]) if self._coalescable(slot["data"])
                       else ("solo", si))
                groups.setdefault(key, []).append(slot)
            for slots in groups.values():
                while slots:
                    take, total = [], 0
                    while slots and (not take
                                     or total + slots[0]["n"] <= self.max_graphs):
                        s = slots.pop(0)
                        take.append(s)
                        total += s["n"]
                    self._execute(take)

    def _execute(self, slots) -> None:
        try:
            if len(slots) == 1:
                slots[0]["result"] = self.p.predict_data(slots[0]["data"])
                return
            resp = self.p.predict_data(self._merge([s["data"] for s in slots]))
            self.coalesced_calls += 1
            pred, off = resp["prediction"], 0
            for s in slots:
                n = s["n"]
                s["result"] = {
                    "prediction": pred[off:off + n], "num": n,
                    "latency_ms": resp["latency_ms"],
                    "checkpoint": resp["checkpoint"],
                    "coalesced": len(slots),
                }
                off += n
        except Exception as e:
            if len(slots) > 1:
                # isolate the failing request: retry one at a time
                for s in slots:
                    self._execute([s])
            else:
                slots[0]["error"] = e
        finally:
            for s in slots:
                s["event"].set()


class ExportPredictor:
    """Serve a ``torch.export`` artifact (``runtime/export.py``): the
    parameters are baked in, and the batch and node shapes are the traced
    ones, read from the artifact's input signature (``traced_inputs``, as
    ``kgcn_tpu``'s ``_traced_shape``).  A request is padded into chunks of
    the traced batch; the dense adjacency is built per chunk, so any edge
    count fits.  A request whose inputs differ from the signature (another
    set of fields, more nodes, other per-graph widths) raises
    ``ValueError``.  ``config``: the training config (the dataset flags
    ``build_dataset`` reads).  Runs on the GPU unless ``device="cpu"``."""

    def __init__(self, path: str, config: Optional[Dict[str, Any]] = None,
                 device=None):
        self.device = device_from_arg(device)
        self.config = dict(config or {})
        self._path = path
        self._ep = export_mod.load_exported(path, self.device)
        self._fn = self._ep.module()
        (args, _), self._spec = export_mod.traced_inputs(self._ep)
        self._traced = args[0]
        g = self._traced.graph
        self.batch_size, self.max_nodes = int(g.n_graph), int(g.max_nodes)
        labels = self._traced.labels
        self.label_dim = int(labels.shape[1]) if labels is not None else 1
        self._lock = threading.Lock()
        self.requests = 0

    def _coerce(self, batch) -> Any:
        """The batch with its leaves cast to the signature's types; another
        set of fields or other shapes raise ``ValueError``."""
        leaves, spec = torch.utils._pytree.tree_flatten(((batch,), {}))
        want = torch.utils._pytree.tree_leaves(((self._traced,), {}))
        given = [leaf is not None for leaf in leaves]
        if spec != self._spec or given != [w is not None for w in want]:
            raise ValueError(
                "the request's batch does not fit the exported signature: its "
                "modalities/optional fields must match what the model was "
                f"exported with ({sum(given)} arrays, the signature "
                f"{sum(w is not None for w in want)})")
        out = []
        for leaf, w in zip(leaves, want):
            if isinstance(leaf, torch.Tensor):
                if tuple(leaf.shape) != tuple(w.shape):
                    raise ValueError(f"request array of shape {tuple(leaf.shape)} where "
                                     f"the exported signature has {tuple(w.shape)}")
                leaf = leaf.to(w.dtype)
            out.append(leaf)
        (args, _) = torch.utils._pytree.tree_unflatten(out, spec)
        return args[0]

    def predict(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        t0 = time.time()
        data = dict(payload_to_data(payload))
        n = _request_nodes(data)
        if n > self.max_nodes:
            raise ValueError(f"request graphs have {n} nodes; the program was "
                             f"exported for {self.max_nodes}")
        data["max_node_num"] = self.max_nodes  # pad into the traced node shape
        ds, info = build_dataset(data, self.config, test_mode=True)
        # the program was traced WITH label arrays: feed zeros
        ds = Predictor._ensure_labels(ds, self.label_dim)
        bs = self.batch_size
        b = Batcher(ds, info, bs, edge_budget=pad_edge_budget(
            max(info.edge_budget_per_graph, 1) * bs))
        preds = []
        with self._lock:
            for start in range(0, ds.num, bs):
                idx = np.arange(start, min(start + bs, ds.num))
                batch = export_mod.export_batch(b.make_batch(idx).to(self.device))
                with torch.no_grad():
                    out = self._fn(self._coerce(batch))
                preds.append(out[:len(idx)].cpu().numpy())
            self.requests += 1
        pred = np.concatenate(preds) if preds else np.zeros((0,))
        return {
            "prediction": pred.tolist(),
            "num": int(ds.num),
            "latency_ms": (time.time() - t0) * 1000.0,
            "checkpoint": self._path,
        }

    def health(self) -> Dict[str, Any]:
        return {"status": "ok", "export": self._path, "ready": True,
                "requests": self.requests}
