"""Model export — the counterpart of ``kgcn_tpu/runtime/export.py``.

``export_model`` writes the inference forward (``train=False``, BN running
statistics) with the parameters baked in as a ``torch.export`` artifact
(``torch.export.save``) at ``path``, and the parameters beside it as a
checkpoint of the port at ``path + ".params"``.  ``load_exported`` reads it
back; ``runtime/serve.ExportPredictor`` serves it.  The artifact is a
PyTorch ``ExportedProgram``: it is not interchangeable with the StableHLO
that ``kgcn_tpu`` exports, and neither package reads the other's.

* The port's ``Batch`` and ``GraphBatch`` are pytree nodes with serialized
  names (``_register_pytrees``, the counterpart of JAX's): a ``GraphBatch``'s
  static fields (``n_graph``, ``max_nodes``, the backend's name and payload
  dtype, ``live_weights``) go in the node's context, its tensors are the
  children, and ``None`` children are allowed.
* The program is traced on the device of the parameters it is given (the
  trainer's); ``load_exported`` moves it to another device type when asked.
* The program takes the dense adjacency ``[C, B, N, N]``, not the edge
  lists: ``export_batch`` builds it and leaves the edge lists out of the
  signature, so a request of any edge count fits the traced shapes (the
  ``Predictor`` sizes its edge budget per request); the batch and node
  shapes are fixed by the trace.
* Only the dense backend exports — every shipped graph config resolves to
  it — and its GraphConv layers are the ``kgcn_torch::gconv`` custom op
  (``ops/gconv.py``), one call each in the program, the CUDA kernel on the
  card.  The tiled, stream and ELL backends raise ``NotImplementedError``.
* ``export_savedmodel`` (a TensorFlow SavedModel through ``jax2tf``) needs
  TensorFlow, which the port does not use; ``cli/main.py`` refuses it.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Dict

import torch
import torch.utils._pytree as pytree
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.graph.batch import GraphBatch
from kgcn_tpu_torch.runtime import checkpoint as ckpt

# GraphBatch fields kept in the pytree context (static), the rest children;
# host_receivers (a NumPy array of the host) is dropped
_GRAPH_STATIC = ("n_graph", "max_nodes", "backend", "compute_dtype", "live_weights")
_GRAPH_CHILDREN = tuple(
    f.name for f in dataclasses.fields(GraphBatch)
    if f.name not in _GRAPH_STATIC + ("host_receivers", "tiled_adj", "stream_adj"))
_BATCH_CHILDREN = tuple(f.name for f in dataclasses.fields(Batch))
_REGISTERED = False


def _flatten_graph(g: GraphBatch):
    if g.tiled_adj is not None or g.stream_adj is not None:
        raise ValueError("a GraphBatch with tiled or stream structures is no "
                         "exportable pytree (only the dense backend exports)")
    return ([getattr(g, n) for n in _GRAPH_CHILDREN],
            tuple(getattr(g, n) for n in _GRAPH_STATIC))


def _unflatten_graph(children, context) -> GraphBatch:
    return GraphBatch(**dict(zip(_GRAPH_CHILDREN, children)),
                      **dict(zip(_GRAPH_STATIC, context)))


def _register_pytrees() -> None:
    """Register ``GraphBatch`` and ``Batch`` with torch's pytree (once).
    The children's keys are mapping keys (``['sequences']``): attribute
    keys would name two inputs ``batch.sequences`` and
    ``batch.sequences_len``, and the exported module's input checks
    substitute the first inside the second."""
    global _REGISTERED
    if _REGISTERED:
        return
    pytree.register_pytree_node(
        GraphBatch, _flatten_graph, _unflatten_graph,
        serialized_type_name="kgcn_tpu_torch.GraphBatch",
        to_dumpable_context=lambda ctx: json.dumps(list(ctx)),
        from_dumpable_context=lambda s: tuple(json.loads(s)),
        flatten_with_keys_fn=lambda g: (
            [(pytree.MappingKey(n), v) for n, v in zip(_GRAPH_CHILDREN,
                                                        _flatten_graph(g)[0])],
            _flatten_graph(g)[1]),
    )
    pytree.register_pytree_node(
        Batch,
        lambda b: ([getattr(b, n) for n in _BATCH_CHILDREN], None),
        lambda children, _: Batch(**dict(zip(_BATCH_CHILDREN, children))),
        serialized_type_name="kgcn_tpu_torch.Batch",
        to_dumpable_context=lambda ctx: "null",
        from_dumpable_context=lambda s: None,
        flatten_with_keys_fn=lambda b: (
            [(pytree.MappingKey(n), getattr(b, n)) for n in _BATCH_CHILDREN], None),
    )
    _REGISTERED = True


def export_batch(batch: Batch) -> Batch:
    """The batch as the exported program takes it: the dense adjacency
    built (on the batch's device), the edge lists and everything derived
    from them left out."""
    g = batch.graph
    if g.backend != "dense":
        raise NotImplementedError(
            f"export of the {g.backend!r} backend is not ported: the exported "
            "program runs the dense backend only (ROADMAP.md A.4)")
    g = g.with_dense_adj()
    g = dataclasses.replace(
        g, senders=None, receivers=None, edge_weights=None, n_edge=None,
        edge_valid=None, ell_senders=None, ell_weights=None, ell_pack=None,
        host_receivers=None, segments=None, ell_transposed=None)
    return batch.replace(graph=g)


class _Inference(nn.Module):
    """The inference forward: the prediction of ``train=False``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, batch: Batch) -> torch.Tensor:
        return self.model(batch, train=False).prediction


def export_model(model: nn.Module, params: Dict[str, torch.Tensor],
                 batch_stats: Dict[str, torch.Tensor], sample_batch: Batch,
                 path: str) -> str:
    """Export ``model`` with ``params`` and ``batch_stats`` baked in, traced
    at ``sample_batch``'s shapes on the parameters' device: ``<path>``
    (``torch.export``) and ``<path>.params`` (a checkpoint of the port)."""
    if sample_batch.graph.backend != "dense":
        export_batch(sample_batch)  # raises, naming the backend
    _register_pytrees()
    device = next(iter(params.values())).device
    m = copy.deepcopy(model).to(device).eval()
    m.load_state_dict({k: v.detach() for k, v in {**params, **batch_stats}.items()})
    sample = export_batch(sample_batch.to(device))
    with torch.no_grad():
        ep = torch.export.export(_Inference(m), (sample,), strict=False)
    # the sample batch is no part of the artifact (its dataclasses would not
    # load with weights_only); the signature keeps its shapes and types
    ep.example_inputs = None
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    torch.export.save(ep, path)
    ckpt.save_checkpoint(path + ".params", params, batch_stats)
    print(f"[SAVE] {path} ({os.path.getsize(path)} bytes, torch.export)")
    return path


def load_exported(path: str, device=None) -> torch.export.ExportedProgram:
    """The ``ExportedProgram`` at ``path`` (its gconv op registered first),
    moved to ``device`` when one is given and the program was traced on
    another device type."""
    import kgcn_tpu_torch.ops.gconv  # noqa: F401  (registers kgcn_torch::gconv)

    _register_pytrees()
    ep = torch.export.load(path)
    if device is not None:
        traced = {v.device.type for v in ep.state_dict.values()}
        if traced != {torch.device(device).type}:
            from torch.export.passes import move_to_device_pass

            ep = move_to_device_pass(ep, torch.device(device))
    return ep


def traced_inputs(ep: torch.export.ExportedProgram):
    """The program's ``(args, kwargs)`` with each tensor input a meta tensor
    of its traced shape and type (``None`` inputs as ``None``), and the
    input pytree spec."""
    vals = {n.name: n.meta.get("val") for n in ep.graph.nodes if n.op == "placeholder"}
    leaves = []
    for s in ep.graph_signature.input_specs:
        if s.kind != torch.export.graph_signature.InputKind.USER_INPUT:
            continue
        if isinstance(s.arg, torch.export.graph_signature.TensorArgument):
            v = vals[s.arg.name]
            leaves.append(torch.empty(v.shape, dtype=v.dtype, device="meta"))
        else:
            leaves.append(getattr(s.arg, "value", None))
    spec = ep.call_spec.in_spec
    return pytree.tree_unflatten(leaves, spec), spec
