"""Model export — the counterpart of ``kgcn_tpu/runtime/export.py``.

``export_model`` writes the inference forward (``train=False``, BN running
statistics) with the parameters baked in as a ``torch.export`` artifact
(``torch.export.save``) at ``path``, and the parameters beside it as a
checkpoint of the port at ``path + ".params"``.  ``load_exported`` reads it
back; ``runtime/serve.ExportPredictor`` serves it.  The artifact is a
PyTorch ``ExportedProgram``: it is not interchangeable with the StableHLO
that ``kgcn_tpu`` exports, and neither package reads the other's.

* The port's ``Batch``, ``GraphBatch`` and the sparse backends' structures
  (``TiledCOO`` with its ``TiledPlan``, ``StreamCOO`` with its
  ``StreamPlan``, each with its transpose) are pytree nodes with
  serialized names (``_register_pytrees``, the counterpart of JAX's): the
  static fields (a ``GraphBatch``'s ``n_graph``, ``max_nodes``, backend
  name, payload dtype and ``live_weights``; a structure's shape numbers; a
  stream plan's piece size) go in the node's context, the tensors are the
  children, and ``None`` children are allowed.
* The program is traced on the device of the parameters it is given (the
  trainer's); ``load_exported`` moves it to another device type when asked.
* Whichever backend the model trained on is exported, as in ``kgcn_tpu``
  (``export_batch`` keeps what that backend's forward reads):
  - ``dense``: the dense adjacency ``[C, B, N, N]``, not the edge lists, so
    a request of any edge count fits; GraphConv is the ``kgcn_torch::gconv``
    custom op (``ops/gconv.py``);
  - ``tiled`` and ``stream``: the edge lists at the trained edge budget and
    the per-channel structures, padded to the trained chunk or macro
    budget; the products are the custom ops ``kgcn_torch::tiled_spmm``
    and ``kgcn_torch::stream_scatter`` / ``stream_scatter_mat``;
  - ``pallas`` and ``xla``: the ELL arrays ``[C, V, K]`` where the dataset
    has them (``kgcn_torch::ell_spmm`` on ``pallas``; their transpose,
    which only the backward reads, is left out), and the receivers' sorted
    segments for the edge-list route (GAT's softmax, the ``xla`` scatter).
  The batch and node shapes, and the edge, chunk and macro budgets, are
  the traced ones.  A plan's lengths (``TiledPlan``, ``StreamPlan``:
  entries, pieces, split and empty rows) depend on each request's edges,
  so they are traced as dynamic dimensions (``torch.export.Dim.AUTO``),
  not padded to a budget: padding a plan would add pieces and rows that
  the kernels walk and write, where a dynamic length is only a different
  shape of the same arrays.  The ops take a plan's counts from its arrays'
  shapes and size the partial-row scratch by the bound of two partial
  rows a piece.  A dimension that is 0 or 1 in the traced batch (a plan
  without split rows) is kept at that value by the trace; a request that
  needs another raises ``ValueError`` at the program's input check, as a
  request beyond the traced sizes does.
* ``export_savedmodel`` (a TensorFlow SavedModel through ``jax2tf``) needs
  TensorFlow, which the port does not use; ``cli/main.py`` refuses it.
"""
from __future__ import annotations

import copy
import dataclasses
import os
from typing import Dict

import torch
import torch.utils._pytree as pytree
from torch import nn

from kgcn_tpu_torch.data.batcher import Batch
from kgcn_tpu_torch.graph.batch import GraphBatch
from kgcn_tpu_torch.ops import pytrees
from kgcn_tpu_torch.ops import stream_spmm as stream_ops
from kgcn_tpu_torch.ops import tiled_spmm as tiled_ops
from kgcn_tpu_torch.runtime import checkpoint as ckpt

# GraphBatch fields kept in the pytree context (static), the rest children;
# host_receivers (a NumPy array of the host) is dropped
_GRAPH_STATIC = ("n_graph", "max_nodes", "backend", "compute_dtype", "live_weights")
_GRAPH_CHILDREN = tuple(
    f.name for f in dataclasses.fields(GraphBatch)
    if f.name not in _GRAPH_STATIC + ("host_receivers",))
_BATCH_CHILDREN = tuple(f.name for f in dataclasses.fields(Batch))


def _flatten_graph(g: GraphBatch):
    return ([getattr(g, n) for n in _GRAPH_CHILDREN],
            tuple(getattr(g, n) for n in _GRAPH_STATIC))


def _unflatten_graph(children, context) -> GraphBatch:
    return GraphBatch(**dict(zip(_GRAPH_CHILDREN, children)),
                      **dict(zip(_GRAPH_STATIC, context)))


def _register_pytrees() -> None:
    """Register ``GraphBatch``, ``Batch`` and the sparse structures with
    torch's pytree (once)."""
    pytrees.register(GraphBatch, "kgcn_tpu_torch.GraphBatch",
                     lambda g: (_GRAPH_CHILDREN, _flatten_graph(g)[0]),
                     lambda g: _flatten_graph(g)[1], _unflatten_graph)
    pytrees.register(Batch, "kgcn_tpu_torch.Batch",
                     lambda b: (_BATCH_CHILDREN, [getattr(b, n) for n in _BATCH_CHILDREN]),
                     lambda b: None,
                     lambda values, _: Batch(**dict(zip(_BATCH_CHILDREN, values))))
    tiled_ops.register_pytrees()
    stream_ops.register_pytrees()


def _segments(g: GraphBatch):
    """The receivers' sorted segments in ``GraphBatch.segments``' layout:
    ``((order [C, E], offsets [C, V + 1]), (order [C*E], offsets [V + 1]))``,
    sorted on the host (``receiver_segments``)."""
    per = [g.receiver_segments(c) for c in range(g.senders.shape[0])]
    _, order_all, offsets_all = g.receiver_segments()
    return ((torch.stack([p[1] for p in per]), torch.stack([p[2] for p in per])),
            (order_all, offsets_all))


def export_batch(batch: Batch) -> Batch:
    """The batch as the exported program takes it, on the batch's device:
    on ``dense`` the dense adjacency built and the edge lists left out; on
    the other backends the edge lists, the receivers' sorted segments, the
    backend's structures (the tiled plans built where the batch has none:
    the program's signature is the same on every device) and ELL arrays
    without their transpose."""
    g = batch.graph
    if g.backend == "dense":
        g = g.with_dense_adj()
        g = dataclasses.replace(
            g, senders=None, receivers=None, edge_weights=None, n_edge=None,
            edge_valid=None, ell_senders=None, ell_weights=None, ell_pack=None,
            host_receivers=None, segments=None, ell_transposed=None)
        return batch.replace(graph=g)
    tiled = g.tiled_adj
    if tiled is not None:
        tiled = tuple(t if t.plan is not None else tiled_ops.with_plan(t) for t in tiled)
    g = dataclasses.replace(
        g, dense_adj=None, tiled_adj=tiled, segments=_segments(g), ell_pack=None,
        ell_transposed=None, host_receivers=None)
    return batch.replace(graph=g)


def _plan_dims(sample: Batch):
    """``dynamic_shapes`` for ``torch.export`` of ``sample``: a plan's
    arrays take ``Dim.AUTO`` on their length (``entries``' second
    dimension, the others' first), every other input its traced shape.
    Custom pytree nodes are lists of their children's specs."""
    auto = torch.export.Dim.AUTO
    leaves, spec = pytree.tree_flatten_with_path(sample)
    dims = []
    for path, leaf in leaves:
        keys = [getattr(k, "key", None) for k in path]
        if isinstance(leaf, torch.Tensor) and "plan" in keys:
            dims.append({1: auto} if keys[-1] == "entries" else {0: auto})
        else:
            dims.append(None)
    it = iter(dims)

    def build(s):
        if s.is_leaf():
            return next(it)
        kids = [build(c) for c in (s.children() if callable(getattr(s, "children", None))
                                   else s.children_specs)]
        if s.type is tuple:
            return tuple(kids)
        if s.type is dict:
            return dict(zip(s.context, kids))
        if s.type is type(None):
            return None
        return kids

    return build(pytree.tree_structure(sample))


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
    _register_pytrees()
    device = next(iter(params.values())).device
    m = copy.deepcopy(model).to(device).eval()
    m.load_state_dict({k: v.detach() for k, v in {**params, **batch_stats}.items()})
    sample = export_batch(sample_batch.to(device))
    # a plan length of 0 or 1 in the sample (no split rows, no empty rows)
    # stays dynamic: sizes are not specialised on those values
    from torch.fx.experimental import _config as fx_config

    with torch.no_grad(), fx_config.patch(backed_size_oblivious=True):
        ep = torch.export.export(_Inference(m), (sample,), strict=False,
                                 dynamic_shapes=(_plan_dims(sample),))
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
    """The ``ExportedProgram`` at ``path`` (the port's custom ops registered
    first), moved to ``device`` when one is given and the program was
    traced on another device type."""
    # the modules that register kgcn_torch::gconv, ::tiled_spmm,
    # ::stream_scatter, ::stream_scatter_mat and ::ell_spmm
    import kgcn_tpu_torch.ops.ell_spmm  # noqa: F401
    import kgcn_tpu_torch.ops.gconv  # noqa: F401

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
    of its traced shape and type (``None`` inputs as ``None``; a dynamic
    dimension, a plan's length, as 0), the input pytree spec, and each
    leaf's traced shape with ``None`` for a dynamic dimension (``None`` for
    a leaf that is no tensor)."""
    vals = {n.name: n.meta.get("val") for n in ep.graph.nodes if n.op == "placeholder"}
    leaves, shapes = [], []
    for s in ep.graph_signature.input_specs:
        if s.kind != torch.export.graph_signature.InputKind.USER_INPUT:
            continue
        if isinstance(s.arg, torch.export.graph_signature.TensorArgument):
            v = vals[s.arg.name]
            shape = tuple(d if isinstance(d, int) else None for d in v.shape)
            leaves.append(torch.empty([0 if d is None else d for d in shape],
                                      dtype=v.dtype, device="meta"))
            shapes.append(shape)
        else:
            leaves.append(getattr(s.arg, "value", None))
            shapes.append(None)
    spec = ep.call_spec.in_spec
    return pytree.tree_unflatten(leaves, spec), spec, shapes
