"""Pytree nodes with serialized names, and a structure as custom-op arguments.

``register`` makes a dataclass a node of torch's pytree that
``torch.export`` can save and load (``runtime/export.py`` registers the
batch types with it; ``ops/tiled_spmm.py`` and ``ops/stream_spmm.py``
their structures).  The sparse products' custom ops take a structure as
the same flattening: ``op_args`` gives its tensors and its spec as a
string (an op schema takes no dataclass), ``from_op_args`` rebuilds it.
"""
from __future__ import annotations

import functools
import json

import torch.utils._pytree as pytree


def register(cls, name, children, context, rebuild) -> None:
    """Register ``cls`` with torch's pytree (once): ``children(obj)`` →
    (names, values); ``context(obj)`` → a JSON-able tuple or None;
    ``rebuild(values, context)`` → the object.  The children's keys are
    mapping keys (``['sequences']``): attribute keys would name two inputs
    ``batch.sequences`` and ``batch.sequences_len``, and the exported
    module's input checks substitute the first inside the second."""
    if cls in pytree.SUPPORTED_NODES:
        return

    def flatten(obj):
        return list(children(obj)[1]), context(obj)

    pytree.register_pytree_node(
        cls, flatten, rebuild,
        serialized_type_name=name,
        to_dumpable_context=lambda ctx: json.dumps(None if ctx is None else list(ctx)),
        from_dumpable_context=lambda s: (None if json.loads(s) is None
                                         else tuple(json.loads(s))),
        flatten_with_keys_fn=lambda obj: (
            [(pytree.MappingKey(n), v) for n, v in zip(*children(obj))], context(obj)),
    )


def op_args(obj):
    """(tensors, spec) of a registered structure: its pytree leaves and
    its tree spec serialized."""
    leaves, spec = pytree.tree_flatten(obj)
    return leaves, pytree.treespec_dumps(spec)


@functools.lru_cache(maxsize=64)
def _spec(s: str):
    return pytree.treespec_loads(s)


def from_op_args(tensors, spec: str):
    """The structure that ``op_args`` gave."""
    return pytree.tree_unflatten(list(tensors), _spec(spec))
