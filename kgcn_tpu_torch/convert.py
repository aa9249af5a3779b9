"""Carry parameters of the JAX package over to the port.

``params_from_jax(params, batch_stats)`` takes the flax ``params`` and
``batch_stats`` trees of a ``kgcn_tpu`` model (nested dicts of numpy arrays,
e.g. ``jax.device_get(state.params)``) and returns the port's checkpoint tree
``{"params": {name: tensor}, "batch_stats": {name: tensor}}``, whose union
loads into the matching port model with ``load_state_dict``.

The port's modules carry flax's scope and parameter names, so the mapping is
a rule, not a table: scopes join with ``.``, and the ``kernel`` of a flax
``Dense`` (scope ``Dense_<n>``, stored ``[in, out]``) becomes the
``nn.Linear`` ``weight``, transposed to ``[out, in]``.  Every other leaf
keeps its name and layout: GraphConv's ``kernel`` ``[C, Fin, Fout]``,
DistMult's relation table ``kernel`` ``[C, dim]``, the ``embedding`` table,
GIN's ``epsilon``, biases, BN ``scale``/``mean``/``var``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


_DENSE_SCOPE = re.compile(r"Dense_\d+")  # flax's name for an nn.Dense


def _convert_leaf(name: str, arr: np.ndarray):
    scope, dot, leaf = name.rpartition(".")
    if leaf == "kernel" and _DENSE_SCOPE.fullmatch(scope.rpartition(".")[2]):
        return f"{scope}{dot}weight", np.ascontiguousarray(arr.T)
    return name, arr


def params_from_jax(params: Mapping[str, Any],
                    batch_stats: Mapping[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """flax trees → ``{"params": ..., "batch_stats": ...}`` of the port."""

    def convert(tree):
        out = {}
        for name, arr in _flatten(tree).items():
            new, arr = _convert_leaf(name, arr)
            out[new] = torch.tensor(arr, dtype=torch.float32)
        return out

    return {"params": convert(params), "batch_stats": convert(batch_stats)}
