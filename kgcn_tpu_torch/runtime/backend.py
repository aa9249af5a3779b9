"""``spmm_backend`` resolution — the port's own copy of
``kgcn_tpu/runtime/backend.py:30-55`` and of its resolve step.

The JAX package applies the choice by flipping three process globals (the
dense-path switch, the spmm backend and the tiled compute dtype).  The port
carries it instead: ``resolve`` returns a :class:`Backend` that the
``Batcher`` takes, and every batch it makes carries the backend name and the
payload dtype to the layers.  Nothing here is global, so tests may run in any
order and in one process.

Every backend of the JAX package is ported: ``dense`` (the CUDA gconv
kernel), ``tiled`` (the CUDA tiled SpMM/SDDMM kernels), ``stream`` (the
CUDA stream scatter kernels; its payload dtype is ``tiled_compute_dtype``
too, as in ``kgcn_tpu``), ``pallas`` (the CUDA ELL gather kernel on the
batches' ELL arrays, where the dataset's degree layout admits them, else
the edge-list scatter) and ``xla`` (no kernel: the ELL gather and einsum,
or the edge-list scatter).
"""
from __future__ import annotations

import dataclasses

DENSE_MAX_NODES = 256

_EXPLICIT = ("dense", "xla", "pallas", "tiled", "stream")


@dataclasses.dataclass(frozen=True)
class Backend:
    """A resolved backend: its name and the tiled/stream payload dtype."""

    name: str = "dense"
    compute_dtype: str = "bfloat16"


def choose_backend(config: dict, info) -> str:
    """Resolve the config's ``spmm_backend`` against the dataset ``info``:
    explicit names pass through; ``"auto"`` takes ``dense`` up to 256 padded
    nodes, ``tiled`` for block-diagonal batches beyond that, ``stream`` for
    whole-graph work and ``xla`` otherwise (as ``kgcn_tpu`` decides)."""
    name = str(config.get("spmm_backend", "auto"))
    if name in _EXPLICIT:
        return name
    whole_graph = (
        config.get("task") == "link_prediction"
        or bool(config.get("with_node_embedding"))
    )
    n = int(getattr(info, "graph_node_num", 0) or 0)
    v = int(getattr(info, "all_node_num", 0) or 0)
    if whole_graph:
        return "dense" if 0 < max(n, v) <= DENSE_MAX_NODES else "stream"
    if 0 < n <= DENSE_MAX_NODES:
        return "dense"
    if int(config.get("batch_size", 1) or 1) > 1:
        return "tiled"
    return "stream" if max(n, v) > DENSE_MAX_NODES else "xla"


def resolve(config: dict, info, *, log: bool = True) -> Backend:
    """Choose once and pin the choice into ``config['_spmm_resolved']``, so
    later dataset loads (the validation set) keep the same path."""
    name = config.get("_spmm_resolved")
    if not name:
        name = choose_backend(config, info)
        config["_spmm_resolved"] = name
        if log:
            print(f"[spmm] backend: {name}")
    return Backend(name, str(config.get("tiled_compute_dtype", "bfloat16")))
