"""Statically-shaped batched graph container (torch tensors).

The counterpart of ``kgcn_tpu/graph/batch.py``: a batch of ``n_graph``
graphs, each padded to ``max_nodes`` nodes, with the same fields and padding
rules —

* node features are a flat ``[V, F]`` tensor, ``V = n_graph * max_nodes``;
  node ``v`` belongs to graph ``v // max_nodes``;
* edges are per-channel COO lists ``[C, E]`` of global node indices with
  the valid edges packed first and counted in ``n_edge``; padding edges
  point at node 0 with weight 0;
* ``dense_adj`` optionally caches the ``[C, B, N, N]`` dense adjacency that
  the fused graph convolution (``ops/gconv.py``) consumes;
* ``tiled_adj`` optionally carries the per-channel ``TiledCOO`` structures
  of the tiled sparse kernels (``ops/tiled_spmm.py``), built on the host by
  ``with_tiled``;
* ``stream_adj`` optionally carries the per-channel ``StreamCOO``
  structures of the stream kernels (``ops/stream_spmm.py``), adjacency
  weights baked in, built on the host by ``with_stream``;
* ``ell_senders`` / ``ell_weights`` optionally carry the per-channel ELL
  arrays (padded per-row neighbour lists, ``ops/ell.py``) that the ``xla``
  and ``pallas`` backends aggregate over, built by the ``Batcher``;
* ``node_ids`` replaces ``nodes`` in node-embedding mode (KG workloads):
  ``[V]`` vocabulary ids into an embedding table;
* ``host_receivers`` keeps the receivers' host array on a batch moved to
  the card, so that the segment sums' sort (``receiver_segments``) runs on
  the host without reading the card.

Where the JAX package reads process globals (the dense-path switch, the
spmm backend, the tiled/stream compute dtype), a batch here carries
``backend`` and ``compute_dtype``, set by the ``Batcher`` from the resolved
backend (``runtime/backend.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from kgcn_tpu_torch.ops import segment as segment_ops
from kgcn_tpu_torch.ops import stream_spmm as stream_ops
from kgcn_tpu_torch.ops import tiled_spmm as tiled_ops

LANE = 128  # edge budgets are rounded up to a multiple (as in kgcn_tpu)


def pad_edge_budget(n: int, multiple: int = LANE) -> int:
    """Round an edge count up to a multiple (min one multiple)."""
    n = max(int(n), 1)
    return ((n + multiple - 1) // multiple) * multiple


@dataclasses.dataclass
class GraphBatch:
    """Fields as in ``kgcn_tpu.graph.batch.GraphBatch``:

    senders, receivers: ``[C, E]`` int32 global node index per edge.
    edge_weights: ``[C, E]`` float32; 0 marks padding edges.
    n_edge: ``[C]`` int32 count of valid (packed-first) edges.
    n_node: ``[B]`` int32 true node count per graph.
    node_mask: ``[V]`` float32, 1 for real nodes and 0 for padding.
    nodes: ``[V, F]`` float32 features, or None in node-embedding mode.
    node_ids: ``[V]`` int32 vocabulary ids (node-embedding mode), or None.
    dense_adj: cached ``[C, B, N, N]`` adjacency, or None.
    edge_valid: optional explicit ``[C, E]`` edge-validity mask.
    tiled_adj: tuple of per-channel ``TiledCOO``, or None.
    stream_adj: tuple of per-channel ``StreamCOO``, or None.
    ell_senders: ``[C, V, K]`` int32 sender of each ELL slot (padding slots
        0), or None.
    ell_weights: ``[C, V, K]`` float32 weight of each ELL slot (padding
        slots 0), or None.
    n_graph, max_nodes: Python ints.
    backend: the resolved spmm backend (``"dense"``, ``"xla"``,
        ``"pallas"``, ``"tiled"`` or ``"stream"``).
    compute_dtype: the tiled and stream kernels' payload dtype.
    host_receivers: ``[C, E]`` NumPy receivers of a batch that moved from
        the host (``to``), or None.
    """

    senders: torch.Tensor
    receivers: torch.Tensor
    edge_weights: torch.Tensor
    n_edge: torch.Tensor
    n_node: torch.Tensor
    node_mask: torch.Tensor
    nodes: Optional[torch.Tensor] = None
    node_ids: Optional[torch.Tensor] = None
    dense_adj: Optional[torch.Tensor] = None
    edge_valid: Optional[torch.Tensor] = None
    tiled_adj: Optional[tuple] = None
    stream_adj: Optional[tuple] = None
    ell_senders: Optional[torch.Tensor] = None
    ell_weights: Optional[torch.Tensor] = None
    n_graph: int = 1
    max_nodes: int = 1
    backend: str = "dense"
    compute_dtype: str = "bfloat16"
    host_receivers: Optional[np.ndarray] = None

    @property
    def total_nodes(self) -> int:
        return self.n_graph * self.max_nodes

    def replace(self, **changes) -> "GraphBatch":
        if "receivers" in changes and "host_receivers" not in changes:
            changes["host_receivers"] = None  # no longer these receivers
        return dataclasses.replace(self, **changes)

    def receiver_segments(self, c: Optional[int] = None):
        """``(ids, order, offsets)`` of channel ``c``'s receivers, or with
        ``c`` None of all channels' receivers as one list (the ``xla``
        scatter's), for the segment sums (``ops/segment``): the ids as
        int64, their stable sorting permutation and each node's first
        position in it.  Sorted on the host in NumPy from the receivers'
        host array, all channels at once, and sent to the batch's device in
        one copy (as the batch's own arrays are), once per batch object:
        GAT's layers and channels share it, and nothing is sorted or read
        back on the card."""
        cache = self.__dict__.setdefault("_receiver_segments", {})
        if c not in cache:
            r = self.host_receivers
            if r is None:
                if self.receivers.is_cuda:
                    raise ValueError("receiver_segments: a batch on the card needs "
                                     "its host receivers (GraphBatch.to keeps them)")
                r = self.receivers.numpy()
            V = self.total_nodes
            lists = [r.reshape(-1)] if c is None else list(r)
            k, n = len(lists), lists[0].size
            flat = np.empty(k * (2 * n + V + 1), np.int64)  # ids, orders, offsets
            parts = (flat[:k * n].reshape(k, n), flat[k * n:2 * k * n].reshape(k, n),
                     flat[2 * k * n:].reshape(k, V + 1))
            for j, ids in enumerate(lists):
                for part, a in zip(parts, segment_ops.host_segments(ids, V)):
                    part[j] = a
            moved = [v.view(p.shape) for v, p in zip(
                torch.from_numpy(flat).to(self.receivers.device).split(
                    [k * n, k * n, k * (V + 1)]), parts)]
            if c is None:
                cache[None] = tuple(a[0] for a in moved)
            else:
                cache.update({j: tuple(a[j] for a in moved) for j in range(k)})
        return cache[c]

    def mask_batched(self) -> torch.Tensor:
        """``[B, N]`` view of the node mask."""
        return self.node_mask.reshape(self.n_graph, self.max_nodes)

    def edge_mask(self) -> torch.Tensor:
        """``[C, E]`` 1.0 for valid edges (packed first, unless an explicit
        ``edge_valid`` mask is carried)."""
        if self.edge_valid is not None:
            return self.edge_valid
        iota = torch.arange(self.senders.shape[1], device=self.senders.device)
        return (iota[None, :] < self.n_edge[:, None]).to(torch.float32)

    def dense_adjacency(self, dtype=None) -> torch.Tensor:
        """Materialise the ``[C, B, N, N]`` dense adjacency from the COO
        lists: receiver row, sender column, ``out[r, s] += w``.  Padding
        edges carry weight 0, so they add nothing."""
        C, E = self.senders.shape
        B, N = self.n_graph, self.max_nodes
        dtype = dtype or self.edge_weights.dtype
        r = self.receivers.long()
        s = self.senders.long()
        flat = (r // N) * (N * N) + (r % N) * N + (s % N)
        chan = torch.arange(C, device=flat.device)[:, None].expand(C, E)
        out = torch.zeros((C, B * N * N), dtype=dtype, device=flat.device)
        out.index_put_((chan, flat), self.edge_weights.to(dtype), accumulate=True)
        return out.reshape(C, B, N, N)

    def with_dense_adj(self) -> "GraphBatch":
        """A copy carrying the dense adjacency (no-op if already cached, and
        unchanged when the batch's backend is not ``dense``: the layers then
        take their edge-list paths); models call it once at the top of
        their forward."""
        if self.backend != "dense" or self.dense_adj is not None:
            return self
        return self.replace(dense_adj=self.dense_adjacency())

    def with_tiled(self, *, tiling: Optional[tuple] = None,
                   chunk_budget: Optional[int] = None, feature_dim: int = 128,
                   locality="auto") -> "GraphBatch":
        """A copy carrying per-channel tiled edge structures
        (``kgcn_tpu``'s ``with_tiled``, ``graph/batch.py:191-257``).

        Host side, NumPy.  ``tiling``: explicit (ts, tr, chunk), else chosen
        per channel by ``choose_tiling`` for this batch's payload dtype.
        ``chunk_budget``: pad the chunk lists to a fixed length.
        ``locality``: "auto" relabels only single whole-graph batches on a
        modelled win; a tuple pins per-channel decisions; a bool forces."""
        if self.tiled_adj is not None:
            return self
        s = self.senders.cpu().numpy()
        r = self.receivers.cpu().numpy()
        w = self.edge_weights.cpu().numpy()
        ev = self.edge_valid.cpu().numpy() if self.edge_valid is not None else None
        bytes_per_elt = 2 if tiled_ops.is_bf16(self.compute_dtype) else 4
        tes = []
        for c in range(s.shape[0]):
            tl = tiling
            if locality == "auto":
                loc = False
                if self.n_graph == 1 and tiling is None:
                    tl, loc = tiled_ops.choose_tiling_with_locality(
                        s[c], r[c], self.total_nodes, feature_dim, weights=w[c],
                        bytes_per_elt=bytes_per_elt)
            elif isinstance(locality, (tuple, list)):
                loc = bool(locality[c])
            else:
                loc = bool(locality)
            if tl is None:
                tl = tiled_ops.choose_tiling(s[c], r[c], self.total_nodes,
                                             feature_dim, weights=w[c],
                                             bytes_per_elt=bytes_per_elt)
            ts, tr, chunk = tl
            tes.append(tiled_ops.build_tiled(
                s[c], r[c], self.total_nodes, weights=w[c], ts=ts, tr=tr,
                chunk=chunk, chunk_budget=chunk_budget, locality=loc,
                # drop by the padding mask when there is one, not by weight:
                # a real edge of weight 0 stays for dynamic (attention) weights
                valid_mask=ev[c] if ev is not None else None,
            ))
        return self.replace(tiled_adj=tuple(tes))

    def with_stream(self, *, macro_budget: Optional[int] = None,
                    params: Optional[dict] = None) -> "GraphBatch":
        """A copy carrying per-channel stream structures
        (``kgcn_tpu``'s ``with_stream``, ``graph/batch.py:259-288``).

        Host side, NumPy.  The adjacency weights are baked in (and into
        bf16 one-hots where they fit), so the layers call the kernels
        weight-free.  ``macro_budget``: pad the macro lists to a fixed
        length; ``params``: ``build_stream`` keyword arguments (tr_w, chunk,
        mc, wb, materialize)."""
        if self.stream_adj is not None:
            return self
        s = self.senders.cpu().numpy()
        r = self.receivers.cpu().numpy()
        w = self.edge_weights.cpu().numpy()
        ev = self.edge_valid.cpu().numpy() if self.edge_valid is not None else None
        kw = dict(params or {})
        sss = tuple(
            stream_ops.build_stream(s[c], r[c], self.total_nodes, weights=w[c],
                                    macro_budget=macro_budget,
                                    valid_mask=ev[c] if ev is not None else None, **kw)
            for c in range(s.shape[0])
        )
        return self.replace(stream_adj=sss)

    def to(self, device) -> "GraphBatch":
        """A copy on ``device`` (this batch where it is there already, with
        its sorted segments); a move from the host keeps the receivers'
        host array (``host_receivers``)."""
        device = torch.device(device)
        here = self.receivers.device
        if here.type == device.type and device.index in (None, here.index):
            return self
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)
        }
        for name in ("tiled_adj", "stream_adj"):
            structs = getattr(self, name)
            if structs is not None:
                moved[name] = tuple(t.to(device) for t in structs)
        moved["host_receivers"] = (self.receivers.numpy() if here.type == "cpu"
                                   else self.host_receivers)
        return self.replace(**moved)


def _coo_normalize(mat) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Accept scipy sparse / (indices, values, shape) tuple / dense ndarray and
    return (row, col, values) numpy arrays."""
    if hasattr(mat, "tocoo"):  # scipy sparse
        coo = mat.tocoo()
        return (
            coo.row.astype(np.int32),
            coo.col.astype(np.int32),
            coo.data.astype(np.float32),
        )
    if isinstance(mat, tuple) and len(mat) == 3:  # kGCN jbl COO tuple
        indices, values, _shape = mat
        indices = np.asarray(indices)
        return (
            indices[:, 0].astype(np.int32),
            indices[:, 1].astype(np.int32),
            np.asarray(values, dtype=np.float32),
        )
    dense = np.asarray(mat)
    row, col = np.nonzero(dense)
    return (
        row.astype(np.int32),
        col.astype(np.int32),
        dense[row, col].astype(np.float32),
    )


def batch_graphs(
    adjs: Sequence[Sequence],
    features: Optional[np.ndarray],
    max_nodes: int,
    *,
    node_ids: Optional[Sequence[Sequence[int]]] = None,
    n_nodes: Optional[Sequence[int]] = None,
    edge_budget: Optional[int] = None,
    n_graph: Optional[int] = None,
) -> GraphBatch:
    """Assemble a ``GraphBatch`` (CPU tensors) from per-graph adjacency
    channels; arguments as ``kgcn_tpu.graph.batch.batch_graphs``.

    adjs: ``adjs[g][c]`` is graph g's channel-c adjacency (scipy sparse, COO
        tuple, or dense ndarray).
    features: ``[G, N, F]`` padded node features or None.
    node_ids: per-graph node vocabulary ids (node-embedding mode).
    n_nodes: true node counts; inferred from feature non-zero rows if omitted.
    edge_budget: static per-channel edge capacity; lane-rounded from this
        batch if omitted.
    n_graph: pad the batch itself to this many graphs (last partial batch).
    """
    G = len(adjs)
    B = n_graph or G
    if B < G:
        raise ValueError(f"n_graph {B} < {G} graphs")
    C = len(adjs[0]) if G else 1
    N = int(max_nodes)

    coo = [[_coo_normalize(adjs[g][c]) for g in range(G)] for c in range(C)]
    need = max((sum(len(r) for (r, _, _) in coo[c]) for c in range(C)), default=1)
    E = edge_budget or pad_edge_budget(need)
    if need > E:
        raise ValueError(f"edge budget {E} < required {need}")

    senders = np.zeros((C, E), dtype=np.int32)
    receivers = np.zeros((C, E), dtype=np.int32)
    weights = np.zeros((C, E), dtype=np.float32)
    n_edge = np.zeros((C,), dtype=np.int32)
    for c in range(C):
        off = 0
        for g in range(G):
            row, col, val = coo[c][g]
            k = len(row)
            if k and (row.max() >= N or col.max() >= N):
                # offsetting out-of-range indices would bleed this graph's
                # edges into graph g+1's block
                raise ValueError(
                    f"graph {g} channel {c} has node index "
                    f"{int(max(row.max(), col.max()))} >= max_nodes {N}"
                )
            receivers[c, off : off + k] = row + g * N
            senders[c, off : off + k] = col + g * N
            weights[c, off : off + k] = val
            off += k
        n_edge[c] = off

    if n_nodes is not None:
        nn = np.asarray(n_nodes, dtype=np.int32)
    elif features is not None:
        nn = (np.abs(features).sum(axis=-1) > 0).sum(axis=-1).astype(np.int32)
        nn = np.maximum(nn, 1)
    else:
        nn = np.full((G,), N, dtype=np.int32)
    nn_pad = np.zeros((B,), dtype=np.int32)
    nn_pad[:G] = nn[:G]

    mask = (np.arange(N)[None, :] < nn_pad[:, None]).astype(np.float32).reshape(-1)

    nodes = None
    if features is not None:
        F = features.shape[-1]
        nodes_np = np.zeros((B, N, F), dtype=np.float32)
        nodes_np[:G, : features.shape[1]] = features[:, :N]
        nodes = torch.from_numpy(nodes_np.reshape(B * N, F))
    ids = None
    if node_ids is not None:
        ids_np = np.zeros((B, N), dtype=np.int32)
        for g, row in enumerate(node_ids):
            row = np.asarray(row, dtype=np.int32)
            ids_np[g, : len(row)] = row
        ids = torch.from_numpy(ids_np.reshape(-1))

    return GraphBatch(
        senders=torch.from_numpy(senders),
        receivers=torch.from_numpy(receivers),
        edge_weights=torch.from_numpy(weights),
        n_edge=torch.from_numpy(n_edge),
        n_node=torch.from_numpy(nn_pad),
        node_mask=torch.from_numpy(mask),
        nodes=nodes,
        node_ids=ids,
        n_graph=B,
        max_nodes=N,
    )
