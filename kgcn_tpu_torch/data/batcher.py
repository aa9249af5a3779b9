"""Mini-batch assembly: Dataset → fixed-shape batches of torch tensors.

The counterpart of ``kgcn_tpu/data/batcher.py``: every batch of a dataset
has the same shapes (node padding ``B*N``, lane-rounded edge budget), and
the last partial batch is padded with empty graphs and reported through
``pad_mask`` (the reference's ``mask`` vector, kgcn/feed.py:148-151).
Batches are built on the CPU; ``Batch.to(device)`` moves them.  The edge
lists and node features of a batch are packed by one call each of the host
library ``ops/csrc/batch_host.cc`` (the port's copy of
``kgcn_tpu/native/batcher.cpp``), over COO blocks laid out once per
dataset; ``graph/batch.batch_graphs`` gives the same arrays in NumPy.  The
library is built at first use and required: there is no NumPy fallback.

The batcher carries the resolved backend (``runtime/backend.Backend``) and
stamps it on every batch; with ``tiled`` it attaches the tiled edge
structures (``_attach_tiled``, as ``kgcn_tpu/data/batcher.py:354-393``),
with ``stream`` the stream structures (``_attach_stream``, as
``kgcn_tpu/data/batcher.py:395-418``), and with ``xla`` or ``pallas`` the
ELL arrays (``_prepare_ell`` / ``_ell_arrays``, as
``kgcn_tpu/data/batcher.py:217-257``: per-graph padded neighbour lists
built once per dataset under the ``ell_layout_ok`` gate, offset per batch;
beside them, each graph's transpose, which the GPU's dx kernel walks; a
batch's ELL arrays and transpose are laid into one int32 buffer,
``GraphBatch.ell_pack``, which moves to the card in one copy).
The JAX package attaches the ELL arrays on every backend, but its layers
read them only on these two, so no value differs.  ``host_seconds``
accumulates the host time spent assembling batches, and ``tiled_seconds``
/ ``stream_seconds`` / ``ell_seconds`` the part of it spent building tiled
/ stream structures / ELL arrays.  With ``epsilon_dim`` each batch carries
the graph VAE's reparameterisation noise ``rng_normal`` ``[B, N,
epsilon_dim]``, drawn from the batcher's ``RandomState`` after the epoch's
shuffle, one array a batch, as ``kgcn_tpu/data/batcher.py:442-446`` draws
it (one seed gives the same noise bit for bit).  Datasets that fit the
device take ``runtime/resident.ResidentBatcher`` instead, which gathers
batches there.
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from kgcn_tpu_torch.data.dataset import Dataset, DatasetInfo
from kgcn_tpu_torch.graph.batch import GraphBatch, pad_edge_budget
from kgcn_tpu_torch.ops import _build
from kgcn_tpu_torch.ops.ell import per_graph_ell
from kgcn_tpu_torch.runtime.backend import Backend


def _ell_host():
    """The ELL batch packer ``kgcn_ell_pack`` (``ops/csrc/ell_host.cc``)."""
    lib = _build.load("ell_host")
    if lib.kgcn_ell_pack.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.kgcn_ell_pack.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.kgcn_ell_pack.restype = ctypes.c_longlong
    return lib


def _batch_host():
    """The edge and feature packer (``ops/csrc/batch_host.cc``)."""
    lib = _build.load("batch_host")
    if lib.kgcn_pack_edges.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
        lib.kgcn_pack_edges.argtypes = [ptr] * 5 + [i64] * 4 + [ptr] * 4
        lib.kgcn_pack_edges.restype = ctypes.c_int
        lib.kgcn_gather_pad_features.argtypes = [ptr, ptr] + [i64] * 4 + [ptr]
        lib.kgcn_gather_pad_features.restype = None
    return lib


def as_tensor(x: np.ndarray) -> torch.Tensor:
    """numpy → torch with JAX's default 32-bit types (float64 → float32,
    int64 → int32), so both packages see the same dtypes."""
    x = np.asarray(x)
    if x.dtype == np.float64:
        x = x.astype(np.float32)
    elif x.dtype == np.int64:
        x = x.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x))


def aligned_max_nodes(ds: Dataset, info: DatasetInfo) -> int:
    """The node padding of a dataset's batches: its node count, beyond one
    128-row tile rounded up to a multiple of 128, as kgcn_tpu does (its
    batches and ours keep one shape)."""
    n = int(ds.max_node_num or info.graph_node_num)
    return ((n + 127) // 128) * 128 if n > 128 else n


def pad_node_axis(x, n: int):
    """Pad a [G, N_ds, ...] per-node array's node axis up to ``n`` (the
    dataset's node count diverges from the batch padding once it is
    rounded above 128)."""
    x = np.asarray(x)
    pad = n - x.shape[1]
    if pad <= 0:
        return x
    widths = [(0, 0)] * x.ndim
    widths[1] = (0, pad)
    return np.pad(x, widths)


@dataclasses.dataclass
class Batch:
    """One batch: the graph plus aligned task tensors."""

    graph: GraphBatch
    labels: Optional[torch.Tensor] = None
    mask_label: Optional[torch.Tensor] = None
    node_label: Optional[torch.Tensor] = None
    mask_node_label: Optional[torch.Tensor] = None
    sequences: Optional[torch.Tensor] = None  # [B, L] int32 token ids
    sequences_len: Optional[torch.Tensor] = None  # [B] int32
    vector_modal: Optional[tuple] = None  # one [B, D_m] float32 per modal
    pad_mask: Optional[torch.Tensor] = None  # [B] 1.0 = real example
    label_list: Optional[torch.Tensor] = None  # [B, L, 6] KG preference triples
    label_valid: Optional[torch.Tensor] = None  # [B, L] 1.0 = real pair (0 = wrap pad)
    rng_normal: Optional[torch.Tensor] = None  # [B, N, latent] the VAE's ε

    def to(self, device) -> "Batch":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None and f.name != "vector_modal"
        }
        if self.vector_modal is not None:
            moved["vector_modal"] = tuple(v.to(device) for v in self.vector_modal)
        return dataclasses.replace(self, **moved)

    def replace(self, **changes) -> "Batch":
        return dataclasses.replace(self, **changes)

    def cast_compute(self, dtype) -> "Batch":
        """The compute-path floats (the graph's payload, ``GraphBatch.
        astype``; the vector modals; the VAE's ε) cast to ``dtype`` for
        mixed precision, as ``kgcn_tpu``'s ``Batch.cast_compute``
        (``data/batcher.py:46-60``).  Labels, masks and ids stay as they
        are: losses and metrics run in float32."""
        vm = self.vector_modal
        if vm is not None:
            vm = tuple(v.to(dtype) for v in vm)
        return dataclasses.replace(
            self, graph=self.graph.astype(dtype), vector_modal=vm,
            rng_normal=None if self.rng_normal is None else self.rng_normal.to(dtype))


def epoch_permutation(n: int, seed: int, epoch: Optional[int] = None,
                      rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    """The permutation law of ``kgcn_tpu``: with ``epoch`` the order is a pure
    function of (seed, epoch); with only ``rng`` it advances the caller's
    stream; with neither it is the identity (shuffle off)."""
    idx = np.arange(n)
    if epoch is not None:
        np.random.RandomState((seed * 100003 + epoch) % (2**31)).shuffle(idx)
    elif rng is not None:
        rng.shuffle(idx)
    return idx


class Batcher:
    """Yields fixed-shape ``Batch``es from a host Dataset.

    The tiled and stream structures' settings are pinned by the first
    batch unless given: ``tiling`` (ts, tr, chunk), ``locality`` (a flag per
    channel) and ``chunk_budget`` together for ``tiled``, ``macro_budget``
    for ``stream`` (an exported program's traced ones).  A given budget is
    never grown: a batch that needs more raises ``ValueError``."""

    def __init__(self, ds: Dataset, info: DatasetInfo, batch_size: int, *,
                 edge_budget: Optional[int] = None, seed: int = 0,
                 backend: Optional[Backend] = None, epsilon_dim: int = 0,
                 tiling: Optional[tuple] = None, locality: Optional[tuple] = None,
                 chunk_budget: Optional[int] = None,
                 macro_budget: Optional[int] = None):
        self.ds = ds
        self.info = info
        self.batch_size = int(batch_size)
        self.max_nodes = aligned_max_nodes(ds, info)
        per_graph = info.edge_budget_per_graph or self._scan_edge_budget()
        self.edge_budget = edge_budget or pad_edge_budget(per_graph * self.batch_size)
        self.seed = int(seed)
        self._rng = np.random.RandomState(seed)
        self.epsilon_dim = int(epsilon_dim)
        self.backend = backend or Backend()
        # tiled: (ts, tr, chunk), locality flags and the chunk budget are
        # pinned by the first batch unless given, so every batch has the
        # same shapes
        if (tiling is None) != (chunk_budget is None) or (tiling is None) != (
                locality is None):
            raise ValueError("tiling, locality and chunk_budget are given together")
        self._tiled_cfg = tiling
        self._tiled_loc = locality
        self._tiled_budget = chunk_budget
        # stream: the macro budget likewise
        self._stream_budget = macro_budget
        self._fixed = (chunk_budget is not None, macro_budget is not None)
        # ELL: the per-graph arrays, built at the first batch (None when the
        # gate refuses the dataset)
        self._ell = None
        self._ell_ready = False
        # the packer's per-dataset COO blocks and node arrays, at the first batch
        self._coo = None
        self.host_seconds = 0.0
        self.tiled_seconds = 0.0
        self.stream_seconds = 0.0
        self.ell_seconds = 0.0

    @property
    def valid_per_epoch(self) -> int:
        return self.ds.num

    def _scan_edge_budget(self) -> int:
        if self.ds.adjs is None:
            return 1
        return max(max((len(ch[0]) for ch in gs), default=1) for gs in self.ds.adjs)

    def batch_valid_counts(self):
        """Per-batch valid-example counts for a shuffle=False iteration."""
        n, bs = self.ds.num, self.batch_size
        return [min(bs, n - s) for s in range(0, n, bs)]

    def epoch_indices(self, shuffle: bool = True,
                      epoch: Optional[int] = None) -> np.ndarray:
        return epoch_permutation(
            self.ds.num, self.seed, epoch if shuffle else None,
            rng=self._rng if shuffle else None,
        )

    def make_batch(self, idx: np.ndarray) -> Batch:
        """Assemble one batch from dataset indices (host-side numpy)."""
        t0 = time.perf_counter()
        batch = self._make_batch(idx)
        self.host_seconds += time.perf_counter() - t0
        return batch

    def _make_batch(self, idx: np.ndarray) -> Batch:
        ds = self.ds
        B = self.batch_size
        idx = np.asarray(idx)
        G = len(idx)
        if G > B:
            raise ValueError(f"{G} graphs do not fit a batch of {B}")
        self.last_valid = G

        graph = self._pack_graph(idx, B).replace(
            backend=self.backend.name, compute_dtype=self.backend.compute_dtype)
        if self.backend.name == "tiled":
            t0 = time.perf_counter()
            graph = self._attach_tiled(graph)
            self.tiled_seconds += time.perf_counter() - t0
        elif self.backend.name == "stream":
            t0 = time.perf_counter()
            graph = self._attach_stream(graph)
            self.stream_seconds += time.perf_counter() - t0
        elif self.backend.name in ("xla", "pallas"):
            t0 = time.perf_counter()
            ei, ew, pack = self._ell_arrays(idx, B)
            if ei is not None:
                graph = graph.replace(ell_senders=ei, ell_weights=ew, ell_pack=pack)
            self.ell_seconds += time.perf_counter() - t0

        def pad_rows(x):
            if x is None:
                return None
            x = np.asarray(x)
            if G < B:
                x = np.concatenate([x, np.zeros((B - G, *x.shape[1:]), x.dtype)])
            return as_tensor(x)

        def take(x, per_node=False):
            if x is None:
                return None
            x = x[idx]
            return pad_rows(pad_node_axis(x, self.max_nodes) if per_node else x)

        pad_mask = np.zeros((B,), np.float32)
        pad_mask[:G] = 1.0
        eps = None
        if self.epsilon_dim:
            eps = torch.from_numpy(self._rng.normal(
                size=(B, self.max_nodes, self.epsilon_dim)).astype(np.float32))
        return Batch(
            graph=graph,
            labels=take(ds.labels),
            mask_label=take(ds.mask_label),
            node_label=take(ds.node_label, per_node=True),
            mask_node_label=take(ds.mask_node_label, per_node=True),
            sequences=take(ds.sequences),
            sequences_len=take(ds.sequences_len),
            vector_modal=(tuple(take(v) for v in ds.vector_modal)
                          if ds.vector_modal else None),
            pad_mask=torch.from_numpy(pad_mask),
            rng_normal=eps,
        )

    def _prepare_coo(self) -> None:
        """The packer's per-dataset operands, laid out once: every graph's
        edges per channel concatenated (``rows``/``cols``/``vals``) with each
        block's offset and length ``[G, C]``, the features as float32, each
        graph's node count (``batch_graphs``'s rule) and node ids."""
        ds, N = self.ds, self.max_nodes
        if ds.adjs is None:  # no adjacency: one channel without edges
            C, blocks = 1, [[(np.zeros(0, np.int32),) * 2 + (np.zeros(0, np.float32),)]
                            ] * ds.num
        else:
            C, blocks = len(ds.adjs[0]), ds.adjs
        length = np.array([[len(ch[0]) for ch in gs] for gs in blocks],
                          np.int64).reshape(ds.num, C)
        off = (np.cumsum(length.reshape(-1)) - length.reshape(-1)).reshape(ds.num, C)

        def flat(j, dtype):
            parts = [np.asarray(ch[j], dtype) for gs in blocks for ch in gs]
            return np.concatenate(parts) if parts else np.zeros(0, dtype)

        coo = {"rows": flat(0, np.int32), "cols": flat(1, np.int32),
               "vals": flat(2, np.float32), "off": off, "len": length, "C": C}
        if ds.enabled_node_nums is not None:
            coo["n_nodes"] = np.asarray(ds.enabled_node_nums, np.int32)
        elif ds.features is not None:
            coo["n_nodes"] = np.maximum(
                (np.abs(ds.features).sum(axis=-1) > 0).sum(axis=-1), 1).astype(np.int32)
        else:
            coo["n_nodes"] = np.full((ds.num,), N, np.int32)
        if ds.features is not None:
            coo["features"] = np.ascontiguousarray(ds.features, np.float32)
        if ds.nodes is not None:
            ids = np.zeros((ds.num, N), np.int32)
            for g, row in enumerate(ds.nodes):
                row = np.asarray(row, np.int32)
                ids[g, : len(row)] = row
            coo["node_ids"] = ids
        self._coo = coo

    def _pack_graph(self, idx: np.ndarray, B: int) -> GraphBatch:
        """The batch's ``GraphBatch`` (as ``batch_graphs`` builds it) from
        one call of the edge packer and one of the feature packer."""
        if self._coo is None:
            self._prepare_coo()
        coo, N, E = self._coo, self.max_nodes, self.edge_budget
        graphs = np.ascontiguousarray(idx, np.int64)
        G, C = len(graphs), coo["C"]
        lib = _batch_host()
        senders = np.empty((C, E), np.int32)
        receivers = np.empty((C, E), np.int32)
        weights = np.empty((C, E), np.float32)
        n_edge = np.zeros(C, np.int32)
        off = np.ascontiguousarray(coo["off"][graphs].reshape(-1))
        length = np.ascontiguousarray(coo["len"][graphs].reshape(-1))
        rc = lib.kgcn_pack_edges(
            coo["rows"].ctypes.data, coo["cols"].ctypes.data, coo["vals"].ctypes.data,
            off.ctypes.data, length.ctypes.data, G, C, N, E, senders.ctypes.data,
            receivers.ctypes.data, weights.ctypes.data, n_edge.ctypes.data)
        if rc != 0:
            raise RuntimeError("edge budget exceeded in native pack_edges" if rc == -1
                               else "node index out of range in native pack_edges")
        nn = np.zeros(B, np.int32)
        nn[:G] = coo["n_nodes"][graphs]
        mask = (np.arange(N)[None, :] < nn[:, None]).astype(np.float32).reshape(-1)
        nodes = None
        if "features" in coo:
            feats = coo["features"]
            rows, F = feats.shape[1:]
            padded = np.empty((B, rows, F), np.float32)
            lib.kgcn_gather_pad_features(feats.ctypes.data, graphs.ctypes.data, G, B,
                                         rows, F, padded.ctypes.data)
            if rows != N:
                out = np.zeros((B, N, F), np.float32)
                out[:, :rows] = padded[:, :N]
                padded = out
            nodes = torch.from_numpy(padded.reshape(B * N, F))
        ids = None
        if "node_ids" in coo:
            ids_np = np.zeros((B, N), np.int32)
            ids_np[:G] = coo["node_ids"][graphs]
            ids = torch.from_numpy(ids_np.reshape(-1))
        return GraphBatch(
            senders=torch.from_numpy(senders), receivers=torch.from_numpy(receivers),
            edge_weights=torch.from_numpy(weights), n_edge=torch.from_numpy(n_edge),
            n_node=torch.from_numpy(nn), node_mask=torch.from_numpy(mask),
            nodes=nodes, node_ids=ids, n_graph=B, max_nodes=N)

    def _attach_tiled(self, graph: GraphBatch) -> GraphBatch:
        """Per-channel tiled structures.  The first batch is a probe: its
        tiling and locality decisions are pinned, and the chunk budget is
        set to 1.25× its largest chunk count (either direction), rounded up
        to a multiple of 8; a later batch that overflows it doubles it
        (a given budget raises)."""
        F = int(self.info.feature_dim or 128)
        if self._tiled_cfg is None:
            probe = graph.with_tiled(feature_dim=F)
            m = probe.tiled_adj[0].meta
            self._tiled_cfg = (m.ts, m.tr, m.chunk)
            self._tiled_loc = tuple(t.node_perm is not None for t in probe.tiled_adj)
            budget = max(
                max(t.meta.n_chunks for t in probe.tiled_adj),
                max(t.transpose.meta.n_chunks for t in probe.tiled_adj),
            )
            self._tiled_budget = -(-int(budget * 1.25) // 8) * 8
        while True:
            try:
                return graph.with_tiled(tiling=self._tiled_cfg,
                                        chunk_budget=self._tiled_budget,
                                        feature_dim=F, locality=self._tiled_loc)
            except ValueError:
                if self._fixed[0]:
                    raise
                self._tiled_budget *= 2

    def _attach_stream(self, graph: GraphBatch) -> GraphBatch:
        """Per-channel stream structures, weights baked in.  The first batch
        is a probe: the macro budget is set to 1.25× its largest macro count
        (either direction), at least one more; a later batch that overflows
        it doubles it (a given budget raises)."""
        if self._stream_budget is None:
            probe = graph.with_stream()
            budget = max(
                max(t.meta.n_macros for t in probe.stream_adj),
                max(t.transpose.meta.n_macros for t in probe.stream_adj),
            )
            self._stream_budget = max(int(budget * 1.25), budget + 1)
        while True:
            try:
                return graph.with_stream(macro_budget=self._stream_budget)
            except ValueError:
                if self._fixed[1]:
                    raise
                self._stream_budget *= 2

    def _prepare_ell(self) -> None:
        """Per-graph ELL arrays ``[G, C, N, K]`` and their transposes
        (``ops/ell.per_graph_ell``), built once when ``ell_layout_ok`` admits
        the dataset (max in-degree ≤ 32, padded slots within 2× the real
        edges); batches assemble them by concatenation and a node offset."""
        self._ell_ready = True
        self._ell = per_graph_ell(self.ds.adjs, self.max_nodes)
        if self._ell is not None:
            # the packer's per-dataset operands, their addresses taken once
            self._ell["ptrs"] = tuple(self._ell[k].ctypes.data for k in (
                "idx", "w", "t_slots", "t_end", "t_count"))

    def _ell_arrays(self, idx: np.ndarray, B: int):
        """The batch's ``[C, B*N, K]`` ELL arrays for graph indices ``idx``
        and the int32 buffer that holds them (senders, the weights' bits),
        then the transpose's offsets ``[C, B*N + 1]`` and slots (as
        ``ell_transpose`` gives them for the batch: a sender's slots all lie
        in its own graph, so the graphs' lists, offset and concatenated in
        batch order, keep (v, k) order); (None, None, None) when the gate
        refused the dataset."""
        if not self._ell_ready:
            self._prepare_ell()
        if self._ell is None:
            return None, None, None
        e = self._ell
        N, K = self.max_nodes, e["K"]
        graphs = np.ascontiguousarray(idx, np.int64)
        G, C = len(graphs), e["idx"].shape[1]
        if G and (graphs.min() < 0 or graphs.max() >= len(e["idx"])):
            raise IndexError(f"graph indices outside the dataset's {len(e['idx'])}")
        n = C * B * N * K
        head = 2 * n + C * (B * N + 1)
        # room for every slot of the batch's graphs; cut to the real ones
        pack = np.empty(head + G * C * N * K, np.int32)
        n_slots = _ell_host().kgcn_ell_pack(*e["ptrs"], graphs.ctypes.data, G, B, C, N, K,
                                            pack.ctypes.data)
        pack = pack[:head + n_slots]
        shape = (C, B * N, K)
        # NumPy views, each then wrapped: cheaper than torch views on the host
        return (torch.from_numpy(pack[:n].reshape(shape)),
                torch.from_numpy(pack[n:2 * n].view(np.float32).reshape(shape)),
                torch.from_numpy(pack))


    def batches(self, shuffle: bool = True,
                epoch: Optional[int] = None) -> Iterator[Batch]:
        idx = self.epoch_indices(shuffle, epoch=epoch)
        for start in range(0, len(idx), self.batch_size):
            yield self.make_batch(idx[start : start + self.batch_size])
