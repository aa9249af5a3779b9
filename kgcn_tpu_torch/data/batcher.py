"""Mini-batch assembly: Dataset → fixed-shape batches of torch tensors.

The counterpart of ``kgcn_tpu/data/batcher.py`` (NumPy assembly path only):
every batch of a dataset has the same shapes (node padding ``B*N``,
lane-rounded edge budget), and the last partial batch is padded with empty
graphs and reported through ``pad_mask`` (the reference's ``mask`` vector,
kgcn/feed.py:148-151).  Batches are built on the CPU; ``Batch.to(device)``
moves them.

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
/ stream structures / ELL arrays.  The JAX package's native C++ packer is
not ported (ROADMAP.md queue A).
"""
from __future__ import annotations

import ctypes
import dataclasses
import time
from typing import Iterator, Optional

import numpy as np
import torch

from kgcn_tpu_torch.data.dataset import Dataset, DatasetInfo
from kgcn_tpu_torch.graph.batch import GraphBatch, batch_graphs, pad_edge_budget
from kgcn_tpu_torch.ops import _build
from kgcn_tpu_torch.ops.ell import coo_to_ell, ell_layout_ok, ell_transpose, scan_ell_stats
from kgcn_tpu_torch.runtime.backend import Backend


def _ell_host():
    """The ELL batch packer ``kgcn_ell_pack`` (``ops/csrc/ell_host.cc``)."""
    lib = _build.load("ell_host")
    if lib.kgcn_ell_pack.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.kgcn_ell_pack.argtypes = [ptr] * 6 + [i32] * 5 + [ptr]
        lib.kgcn_ell_pack.restype = ctypes.c_longlong
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


@dataclasses.dataclass
class Batch:
    """One batch: the graph plus aligned task tensors."""

    graph: GraphBatch
    labels: Optional[torch.Tensor] = None
    mask_label: Optional[torch.Tensor] = None
    node_label: Optional[torch.Tensor] = None
    mask_node_label: Optional[torch.Tensor] = None
    pad_mask: Optional[torch.Tensor] = None  # [B] 1.0 = real example
    label_list: Optional[torch.Tensor] = None  # [B, L, 6] KG preference triples
    label_valid: Optional[torch.Tensor] = None  # [B, L] 1.0 = real pair (0 = wrap pad)

    def to(self, device) -> "Batch":
        moved = {
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None
        }
        return dataclasses.replace(self, **moved)

    def replace(self, **changes) -> "Batch":
        return dataclasses.replace(self, **changes)


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
    """Yields fixed-shape ``Batch``es from a host Dataset."""

    def __init__(self, ds: Dataset, info: DatasetInfo, batch_size: int, *,
                 edge_budget: Optional[int] = None, seed: int = 0,
                 backend: Optional[Backend] = None):
        self.ds = ds
        self.info = info
        self.batch_size = int(batch_size)
        self.max_nodes = int(ds.max_node_num or info.graph_node_num)
        # beyond one 128-row tile, round the node padding up to a multiple
        # of 128, as kgcn_tpu does (its batches and ours keep one shape)
        if self.max_nodes > 128:
            self.max_nodes = ((self.max_nodes + 127) // 128) * 128
        per_graph = info.edge_budget_per_graph or self._scan_edge_budget()
        self.edge_budget = edge_budget or pad_edge_budget(per_graph * self.batch_size)
        self.seed = int(seed)
        self._rng = np.random.RandomState(seed)
        self.backend = backend or Backend()
        # tiled: (ts, tr, chunk), locality flags and the chunk budget are
        # pinned by the first batch, so every batch has the same shapes
        self._tiled_cfg = None
        self._tiled_loc = None
        self._tiled_budget = None
        # stream: the macro budget is pinned by the first batch likewise
        self._stream_budget = None
        # ELL: the per-graph arrays, built at the first batch (None when the
        # gate refuses the dataset)
        self._ell = None
        self._ell_ready = False
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

        if ds.adjs is not None:
            adjs = [
                [
                    (np.stack([r, c], axis=1), v, (self.max_nodes, self.max_nodes))
                    for (r, c, v) in ds.adjs[i]
                ]
                for i in idx
            ]
        else:
            adjs = [[(np.zeros((0, 2), np.int32), np.zeros(0, np.float32),
                      (self.max_nodes, self.max_nodes))]] * G
        graph = batch_graphs(
            adjs,
            ds.features[idx] if ds.features is not None else None,
            self.max_nodes,
            node_ids=[ds.nodes[i] for i in idx] if ds.nodes is not None else None,
            n_nodes=(
                ds.enabled_node_nums[idx] if ds.enabled_node_nums is not None else None
            ),
            edge_budget=self.edge_budget,
            n_graph=B,
        ).replace(backend=self.backend.name,
                  compute_dtype=self.backend.compute_dtype)
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
            return pad_rows(self._pad_node_axis(x) if per_node else x)

        pad_mask = np.zeros((B,), np.float32)
        pad_mask[:G] = 1.0
        return Batch(
            graph=graph,
            labels=take(ds.labels),
            mask_label=take(ds.mask_label),
            node_label=take(ds.node_label, per_node=True),
            mask_node_label=take(ds.mask_node_label, per_node=True),
            pad_mask=torch.from_numpy(pad_mask),
        )

    def _attach_tiled(self, graph: GraphBatch) -> GraphBatch:
        """Per-channel tiled structures.  The first batch is a probe: its
        tiling and locality decisions are pinned, and the chunk budget is
        set to 1.25× its largest chunk count (either direction), rounded up
        to a multiple of 8; a later batch that overflows it doubles it."""
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
                self._tiled_budget *= 2

    def _attach_stream(self, graph: GraphBatch) -> GraphBatch:
        """Per-channel stream structures, weights baked in.  The first batch
        is a probe: the macro budget is set to 1.25× its largest macro count
        (either direction), at least one more; a later batch that overflows
        it doubles it."""
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
                self._stream_budget *= 2

    def _prepare_ell(self) -> None:
        """Per-graph ELL arrays ``[G, C, N, K]``, built once when
        ``ell_layout_ok`` admits the dataset (max in-degree ≤ 32, padded
        slots within 2× the real edges); batches assemble them by
        concatenation and a node offset.  With them each graph's transpose
        (``ell_transpose``): per channel its real slots ``v*K + k`` grouped
        by sender, padded to ``N*K`` (``t_slots``), their count
        (``t_count``) and each sender's list end (``t_end``)."""
        self._ell_ready = True
        ds = self.ds
        if ds.adjs is None:
            return
        C = len(ds.adjs[0])
        N = self.max_nodes
        max_deg, total_edges = scan_ell_stats(ds.adjs)
        if not ell_layout_ok(max_deg, len(ds.adjs) * C * N, total_edges):
            return
        K = max_deg
        G = len(ds.adjs)
        per_graph = np.zeros((G, C, N, K), np.int32)
        per_graph_w = np.zeros((G, C, N, K), np.float32)
        for g, gs in enumerate(ds.adjs):
            for c, (r, cc, v) in enumerate(gs):
                per_graph[g, c], per_graph_w[g, c] = coo_to_ell(cc, r, v, N,
                                                                max_degree=K)
        # every (graph, channel) as one channel of the transpose
        offsets, slots = ell_transpose(per_graph.reshape(G * C, N, K),
                                       per_graph_w.reshape(G * C, N, K), N)
        count = offsets[:, -1] - offsets[:, 0]
        t_slots = np.zeros((G * C, N * K), np.int32)
        t_slots[np.arange(N * K)[None, :] < count[:, None]] = slots
        self._ell = {"idx": per_graph, "w": per_graph_w, "K": K,
                     "t_slots": t_slots.reshape(G, C, N * K),
                     # each sender's list end, counted from its graph's list start
                     "t_end": np.ascontiguousarray(
                         (offsets[:, 1:] - offsets[:, :1]).reshape(G, C, N)),
                     "t_count": np.ascontiguousarray(count.reshape(G, C))}
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

    def _pad_node_axis(self, x):
        """Pad a [G, N_ds, ...] per-node array to ``self.max_nodes`` (the
        dataset's node count diverges from the batch padding once it is
        rounded above 128)."""
        x = np.asarray(x)
        pad = self.max_nodes - x.shape[1]
        if pad <= 0:
            return x
        widths = [(0, 0)] * x.ndim
        widths[1] = (0, pad)
        return np.pad(x, widths)

    def batches(self, shuffle: bool = True,
                epoch: Optional[int] = None) -> Iterator[Batch]:
        idx = self.epoch_indices(shuffle, epoch=epoch)
        for start in range(0, len(idx), self.batch_size):
            yield self.make_batch(idx[start : start + self.batch_size])
