"""Device-resident datasets — the counterpart of ``kgcn_tpu/runtime/resident.py``.

A dataset that fits the device (molecular workloads easily do) is laid out
ONCE as padded per-graph arrays, built on the host and moved to the
trainer's device in one copy; a batch is then assembled on the device by
pure gathers from an epoch's schedule of graph indices (``gather_batch``),
with no host work and no host read.  ``Trainer.run_epoch`` and
``Trainer.evaluate`` run a whole epoch of such batches, on the card each
step replayed from one captured CUDA graph (``runtime/runner.py``).

Layout: per-graph fixed budgets (edges padded to the dataset's largest
channel, rounded up to a multiple of 8; nodes to ``max_nodes``), so a
batch gather is ``dd.senders[idx] [B, C, Eg] → + b·N → [C, B·Eg]``: the
streaming Batcher's semantics, with the padding edges interleaved, which
is why the batch carries an explicit ``edge_valid`` mask.

What the port's kernels and ops read besides, gathered the same way:

* the receivers' stable sort for the segment sums of the edge-list routes
  (GAT, the ``xla`` scatter): each graph's order and segment starts, built
  once; a batch is block-diagonal, so offsetting them by the graph's slot
  and edge position gives exactly the stable sort of the batch's
  receivers (``GraphBatch.segments``), with no sort per step;
* the ELL arrays' transpose for the dx kernel (``GraphBatch.
  ell_transposed``): each graph's sender-grouped slot lists
  (``ops/ell.per_graph_ell``), laid channel by channel at offsets from a
  prefix sum of the batch's per-graph counts, so the lists and their
  (v, k) order are the streaming Batcher's (``csrc/ell_host.cc``) bit for
  bit;
* the dense path builds ``[C, B, N, N]`` from the gathered lists in the
  model (``GraphBatch.with_dense_adj``), as the JAX package does;
* the multimodal inputs (sequences, their lengths, the vector modals)
  are gathered per example like the labels.

``ResidentVAEBatcher`` holds a ``ResidentBatcher`` and adds the graph
VAE's reparameterisation noise; its docstring says where each path draws
ε.

The gate (``resident_enabled``) is the JAX package's, with the resolved
backend passed in: the tiled and stream structures are packed on the host
per batch, so those backends decline.  Shuffling stays a host function of
(seed, epoch), the streaming Batcher's ``epoch_permutation``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from kgcn_tpu_torch.data.batcher import (
    Batch, aligned_max_nodes, as_tensor, epoch_permutation, pad_node_axis,
)
from kgcn_tpu_torch.data.dataset import Dataset, DatasetInfo
from kgcn_tpu_torch.graph.batch import GraphBatch
from kgcn_tpu_torch.ops.ell import ELL_MAX_DEGREE, per_graph_ell
from kgcn_tpu_torch.runtime.backend import Backend

# Default device-memory budget for keeping a dataset resident (bytes).
DEFAULT_RESIDENT_BUDGET = 4 * 1024 * 1024 * 1024


@dataclasses.dataclass
class DeviceDataset:
    """A whole dataset as per-graph padded tensors on one device."""

    senders: torch.Tensor  # [G, C, Eg] int32, graph-local node indices
    receivers: torch.Tensor  # [G, C, Eg]
    weights: torch.Tensor  # [G, C, Eg] float32 (0 = padding slot)
    n_edge: torch.Tensor  # [G, C] int32 valid-edge counts
    node_mask: torch.Tensor  # [G, N] float32
    features: Optional[torch.Tensor] = None  # [G, N, F]
    node_ids: Optional[torch.Tensor] = None  # [G, N] int32
    labels: Optional[torch.Tensor] = None
    mask_label: Optional[torch.Tensor] = None
    node_label: Optional[torch.Tensor] = None
    mask_node_label: Optional[torch.Tensor] = None
    sequences: Optional[torch.Tensor] = None  # [G, L] int32
    sequences_len: Optional[torch.Tensor] = None  # [G] int32
    vector_modal: Optional[tuple] = None  # one [G, D_m] per modal
    ell_idx: Optional[torch.Tensor] = None  # [G, C, N, K] graph-local
    ell_w: Optional[torch.Tensor] = None  # [G, C, N, K]
    ell_t_slots: Optional[torch.Tensor] = None  # [G, C, N*K] slot lists
    ell_t_end: Optional[torch.Tensor] = None  # [G, C, N] list ends
    ell_t_count: Optional[torch.Tensor] = None  # [G, C] real slots
    seg_order: Optional[torch.Tensor] = None  # [G, C, Eg] stable sort
    seg_start: Optional[torch.Tensor] = None  # [G, C, N] segment starts
    seg_order_all: Optional[torch.Tensor] = None  # [G, C*Eg] all channels
    seg_start_all: Optional[torch.Tensor] = None  # [G, N]
    num: int = 0
    max_nodes: int = 1
    backend: str = "dense"
    compute_dtype: str = "bfloat16"

    @property
    def device(self) -> torch.device:
        return self.senders.device


def supports_resident(ds: Dataset, *, allow_index_list: bool = False) -> bool:
    """The resident path covers the standard Batcher protocol; engines with
    their own feed logic (KG label lists) keep their own path.
    ``allow_index_list``: an engine that consumes ``graph_index_list``
    itself does not disqualify the dataset for it."""
    return (
        ds.adjs is not None
        and ds.label_list is None
        and (allow_index_list or ds.graph_index_list is None)
    )


def resident_flag(config) -> str:
    """Config ``device_resident`` as 'off' | 'force' | 'auto'."""
    flag = config.get("device_resident", "auto")
    if flag in (False, "false", "off", 0, "0"):
        return "off"
    if flag in (True, "true", "force", 1, "1"):
        return "force"
    return "auto"


def resident_enabled(config, ds: Dataset, info: DatasetInfo, backend, *,
                     allow_index_list: bool = False) -> bool:
    """THE gate: config ``device_resident`` true / false / "auto"
    (default).  ``true`` bypasses the memory budget; ``auto`` enforces it;
    the tiled and stream backends (``backend``: a ``Backend`` or its name)
    and unsupported datasets always decline, with a message when the user
    asked explicitly."""
    flag = resident_flag(config)
    if flag == "off":
        return False
    name = backend.name if isinstance(backend, Backend) else str(backend)
    if name in ("tiled", "stream"):
        # the tiled/stream structures are packed on the host per batch; the
        # on-device batch assembly cannot carry them
        if flag == "force":
            print(f"[resident] spmm_backend={name} needs host batching; "
                  "streaming batcher")
        return False
    if not supports_resident(ds, allow_index_list=allow_index_list):
        if flag == "force":
            print("[resident] dataset unsupported; streaming batcher")
        return False
    if flag == "force":
        return True
    budget = int(config.get("resident_budget_bytes", DEFAULT_RESIDENT_BUDGET))
    return estimate_bytes(ds, aligned_max_nodes(ds, info)) <= budget


def estimate_bytes(ds: Dataset, max_nodes: int) -> int:
    """Upper-bound the resident dataset's device footprint, as the JAX
    package counts it (aligned edge budget, features padded to the aligned
    N, possible ELL arrays, labels and ids)."""
    if ds.adjs is None:
        return 1 << 62
    G = ds.num
    C = len(ds.adjs[0])
    N = max_nodes
    eg = max((len(ch[0]) for gs in ds.adjs for ch in gs), default=1)
    eg = ((max(eg, 1) + 7) // 8) * 8
    total = G * C * eg * 12 + G * C * 4  # senders+receivers+weights, n_edge
    total += G * N * 4  # node mask
    if ds.features is not None:
        total += G * N * ds.features.shape[-1] * 4
    if ds.nodes is not None:
        total += G * N * 4
    # potential ELL arrays [G, C, N, K] idx + weights; K bounded by the gate's
    # limit scaled by the waste cap (2E/(G·C·N))
    total_edges = sum(len(ch[0]) for gs in ds.adjs for ch in gs)
    k_cap = min(ELL_MAX_DEGREE,
                int(2.0 * max(total_edges, 1) / max(G * C * N, 1)) + 1)
    total += G * C * N * k_cap * 8
    for name in ("labels", "mask_label", "node_label", "mask_node_label",
                 "sequences", "sequences_len"):
        arr = getattr(ds, name, None)
        if arr is not None:
            total += np.asarray(arr).size * 4
    for v in getattr(ds, "vector_modal", None) or []:
        total += np.asarray(v).size * 4
    return total


def _segment_arrays(receivers: np.ndarray, N: int) -> Dict[str, np.ndarray]:
    """Each graph's receivers' stable sort ``[G, C, Eg]`` with its segment
    starts ``[G, C, N]``, and the same of its channels as one list
    (``[G, C*Eg]``, entries ``c*Eg + e``; starts ``[G, N]``)."""
    G, C, Eg = receivers.shape
    counts = np.zeros((G, C, N), np.int64)
    np.add.at(counts, (np.arange(G)[:, None, None], np.arange(C)[None, :, None],
                       receivers), 1)
    start = np.cumsum(counts, axis=-1) - counts
    return {
        "seg_order": np.argsort(receivers, axis=-1, kind="stable").astype(np.int32),
        "seg_start": start.astype(np.int32),
        "seg_order_all": np.argsort(receivers.reshape(G, C * Eg), axis=-1,
                                    kind="stable").astype(np.int32),
        "seg_start_all": (np.cumsum(counts.sum(1), axis=-1) - counts.sum(1)).astype(np.int32),
    }


def _one_copy(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The arrays as tensors on ``device``, moved in ONE host-to-device
    copy: laid into one byte buffer at 16-byte aligned offsets, then viewed
    back by type and shape."""
    arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
    device = torch.device(device)
    if device.type == "cpu":
        return {k: torch.from_numpy(v) for k, v in arrays.items()}
    offsets, at = {}, 0
    for k, v in arrays.items():
        offsets[k] = at
        at += -(-v.nbytes // 16) * 16
    buf = np.empty(max(at, 16), np.uint8)
    for k, v in arrays.items():
        buf[offsets[k]:offsets[k] + v.nbytes] = v.reshape(-1).view(np.uint8)
    moved = torch.from_numpy(buf).to(device)
    return {k: moved[offsets[k]:offsets[k] + v.nbytes].view(
        getattr(torch, v.dtype.name)).view(v.shape) for k, v in arrays.items()}


def build_device_dataset(ds: Dataset, info: DatasetInfo, *,
                         max_nodes: Optional[int] = None,
                         backend: Optional[Backend] = None,
                         device="cpu") -> DeviceDataset:
    """Pack a Dataset into per-graph padded arrays on the host, once, and
    move them to ``device`` in one copy.  The ELL arrays (under the
    ``ell_layout_ok`` gate) and the receivers' sort are built where the
    backend's layers read them: ELL on ``xla`` and ``pallas``, the sort on
    every backend but ``dense``."""
    if not supports_resident(ds, allow_index_list=True):
        raise ValueError("dataset not supported by the resident path")
    backend = backend or Backend()
    N = max_nodes or aligned_max_nodes(ds, info)
    G = ds.num
    C = len(ds.adjs[0])
    eg = max((len(ch[0]) for gs in ds.adjs for ch in gs), default=1)
    eg = ((max(eg, 1) + 7) // 8) * 8  # the per-graph budget, a multiple of 8

    senders = np.zeros((G, C, eg), np.int32)
    receivers = np.zeros((G, C, eg), np.int32)
    weights = np.zeros((G, C, eg), np.float32)
    n_edge = np.zeros((G, C), np.int32)
    for g, chans in enumerate(ds.adjs):
        for c, (r, cc, v) in enumerate(chans):
            k = len(r)
            r = np.asarray(r, np.int32)
            cc = np.asarray(cc, np.int32)
            if k and (r.max() >= N or cc.max() >= N):
                # gather_batch offsets by b·N: an out-of-range index would
                # bleed into the neighbouring graph's block
                raise ValueError(
                    f"graph {g} channel {c} has node index "
                    f"{int(max(r.max(), cc.max()))} >= max_nodes {N}"
                )
            receivers[g, c, :k] = r
            senders[g, c, :k] = cc
            weights[g, c, :k] = np.asarray(v, np.float32)
            n_edge[g, c] = k

    if ds.enabled_node_nums is not None:
        nn = np.asarray(ds.enabled_node_nums, np.int32)
    elif ds.features is not None:
        nn = np.maximum(
            (np.abs(ds.features).sum(axis=-1) > 0).sum(axis=-1), 1
        ).astype(np.int32)
    else:
        nn = np.full((G,), N, np.int32)
    arrays = {"senders": senders, "receivers": receivers, "weights": weights,
              "n_edge": n_edge,
              "node_mask": (np.arange(N)[None, :] < nn[:, None]).astype(np.float32)}
    if ds.features is not None:
        features = np.zeros((G, N, ds.features.shape[-1]), np.float32)
        m = min(N, ds.features.shape[1])
        features[:, :m] = ds.features[:, :m]
        arrays["features"] = features
    if ds.nodes is not None:
        node_ids = np.zeros((G, N), np.int32)
        for g, row in enumerate(ds.nodes):
            row = np.asarray(row, np.int32)
            node_ids[g, : len(row)] = row
        arrays["node_ids"] = node_ids
    for name in ("labels", "mask_label"):
        if getattr(ds, name) is not None:
            arrays[name] = as_tensor(getattr(ds, name)).numpy()
    for name in ("node_label", "mask_node_label"):
        if getattr(ds, name) is not None:
            # per-node arrays follow the (aligned) node padding
            arrays[name] = as_tensor(pad_node_axis(getattr(ds, name), N)).numpy()
    for name in ("sequences", "sequences_len"):
        if getattr(ds, name) is not None:
            arrays[name] = np.asarray(getattr(ds, name), np.int32)
    for m, v in enumerate(ds.vector_modal or []):
        arrays[f"vector_modal_{m}"] = np.asarray(v, np.float32)
    if backend.name in ("xla", "pallas"):
        ell = per_graph_ell(ds.adjs, N)
        if ell is not None:
            arrays.update(ell_idx=ell["idx"], ell_w=ell["w"], ell_t_slots=ell["t_slots"],
                          ell_t_end=ell["t_end"], ell_t_count=ell["t_count"])
    if backend.name != "dense":
        arrays.update(_segment_arrays(receivers, N))
    moved = _one_copy(arrays, device)
    modals = tuple(moved.pop(f"vector_modal_{m}") for m in range(len(ds.vector_modal or [])))
    return DeviceDataset(**moved, vector_modal=modals or None, num=G, max_nodes=N,
                         backend=backend.name, compute_dtype=backend.compute_dtype)


def _by_graph(x):
    """[B, C, Eg] → [C, B·Eg]: each channel's graphs in batch order."""
    return x.transpose(0, 1).reshape(x.shape[1], -1)


def _gather_ell_transpose(dd: DeviceDataset, idx, valid, B):
    """The batch's ELL transpose ``(offsets [C, B*N + 1], slots [C*B*N*K])``
    in the streaming Batcher's layout: channel by channel, each graph's
    slot lists offset by its first slot ``b*N*K``, placed at the prefix
    sum of the counts before it (padding graphs have none); slots past the
    real ones are 0 and never read."""
    C, N = dd.ell_t_end.shape[1], dd.max_nodes
    NK = dd.ell_t_slots.shape[2]
    live = valid.to(torch.int32)
    count = (dd.ell_t_count[idx] * live[:, None]).transpose(0, 1).reshape(-1)  # [C*B]
    start = (torch.cumsum(count, 0) - count).reshape(C, B, 1)
    j = torch.arange(NK, device=idx.device, dtype=torch.int32)
    pos = torch.where(j < count.reshape(C, B, 1), start + j, C * B * NK).reshape(-1)
    first = (torch.arange(B, device=idx.device, dtype=torch.int32) * NK)[None, :, None]
    vals = dd.ell_t_slots[idx].transpose(0, 1) + first
    slots = torch.zeros(C * B * NK + 1, dtype=torch.int32, device=idx.device)
    slots.scatter_(0, pos.long(), vals.reshape(-1))
    ends = start + dd.ell_t_end[idx].transpose(0, 1) * live[None, :, None]  # [C, B, N]
    offsets = torch.cat([start[:, 0], ends.reshape(C, B * N)], dim=1)
    return offsets.to(torch.int32), slots[:-1]


def _gather_segments(dd: DeviceDataset, idx, B):
    """The batch's receivers' stable sort: each graph's order and starts
    offset by its edge position (``GraphBatch.segments``)."""
    C, Eg = dd.seg_order.shape[1:]
    dev = idx.device
    b = torch.arange(B, device=dev, dtype=torch.int64)
    order = dd.seg_order[idx].long() + (b * Eg)[:, None, None]  # [B, C, Eg]
    start = dd.seg_start[idx].long() + (b * Eg)[:, None, None]  # [B, C, N]
    tail = torch.full((C, 1), B * Eg, dtype=torch.int64, device=dev)
    per_channel = (order.transpose(0, 1).reshape(C, B * Eg),
                   torch.cat([start.transpose(0, 1).reshape(C, -1), tail], dim=1))
    o = dd.seg_order_all[idx].long()  # entries c*Eg + e of graph b
    flat = (o // Eg) * (B * Eg) + b[:, None] * Eg + o % Eg
    start_all = dd.seg_start_all[idx].long() + (b * C * Eg)[:, None]
    tail_all = torch.full((1,), B * C * Eg, dtype=torch.int64, device=dev)
    return per_channel, (flat.reshape(-1), torch.cat([start_all.reshape(-1), tail_all]))


def gather_batch(dd: DeviceDataset, idx: torch.Tensor, valid: torch.Tensor) -> Batch:
    """One fixed-shape Batch from graph indices, by gathers on the device:
    ``idx`` [B] int (padding slots may repeat index 0), ``valid`` [B]
    float32, 1.0 for real examples.  No host work, no host read."""
    B = idx.shape[0]
    N = dd.max_nodes
    C = dd.senders.shape[1]
    idx = idx.long()
    vb = valid.to(torch.float32)
    offs = (torch.arange(B, device=idx.device, dtype=torch.int32) * N)[:, None, None]
    ne = dd.n_edge[idx]  # [B, C]
    eg = dd.senders.shape[2]
    iota = torch.arange(eg, device=idx.device, dtype=torch.int32)[None, None, :]
    ev = (iota < ne[:, :, None]).to(torch.float32) * vb[:, None, None]
    nm = dd.node_mask[idx] * vb[:, None]  # [B, N]

    ell_s = ell_w = ell_t = None
    if dd.ell_idx is not None:
        K = dd.ell_idx.shape[-1]
        gw = dd.ell_w[idx] * vb[:, None, None, None]
        gi = dd.ell_idx[idx] + offs[..., None] * (gw != 0).to(torch.int32)
        ell_s = gi.transpose(0, 1).reshape(C, B * N, K)
        ell_w = gw.transpose(0, 1).reshape(C, B * N, K)
        ell_t = _gather_ell_transpose(dd, idx, vb, B)
    graph = GraphBatch(
        senders=_by_graph(dd.senders[idx] + offs),
        receivers=_by_graph(dd.receivers[idx] + offs),
        edge_weights=_by_graph(dd.weights[idx] * vb[:, None, None]),
        n_edge=torch.sum(ne * vb[:, None].to(ne.dtype), dim=0).to(torch.int32),
        n_node=torch.sum(nm, dim=1).to(torch.int32),
        node_mask=nm.reshape(B * N),
        nodes=(None if dd.features is None
               else (dd.features[idx] * vb[:, None, None]).reshape(B * N, -1)),
        node_ids=(None if dd.node_ids is None
                  else (dd.node_ids[idx] * vb[:, None].to(torch.int32)).reshape(B * N)),
        edge_valid=_by_graph(ev),
        ell_senders=ell_s,
        ell_weights=ell_w,
        n_graph=B,
        max_nodes=N,
        backend=dd.backend,
        compute_dtype=dd.compute_dtype,
        segments=None if dd.seg_order is None else _gather_segments(dd, idx, B),
        ell_transposed=ell_t,
    )

    def take(x):
        """Per-example rows; padding slots zeroed (the streaming Batcher's
        zero-padding of the last partial batch)."""
        if x is None:
            return None
        g = x[idx]
        return g * vb.to(g.dtype).reshape((B,) + (1,) * (g.dim() - 1))

    return Batch(
        graph=graph,
        labels=take(dd.labels),
        mask_label=take(dd.mask_label),
        node_label=take(dd.node_label),
        mask_node_label=take(dd.mask_node_label),
        sequences=take(dd.sequences),
        sequences_len=take(dd.sequences_len),
        vector_modal=(None if dd.vector_modal is None
                      else tuple(take(v) for v in dd.vector_modal)),
        pad_mask=vb,
    )


class ResidentBatcher:
    """A Batcher over a DeviceDataset: ``epoch_schedule`` feeds the
    Trainer's whole-epoch runner; ``batches`` and ``make_batch`` gather
    single batches on the device (no host assembly)."""

    def __init__(self, ds: Dataset, info: DatasetInfo, batch_size: int, *,
                 seed: int = 0, max_nodes: Optional[int] = None,
                 backend: Optional[Backend] = None, device="cpu",
                 device_data: Optional[DeviceDataset] = None):
        self.ds = ds
        self.info = info
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self._rng = np.random.RandomState(self.seed)
        self.device_data = device_data if device_data is not None else \
            build_device_dataset(ds, info, max_nodes=max_nodes, backend=backend,
                                 device=device)
        self.max_nodes = self.device_data.max_nodes

    @property
    def num_batches(self) -> int:
        return (self.ds.num + self.batch_size - 1) // self.batch_size

    @property
    def valid_per_epoch(self) -> int:
        return self.ds.num

    def batch_valid_counts(self):
        n, bs = self.ds.num, self.batch_size
        return [min(bs, n - s) for s in range(0, n, bs)]

    def epoch_indices(self, shuffle: bool = True,
                      epoch: Optional[int] = None) -> np.ndarray:
        """The streaming Batcher's permutation law: both paths see the same
        order."""
        return epoch_permutation(
            self.ds.num, self.seed, epoch if shuffle else None,
            rng=self._rng if shuffle else None,
        )

    def epoch_schedule(self, shuffle: bool = True, epoch: Optional[int] = None):
        """[S, B] int32 graph indices and [S, B] float32 validity of one
        epoch (NumPy)."""
        idx = self.epoch_indices(shuffle, epoch=epoch)
        B, S = self.batch_size, self.num_batches
        sched = np.zeros(S * B, np.int32)
        sched[:len(idx)] = idx
        valid = (np.arange(S * B) < len(idx)).astype(np.float32)
        return sched.reshape(S, B), valid.reshape(S, B)

    def _gather(self, idx: np.ndarray, valid: np.ndarray) -> Batch:
        dev = self.device_data.device
        return gather_batch(self.device_data, torch.from_numpy(idx).to(dev),
                            torch.from_numpy(valid).to(dev))

    def batches(self, shuffle: bool = True, epoch: Optional[int] = None):
        sched, valid = self.epoch_schedule(shuffle, epoch=epoch)
        for i in range(sched.shape[0]):
            yield self._gather(sched[i], valid[i])

    def make_batch(self, idx: np.ndarray) -> Batch:
        idx = np.asarray(idx)
        sched = np.zeros(self.batch_size, np.int32)
        sched[:len(idx)] = idx
        valid = (np.arange(self.batch_size) < len(idx)).astype(np.float32)
        return self._gather(sched, valid)


class ResidentVAEBatcher:
    """The resident batcher of the graph VAE (``kgcn_tpu/runtime/resident.py:
    437-493``): graphs gathered on the device by a ``ResidentBatcher`` it
    holds, and ε ``[B, N, latent]`` for the reparameterisation with each
    batch (the reference feeds it as the ``epsilon`` placeholder,
    kgcn/feed_index.py:107-109).  It offers the trainer a scanned epoch
    (``epoch_scan_inputs``) and no resident schedule, so each path has one
    source of ε:

    * ``Trainer.run_epoch`` (the scanned epoch, ``make_scan_batch``) draws
      it on the device from the runner's generator, step by step, with no
      host work (``kgcn_tpu`` takes its schedule first and trains at ε = 0,
      ROADMAP C.5);
    * ``make_batch`` and ``batches``, and so ``Trainer.evaluate``, draw it
      on the host from the batcher's ``RandomState``, after the shuffle,
      one array a batch, in the streaming ``Batcher``'s order."""

    def __init__(self, ds: Dataset, info: DatasetInfo, batch_size: int, latent_dim: int,
                 *, seed: int = 0, backend: Optional[Backend] = None, device="cpu"):
        self._resident = ResidentBatcher(ds, info, batch_size, seed=seed, backend=backend,
                                         device=device)
        self.ds, self.batch_size = ds, self._resident.batch_size
        self.device_data, self.max_nodes = self._resident.device_data, self._resident.max_nodes
        self.latent_dim = int(latent_dim)

    @property
    def num_batches(self) -> int:
        return self._resident.num_batches

    @property
    def valid_per_epoch(self) -> int:
        return self._resident.valid_per_epoch

    def batch_valid_counts(self):
        return self._resident.batch_valid_counts()

    def epoch_scan_inputs(self, shuffle: bool = True, epoch: Optional[int] = None):
        """(this batcher, the epoch's schedule and validity)."""
        return self, self._resident.epoch_schedule(shuffle, epoch=epoch)

    @staticmethod
    def make_scan_batch(const: "ResidentVAEBatcher", x, generator=None) -> Batch:
        idx, valid = x
        batch = gather_batch(const.device_data, idx, valid)
        eps = torch.randn((const.batch_size, const.max_nodes, const.latent_dim),
                          generator=generator, device=idx.device)
        return batch.replace(rng_normal=eps)

    def _eps(self) -> torch.Tensor:
        eps = self._resident._rng.normal(size=(self.batch_size, self.max_nodes,
                                               self.latent_dim))
        return torch.from_numpy(eps.astype(np.float32)).to(self.device_data.device)

    def make_batch(self, idx: np.ndarray) -> Batch:
        return self._resident.make_batch(idx).replace(rng_normal=self._eps())

    def batches(self, shuffle: bool = True, epoch: Optional[int] = None):
        """``kgcn_tpu``'s draw order: the shuffle, then each batch's ε, from
        the same ``RandomState`` (``epoch`` is not read)."""
        idx = np.arange(self.ds.num)
        if shuffle:
            self._resident._rng.shuffle(idx)
        for start in range(0, len(idx), self.batch_size):
            yield self.make_batch(idx[start:start + self.batch_size])
