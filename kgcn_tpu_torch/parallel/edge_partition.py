"""Edge-partitioned aggregation across the ranks — the counterpart of
``kgcn_tpu/parallel/edge_partition.py``: one giant graph whose nodes and
edges no longer fit one device.

* nodes are partitioned into D contiguous blocks, rank d owning rows
  ``d·V/D : (d+1)·V/D``;
* edges are partitioned by receiver block (``partition_edges``, NumPy,
  the same arrays as ``kgcn_tpu``'s), so the sums are local; within
  receiver block d the edges are grouped by sender-block offset
  ``o = (d − sender block) mod D``, each group padded to one budget;
* the senders' rows come from other ranks by one of two halos:

  - ``ring``: D − 1 hops of ``batch_isend_irecv`` rotate the node blocks
    around the ranks (to rank + 1, from rank − 1); after o hops a rank
    holds block ``(d − o) mod D`` and sums offset group o.  Memory stays
    O(V/D · F) a rank;
  - ``allgather``: one all-gather of the blocks, then every group summed
    locally.  O(V · F) a rank.

On the device each group keeps its real edges only (``DevicePartition``).

Both are differentiable: a hop's backward sends the gradient one hop back
(``_RingShift``), the all-gather's is its reduce-scatter (``_AllGather``:
``reduce_scatter_tensor`` on NCCL; gloo has none, so there an all-reduce
and this rank's slice of it).  The local sums run through the port's
``ops/segment.segment_sum`` (each receiver summed in data order), with each
group's receiver sort made once when the partition moves to the device."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from kgcn_tpu_torch.ops.segment import segment_sum, sort_segments
from kgcn_tpu_torch.parallel import mesh as pmesh


class PartitionedEdges(NamedTuple):
    """Static edge partition for D ranks (``kgcn_tpu``'s layout).

    senders_local: [D, D, E] — ``[d, o]`` = edges of receiver block d whose
        sender block is ``(d − o) mod D``, sender index local to that block.
    receivers_local: [D, D, E] — receiver index local to block d.
    weights: [D, D, E] — 0 marks padding.
    v_local: nodes a block.
    """

    senders_local: np.ndarray
    receivers_local: np.ndarray
    weights: np.ndarray
    v_local: int


def partition_edges(senders, receivers, weights, num_nodes: int,
                    num_devices: int) -> PartitionedEdges:
    """Host-side grouping of a COO edge list for the ring schedule
    (``kgcn_tpu``'s arithmetic: stable sort by (receiver block, offset),
    each group's budget the largest group's count rounded up to 128)."""
    D = int(num_devices)
    if num_nodes % D:
        raise ValueError(f"pad num_nodes {num_nodes} to a multiple of {D}")
    v_loc = num_nodes // D
    s = np.asarray(senders)
    r = np.asarray(receivers)
    w = np.asarray(weights)
    valid = w != 0
    s, r, w = s[valid], r[valid], w[valid]
    if len(s) and (int(s.max()) >= num_nodes or int(r.max()) >= num_nodes
                   or int(s.min()) < 0 or int(r.min()) < 0):
        raise ValueError(
            f"edge endpoints must lie in [0, {num_nodes}); got "
            f"senders [{s.min()}, {s.max()}], receivers [{r.min()}, {r.max()}]")
    rb = r // v_loc
    sb = s // v_loc
    off = (rb - sb) % D
    key = rb * D + off
    order = np.argsort(key, kind="stable")
    counts = np.bincount(key, minlength=D * D)
    budget = max(int(counts.max(initial=1)), 1)
    budget = ((budget + 127) // 128) * 128
    sl = np.zeros((D, D, budget), np.int32)
    rl = np.zeros((D, D, budget), np.int32)
    wl = np.zeros((D, D, budget), np.float32)
    pos = 0
    for g in range(D * D):
        k = int(counts[g])
        if k:
            d, o = divmod(g, D)
            sel = order[pos:pos + k]
            sl[d, o, :k] = s[sel] % v_loc
            rl[d, o, :k] = r[sel] % v_loc
            wl[d, o, :k] = w[sel]
            pos += k
    return PartitionedEdges(sl, rl, wl, v_loc)


class DevicePartition:
    """This rank's edge groups on its device, one a (channel c, offset o)
    (``groups[c][o]``: senders, receivers, weights and the receivers' sort
    for ``segment_sum``), each cut to its real edges: the padding of
    ``partition_edges`` (weight 0, sender and receiver 0, there to give XLA
    one static shape) would pile every empty slot of a group onto row 0."""

    def __init__(self, senders: np.ndarray, receivers: np.ndarray, weights: np.ndarray,
                 v_local: int, device):
        self.v_local = int(v_local)
        C, D, _ = np.shape(senders)
        self.channels, self.num_devices = int(C), int(D)
        self.groups = []
        for c in range(C):
            row = []
            for o in range(D):
                n = int(np.count_nonzero(weights[c, o]))  # real edges come first
                r = torch.from_numpy(np.ascontiguousarray(receivers[c, o, :n])).to(device)
                row.append((torch.from_numpy(np.ascontiguousarray(senders[c, o, :n]))
                            .to(device).long(), r,
                            torch.from_numpy(np.ascontiguousarray(weights[c, o, :n]))
                            .to(device), sort_segments(r, self.v_local)))
            self.groups.append(row)

    @classmethod
    def of(cls, part: PartitionedEdges, rank: int, device) -> "DevicePartition":
        """Rank ``rank``'s groups of a one-channel partition."""
        return cls(part.senders_local[rank][None], part.receivers_local[rank][None],
                   part.weights[rank][None], part.v_local, device)

    def group_sum(self, x: torch.Tensor, c: int, o: int) -> torch.Tensor:
        """``Σ_e w_e x[s_e]`` into the receivers of group (c, o): ``[v_loc, F]``
        (the gather by indexing: its backward accumulates in a fixed order
        on the card, where ``index_select``'s adds through atomics)."""
        s, r, w, seg = self.groups[c][o]
        if not len(s):
            return x.new_zeros((self.v_local, x.shape[-1]))
        msg = x[s] * w[:, None].to(x.dtype)
        return segment_sum(msg, r, self.v_local, sorted_segments=seg)


def _peers():
    world, rk = pmesh.world_size(), pmesh.rank()
    return (rk + 1) % world, (rk - 1) % world


def _exchange(x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    ops = [dist.P2POp(dist.isend, x.contiguous(), to),
           dist.P2POp(dist.irecv, out, frm)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """One ring hop: this rank's block to rank + 1, rank − 1's block back;
    the backward sends the gradient the other way."""

    @staticmethod
    def forward(ctx, x):
        nxt, prv = _peers()
        return _exchange(x, nxt, prv)

    @staticmethod
    def backward(ctx, g):
        nxt, prv = _peers()
        return _exchange(g, prv, nxt)


class _AllGather(torch.autograd.Function):
    """``[D, *x.shape]``, every rank's ``x`` in rank order; the backward is
    the reduce-scatter of the gradient."""

    @staticmethod
    def forward(ctx, x):
        world = pmesh.world_size()
        out = torch.empty((world * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        dist.all_gather_into_tensor(out, x.contiguous())
        return out.view(world, *x.shape)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if g.is_cuda:
            out = torch.empty(g.shape[1:], dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(out, g.view(-1, *g.shape[2:]))
            return out
        dist.all_reduce(g)  # gloo has no reduce-scatter
        return g[pmesh.rank()].clone()


def ring_shift(x: torch.Tensor) -> torch.Tensor:
    """``x`` of rank − 1 (differentiable; the identity in a world of one
    without a group)."""
    return _RingShift.apply(x) if pmesh.initialized() else x


def all_gather_blocks(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, ``[D, *x.shape]``
    (differentiable)."""
    return _AllGather.apply(x) if pmesh.initialized() else x[None]


def ring_spmm_local_channels(xs: torch.Tensor, part: DevicePartition) -> torch.Tensor:
    """Channel-summed ring aggregation with ONE exchange a hop: ``xs``
    ``[C, v_loc, F]`` per-channel inputs (rotated as one stack) or
    ``[v_loc, F]`` one input shared by the channels (GIN).  Returns the
    channel sum ``[v_loc, F]``."""
    shared = xs.dim() == 2
    D = part.num_devices
    rot = xs
    acc = None
    for o in range(D):
        for c in range(part.channels):
            term = part.group_sum(rot if shared else rot[c], c, o)
            acc = term if acc is None else acc + term
        if o + 1 < D:
            rot = ring_shift(rot)
    return acc


def allgather_spmm_local_channels(xs: torch.Tensor, part: DevicePartition) -> torch.Tensor:
    """The same sum through one all-gather of the stack."""
    shared = xs.dim() == 2
    D = part.num_devices
    full = all_gather_blocks(xs)
    d = pmesh.rank()
    acc = None
    for o in range(D):
        blk = full[(d - o) % D]
        for c in range(part.channels):
            term = part.group_sum(blk if shared else blk[c], c, o)
            acc = term if acc is None else acc + term
    return acc


HALOS = {"ring": ring_spmm_local_channels, "allgather": allgather_spmm_local_channels}


def spmm_edge_partitioned(part: DevicePartition, x_blk: torch.Tensor,
                          strategy: str = "ring") -> torch.Tensor:
    """Distributed ``out[r] = Σ_c Σ w_e x[s_e]`` over the ranks: ``x_blk``
    ``[v_loc, F]`` this rank's rows; returns this rank's rows of the
    output."""
    if strategy not in HALOS:
        raise ValueError(f"unknown halo strategy {strategy!r}")
    if part.num_devices != pmesh.world_size():
        raise ValueError(f"partition built for {part.num_devices} ranks, world of "
                         f"{pmesh.world_size()}")
    return HALOS[strategy](x_blk, part)
