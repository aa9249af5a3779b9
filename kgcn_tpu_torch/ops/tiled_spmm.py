"""Tiled sparse × dense product and its sampled dense-dense gradient.

The counterpart of ``kgcn_tpu/ops/tiled_spmm.py``: the same host-side edge
structure (``TiledCOO``) and the same two device operations,

* ``tiled_spmm(te, weights, x)`` — ``out[r] = Σ_e w_e · x[s_e]``, with a
  custom backward (``_TiledSpMM``): dx is the same kernel on the transpose
  structure and d(weights) is the SDDMM, as the JAX custom VJP ``_core``
  (``tiled_spmm.py:477-508``) computes them;
* ``tiled_sddmm(te, a, b)`` — ``out[e] = ⟨a[r_e], b[s_e]⟩``, per edge.

Host side (per batch): ``build_tiled`` groups the edges by (receiver tile,
sender tile) and packs them into fixed-size chunks that never cross a tile
pair (in C++, ``csrc/tiled_host.cc``); ``choose_tiling`` picks ``(ts, tr, chunk)`` with the JAX
package's TPU cost model, kept unchanged so both packages build the same
arrays (a tiling chosen for the GPU is later work, ROADMAP.md B.3).  The
port adds a ``TiledPlan`` per direction: the real slots in receiver order,
stable in slot order, with their edge ids, cut into balanced pieces for the
SpMM kernel.  It is built when a structure moves to a CUDA device
(``TiledCOO.to``), by the host library ``csrc/tiled_host.cc`` (plain C++),
so the CPU path, which never reads it, does not pay for it.  The same
library packs the structures themselves (``_build_arrays``).

Device side: on CUDA tensors the wrappers launch the hand-written Hopper
kernels of ``csrc/tiled.cu`` (both walk the structure's plan: the SpMM its
pieces, the SDDMM its real entries, writing each edge's value straight into
an ``[E]`` output); on CPU tensors they compute the plain versions
``tiled_spmm_reference`` / ``tiled_sddmm_edges_reference`` (the per-edge
form of the per-slot ``tiled_sddmm_reference``).  Neither falls back to the
other.  ``tiled_spmm.launches`` and ``tiled_sddmm.launches`` count kernel
launches and nothing else.

Payload dtype (``compute_dtype``, config ``tiled_compute_dtype``, default
``"bfloat16"``): as on the TPU, x and w are rounded to bf16, the product is
exact in f32, the message is rounded to bf16 and the sum runs in f32; the
SDDMM rounds both operands to bf16 and sums the products in f32.
``"float32"`` is the exact mode.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from kgcn_tpu_torch.ops import _build


def _cdiv(a, b):
    return -(-a // b)


def _round_up(x: int, m: int) -> int:
    return _cdiv(x, m) * m


# ---------------------------------------------------------------------------
# structure


@dataclasses.dataclass(frozen=True)
class TiledMeta:
    """Shape metadata of one tiled edge structure (as in ``kgcn_tpu``)."""

    ts: int          # sender-tile rows
    tr: int          # receiver-tile rows
    chunk: int       # edge slots per chunk
    n_chunks: int
    n_st: int        # sender tiles
    n_rt: int        # receiver tiles
    num_senders: int
    num_receivers: int
    num_edges: int   # true E; the slot_src sentinel of padding slots


@dataclasses.dataclass
class TiledCOO:
    """int32 tensors of one tiled edge structure (weights are NOT part of
    it: they are a per-call input, so learned attention weights work).

    s_loc/r_loc: ``[n_chunks, chunk]`` sender/receiver row local to the
        chunk's tile; 0 in padding slots.
    slot_src: ``[n_chunks, chunk]`` original edge id per slot; padding slots
        hold ``num_edges``.
    chunk_rt/chunk_st: ``[n_chunks]`` tile ids; chunk_rt is non-decreasing
        (a receiver tile's chunks are contiguous).
    transpose: the same edges with senders and receivers swapped (dx).
    node_perm/node_inv: locality relabelling, ``perm[new] = old``.
    edge_slot: ``[E]`` flat slot of each edge (dropped edges: the slot
        count, the index of an appended zero).
    plan: the SpMM kernel's ``TiledPlan`` of this direction's real slots;
        built on the host by ``to`` a CUDA device (``with_plan``), since
        only the kernel reads it.
    """

    s_loc: torch.Tensor
    r_loc: torch.Tensor
    slot_src: torch.Tensor
    chunk_rt: torch.Tensor
    chunk_st: torch.Tensor
    meta: TiledMeta
    transpose: Optional["TiledCOO"] = None
    node_perm: Optional[torch.Tensor] = None
    edge_slot: Optional[torch.Tensor] = None
    node_inv: Optional[torch.Tensor] = None
    plan: Optional["TiledPlan"] = None

    def replace(self, **changes) -> "TiledCOO":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "TiledCOO":
        """A copy on ``device``.  A move of a host structure to a CUDA
        device first builds the SpMM kernel's plans (``with_plan``), then
        copies every array of both directions and their plans at once
        (``_to_card``)."""
        if torch.device(device).type == "cuda" and not self.slot_src.is_cuda:
            return _to_card(with_plan(self), device)
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TiledCOO, TiledPlan)):
                moved[f.name] = v.to(device)
        return self.replace(**moved)


def _to_card(te: TiledCOO, device) -> TiledCOO:
    """``te`` and its transpose, with their plans, on ``device`` through ONE
    host-to-device copy: every int32 array laid into one host buffer, each
    from a 16-byte boundary (the plans' int4 reads), then views of the copy
    (one split).  A copy call costs the host some 20 µs, and a structure
    with its transpose and plans holds a dozen arrays."""
    dirs = (te,) if te.transpose is None else (te, te.transpose)
    names = [[f.name for f in dataclasses.fields(d) if isinstance(getattr(d, f.name), torch.Tensor)]
             for d in dirs]
    arrays = [getattr(d, n) for d, ns in zip(dirs, names) for n in ns]
    arrays += [d.plan.buf for d in dirs]
    sizes = []
    for t in arrays:
        if t.dtype != torch.int32:
            raise ValueError(f"TiledCOO arrays are int32 (got {t.dtype})")
        sizes += [t.numel(), -t.numel() % 4]
    host = np.empty(sum(sizes), np.int32)
    o = 0
    for t, n, pad in zip(arrays, sizes[::2], sizes[1::2]):
        host[o:o + n] = t.numpy().reshape(-1)
        o += n + pad
    views = torch.from_numpy(host).to(device).split(sizes)[::2]
    it = (v.view(t.shape) for v, t in zip(views, arrays))
    moved = [{n: next(it) for n in ns} for ns in names]
    for d, m in zip(dirs, moved):
        m["plan"] = dataclasses.replace(d.plan, buf=next(it))
    if len(dirs) == 2:
        moved[0]["transpose"] = te.transpose.replace(**moved[1])
    return te.replace(**moved[0])


def _host_lib():
    lib = _build.load("tiled_host")
    if lib.kgcn_tiled_plan.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kgcn_tiled_arrays.argtypes = [ptr] * 3 + [i64] + [i32] * 6 + [i64, i32]
        lib.kgcn_tiled_arrays.restype = i64
        lib.kgcn_tiled_arrays_take.argtypes = [ptr] * 3
        lib.kgcn_tiled_arrays_take.restype = None
        lib.kgcn_tiled_plan.argtypes = [ptr] * 5 + [i32] * 9 + [ptr] * 2
        lib.kgcn_tiled_plan.restype = i64
        lib.kgcn_tiled_plan_take.argtypes = [ptr]
        lib.kgcn_tiled_plan_take.restype = None
    return lib


def _build_arrays(s, r, eid, num_senders, num_receivers, num_edges, ts, tr, chunk,
                  budget=None, edge_slot=False):
    """One direction's arrays (``kgcn_tpu``'s ``_build_arrays`` and
    ``_pad_chunks``) from ``kgcn_tiled_arrays`` (``csrc/tiled_host.cc``):
    s/r/eid are the kept edges in input order; ``budget`` pads the chunk
    list to that many chunks (raises if short); ``edge_slot`` also returns
    each original edge's flat slot (dropped edges: the slot count)."""
    s = np.ascontiguousarray(s, np.int64)
    r = np.ascontiguousarray(r, np.int64)
    eid = np.ascontiguousarray(eid, np.int32)
    lib = _host_lib()
    n_chunks = lib.kgcn_tiled_arrays(
        s.ctypes.data, r.ctypes.data, eid.ctypes.data, len(s), num_senders,
        num_receivers, num_edges, ts, tr, chunk, -1 if budget is None else budget,
        int(edge_slot))
    if n_chunks < 0:
        raise ValueError(f"chunk budget {budget} < required {-n_chunks}; "
                         "raise the budget or the chunk size")
    if n_chunks == 0:
        raise ValueError("tiled structure: an edge lies outside the node range")
    slots = np.empty((3, n_chunks, chunk), np.int32)  # slot_src, s_loc, r_loc
    chunks = np.empty((2, n_chunks), np.int32)        # chunk_rt, chunk_st
    slot_of_edge = np.empty(num_edges, np.int32) if edge_slot else None
    lib.kgcn_tiled_arrays_take(slots.ctypes.data, chunks.ctypes.data,
                               None if slot_of_edge is None else slot_of_edge.ctypes.data)
    meta = TiledMeta(ts=ts, tr=tr, chunk=chunk, n_chunks=int(n_chunks),
                     n_st=max(_cdiv(num_senders, ts), 1),
                     n_rt=max(_cdiv(num_receivers, tr), 1), num_senders=num_senders,
                     num_receivers=num_receivers, num_edges=num_edges)
    te = TiledCOO(s_loc=torch.from_numpy(slots[1]), r_loc=torch.from_numpy(slots[2]),
                  slot_src=torch.from_numpy(slots[0]), chunk_rt=torch.from_numpy(chunks[0]),
                  chunk_st=torch.from_numpy(chunks[1]), meta=meta)
    return te if slot_of_edge is None else te.replace(edge_slot=torch.from_numpy(slot_of_edge))


def build_tiled(senders, receivers, num_nodes: int, *, weights=None,
                num_sender_nodes: Optional[int] = None, ts: int = 512,
                tr: int = 512, chunk: int = 128, with_transpose: bool = True,
                chunk_budget: Optional[int] = None, locality: bool = False,
                valid_mask=None) -> TiledCOO:
    """Build the tiled chunk structure on the host (topology only).

    Arguments as ``kgcn_tpu.ops.tiled_spmm.build_tiled``: ``valid_mask``
    ([E], nonzero = real edge) names the padding edges to drop; without it
    edges of weight 0 are dropped.  ``chunk_budget`` pads the chunk list to
    a fixed length; ``locality`` relabels nodes degree-descending first
    (square adjacency only).  The JAX package's compiled-TPU check that
    tiles be multiples of 16 does not apply here."""
    if ts % 8 or tr % 8 or chunk % 8:
        raise ValueError("tile and chunk sizes must be multiples of 8")
    s = np.asarray(senders).astype(np.int64)
    r = np.asarray(receivers).astype(np.int64)
    num_edges = len(s)
    if valid_mask is not None:
        valid = np.asarray(valid_mask) != 0
    elif weights is not None:
        valid = np.asarray(weights) != 0
    else:
        valid = np.ones(num_edges, bool)
    eid = np.arange(num_edges, dtype=np.int32)[valid]
    s_v, r_v = s[valid], r[valid]
    n_send = num_sender_nodes if num_sender_nodes is not None else num_nodes

    perm = inv = None
    if locality:
        if n_send != num_nodes:
            raise ValueError("locality relabelling needs a square adjacency")
        perm = locality_order(s_v, r_v, num_nodes)       # perm[new] = old
        inv = np.empty_like(perm)
        inv[perm] = np.arange(num_nodes, dtype=perm.dtype)
        s_v, r_v = inv[s_v], inv[r_v]

    # after padding: the sentinel of a dropped edge is the FINAL slot count
    te = _build_arrays(s_v, r_v, eid, n_send, num_nodes, num_edges, ts, tr, chunk,
                       chunk_budget, edge_slot=True)
    if with_transpose:
        te = te.replace(transpose=_build_arrays(r_v, s_v, eid, num_nodes, n_send, num_edges,
                                                tr, ts, chunk, chunk_budget))
    if perm is not None:
        te = te.replace(node_perm=torch.from_numpy(perm.astype(np.int32)),
                        node_inv=torch.from_numpy(inv.astype(np.int32)))
    return te


# ---------------------------------------------------------------------------
# the SpMM kernel's plan (host side, built for the card only)

# pieces per CUDA block of the SpMM kernel, one per warp (csrc/tiled.cu's WARPS)
PIECES_PER_BLOCK = 8
# the piece size (a multiple of 32, a warp's batch: 32-512) aims at about
# this many pieces a structure: 16 warps on each of the H100's 132 SMs,
# enough x-row gathers in flight to cover their latency
_TARGET_PIECES = 2048
# below this many real slots a piece is one row (a molecule batch's ~750
# slots: ~250 warps, each a chain of a few loads, instead of ~25 pieces of
# 32), a row longer than `piece` cut at the multiples of `piece` in it
_SMALL = 8 * _TARGET_PIECES


@dataclasses.dataclass
class TiledPlan:
    """The SpMM kernel's cut of one direction's real slots (host-built by
    ``with_plan``).  Piece ``p`` is entries ``[starts[p], starts[p+1])``.
    Below ``_SMALL`` entries every piece is a whole row, a row of more than
    ``piece`` entries cut at the multiples of ``piece`` inside it; beyond,
    there is a cut at each multiple of ``piece``, moved back to the start of
    its row unless that row is longer than ``piece`` or starts more than
    ``max(8, piece // 4)`` back.  A warp sums a piece in order, writing each
    receiver row that lies in this piece alone straight to the output, and
    the first and last rows, where other pieces share them, to partial rows.
    A row whose slots span pieces ("split") is then the sum of its partials,
    taken in a fixed order by the last CUDA block of ``PIECES_PER_BLOCK``
    pieces to write one of them.

    The arrays live in one int32 tensor ``buf``, each from a 16-byte
    boundary (the kernel reads pieces and splits as int4), so a plan moves
    to the card in one copy; ``array(name)`` (or the property of that name)
    is a view of it:

    entries: ``[3, n_real]`` edge id (the weight's index), receiver row and
        sender of each real slot, sorted by receiver row (within a row in
        slot order, the plain version's order of sums).
    starts: ``[n_pieces + 1]`` first entry of each piece, then n_real.
    pieces: ``[n_pieces, 4]`` (split row, partial) of the piece's first row
        and of its last row; ``-1, -1`` where that row is whole in this
        piece, and for the last row where it is also the first.
    splits: ``[n_split, 4]`` receiver row, first partial, partial count and
        number of blocks holding its partials, of each split row; its
        partials are consecutive, in piece order.
    empty_rows: ``[n_empty]`` receiver rows without a real slot (the kernel
        writes them as zeros).
    arrivals: ``[n_split]`` count of the blocks that have written a split
        row's partials in the running launch; 0 between launches (the last
        block resets it), so launches on one structure must run in stream
        order.

    piece: the target number of real slots per piece, ``min(512, 32 *
        max(1, ceil(n_real / (32 * _TARGET_PIECES))))``.
    counts: (n_real, n_pieces, n_split, n_empty).
    offsets: each array's first element in ``buf``, in ``ARRAYS`` order.
    n_parts: number of partial rows (the launch's scratch).
    seconds: host seconds spent building the plan.
    """

    piece: int
    counts: tuple
    offsets: tuple
    n_parts: int
    buf: torch.Tensor
    seconds: float = 0.0

    ARRAYS = ("entries", "starts", "pieces", "splits", "empty_rows", "arrivals")

    def shape(self, name) -> tuple:
        n_real, n_pieces, n_split, n_empty = self.counts
        return {"entries": (3, n_real), "starts": (n_pieces + 1,),
                "pieces": (n_pieces, 4), "splits": (n_split, 4),
                "empty_rows": (n_empty,), "arrivals": (n_split,)}[name]

    def array(self, name) -> torch.Tensor:
        shape = self.shape(name)
        o = self.offsets[self.ARRAYS.index(name)]
        return self.buf[o:o + math.prod(shape)].view(shape)

    entries = property(lambda self: self.array("entries"))
    starts = property(lambda self: self.array("starts"))
    pieces = property(lambda self: self.array("pieces"))
    splits = property(lambda self: self.array("splits"))
    empty_rows = property(lambda self: self.array("empty_rows"))
    arrivals = property(lambda self: self.array("arrivals"))

    def pointers(self) -> list:
        """Each array's device address, in ``ARRAYS`` order."""
        base = self.buf.data_ptr()
        return [base + 4 * o for o in self.offsets]

    def to(self, device) -> "TiledPlan":
        return dataclasses.replace(self, buf=self.buf.to(device))


def _plan(te: TiledCOO) -> TiledPlan:
    """The plan of one direction from ``kgcn_tiled_plan`` (``csrc/
    tiled_host.cc``): one pass over the slots, a few microseconds for a
    molecule batch."""
    m = te.meta
    lib = _host_lib()
    counts = (ctypes.c_longlong * 6)()
    offsets = (ctypes.c_longlong * 6)()
    total = lib.kgcn_tiled_plan(
        *(getattr(te, name).data_ptr() for name in ("slot_src", "s_loc", "r_loc",
                                                     "chunk_rt", "chunk_st")),
        m.n_chunks, m.chunk, m.ts, m.tr, m.num_receivers, m.num_edges,
        _TARGET_PIECES, _SMALL, PIECES_PER_BLOCK, counts, offsets)
    if total < 0:
        raise ValueError("tiled plan: a real slot's receiver lies outside the structure")
    buf = torch.empty(total, dtype=torch.int32)
    lib.kgcn_tiled_plan_take(buf.data_ptr())
    P, *rest, n_parts = counts
    return TiledPlan(piece=P, counts=tuple(rest), offsets=tuple(offsets[:]),
                     n_parts=n_parts, buf=buf)


def with_plan(te: TiledCOO) -> TiledCOO:
    """``te`` (a host structure) with the SpMM kernel's plan, and its
    transpose with its own: the real slots sorted by receiver row, stably,
    so a row keeps slot order (the plain version's order of sums), as (edge
    id, receiver row, sender).  A plan's ``seconds`` is its host time."""
    if te.transpose is not None and te.transpose.plan is None:
        te = te.replace(transpose=with_plan(te.transpose))
    if te.plan is not None:
        return te
    _check_structure(te, torch.device("cpu"))
    t0 = time.perf_counter()
    plan = _plan(te)
    plan.seconds = time.perf_counter() - t0
    return te.replace(plan=plan)


# ---------------------------------------------------------------------------
# tiling choice and locality order (host side)

_CANDIDATES = (
    # clustered / block-diagonal regimes: small tiles, long chunks
    (128, 128, 1024), (256, 256, 512), (256, 256, 1024), (256, 256, 2048),
    (512, 512, 512),
    # scattered / uniform regimes: big tiles, short chunks
    (512, 512, 128), (1024, 1024, 128), (2048, 2048, 256),
)


def choose_tiling(senders, receivers, num_nodes: int, feature_dim: int, *,
                  weights=None, candidates=_CANDIDATES, bytes_per_elt: int = 2,
                  num_sender_nodes: Optional[int] = None,
                  return_cost: bool = False):
    """(ts, tr, chunk) minimising ``kgcn_tpu``'s TPU cost model on the exact
    (rt, st) pair histogram of this edge list — kept unchanged so both
    packages pick the same tiling.  ``bytes_per_elt`` is the payload's
    (2 for bf16, 4 for f32); the JAX package reads it from its process
    global, the port takes it as an argument."""
    s = np.asarray(senders).astype(np.int64)
    r = np.asarray(receivers).astype(np.int64)
    if weights is not None:
        valid = np.asarray(weights) != 0
        s, r = s[valid], r[valid]
    n_send = num_sender_nodes if num_sender_nodes is not None else num_nodes
    F = _round_up(max(feature_dim, 1), 128)
    MXU_FLOPS = 2.0e14 if bytes_per_elt == 2 else 1.0e14
    HBM_BPS = 8.0e11
    VPU_OPS = 1.0e12
    best, best_cost = candidates[0], float("inf")
    for ts, tr, chunk in candidates:
        n_st = max(_cdiv(n_send, ts), 1)
        n_rt = max(_cdiv(num_nodes, tr), 1)
        key = (r // tr) * n_st + (s // ts)
        uniq, counts = np.unique(key, return_counts=True)
        n_pairs = len(counts)
        n_chunks = int(np.sum(_cdiv(counts, chunk)))
        # one all-padding chunk per edge-free receiver tile
        empty_rt = n_rt - len(np.unique(uniq // n_st))
        n_chunks += empty_rt
        n_pairs += empty_rt
        slots = n_chunks * chunk
        t_mxu = slots * 2.0 * F * (ts + tr) / MXU_FLOPS
        t_vpu = slots * 3.0 * (ts + tr) / VPU_OPS
        t_hbm = n_pairs * ts * F * bytes_per_elt / HBM_BPS
        t_grid = n_chunks * 1.0e-6
        cost = max(t_mxu + 0.7 * t_vpu, t_hbm) + t_grid
        if cost < best_cost:
            best, best_cost = (ts, tr, chunk), cost
    if return_cost:
        return best, best_cost
    return best


def choose_tiling_with_locality(senders, receivers, num_nodes: int,
                                feature_dim: int, *, weights=None,
                                bytes_per_elt: int = 2):
    """(tiling, locality_flag): the cost model on the raw and on the
    degree-relabelled edge list; relabel only on a ≥ 20 % modelled win."""
    s = np.asarray(senders).astype(np.int64)
    r = np.asarray(receivers).astype(np.int64)
    raw_t, raw_c = choose_tiling(s, r, num_nodes, feature_dim, weights=weights,
                                 bytes_per_elt=bytes_per_elt, return_cost=True)
    # filter before relabelling: the permutation covers real node ids only
    valid = (np.asarray(weights) != 0 if weights is not None
             else np.ones(len(s), bool))
    s_v, r_v = s[valid], r[valid]
    perm = locality_order(s_v, r_v, num_nodes)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(num_nodes, dtype=perm.dtype)
    loc_t, loc_c = choose_tiling(inv[s_v], inv[r_v], num_nodes, feature_dim,
                                 bytes_per_elt=bytes_per_elt, return_cost=True)
    if loc_c < 0.8 * raw_c:
        return loc_t, True
    return raw_t, False


def locality_order(senders, receivers, num_nodes: int) -> np.ndarray:
    """Degree-descending node permutation (``perm[new] = old``)."""
    deg = np.bincount(np.asarray(senders), minlength=num_nodes)
    deg = deg + np.bincount(np.asarray(receivers), minlength=num_nodes)
    return np.argsort(-deg, kind="stable").astype(np.int64)


# ---------------------------------------------------------------------------
# plain versions (CPU path; the yardstick of the kernels on the card)


def is_bf16(compute_dtype) -> bool:
    """``"bfloat16"`` / ``torch.bfloat16`` → True; ``"float32"`` → False."""
    name = str(compute_dtype).replace("torch.", "")
    if name not in ("bfloat16", "float32"):
        raise ValueError(f"tiled compute dtype must be bfloat16 or float32, "
                         f"got {compute_dtype!r}")
    return name == "bfloat16"


def _rb(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 and back (round to nearest even)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _slot_rows(te: TiledCOO):
    """(valid, sender row, receiver row) of every slot, flat."""
    m = te.meta
    valid = te.slot_src.reshape(-1) < m.num_edges
    send = (te.chunk_st.long()[:, None] * m.ts + te.s_loc.long()).reshape(-1)
    recv = (te.chunk_rt.long()[:, None] * m.tr + te.r_loc.long()).reshape(-1)
    zero = torch.zeros_like(send)
    return valid, torch.where(valid, send, zero), torch.where(valid, recv, zero)


def tiled_spmm_reference(te: TiledCOO, weights, x, compute_dtype="bfloat16"):
    """Plain PyTorch version of the SpMM kernel: per slot the message
    ``w·x[s]`` (with the bf16 roundings of the payload dtype), summed into
    its receiver in float32.  x ``[num_senders, F]`` → ``[num_receivers, F]``."""
    m = te.meta
    valid, send, recv = _slot_rows(te)
    w_ext = torch.cat([weights.to(torch.float32),
                       weights.new_zeros(1, dtype=torch.float32)])
    w = w_ext[te.slot_src.reshape(-1).long()]
    xs = x.to(torch.float32)[send]
    if is_bf16(compute_dtype):
        msg = _rb(_rb(w)[:, None] * _rb(xs))
    else:
        msg = w[:, None] * xs
    out = torch.zeros((m.n_rt * m.tr, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out.index_add_(0, recv, msg)
    return out[: m.num_receivers]


def _slot_dots(te: TiledCOO, x, g, compute_dtype):
    """(valid, ``⟨g[r], x[s]⟩`` of every slot, flat) in float32, operands
    rounded to bf16 in bf16 mode."""
    valid, send, recv = _slot_rows(te)
    xs = x.to(torch.float32)[send]
    gr = g.to(torch.float32)[recv]
    if is_bf16(compute_dtype):
        xs, gr = _rb(xs), _rb(gr)
    return valid, (xs * gr).sum(dim=1)


def tiled_sddmm_reference(te: TiledCOO, x, g, compute_dtype="bfloat16"):
    """Plain PyTorch version of the SDDMM, per slot: ``⟨g[r], x[s]⟩`` in
    float32 (operands rounded to bf16 in bf16 mode); padding slots 0.
    → ``[n_chunks, chunk]``."""
    m = te.meta
    valid, dot = _slot_dots(te, x, g, compute_dtype)
    dot = torch.where(valid, dot, torch.zeros_like(dot))
    return dot.reshape(m.n_chunks, m.chunk)


def tiled_sddmm_edges_reference(te: TiledCOO, x, g, compute_dtype="bfloat16"):
    """The same per edge, as the kernel writes it: each real slot's value
    at its edge id (``slot_src``), edges not in the structure 0 → ``[E]``
    float32."""
    m = te.meta
    valid, dot = _slot_dots(te, x, g, compute_dtype)
    # padding slots all go to a sacrificial last element
    eid = torch.where(valid, te.slot_src.reshape(-1).long(),
                      torch.full_like(dot, m.num_edges, dtype=torch.long))
    out = torch.zeros(m.num_edges + 1, dtype=torch.float32, device=dot.device)
    return out.scatter_(0, eid, dot)[:-1]


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/tiled.cu)

_INT_FIELDS = ("s_loc", "r_loc", "slot_src", "chunk_rt", "chunk_st")


def _check_structure(te: TiledCOO, device):
    for name in _INT_FIELDS:
        t = getattr(te, name)
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"TiledCOO.{name} must be contiguous int32 on "
                             f"{device} (got {t.dtype} on {t.device})")


def _check_operand(name, t, rows, device):
    if t.dtype != torch.float32 or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name} must be a contiguous float32 tensor on "
                         f"{device} (got {t.dtype} on {t.device})")
    if t.dim() != 2 or t.shape[0] != rows:
        raise ValueError(f"{name} has shape {tuple(t.shape)}; want [{rows}, F]")


def _lib():
    lib = _build.load("tiled")
    if lib.kgcn_tiled_spmm.argtypes is None:
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.kgcn_tiled_spmm.argtypes = [ptr] * 10 + [i32] * 6 + [ptr]
        lib.kgcn_tiled_spmm.restype = ctypes.c_int
        lib.kgcn_tiled_sddmm.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
        lib.kgcn_tiled_sddmm.restype = ctypes.c_int
    return lib


def _check_plan(te: TiledCOO, device, kernel):
    """``te.plan``, which the kernels walk, checked to be on ``device``."""
    plan = te.plan
    if plan is None:
        raise ValueError(f"the tiled {kernel} kernel needs the structure's plan "
                         "(TiledCOO.to a CUDA device attaches it)")
    if plan.buf.dtype != torch.int32 or plan.buf.device != device:
        raise ValueError(f"TiledPlan.buf must be int32 on {device} (got "
                         f"{plan.buf.dtype} on {plan.buf.device})")
    return plan


def _spmm_launch(te: TiledCOO, weights, x, bf16: bool):
    """One launch of the SpMM kernel over ``te.plan`` → ``[num_receivers,
    F]`` float32."""
    m, plan = te.meta, _check_plan(te, x.device, "SpMM")
    _check_operand("x", x, m.num_senders, x.device)
    if (weights.dtype != torch.float32 or weights.device != x.device
            or tuple(weights.shape) != (m.num_edges,) or not weights.is_contiguous()):
        raise ValueError(f"weights must be contiguous float32 [{m.num_edges}] "
                         f"on {x.device}; got {weights.dtype} "
                         f"{tuple(weights.shape)} on {weights.device}")
    F = x.shape[1]
    out = torch.empty((m.num_receivers, F), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    # the split rows' partials (none on a molecule batch: no allocation)
    part = (torch.empty((plan.n_parts, F), dtype=torch.float32, device=x.device)
            if plan.n_parts else None)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.kgcn_tiled_spmm(
            *plan.pointers(), weights.data_ptr(), x.data_ptr(), out.data_ptr(),
            0 if part is None else part.data_ptr(), *plan.counts, F, int(bf16), stream)
    _build.check(lib, code, "tiled_spmm launch")
    tiled_spmm.launches += 1
    return out


def _sddmm_launch(te: TiledCOO, x, g, bf16: bool):
    """One launch of the SDDMM kernel over ``te.plan``'s real entries →
    ``[E]`` float32 in edge order (edges not in the structure 0: the
    output is zeroed first, the one other launch)."""
    m, plan = te.meta, _check_plan(te, x.device, "SDDMM")
    _check_operand("x", x, m.num_senders, x.device)
    _check_operand("g", g, m.num_receivers, x.device)
    if g.shape[1] != x.shape[1]:
        raise ValueError(f"x and g widths differ: {x.shape[1]} vs {g.shape[1]}")
    out = torch.zeros(m.num_edges, dtype=torch.float32, device=x.device)
    n_real = plan.counts[0]
    if n_real == 0 or x.shape[1] == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.kgcn_tiled_sddmm(plan.pointers()[0], x.data_ptr(), g.data_ptr(),
                                    out.data_ptr(), n_real, x.shape[1], int(bf16), stream)
    _build.check(lib, code, "tiled_sddmm launch")
    tiled_sddmm.launches += 1
    return out


def _spmm(te, weights, x, bf16):
    if x.is_cuda:
        return _spmm_launch(te, weights.contiguous(), x.contiguous(), bf16)
    return tiled_spmm_reference(te, weights, x, "bfloat16" if bf16 else "float32")


def _sddmm(te, x, g, bf16):
    if x.is_cuda:
        return _sddmm_launch(te, x.contiguous(), g.contiguous(), bf16)
    return tiled_sddmm_edges_reference(te, x, g, "bfloat16" if bf16 else "float32")


class _TiledSpMM(torch.autograd.Function):
    """``out = A(w) x`` with the JAX custom VJP's gradient pair: dx through
    the transpose structure, d(weights) through the SDDMM — computed only
    when asked for (a GCN's adjacency weights are constants)."""

    @staticmethod
    def forward(ctx, weights, x, te, bf16):
        weights = weights.to(torch.float32)
        x = x.to(torch.float32)
        ctx.te, ctx.bf16 = te, bf16
        ctx.save_for_backward(weights, x)
        return _spmm(te, weights, x, bf16)

    @staticmethod
    def backward(ctx, g):
        weights, x = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dw = dx = None
        if ctx.needs_input_grad[0]:
            dw = _sddmm(ctx.te, x, g, ctx.bf16)
        if ctx.needs_input_grad[1]:
            dx = _spmm(ctx.te.transpose, weights, g, ctx.bf16)
        return dw, dx, None, None


def tiled_spmm(te: TiledCOO, weights, x, *, compute_dtype="bfloat16"):
    """``out[r] = Σ_e w_e · x[s_e]``.  weights ``[E]`` (differentiable),
    x ``[num_senders, F]`` → ``[num_receivers, F]`` float32.  The CUDA
    kernel for CUDA tensors, the plain version for CPU tensors.  Requires
    ``te.transpose``; applies the locality permutation in and out."""
    if te.transpose is None:
        raise ValueError("tiled_spmm needs build_tiled(with_transpose=True)")
    if x.shape[0] != te.meta.num_senders:
        raise ValueError(f"x rows {x.shape[0]} != structure num_senders "
                         f"{te.meta.num_senders}")
    bf16 = is_bf16(compute_dtype)
    if te.node_perm is not None:
        x = x.index_select(0, te.node_perm.long())
    out = _TiledSpMM.apply(weights, x, te, bf16)
    if te.node_perm is not None:
        out = out.index_select(0, te.node_inv.long())
    return out


def tiled_sddmm(te: TiledCOO, a, b, *, compute_dtype="bfloat16"):
    """Per-edge inner products ``out[e] = ⟨a[r_e], b[s_e]⟩`` → ``[E]``
    float32 (edges dropped from the structure get 0)."""
    bf16 = is_bf16(compute_dtype)
    if te.node_perm is not None:
        perm = te.node_perm.long()
        a, b = a.index_select(0, perm), b.index_select(0, perm)
    return _sddmm(te, b.to(torch.float32), a.to(torch.float32), bf16)


tiled_spmm.launches = 0
tiled_sddmm.launches = 0
