"""Streaming scatter SpMM — the stream backend's sparse × dense product.

The counterpart of ``kgcn_tpu/ops/stream_spmm.py``: the same host-side edge
structure (``StreamCOO``, built by ``build_stream``) and the same device
function ``out[r] = Σ_e w_e · x[s_e]`` with its gradient pair (dx through the
transpose structure, d(weights) in slot order), by two routes chosen as the
JAX package chooses them (``stream_spmm``):

* the **static** route — the structure carries materialised bf16 weighted
  one-hots ``oh [slots, tr_w]`` (one per direction) and the payload is
  bf16: the window sum ``ohᵀ g`` per receiver window, forward and dx
  (``_StreamStatic``, JAX ``_core_static``);
* the **iota** route — slot-aligned f32 weights (baked ``w_slots`` or
  dynamic ones): per slot ``cdt(w)·cdt(x[s])``, forward and dx, and the
  weight gradient ``dw[slot] = ⟨cdt(dy[r_slot]), cdt(x[s_slot])⟩`` when it
  is asked for (``_StreamIota``, JAX ``_core``).

Under a trace (``torch.export``, ``runtime/export.py``) the routes are the
custom ops ``kgcn_torch::stream_scatter_mat`` and
``kgcn_torch::stream_scatter`` (``register_fake``, ``register_autograd``),
one call each, with the autograd Functions' launches.

Host side (NumPy): ``build_stream`` sorts the edges by receiver, cuts the
receivers into ``tr_w``-row windows, pads every window to whole sub-chunks
of ``chunk`` slots, groups ``wb`` windows into an output block and the
block's sub-chunks into macros of ``mc``; padding slots carry sender
``num_senders`` (the appended zero row) and weight 0.  The arrays equal the
JAX package's array for array.  The port adds a ``StreamPlan`` per direction
(``_build_plan``): the real slots cut into pieces of equal size for the CUDA
scatter kernels, with the receiver rows that pieces share, so a kernel's
time follows the real edges and not the largest in-degree; the
weight-gradient kernel walks the same entries (in the plan's pieces, or in
shorter spans on a small structure: ``_dw_span``).

Device side: on CUDA tensors the dispatchers ``stream_scatter``,
``stream_scatter_mat`` and ``stream_dw`` launch the hand-written Hopper
kernels of ``csrc/stream.cu``; on CPU tensors they compute the plain
versions ``stream_scatter_reference``, ``stream_scatter_mat_reference`` and
``stream_dw_reference``.  Neither falls back to the other.  Each dispatcher's
``launches`` counts its kernel's launches and nothing else.

Payload dtype (``compute_dtype``, config ``tiled_compute_dtype``): with
``"bfloat16"`` the gathered rows and the weights are rounded to bf16 (the
one-hots hold bf16 weights), each product is exact in f32 and the sums run
in f32; the dx pass rounds ``dy``, the weight gradient rounds ``dy`` and x.
``"float32"`` rounds nothing.  The plain versions sum each output row in
slot order; the scatter kernels in the plan's fixed order (pieces, then a
split row's partials), the weight-gradient kernel each slot's products in a
fixed order of columns (per lane, then across lanes), so two launches give
the same bits.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from kgcn_tpu_torch.ops import _build, pytrees
from kgcn_tpu_torch.ops.tiled_spmm import is_bf16


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# structure


@dataclasses.dataclass(frozen=True)
class StreamMeta:
    """Shape metadata of one stream edge structure (as in ``kgcn_tpu``)."""

    tr_w: int        # receiver-window rows
    chunk: int       # edge slots per sub-chunk
    mc: int          # sub-chunks per macro
    wb: int          # windows per output block
    n_macros: int
    n_rb: int        # output blocks
    num_senders: int
    num_receivers: int
    num_edges: int   # true E; the slot_src sentinel of padding slots

    @property
    def slots(self) -> int:
        return self.n_macros * self.mc * self.chunk

    @property
    def n_sub(self) -> int:
        return self.n_macros * self.mc


@dataclasses.dataclass
class StreamCOO:
    """Tensors of one stream edge structure (fields as in ``kgcn_tpu``).

    slot_sender: ``[slots]`` int32 sender per slot; padding slots hold
        ``num_senders``.
    r_loc: ``[slots, 1]`` int32 receiver row within the slot's window.
    slot_src: ``[slots]`` int32 original edge id; padding slots hold
        ``num_edges``.
    sub_wid: ``[n_sub, 1]`` int32 window of each sub-chunk within its block.
    macro_rb / macro_first: ``[n_macros]`` int32 output block of each macro /
        1 on a block's first macro.
    plan: the scatter kernels' ``StreamPlan`` of this direction's real slots.
    t_from_f: transpose only — ``[slots_T]`` forward slot of each transpose
        slot (``slots_F`` for padding).
    w_slots: ``[slots]`` float32 baked weights, or None.
    oh: ``[slots, tr_w]`` bfloat16 weighted one-hots, or None.  Each row
        holds at most one non-zero, at ``r_loc`` (``_materialize_oh``): the
        one-hot kernel reads only ``oh[slot, r_loc[slot]]``.
    transpose: the same edges sender-sorted (dx), or None.
    """

    slot_sender: torch.Tensor
    r_loc: torch.Tensor
    slot_src: torch.Tensor
    sub_wid: torch.Tensor
    macro_rb: torch.Tensor
    macro_first: torch.Tensor
    plan: "StreamPlan"
    meta: StreamMeta
    t_from_f: Optional[torch.Tensor] = None
    w_slots: Optional[torch.Tensor] = None
    oh: Optional[torch.Tensor] = None
    transpose: Optional["StreamCOO"] = None

    def replace(self, **changes) -> "StreamCOO":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "StreamCOO":
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, StreamCOO, StreamPlan)):
                moved[f.name] = v.to(device)
        return self.replace(**moved)


# pieces per CUDA block of the scatter kernels, one per warp (csrc/stream.cu's
# WARPS)
PIECES_PER_BLOCK = 8
# the piece size aims at about this many pieces a structure: 16 warps on each
# of the H100's 132 SMs, enough x-row gathers in flight to cover their latency
_TARGET_PIECES = 2048


def _piece_size(n_real: int) -> int:
    """Real slots per piece: a multiple of 32 (a warp's batch), 32-512."""
    return int(min(512, 32 * max(1, _cdiv(n_real, 32 * _TARGET_PIECES))))


@dataclasses.dataclass
class StreamPlan:
    """The stream kernels' cut of one direction's real slots (host-built by
    ``_build_plan``; the weight-gradient kernel walks the entries alone).
    Piece ``p`` is entries ``[p·piece, (p+1)·piece)``; a warp sums it in
    order, writing each receiver row that lies in this piece alone straight
    to the output, and the first and last rows, where other pieces share
    them, to partial rows.  A row whose slots span pieces
    ("split") is then the sum of its partials, taken in a fixed order by the
    last CUDA block of ``PIECES_PER_BLOCK`` pieces to write one of them.

    piece: real slots per piece.
    entries: ``[3, n_real]`` int32 slot, receiver row and sender of each real
        slot, in slot order (which sorts them by receiver row).
    pieces: ``[n_pieces, 4]`` int32 (split row, partial) of the piece's first
        row and of its last row; ``-1, -1`` where that row is whole in this
        piece, and for the last row where it is also the first.
    splits: ``[n_split, 4]`` int32 receiver row, first partial, partial count
        and number of blocks holding its partials, of each split row; its
        partials are consecutive, in piece order.
    empty_rows: ``[n_empty]`` int32 receiver rows without a real slot (the
        kernels write them as zeros).
    arrivals: ``[n_split]`` int32 count of the blocks that have written a
        split row's partials in the running launch; 0 between launches (the
        last block resets it), so launches on one structure must run in
        stream order.
    n_parts: number of partial rows (the launch's scratch).
    """

    piece: int
    entries: torch.Tensor
    pieces: torch.Tensor
    splits: torch.Tensor
    empty_rows: torch.Tensor
    arrivals: torch.Tensor
    n_parts: int

    def to(self, device) -> "StreamPlan":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device) for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def _build_plan(slot, rows, senders, num_receivers) -> StreamPlan:
    """The plan of real slots ``slot`` (ascending) with receiver rows
    ``rows`` (non-decreasing) and ``senders``."""
    n = len(slot)
    P = _piece_size(n)
    n_pieces = _cdiv(n, P)
    starts = np.arange(n_pieces) * P
    first = rows[starts]
    last = rows[np.minimum(starts + P, n) - 1]
    # a row is split where a piece ends in it and the next one starts in it
    split_rows = np.unique(first[1:][first[1:] == last[:-1]])
    has = np.stack([np.isin(first, split_rows),
                    np.isin(last, split_rows) & (last != first)], axis=1)
    # partials in (piece, first/last) order, i.e. by (row, piece)
    part = np.where(has, np.cumsum(has.ravel()).reshape(has.shape) - 1, -1)
    k = np.where(has, np.searchsorted(split_rows, np.stack([first, last], 1)), -1)
    k_of_part = k[has]
    part_piece = np.repeat(np.arange(n_pieces), 2)[has.ravel()]
    n_parts = len(k_of_part)
    off = np.searchsorted(k_of_part, np.arange(len(split_rows)))
    count = np.bincount(k_of_part, minlength=len(split_rows))
    blocks = (part_piece[off + count - 1] // PIECES_PER_BLOCK
              - part_piece[off] // PIECES_PER_BLOCK + 1)
    filled = np.zeros(num_receivers, bool)
    filled[rows] = True

    def i32(a, shape):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32).reshape(shape))

    return StreamPlan(
        piece=P,
        entries=i32(np.stack([slot, rows, senders]), (3, n)),
        pieces=i32(np.stack([k[:, 0], part[:, 0], k[:, 1], part[:, 1]], 1), (n_pieces, 4)),
        splits=i32(np.stack([split_rows, off, count, blocks], 1), (len(split_rows), 4)),
        empty_rows=i32(np.nonzero(~filled)[0], (-1,)),
        arrivals=torch.zeros(len(split_rows), dtype=torch.int32),
        n_parts=n_parts,
    )


def _build_one(s, r, eid, num_senders, num_receivers, num_edges,
               tr_w, chunk, mc, wb):
    """Pack one direction (``kgcn_tpu``'s ``_build_one``): sort by receiver,
    window by tr_w, chunk, macro-chunk.  Returns (structure, slot_src)."""
    E = len(s)
    order = np.argsort(r, kind="stable")
    s_sorted, r_sorted = s[order], r[order]
    eid_sorted = eid[order]
    rw = r_sorted // tr_w
    n_rw = max(_cdiv(num_receivers, tr_w), 1)
    n_rb = max(_cdiv(n_rw, wb), 1)
    n_rw_pad = n_rb * wb                       # windows incl. block padding
    counts = np.bincount(rw, minlength=n_rw_pad)
    sub_per_w = np.maximum(_cdiv(counts, chunk), 1)
    wblock = np.arange(n_rw_pad) // wb
    sub_base = np.concatenate([[0], np.cumsum(sub_per_w)])
    n_sub = int(sub_base[-1])
    sub_w = np.repeat(np.arange(n_rw_pad), sub_per_w)
    subs_per_block = np.bincount(wblock[sub_w], minlength=n_rb)
    macros_per_block = np.maximum(_cdiv(subs_per_block, mc), 1)
    n_macros = int(macros_per_block.sum())
    total_subs = n_macros * mc
    block_sub_base = np.concatenate([[0], np.cumsum(macros_per_block * mc)])
    sub_block = wblock[sub_w]
    first_in_block = np.searchsorted(sub_block, sub_block, side="left")
    sub_rank = np.arange(n_sub) - first_in_block
    sub_pos = block_sub_base[sub_block] + sub_rank

    slots = total_subs * chunk
    slot_sender = np.full(slots, num_senders, np.int32)
    r_loc = np.zeros(slots, np.int32)
    slot_src = np.full(slots, num_edges, np.int32)
    sub_wid = np.zeros(total_subs, np.int32)
    sub_wid[sub_pos] = (sub_w % wb).astype(np.int32)

    wstart = np.concatenate([[0], np.cumsum(counts)])
    rank = np.arange(E) - wstart[rw]
    edge_sub = sub_base[rw] + rank // chunk
    slot = sub_pos[edge_sub] * chunk + rank % chunk
    slot_sender[slot] = s_sorted
    r_loc[slot] = (r_sorted % tr_w).astype(np.int32)
    slot_src[slot] = eid_sorted

    macro_rb = np.repeat(np.arange(n_rb), macros_per_block).astype(np.int32)
    macro_first = np.zeros(n_macros, np.int32)
    if n_macros:
        macro_first[0] = 1
        macro_first[1:][macro_rb[1:] != macro_rb[:-1]] = 1

    meta = StreamMeta(
        tr_w=tr_w, chunk=chunk, mc=mc, wb=wb, n_macros=n_macros, n_rb=n_rb,
        num_senders=num_senders, num_receivers=num_receivers,
        num_edges=num_edges,
    )
    return StreamCOO(
        slot_sender=torch.from_numpy(slot_sender),
        r_loc=torch.from_numpy(r_loc.reshape(-1, 1)),
        slot_src=torch.from_numpy(slot_src),
        sub_wid=torch.from_numpy(sub_wid.reshape(-1, 1)),
        macro_rb=torch.from_numpy(macro_rb),
        macro_first=torch.from_numpy(macro_first),
        plan=_build_plan(slot, r_sorted, s_sorted, num_receivers),
        meta=meta,
    ), slot_src


# one-hot materialisation budget: slots × tr_w × 2 bytes per direction
# (kgcn_tpu's, so both packages pick the same route)
_MATERIALIZE_BUDGET_BYTES = 512 * 1024 * 1024


def build_stream(senders, receivers, num_nodes: int, *, weights=None,
                 num_sender_nodes: Optional[int] = None, tr_w: int = 64,
                 chunk: int = 64, mc: int = 24, wb: int = 16,
                 with_transpose: bool = True,
                 macro_budget: Optional[int] = None, materialize="auto",
                 valid_mask=None) -> StreamCOO:
    """Build the stream chunk structure on the host.

    Arguments as ``kgcn_tpu.ops.stream_spmm.build_stream``: ``weights``
    ([E]) bakes slot-aligned weights into both directions and, without
    ``valid_mask``, drops the zero-weight (padding) edges; ``valid_mask``
    names the padding edges instead.  ``macro_budget`` pads the macro list to
    a fixed length.  ``materialize`` ("auto", True, False; baked weights
    only) builds the bf16 one-hots, "auto" when they fit 512 MB a direction.
    The JAX package's compiled-TPU check that ``mc`` be a multiple of 8 does
    not apply here."""
    if tr_w % 8 or chunk % 8:
        raise ValueError("tr_w and chunk must be multiples of 8")
    s = np.asarray(senders).astype(np.int64)
    r = np.asarray(receivers).astype(np.int64)
    num_edges = len(s)
    w_np = np.asarray(weights, np.float32) if weights is not None else None
    if valid_mask is not None:
        valid = np.asarray(valid_mask) != 0
    elif w_np is not None:
        valid = w_np != 0
    else:
        valid = np.ones(num_edges, bool)
    eid = np.arange(num_edges, dtype=np.int32)[valid]
    s_v, r_v = s[valid], r[valid]
    n_send = num_sender_nodes if num_sender_nodes is not None else num_nodes

    fwd, slot_src_f = _build_one(s_v, r_v, eid, n_send, num_nodes, num_edges,
                                 tr_w, chunk, mc, wb)
    if macro_budget is not None:
        fwd = _pad_macros(fwd, macro_budget)
        slot_src_f = fwd.slot_src.numpy()
    if w_np is not None:
        w_ext = np.concatenate([w_np, np.zeros(1, np.float32)])
        fwd = fwd.replace(w_slots=torch.from_numpy(w_ext[slot_src_f]))
        if _should_materialize(fwd.meta, materialize):
            fwd = fwd.replace(oh=_materialize_oh(fwd, w_ext[slot_src_f]))
    if with_transpose:
        bwd, slot_src_t = _build_one(r_v, s_v, eid, num_nodes, n_send,
                                     num_edges, tr_w, chunk, mc, wb)
        if macro_budget is not None:
            bwd = _pad_macros(bwd, macro_budget)
            slot_src_t = bwd.slot_src.numpy()
        # forward slot of each transpose slot (sentinel: slots_F)
        slots_f = fwd.meta.slots
        f_slot_of_edge = np.full(num_edges + 1, slots_f, np.int64)
        valid_f = slot_src_f != num_edges
        f_slot_of_edge[slot_src_f[valid_f]] = np.nonzero(valid_f)[0]
        t_from_f = f_slot_of_edge[slot_src_t].astype(np.int32)
        bwd = bwd.replace(t_from_f=torch.from_numpy(t_from_f))
        if w_np is not None:
            bwd = bwd.replace(w_slots=torch.from_numpy(w_ext[slot_src_t]))
            if _should_materialize(bwd.meta, materialize):
                bwd = bwd.replace(oh=_materialize_oh(bwd, w_ext[slot_src_t]))
        fwd = fwd.replace(transpose=bwd)
    return fwd


def _should_materialize(meta: StreamMeta, materialize) -> bool:
    if materialize is False:
        return False
    if materialize == "auto":
        return meta.slots * meta.tr_w * 2 <= _MATERIALIZE_BUDGET_BYTES
    return True


def _materialize_oh(ss: StreamCOO, w_slots_np) -> torch.Tensor:
    """``[slots, tr_w]`` bf16 weighted one-hot (padding slots all zero)."""
    m = ss.meta
    oh = torch.zeros((m.slots, m.tr_w), dtype=torch.float32)
    oh[torch.arange(m.slots), ss.r_loc.reshape(-1).long()] = torch.from_numpy(
        np.asarray(w_slots_np, np.float32))
    return oh.to(torch.bfloat16)


def _pad_macros(ss: StreamCOO, budget: int) -> StreamCOO:
    """Pad the macro list to ``budget`` macros.  Fillers revisit the last
    output block with all-padding slots, a no-op.  Raises if the budget is
    short."""
    m = ss.meta
    if m.n_macros > budget:
        raise ValueError(f"macro budget {budget} < required {m.n_macros}")
    pad = budget - m.n_macros
    if pad == 0:
        return ss
    spad = pad * m.mc * m.chunk
    last_rb = int(ss.macro_rb[-1]) if m.n_macros else 0

    def fill(value, shape):
        return torch.full(shape, value, dtype=torch.int32)

    return ss.replace(
        slot_sender=torch.cat([ss.slot_sender, fill(m.num_senders, (spad,))]),
        r_loc=torch.cat([ss.r_loc, fill(0, (spad, 1))]),
        slot_src=torch.cat([ss.slot_src, fill(m.num_edges, (spad,))]),
        sub_wid=torch.cat([ss.sub_wid, fill(0, (pad * m.mc, 1))]),
        macro_rb=torch.cat([ss.macro_rb, fill(last_rb, (pad,))]),
        macro_first=torch.cat([ss.macro_first, fill(0, (pad,))]),
        meta=dataclasses.replace(m, n_macros=budget),
    )


def choose_stream(senders, receivers, num_nodes: int, feature_dim: int) -> dict:
    """``kgcn_tpu``'s default parameters, its TPU sweep optimum at
    V=100k/E=1M/F=128 (kept so both packages build the same structures)."""
    return dict(tr_w=64, chunk=64, mc=24, wb=16)


def edge_to_slot(ss: StreamCOO, values, fill=0.0) -> np.ndarray:
    """Host side: an original-edge-order array realigned to slot order."""
    v = np.asarray(values)
    ext = np.concatenate([v, np.full((1,), fill, v.dtype)])
    return ext[ss.slot_src.cpu().numpy()]


def transpose_w_slots(ss: StreamCOO, w_slots) -> torch.Tensor:
    """Slot-ordered weights realigned to the transpose structure's slots
    (dynamic weights only; baked structures carry both)."""
    if ss.transpose is None or ss.transpose.t_from_f is None:
        raise ValueError("transpose_w_slots needs build_stream(with_transpose=True)")
    we = torch.cat([w_slots.to(torch.float32), w_slots.new_zeros(1, dtype=torch.float32)])
    return we[ss.transpose.t_from_f.long()]


# ---------------------------------------------------------------------------
# plain versions (CPU path; the yardstick of the kernels on the card)


def _rb(t: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 and back (round to nearest even)."""
    return t.to(torch.bfloat16).to(torch.float32)


def _slot_rows(ss: StreamCOO):
    """(real-slot mask, sender, receiver row) of every slot: the receiver
    row is ``(macro_rb·wb + sub_wid)·tr_w + r_loc``."""
    m = ss.meta
    dev = ss.slot_sender.device
    sub = torch.arange(m.slots, device=dev) // m.chunk
    rb = ss.macro_rb.long()[sub // m.mc]
    wid = ss.sub_wid.reshape(-1).long()[sub]
    recv = (rb * m.wb + wid) * m.tr_w + ss.r_loc.reshape(-1).long()
    send = ss.slot_sender.long()
    return send < m.num_senders, send, recv


def _out_rows(m: StreamMeta) -> int:
    return m.n_rb * m.wb * m.tr_w


def stream_scatter_reference(ss: StreamCOO, w_slots, x, compute_dtype="bfloat16"):
    """Plain version of the iota-route kernel: per real slot the message
    ``cdt(w)·cdt(x[s])`` (exact in f32), summed into its receiver in f32.
    w_slots ``[slots]``, x ``[num_senders, F]`` → ``[num_receivers, F]``."""
    m = ss.meta
    valid, send, recv = _slot_rows(ss)
    xs = x.to(torch.float32)[send[valid]]
    w = w_slots.to(torch.float32)[valid]
    if is_bf16(compute_dtype):
        xs, w = _rb(xs), _rb(w)
    out = torch.zeros((_out_rows(m), x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, recv[valid], w[:, None] * xs)
    return out[: m.num_receivers]


def stream_scatter_mat_reference(ss: StreamCOO, oh, x):
    """Plain version of the static-route kernel: the window sums ``ohᵀ g``
    with ``g = bf16(x[slot_sender])``, over the non-zero one-hot entries in
    slot order.  oh ``[slots, tr_w]`` bf16 → ``[num_receivers, F]`` f32."""
    m = ss.meta
    _, send, recv = _slot_rows(ss)
    base = recv - ss.r_loc.reshape(-1).long()
    nz_slot, nz_row = torch.nonzero(oh, as_tuple=True)   # slot-major order
    x_ext = torch.cat([x.to(torch.float32), x.new_zeros((1, x.shape[1]),
                                                        dtype=torch.float32)])
    g = _rb(x_ext[send[nz_slot]])
    msg = oh[nz_slot, nz_row].to(torch.float32)[:, None] * g
    out = torch.zeros((_out_rows(m), x.shape[1]), dtype=torch.float32, device=x.device)
    out.index_add_(0, base[nz_slot] + nz_row, msg)
    return out[: m.num_receivers]


def stream_dw_reference(ss: StreamCOO, x, dy, compute_dtype="bfloat16"):
    """Plain version of the weight-gradient kernel: per real slot
    ``⟨cdt(dy[r]), cdt(x[s])⟩`` summed in f32, 0 in padding slots → ``[slots]``."""
    m = ss.meta
    valid, send, recv = _slot_rows(ss)
    xs = x.to(torch.float32)[send[valid]]
    dr = dy.to(torch.float32)[recv[valid]]
    if is_bf16(compute_dtype):
        xs, dr = _rb(xs), _rb(dr)
    out = torch.zeros(m.slots, dtype=torch.float32, device=x.device)
    out[valid] = (xs * dr).sum(dim=1)
    return out


# ---------------------------------------------------------------------------
# CUDA kernels (csrc/stream.cu)


def _lib():
    lib = _build.load("stream")
    if lib.kgcn_stream_scatter.argtypes is None:
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kgcn_stream_scatter.argtypes = [ptr] * 9 + [i32] * 7 + [ptr]
        lib.kgcn_stream_scatter.restype = ctypes.c_int
        lib.kgcn_stream_dw.argtypes = [ptr] * 4 + [i32] * 3 + [i64] + [i32] * 2 + [ptr]
        lib.kgcn_stream_dw.restype = ctypes.c_int
    return lib


def _check_ints(obj, names, device):
    for name in names:
        t = getattr(obj, name)
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != device:
            raise ValueError(f"{type(obj).__name__}.{name} must be contiguous int32 "
                             f"on {device} (got {t.dtype} on {t.device})")


def _check_operand(name, t, shape, dtype, device):
    if (t.dtype != dtype or not t.is_contiguous() or t.device != device
            or tuple(t.shape) != tuple(shape)):
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


# the scatter kernel's weight source (csrc/stream.cu's kgcn_stream_scatter)
_W_F32, _W_BF16, _W_ONEHOT = 0, 1, 2


def _scatter_plan_launch(ss: StreamCOO, weights, x, mode: int):
    """One launch of the scatter kernel over ``ss.plan`` → ``[num_receivers,
    F]`` f32; ``weights`` are the slot weights (modes f32, bf16) or the
    one-hots (mode one-hot)."""
    m, plan = ss.meta, ss.plan
    dev = x.device
    _check_ints(plan, ("entries", "pieces", "splits", "empty_rows", "arrivals"), dev)
    _check_operand("x", x, (m.num_senders, x.shape[1]), torch.float32, dev)
    F = x.shape[1]
    out = torch.empty((m.num_receivers, F), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    part = torch.empty((plan.n_parts, F), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.kgcn_stream_scatter(
            plan.entries.data_ptr(), plan.pieces.data_ptr(), plan.splits.data_ptr(),
            plan.empty_rows.data_ptr(), plan.arrivals.data_ptr(), weights.data_ptr(),
            x.data_ptr(), out.data_ptr(), part.data_ptr(), plan.entries.shape[1],
            plan.pieces.shape[0], plan.empty_rows.shape[0], plan.piece, m.tr_w, F,
            mode, stream)
    _build.check(lib, code, "stream_scatter launch")
    return out


def _scatter_launch(ss: StreamCOO, w_slots, x, bf16: bool):
    """One launch of the iota-route kernel → ``[num_receivers, F]`` f32."""
    _check_operand("w_slots", w_slots, (ss.meta.slots,), torch.float32, x.device)
    out = _scatter_plan_launch(ss, w_slots, x, _W_BF16 if bf16 else _W_F32)
    stream_scatter.launches += 1
    return out


def _scatter_mat_launch(ss: StreamCOO, x):
    """One launch of the static-route kernel on ``ss.oh`` → f32."""
    m = ss.meta
    _check_operand("oh", ss.oh, (m.slots, m.tr_w), torch.bfloat16, x.device)
    out = _scatter_plan_launch(ss, ss.oh, x, _W_ONEHOT)
    stream_scatter_mat.launches += 1
    return out


# entries a warp of the weight-gradient kernel keeps in flight where one
# lane group is the whole warp (F > 64; csrc/stream.cu's DW_BATCH)
_DW_BATCH = 8


def _dw_span(plan: StreamPlan, F: int) -> int:
    """Entries a warp of the weight-gradient kernel walks: the plan's piece;
    where the plan has fewer than ``_TARGET_PIECES`` pieces and F > 64 (a
    lane group of 32 lanes, ``_DW_BATCH`` entries in flight), a multiple of
    ``_DW_BATCH`` down to it, so that about ``_TARGET_PIECES`` warps share a
    small structure's entries.  (Narrower F packs 32 entries in flight into
    a warp, the plan's smallest piece.)"""
    n_real = plan.entries.shape[1]
    if F <= 64 or _cdiv(n_real, plan.piece) >= _TARGET_PIECES:
        return plan.piece
    return min(plan.piece, _DW_BATCH * max(1, _cdiv(n_real, _DW_BATCH * _TARGET_PIECES)))


def _dw_launch(ss: StreamCOO, x, dy, bf16: bool):
    """One launch of the weight-gradient kernel over ``ss.plan``'s real
    entries in spans of ``_dw_span`` → ``[slots]`` f32, every padding slot
    written as 0 in the same launch."""
    m, plan = ss.meta, ss.plan
    dev = x.device
    _check_ints(plan, ("entries",), dev)
    _check_operand("x", x, (m.num_senders, x.shape[1]), torch.float32, dev)
    _check_operand("dy", dy, (m.num_receivers, x.shape[1]), torch.float32, dev)
    out = torch.empty(m.slots, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    lib = _lib()
    n_real, span = plan.entries.shape[1], _dw_span(plan, x.shape[1])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.kgcn_stream_dw(
            plan.entries.data_ptr(), x.data_ptr(), dy.data_ptr(), out.data_ptr(),
            n_real, _cdiv(n_real, span), span, m.slots, x.shape[1], int(bf16), stream)
    _build.check(lib, code, "stream_dw launch")
    stream_dw.launches += 1
    return out


def _dtype_name(bf16: bool) -> str:
    return "bfloat16" if bf16 else "float32"


def stream_scatter(ss: StreamCOO, w_slots, x, bf16: bool):
    """Iota-route product: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if x.is_cuda:
        return _scatter_launch(ss, w_slots.contiguous(), x.contiguous(), bf16)
    return stream_scatter_reference(ss, w_slots, x, _dtype_name(bf16))


def stream_scatter_mat(ss: StreamCOO, x):
    """Static-route product over ``ss.oh``: kernel or plain version."""
    if x.is_cuda:
        return _scatter_mat_launch(ss, x.contiguous())
    return stream_scatter_mat_reference(ss, ss.oh, x)


def stream_dw(ss: StreamCOO, x, dy, bf16: bool):
    """Per-slot weight gradient: kernel or plain version."""
    if x.is_cuda:
        return _dw_launch(ss, x.contiguous(), dy.contiguous(), bf16)
    return stream_dw_reference(ss, x, dy, _dtype_name(bf16))


stream_scatter.launches = 0
stream_scatter_mat.launches = 0
stream_dw.launches = 0


# ---------------------------------------------------------------------------
# differentiable routes


class _StreamIota(torch.autograd.Function):
    """``out = A(w) x`` over slot-aligned weights (JAX ``_core``): dx by the
    same kernel on the transpose structure, dw by the weight-gradient kernel
    only when asked for (JAX always traces it); the transpose weights get no
    gradient (JAX returns zeros)."""

    @staticmethod
    def forward(ctx, w_slots, wT_slots, x, ss, bf16):
        ctx.ss, ctx.bf16 = ss, bf16
        ctx.save_for_backward(wT_slots, x)
        return stream_scatter(ss, w_slots, x, bf16)

    @staticmethod
    def backward(ctx, dy):
        wT_slots, x = ctx.saved_tensors
        dw, dx = _iota_grads(ctx.ss, wT_slots, x, dy, ctx.bf16,
                             ctx.needs_input_grad[0], ctx.needs_input_grad[2])
        return dw, None, dx, None, None


def _iota_grads(ss, wT_slots, x, dy, bf16, need_w, need_x):
    """(dw, dx) of the iota route, each only when asked for: the weight
    gradient kernel, and the scatter on the transpose structure."""
    dy = dy.to(torch.float32).contiguous()
    dw = stream_dw(ss, x, dy, bf16) if need_w else None
    dx = stream_scatter(ss.transpose, wT_slots, dy, bf16) if need_x else None
    return dw, dx


class _StreamStatic(torch.autograd.Function):
    """Static-weight route over the materialised one-hots (JAX
    ``_core_static``): dx by the same kernel on the transpose one-hots; the
    weights are constants."""

    @staticmethod
    def forward(ctx, x, ss):
        ctx.ss = ss
        return stream_scatter_mat(ss, x)

    @staticmethod
    def backward(ctx, dy):
        return stream_scatter_mat(ctx.ss.transpose, dy.to(torch.float32).contiguous()), None


# The custom ops kgcn_torch::stream_scatter (the iota route) and
# kgcn_torch::stream_scatter_mat (the one-hot route): what a trace
# (``torch.export``) records in place of ``_StreamIota`` and
# ``_StreamStatic``, with the same launches forward and backward; eager
# calls keep the autograd Functions (as ops they made a GCN step on the
# stream loop 1.8 ms slower, H100 80GB HBM3 at 700 W, ``tree_compare.py``).
# A ``StreamCOO`` and its ``StreamPlan`` go in as the structure's pytree
# leaves, both directions (the backward's dx runs on the transpose), and
# its tree spec as a string (``ops/pytrees.py``).  A plan's lengths are its
# arrays' shapes.

_CHILDREN = ("slot_sender", "r_loc", "slot_src", "sub_wid", "macro_rb", "macro_first",
             "plan", "t_from_f", "w_slots", "oh", "transpose")
_PLAN_CHILDREN = ("entries", "pieces", "splits", "empty_rows", "arrivals")


def register_pytrees() -> None:
    """Register ``StreamCOO`` and ``StreamPlan`` with torch's pytree (once):
    the meta and a plan's piece size are contexts; a plan's partial rows
    come back at their bound, two a piece."""
    pytrees.register(StreamCOO, "kgcn_tpu_torch.StreamCOO",
                     lambda s: (_CHILDREN, [getattr(s, n) for n in _CHILDREN]),
                     lambda s: dataclasses.astuple(s.meta),
                     lambda values, ctx: StreamCOO(meta=StreamMeta(*ctx),
                                                   **dict(zip(_CHILDREN, values))))
    pytrees.register(StreamPlan, "kgcn_tpu_torch.StreamPlan",
                     lambda p: (_PLAN_CHILDREN, [getattr(p, n) for n in _PLAN_CHILDREN]),
                     lambda p: (p.piece,),
                     lambda values, ctx: StreamPlan(
                         piece=ctx[0], n_parts=2 * values[1].shape[0],
                         **dict(zip(_PLAN_CHILDREN, values))))


def _out_fake(x, arrays, spec):
    num_receivers = pytrees.from_op_args(arrays, spec).meta.num_receivers
    return x.new_empty((num_receivers, x.shape[1]), dtype=torch.float32)


@torch.library.custom_op("kgcn_torch::stream_scatter", mutates_args=())
def _stream_op(w_slots: torch.Tensor, wT_slots: torch.Tensor, x: torch.Tensor,
               arrays: List[Optional[torch.Tensor]], spec: str, bf16: bool) -> torch.Tensor:
    """``out = A(w) x`` over slot-aligned weights (JAX ``_core``): the
    iota-route kernel for CUDA tensors, the plain version for CPU tensors."""
    return stream_scatter(pytrees.from_op_args(arrays, spec), w_slots, x, bf16)


@_stream_op.register_fake
def _stream_fake(w_slots, wT_slots, x, arrays, spec, bf16):
    return _out_fake(x, arrays, spec)


def _stream_setup(ctx, inputs, output):
    w_slots, wT_slots, x, arrays, spec, bf16 = inputs
    ctx.spec, ctx.bf16 = spec, bf16
    ctx.save_for_backward(wT_slots, x, *arrays)


def _stream_backward(ctx, dy):
    wT_slots, x, *arrays = ctx.saved_tensors
    dw, dx = _iota_grads(pytrees.from_op_args(arrays, ctx.spec), wT_slots, x, dy, ctx.bf16,
                         ctx.needs_input_grad[0], ctx.needs_input_grad[2])
    return dw, None, dx, None, None, None


_stream_op.register_autograd(_stream_backward, setup_context=_stream_setup)


@torch.library.custom_op("kgcn_torch::stream_scatter_mat", mutates_args=())
def _stream_mat_op(x: torch.Tensor, arrays: List[Optional[torch.Tensor]],
                   spec: str) -> torch.Tensor:
    """Static-weight route over the materialised one-hots (JAX
    ``_core_static``): the one-hot kernel for CUDA tensors, the plain
    version for CPU tensors; the weights are constants."""
    return stream_scatter_mat(pytrees.from_op_args(arrays, spec), x)


@_stream_mat_op.register_fake
def _stream_mat_fake(x, arrays, spec):
    return _out_fake(x, arrays, spec)


def _stream_mat_setup(ctx, inputs, output):
    x, arrays, spec = inputs
    ctx.spec = spec
    ctx.save_for_backward(*arrays)


def _stream_mat_backward(ctx, dy):
    ss = pytrees.from_op_args(ctx.saved_tensors, ctx.spec)
    return stream_scatter_mat(ss.transpose, dy.to(torch.float32).contiguous()), None, None


_stream_mat_op.register_autograd(_stream_mat_backward, setup_context=_stream_mat_setup)


def _op_args(ss):
    register_pytrees()
    return pytrees.op_args(ss)


def _static(x, ss):
    if torch.compiler.is_compiling():
        return _stream_mat_op(x, *_op_args(ss))
    return _StreamStatic.apply(x, ss)


def stream_spmm(ss: StreamCOO, w_slots=None, x=None, *, wT_slots=None,
                compute_dtype="bfloat16"):
    """``out[r] = Σ_e w_e · x[s_e]`` → ``[num_receivers, F]`` float32.

    ``w_slots``: ``[slots]`` slot-aligned weights (differentiable), or None
    for the structure's baked weights.  Baked weights take the static route
    when the structure has one-hots in both directions and the payload is
    bf16 (their dtype), as in ``kgcn_tpu``; everything else takes the iota
    route.  x ``[num_senders, F]``."""
    if ss.transpose is None:
        raise ValueError("stream_spmm needs build_stream(with_transpose=True)")
    if x.shape[0] != ss.meta.num_senders:
        raise ValueError(f"x rows {x.shape[0]} != num_senders {ss.meta.num_senders}")
    bf16 = is_bf16(compute_dtype)
    if (w_slots is None and ss.oh is not None and ss.transpose.oh is not None
            and bf16):
        return _static(x.to(torch.float32), ss)
    if w_slots is None:
        if ss.w_slots is None:
            raise ValueError("no weights given or baked in")
        w_slots = ss.w_slots
        if wT_slots is None:
            wT_slots = ss.transpose.w_slots
    if wT_slots is None:
        wT_slots = transpose_w_slots(ss, w_slots)
    args = (w_slots.to(torch.float32), wT_slots.to(torch.float32), x.to(torch.float32))
    if torch.compiler.is_compiling():
        return _stream_op(*args, *_op_args(ss), bf16)
    return _StreamIota.apply(*args, ss, bf16)


def stream_spmm_edges(ss: StreamCOO, weights, x, *, compute_dtype="bfloat16"):
    """Weights in original edge order (``[E]``, differentiable), realigned to
    both directions' slots with one gather each."""
    we = torch.cat([weights.to(torch.float32),
                    weights.new_zeros(1, dtype=torch.float32)])
    w_slots = we[ss.slot_src.long()]
    wT_slots = we[ss.transpose.slot_src.long()]
    return stream_spmm(ss, w_slots, x, wT_slots=wT_slots, compute_dtype=compute_dtype)


@dataclasses.dataclass
class BakedStream:
    """A static-weight structure frozen for closure-style use (``kgcn_tpu``'s
    ``BakedStream``).  The JAX package bakes the integer arrays into the
    compiled program as constants; a CUDA launch has no such constants, so
    this only holds the structure with its one-hots."""

    ss: StreamCOO

    @property
    def oh(self):
        return self.ss.oh

    @property
    def ohT(self):
        return self.ss.transpose.oh

    @property
    def meta(self):
        return self.ss.meta

    @property
    def metaT(self):
        return self.ss.transpose.meta


def bake_stream(ss: StreamCOO) -> BakedStream:
    """Freeze a static-weight structure (both directions need one-hots)."""
    if ss.oh is None or ss.transpose is None or ss.transpose.oh is None:
        raise ValueError("bake_stream needs one-hots in both directions "
                         "(build_stream with weights and materialize)")
    return BakedStream(ss)


def stream_spmm_baked(bs: BakedStream, x):
    """Static-weight product through a baked structure: the static route."""
    if x.shape[0] != bs.meta.num_senders:
        raise ValueError(f"x rows {x.shape[0]} != num_senders {bs.meta.num_senders}")
    return _static(x.to(torch.float32), bs.ss)
