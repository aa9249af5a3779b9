"""Tiled sparse × dense product and its sampled dense-dense gradient.

The counterpart of ``kgcn_tpu/ops/tiled_spmm.py``: the same host-side edge
structure (``TiledCOO``) and the same two device operations,

* ``tiled_spmm(te, weights, x)`` — ``out[r] = Σ_e w_e · x[s_e]``, with a
  custom backward (``_TiledSpMM``): dx is the same kernel on the transpose
  structure and d(weights) is the SDDMM, as the JAX custom VJP ``_core``
  (``tiled_spmm.py:477-508``) computes them;
* ``tiled_sddmm(te, a, b)`` — ``out[e] = ⟨a[r_e], b[s_e]⟩``.

Host side (NumPy, per batch): ``build_tiled`` sorts the edges by
(receiver tile, sender tile) and packs them into fixed-size chunks that never
cross a tile pair; ``choose_tiling`` picks ``(ts, tr, chunk)`` with the JAX
package's TPU cost model, kept unchanged so both packages build the same
arrays (a tiling chosen for the GPU is later work, ROADMAP.md B.2).

Device side: on CUDA tensors the wrappers launch the hand-written Hopper
kernels of ``csrc/tiled.cu``; on CPU tensors they compute the plain versions
``tiled_spmm_reference`` / ``tiled_sddmm_reference``.  Neither falls back to
the other.  ``tiled_spmm.launches`` and ``tiled_sddmm.launches`` count kernel
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

    def replace(self, **changes) -> "TiledCOO":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "TiledCOO":
        moved = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, TiledCOO)):
                moved[f.name] = v.to(device)
        return self.replace(**moved)


def _build_arrays(s, r, eid, num_senders, num_receivers, num_edges,
                  ts, tr, chunk) -> TiledCOO:
    """Vectorised host-side packing of one direction (``kgcn_tpu``'s
    ``_build_arrays``).  s/r/eid are the kept edges; eid maps back to the
    original edge positions."""
    n_st = max(_cdiv(num_senders, ts), 1)
    n_rt = max(_cdiv(num_receivers, tr), 1)
    key = (r // tr).astype(np.int64) * n_st + s // ts
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]

    # pairs present, their counts, and each edge's rank within its pair
    pair_keys, pair_counts = np.unique(key_sorted, return_counts=True)
    first_idx = np.searchsorted(key_sorted, key_sorted, side="left")
    rank = np.arange(len(order), dtype=np.int64) - first_idx

    # every receiver tile owns ≥ 1 chunk, so its output rows get zeroed
    present_rt = np.unique(pair_keys // n_st)
    missing_rt = np.setdiff1d(np.arange(n_rt, dtype=np.int64), present_rt,
                              assume_unique=True)
    all_keys = np.concatenate([pair_keys, missing_rt * n_st])  # filler st=0
    all_counts = np.concatenate([pair_counts, np.zeros(len(missing_rt), np.int64)])
    porder = np.argsort(all_keys, kind="stable")
    all_keys, all_counts = all_keys[porder], all_counts[porder]
    chunks_per_pair = np.maximum(_cdiv(all_counts, chunk), 1)
    chunk_base = np.concatenate([[0], np.cumsum(chunks_per_pair)])
    n_chunks = int(chunk_base[-1])

    chunk_rt = np.repeat(all_keys // n_st, chunks_per_pair).astype(np.int32)
    chunk_st = np.repeat(all_keys % n_st, chunks_per_pair).astype(np.int32)

    # slot of each sorted edge = (base chunk of its pair)·chunk + rank
    slot = chunk_base[np.searchsorted(all_keys, key_sorted)] * chunk + rank
    slot_src = np.full(n_chunks * chunk, num_edges, np.int32)
    s_loc = np.zeros(n_chunks * chunk, np.int32)
    r_loc = np.zeros(n_chunks * chunk, np.int32)
    slot_src[slot] = eid[order]
    s_loc[slot] = (s[order] % ts).astype(np.int32)
    r_loc[slot] = (r[order] % tr).astype(np.int32)

    meta = TiledMeta(ts=ts, tr=tr, chunk=chunk, n_chunks=n_chunks, n_st=n_st,
                     n_rt=n_rt, num_senders=num_senders,
                     num_receivers=num_receivers, num_edges=num_edges)
    return TiledCOO(
        s_loc=torch.from_numpy(s_loc.reshape(n_chunks, chunk)),
        r_loc=torch.from_numpy(r_loc.reshape(n_chunks, chunk)),
        slot_src=torch.from_numpy(slot_src.reshape(n_chunks, chunk)),
        chunk_rt=torch.from_numpy(chunk_rt),
        chunk_st=torch.from_numpy(chunk_st),
        meta=meta,
    )


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

    te = _build_arrays(s_v, r_v, eid, n_send, num_nodes, num_edges, ts, tr, chunk)
    if chunk_budget is not None:
        te = _pad_chunks(te, chunk_budget)
    if with_transpose:
        tt = _build_arrays(r_v, s_v, eid, num_nodes, n_send, num_edges, tr, ts, chunk)
        if chunk_budget is not None:
            tt = _pad_chunks(tt, chunk_budget)
        te = te.replace(transpose=tt)
    if perm is not None:
        te = te.replace(node_perm=torch.from_numpy(perm.astype(np.int32)),
                        node_inv=torch.from_numpy(inv.astype(np.int32)))
    # after padding: the sentinel of a dropped edge is the FINAL slot count
    return te.replace(edge_slot=torch.from_numpy(_slot_of_edge_np(te)))


def _slot_of_edge_np(te: TiledCOO) -> np.ndarray:
    """[E] int32 flat slot of each original edge; dropped edges carry the
    slot count (the index of the appended zero)."""
    m = te.meta
    total = m.n_chunks * m.chunk
    src = te.slot_src.numpy().reshape(-1)
    out = np.full((m.num_edges + 1,), total, np.int64)
    out[src] = np.arange(total, dtype=np.int64)
    return out[: m.num_edges].astype(np.int32)


def _pad_chunks(te: TiledCOO, budget: int) -> TiledCOO:
    """Pad the chunk list to ``budget`` chunks.  Fillers repeat the last
    chunk's (rt, st) with all-padding slots, so they add nothing to the last
    receiver tile.  Raises if the budget is short."""
    m = te.meta
    if m.n_chunks > budget:
        raise ValueError(f"chunk budget {budget} < required {m.n_chunks}; "
                         "raise the budget or the chunk size")
    pad = budget - m.n_chunks
    if pad == 0:
        return te
    last_rt = int(te.chunk_rt[-1]) if m.n_chunks else 0
    last_st = int(te.chunk_st[-1]) if m.n_chunks else 0

    def fill(value, shape):
        return torch.full(shape, value, dtype=torch.int32)

    return TiledCOO(
        s_loc=torch.cat([te.s_loc, fill(0, (pad, m.chunk))]),
        r_loc=torch.cat([te.r_loc, fill(0, (pad, m.chunk))]),
        slot_src=torch.cat([te.slot_src, fill(m.num_edges, (pad, m.chunk))]),
        chunk_rt=torch.cat([te.chunk_rt, fill(last_rt, (pad,))]),
        chunk_st=torch.cat([te.chunk_st, fill(last_st, (pad,))]),
        meta=dataclasses.replace(m, n_chunks=budget),
        transpose=te.transpose,
    )


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


def tiled_sddmm_reference(te: TiledCOO, x, g, compute_dtype="bfloat16"):
    """Plain PyTorch version of the SDDMM kernel: per slot ``⟨g[r], x[s]⟩``
    in float32 (operands rounded to bf16 in bf16 mode); padding slots 0.
    → ``[n_chunks, chunk]``."""
    m = te.meta
    valid, send, recv = _slot_rows(te)
    xs = x.to(torch.float32)[send]
    gr = g.to(torch.float32)[recv]
    if is_bf16(compute_dtype):
        xs, gr = _rb(xs), _rb(gr)
    dot = (xs * gr).sum(dim=1)
    dot = torch.where(valid, dot, torch.zeros_like(dot))
    return dot.reshape(m.n_chunks, m.chunk)


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
        lib.kgcn_tiled_spmm.argtypes = [ptr] * 8 + [i32] * 9 + [ptr]
        lib.kgcn_tiled_spmm.restype = ctypes.c_int
        lib.kgcn_tiled_sddmm.argtypes = [ptr] * 8 + [i32] * 7 + [ptr]
        lib.kgcn_tiled_sddmm.restype = ctypes.c_int
    return lib


def _spmm_launch(te: TiledCOO, weights, x, bf16: bool):
    """One launch of the SpMM kernel → ``[num_receivers, F]`` float32."""
    m = te.meta
    _check_structure(te, x.device)
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
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.kgcn_tiled_spmm(
            te.s_loc.data_ptr(), te.r_loc.data_ptr(), te.slot_src.data_ptr(),
            te.chunk_rt.data_ptr(), te.chunk_st.data_ptr(), weights.data_ptr(),
            x.data_ptr(), out.data_ptr(), m.n_chunks, m.chunk, m.ts, m.tr,
            m.n_rt, m.num_receivers, m.num_edges, F, int(bf16), stream)
    _build.check(lib, code, "tiled_spmm launch")
    tiled_spmm.launches += 1
    return out


def _sddmm_launch(te: TiledCOO, x, g, bf16: bool):
    """One launch of the SDDMM kernel → ``[n_chunks, chunk]`` float32."""
    m = te.meta
    _check_structure(te, x.device)
    _check_operand("x", x, m.num_senders, x.device)
    _check_operand("g", g, m.num_receivers, x.device)
    if g.shape[1] != x.shape[1]:
        raise ValueError(f"x and g widths differ: {x.shape[1]} vs {g.shape[1]}")
    out = torch.empty((m.n_chunks, m.chunk), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.kgcn_tiled_sddmm(
            te.s_loc.data_ptr(), te.r_loc.data_ptr(), te.slot_src.data_ptr(),
            te.chunk_rt.data_ptr(), te.chunk_st.data_ptr(), x.data_ptr(),
            g.data_ptr(), out.data_ptr(), m.n_chunks, m.chunk, m.ts, m.tr,
            m.num_edges, x.shape[1], int(bf16), stream)
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
    return tiled_sddmm_reference(te, x, g, "bfloat16" if bf16 else "float32")


def _slots_to_edges(te: TiledCOO, slots):
    """Per-slot values → ``[E]`` in edge order (dropped edges get 0)."""
    flat = torch.cat([slots.reshape(-1), slots.new_zeros(1)])
    return flat[te.edge_slot.long()]


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
            dw = _slots_to_edges(ctx.te, _sddmm(ctx.te, x, g, ctx.bf16))
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
    slots = _sddmm(te, b.to(torch.float32), a.to(torch.float32), bf16)
    return _slots_to_edges(te, slots)


tiled_spmm.launches = 0
tiled_sddmm.launches = 0
