"""ELL-format (padded per-row neighbour lists) aggregation — the port's
copy of ``kgcn_tpu/ops/ell.py``.

Each node's in-edges are padded to a fixed ``max_degree`` K, giving dense
``[V, K]`` index and weight matrices; aggregation is a gather and a weighted
K-sum, with no scatter.  Molecular graphs have a small bounded degree, so
the padding waste is small.

* ``ELL_MAX_DEGREE``, ``ell_layout_ok``, ``scan_ell_stats`` and
  ``coo_to_ell`` are NumPy, equal to the JAX package's array for array (the
  ``Batcher`` builds its ELL arrays with them, under the same gate).
* ``ell_transpose`` (NumPy) lists each sender's slots, the transpose that
  the GPU's dx kernel walks; ``per_graph_ell`` builds the forward arrays
  and it per graph, once per dataset, for the ``Batcher`` and the
  device-resident dataset (``runtime/resident.py``).
* ``spmm_ell`` and ``spmm_ell_multichannel`` are the plain PyTorch
  versions: gather, then einsum.  On the CPU they are the path itself; on
  the GPU ``ops/ell_spmm.py`` launches the hand-written kernel
  ``csrc/ell.cu`` and these are what it is held against.
"""
from __future__ import annotations

import numpy as np
import torch

# Max in-degree above which the padded-neighbour-list layout stops paying
# off; shared by every batch assembler so path selection is uniform (the JAX
# package's value).
ELL_MAX_DEGREE = 32


def ell_layout_ok(max_degree: int, node_slots: int, total_edges: int) -> bool:
    """Whether the ELL layout is worth building: bounded degree and padded
    gather work within 2x of the true edge count."""
    return (
        0 < max_degree <= ELL_MAX_DEGREE
        and node_slots * max_degree <= 2.0 * max(total_edges, 1)
    )


def scan_ell_stats(adjs) -> tuple[int, int]:
    """(max in-degree, total edge count) over per-graph per-channel COO
    triples ``adjs[g][c] = (row, col, val)`` — the inputs to
    :func:`ell_layout_ok`."""
    max_deg = 0
    total_edges = 0
    for gs in adjs:
        for (r, _c, _v) in gs:
            total_edges += len(r)
            if len(r):
                max_deg = max(max_deg, int(np.bincount(np.asarray(r)).max()))
    return max_deg, total_edges


def coo_to_ell(senders, receivers, weights, num_nodes: int,
               max_degree: int | None = None):
    """Host-side conversion: packed COO → (idx ``[V, K]`` int32, w
    ``[V, K]`` float32).

    Sort + searchsorted slot ranks, fully vectorised.  Zero-weight edges are
    dropped; padding slots point at node 0 with weight 0.  Edges beyond
    ``max_degree`` per row are DROPPED: pass None to size K to the true
    max."""
    senders = np.asarray(senders)
    receivers = np.asarray(receivers)
    weights = np.asarray(weights)
    valid = weights != 0
    s, r, w_v = senders[valid], receivers[valid], weights[valid]
    order = np.argsort(r, kind="stable")
    r_sorted = r[order]
    first = np.searchsorted(r_sorted, r_sorted, side="left")
    slot = np.arange(len(r_sorted)) - first
    if max_degree is None:
        K = int(slot.max()) + 1 if len(slot) else 1
    else:
        K = int(max_degree)
        keep = slot < K
        order, r_sorted, slot = order[keep], r_sorted[keep], slot[keep]
    idx = np.zeros((num_nodes, max(K, 1)), np.int32)
    w = np.zeros((num_nodes, max(K, 1)), np.float32)
    idx[r_sorted, slot] = s[order]
    w[r_sorted, slot] = w_v[order]
    return idx, w


def ell_transpose(idx, w, num_rows: int):
    """The ELL arrays' transpose: each sender's slots, for the dx kernel.

    idx, w ``[C, V, K]`` (or ``[V, K]``, one channel) → ``(offsets [C,
    num_rows + 1], slots [S])`` int32: ``slots`` holds the flat slot id
    ``v*K + k`` of every real slot (weight ≠ 0), channel by channel, grouped
    by sender ``idx[c, v, k]`` and within a sender in increasing (v, k)
    order (the order in which the reference's segment sum and ``index_add_``
    add them); sender ``u`` of channel ``c`` owns ``slots[offsets[c, u] :
    offsets[c, u + 1]]``, the offsets counted from the start of ``slots``.
    Offsets, not a padded ``[V, K_T]``: the ELL gate bounds the in-degree,
    not the out-degree, so one hub sender would pad every row."""
    idx = np.asarray(idx)
    w = np.asarray(w)
    if idx.ndim == 2:
        idx, w = idx[None], w[None]
    C, V, K = idx.shape
    flat = np.flatnonzero(w.reshape(-1) != 0)  # real slots in (c, v, k) order
    key = (flat // (V * K)) * num_rows + idx.reshape(-1)[flat]
    order = np.argsort(key, kind="stable")
    slots = (flat[order] % max(V * K, 1)).astype(np.int32)
    cum = np.cumsum(np.bincount(key, minlength=C * num_rows)).reshape(C, num_rows)
    offsets = np.zeros((C, num_rows + 1), np.int32)
    offsets[:, 1:] = cum
    if num_rows:
        offsets[1:, 0] = cum[:-1, -1]
    return offsets, slots


def per_graph_ell(adjs, num_nodes: int):
    """Per-graph ELL arrays of a dataset, or None where ``ell_layout_ok``
    refuses it: ``{"idx", "w"}`` ``[G, C, N, K]`` (``coo_to_ell`` of each
    graph and channel, K the max in-degree) and each graph's transpose
    (``ell_transpose``): per channel its real slots ``v*K + k`` grouped by
    sender, padded to ``N*K`` (``t_slots [G, C, N*K]``), their count
    (``t_count [G, C]``) and each sender's list end counted from the
    graph's list start (``t_end [G, C, N]``); and ``"K"``."""
    if adjs is None:
        return None
    G, C, N = len(adjs), len(adjs[0]), num_nodes
    max_deg, total_edges = scan_ell_stats(adjs)
    if not ell_layout_ok(max_deg, G * C * N, total_edges):
        return None
    K = max_deg
    idx = np.zeros((G, C, N, K), np.int32)
    w = np.zeros((G, C, N, K), np.float32)
    for g, gs in enumerate(adjs):
        for c, (r, cc, v) in enumerate(gs):
            idx[g, c], w[g, c] = coo_to_ell(cc, r, v, N, max_degree=K)
    # every (graph, channel) as one channel of the transpose
    offsets, slots = ell_transpose(idx.reshape(G * C, N, K), w.reshape(G * C, N, K), N)
    count = offsets[:, -1] - offsets[:, 0]
    t_slots = np.zeros((G * C, N * K), np.int32)
    t_slots[np.arange(N * K)[None, :] < count[:, None]] = slots
    return {"idx": idx, "w": w, "K": K, "t_slots": t_slots.reshape(G, C, N * K),
            "t_end": np.ascontiguousarray((offsets[:, 1:] - offsets[:, :1]).reshape(G, C, N)),
            "t_count": np.ascontiguousarray(count.reshape(G, C))}


def spmm_ell(idx, w, x):
    """``out[v] = Σ_k w[v,k] · x[idx[v,k]]``: gather, then einsum.

    idx, w ``[V, K]``; x ``[N, F]`` → ``[V, F]`` in x's dtype (w is cast to
    it, as in the JAX package)."""
    gathered = x[idx.long()]  # [V, K, F]
    return torch.einsum("vk,vkf->vf", w.to(x.dtype), gathered)


def spmm_ell_multichannel(idxs, ws, x):
    """Channel-summed ELL product: idxs, ws ``[C, V, K]``; x ``[N, F]``
    (shared) or ``[C, N, F]`` (per channel) → ``[V, F]``."""
    if x.dim() == 3:
        gathered = torch.stack([xc[i.long()] for xc, i in zip(x, idxs)])
    else:
        gathered = x[idxs.long()]  # [C, V, K, F]
    return torch.einsum("cvk,cvkf->vf", ws.to(x.dtype), gathered)
