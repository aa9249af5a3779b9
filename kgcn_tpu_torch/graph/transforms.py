"""Host-side (NumPy/SciPy) adjacency transforms — the port's own copy of
``kgcn_tpu/graph/transforms.py`` (the port imports nothing of ``kgcn_tpu``).

Re-implementations of the reference's preprocessing math with the same
semantics but operating on our COO representation:

* :func:`normalize_adj`       — Kipf symmetric D^-1/2 A D^-1/2
                                (reference: kgcn/data_util.py:125-140)
* :func:`high_order_adj`      — A^k powers, binarised values
                                (reference: kgcn/data_util.py:58-73)
* :func:`split_adj`           — degree-binned channels + self-loop channel
                                (reference: kgcn/data_util.py:76-122)
* :func:`add_self_loops`      — A + I (reference featurizer adds self loops,
                                kgcn/preprocessing/utils.py:147-153)

All operate on a per-graph channel list ``[ (row, col, val, n) ... ]`` where
``row/col/val`` are numpy arrays and ``n`` is the node count.  These run once
at dataset-build time on the host; nothing here touches a device.
"""
from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def _to_csr(row, col, val, n):
    return sp.csr_matrix((val, (row, col)), shape=(n, n))


def _from_spmat(mat):
    coo = mat.tocoo()
    order = np.lexsort((coo.col, coo.row))
    return (
        coo.row[order].astype(np.int32),
        coo.col[order].astype(np.int32),
        coo.data[order].astype(np.float32),
    )


def normalize_adj(row, col, val, n):
    """Kipf symmetric normalisation D^-1/2 A D^-1/2.

    Matches the reference exactly: values are first binarised, degree computed
    over axis 0 (column sums), zero degrees clamped to 1
    (kgcn/data_util.py:125-140).
    """
    val = np.where(np.asarray(val) > 0, 1.0, np.asarray(val)).astype(np.float32)
    A = _to_csr(row, col, val, n)
    deg = np.asarray(A.sum(axis=0)).ravel()
    deg[deg == 0] = 1.0
    d = 1.0 / np.sqrt(deg)
    D = sp.diags(d)
    return _from_spmat(D @ A @ D)


def high_order_adj(row, col, val, n, order: int):
    """A^order with values reset to 1 (kgcn/data_util.py:58-73)."""
    if order <= 1:
        return (
            np.asarray(row, np.int32),
            np.asarray(col, np.int32),
            np.asarray(val, np.float32),
        )
    A = _to_csr(row, col, val, n)
    B = A
    for _ in range(order - 1):
        B = B @ A
    r, c, v = _from_spmat(B)
    return r, c, np.ones_like(v, dtype=np.float32)


def add_self_loops(row, col, val, n):
    """A + I, skipping nodes that already have a self edge."""
    has_self = set(int(r) for r, c in zip(row, col) if r == c)
    extra = np.array([i for i in range(n) if i not in has_self], dtype=np.int32)
    row2 = np.concatenate([row, extra]).astype(np.int32)
    col2 = np.concatenate([col, extra]).astype(np.int32)
    val2 = np.concatenate([val, np.ones(len(extra), np.float32)]).astype(np.float32)
    order = np.lexsort((col2, row2))
    return row2[order], col2[order], val2[order]


def split_adj(row, col, val, n, min_deg: int = 1, max_deg: int = 5):
    """Split one channel into degree-binned channels plus a self-loop channel.

    Returns a list of ``(row, col, val)`` — ``max_deg - min_deg + 2`` channels.
    Degree of a node counts ALL its outgoing entries (including self loops),
    matching the reference (kgcn/data_util.py:76-122); self-loop edges are
    routed to the dedicated last channel, other edges go to the bin of their
    source row's degree clamped to [min_deg, max_deg].  (We do not replicate
    the reference's dummy-[0,0]-entry workaround — our batching handles empty
    channels natively.)
    """
    n_bins = max_deg - min_deg + 1
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, np.asarray(row, np.int64), 1)
    bins = np.clip(deg - min_deg, 0, n_bins - 1)

    out = []
    row = np.asarray(row)
    col = np.asarray(col)
    val = np.asarray(val, np.float32)
    is_self = row == col
    for b in range(n_bins):
        pick = (~is_self) & (bins[row] == b)
        out.append((row[pick].astype(np.int32), col[pick].astype(np.int32), val[pick]))
    out.append((row[is_self].astype(np.int32), col[is_self].astype(np.int32), val[is_self]))
    return out
