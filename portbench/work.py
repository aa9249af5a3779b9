"""The yardstick's arithmetic: the chip's peaks and the least work of the
operations a training step needs.

Least work counts what the layer's equation needs at the inputs a step
had, whatever computes it: products over real atoms, entities and edges
only (padding is never work), each input byte read once and each output
byte written once.  A matrix product ``[M, K] × [K, N]`` is ``2·M·K·N``
operations; its backward is that again for each operand that needs a
gradient.  A sparse aggregation over ``nnz`` edges of ``F`` columns is
``2·nnz·F``, and its structure costs an index and a weight an edge and a
row pointer a receiver (the least of CSR).  Element-wise work (biases,
activations, normalisation, the loss, the optimizer) is not counted.
"""
from __future__ import annotations

from typing import Dict, Optional

# NVIDIA's data sheet for the H100 SXM (dense, no sparsity), at the full
# 700 W power limit: FLOP/s by the dtype a call computes in, and HBM bytes/s
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
                              "bytes": 3.35e12},
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named ``kind``, or None for a card the table
    does not hold (its shares of a peak are then not reported)."""
    return PEAKS.get(kind)


def matmul_flops(m: int, k: int, n: int, grads: int = 0) -> float:
    """A product and ``grads`` of its backward products."""
    return 2.0 * m * k * n * (1 + grads)


def least_seconds(flops: float, nbytes: float, peak: Dict[str, float],
                  dtype: str = "float32") -> float:
    """The least time of a call: its operations at the dtype's peak or its
    bytes at the memory's, whichever is longer."""
    return max(flops / peak[dtype], nbytes / peak["bytes"])


def graph_conv_call(atoms: int, edges: int, fin: int, fout: int, channels: int = 1,
                    senders: Optional[int] = None, receivers: Optional[int] = None,
                    elem: int = 4, weight_bytes: int = 4) -> Dict[str, float]:
    """One forward call of ``Σ_c A_c (X W_c + b_c)``: the projection over
    the smaller of the rows that send and that receive (``atoms`` where
    every row does both), the aggregation over the real edges; bytes of X,
    the kernels and biases, the adjacency's real edges and the output."""
    rows = min(senders if senders is not None else atoms,
               receivers if receivers is not None else atoms)
    flops = channels * matmul_flops(rows, fin, fout) + 2.0 * edges * fout
    nbytes = (atoms * fin * elem + channels * (fin + 1) * fout * 4
              + edges * (4 + weight_bytes) + (atoms + 1) * 4 + atoms * fout * elem)
    return {"flops": flops, "bytes": nbytes}


def scatter_call(edges: int, senders: int, receivers: int, features: int,
                 weight_bytes: int = 4) -> Dict[str, float]:
    """One sparse aggregation ``out[r] = Σ w·x[s]`` with float32 rows in
    and out: the rows that send read once, the rows that receive written
    once, the structure at the least of CSR."""
    return {"flops": 2.0 * edges * features,
            "bytes": (senders * features * 4 + receivers * features * 4
                      + edges * (4 + weight_bytes) + (receivers + 1) * 4)}
