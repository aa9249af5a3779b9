"""Plain GCN-DistMult link prediction (kGCN's ``kg_distmult`` with the
``gcn`` encoder, sample_kg/network_prediction/model_py): entity embeddings
→ two GraphConv layers ``tanh(Σ_c A_c (Z W_c + b_c))`` over the relation
channels → DistMult scores ``Σ_f h_f w_{r,f} t_f`` of a positive triple and
its corrupted copy, loss ``softplus(s_neg − s_pos + γ)`` averaged over the
slice's real rows.

The adjacency is rebuilt here from the training triples: per relation both
directions of each triple and a self loop on every entity, each pair once,
then ``D^-1/2 A D^-1/2`` with the degree taken over the columns (kGCN's
``normalize_adj``).  With a ``"bfloat16"`` payload each aggregation rounds
its gathered rows and weights to bf16, and its gradient the rows of dy.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from portbench.reference.common import aggregate, matmul

GAMMA = 0.1


def leaves(config: dict, entities: int, relations: int) -> Dict[str, tuple]:
    d = int(config["program"]["embedding_dim"])
    return {"embed.embedding": (entities, d),
            "conv1.kernel": (relations, d, d), "conv1.bias": (relations, d),
            "conv2.kernel": (relations, d, d), "conv2.bias": (relations, d),
            "distmult.kernel": (relations, d)}


def adjacency(kg: dict, device) -> List[tuple]:
    """Per relation (row, col, weight) tensors on ``device``."""
    n, train = kg["entities"], kg["train"]
    out = []
    for c in range(kg["relations"]):
        m = train[:, 1] == c
        rows = np.concatenate([train[m, 0], train[m, 2], np.arange(n)])
        cols = np.concatenate([train[m, 2], train[m, 0], np.arange(n)])
        key = np.unique(rows.astype(np.int64) * n + cols)
        row, col = torch.as_tensor(key // n), torch.as_tensor(key % n)
        deg = torch.bincount(col, minlength=n).to(torch.float32)
        d = 1.0 / torch.sqrt(torch.clamp(deg, min=1.0))
        w = d[row] * d[col]
        out.append((row.to(device), col.to(device), w.to(device)))
    return out


def loss(p: Dict[str, torch.Tensor], b: dict, precision: str = "float32",
         half_batch: bool = False):
    """(mean loss over the slice's real rows, their summed loss).
    ``b``: {"adj", "payload", "rows" [L, 6] (h, r, t, h', r', t'), "valid"
    [L]}.  ``half_batch``: the slice's second half left out, the mean taken
    over the rest (a fault the comparison has to catch)."""
    z = p["embed.embedding"]
    n = z.shape[0]
    for layer in ("conv1", "conv2"):
        w, bias = p[f"{layer}.kernel"], p[f"{layer}.bias"]
        out = None
        for c, (row, col, aw) in enumerate(b["adj"]):
            hw = matmul(z, w[c], precision) + bias[c]
            agg = aggregate(hw, row, col, aw, n, b["payload"])
            out = agg if out is None else out + agg
        z = torch.tanh(out)
    rows, valid = b["rows"], b["valid"]
    if half_batch:
        rows, valid = rows[: rows.shape[0] // 2], valid[: rows.shape[0] // 2]
    k = p["distmult.kernel"]
    s_pos = torch.sum(z[rows[:, 0]] * z[rows[:, 2]] * k[rows[:, 1]], dim=-1)
    s_neg = torch.sum(z[rows[:, 3]] * z[rows[:, 5]] * k[rows[:, 4]], dim=-1)
    score = s_neg - s_pos + GAMMA
    cost = torch.logaddexp(score, torch.zeros_like(score)) * valid
    total = cost.sum()
    return total / torch.clamp(valid.sum(), min=1.0), total
