"""Plain SparseGCN (kGCN's reaction-template model, example_model/sparse.py):
GraphConv × L (``Σ_c A_c (X W_c + b_c)``, relu) → GraphDense + batch norm
over the real atoms (biased variance, ε 1e-3) → relu → per-graph sum →
tanh → Dense(classes); softmax cross-entropy summed over the batch.

A batch is the real atoms of its graphs only, laid end to end, with the
bonds offset to match: no padding, so nothing needs masking.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference.common import aggregate, matmul

BN_EPSILON = 1e-3


def leaves(config: dict, features: int, channels: int) -> Dict[str, tuple]:
    """{leaf: shape} of the model, in the layout the benchmark draws
    weights in (flax's names, ``[C, Fin, Fout]`` graph kernels, ``[out,
    in]`` dense kernels)."""
    prog = config["program"]
    dims = [features, *prog["out_dims"]]
    out = {}
    for i in range(len(prog["out_dims"])):
        out[f"GraphConv_{i}.kernel"] = (channels, dims[i], dims[i + 1])
        out[f"GraphConv_{i}.bias"] = (channels, dims[i + 1])
    d = int(prog["dense_dim"])
    out["GraphDense_0.Dense_0.weight"] = (d, dims[-1])
    out["GraphDense_0.Dense_0.bias"] = (d,)
    out["GraphBatchNormalization_0.scale"] = (d,)
    out["GraphBatchNormalization_0.bias"] = (d,)
    out["Dense_0.weight"] = (int(prog["num_classes"]), d)
    out["Dense_0.bias"] = (int(prog["num_classes"]),)
    return out


def make_batch(mols: dict, graphs: np.ndarray, device) -> dict:
    """The real atoms and bonds of ``graphs`` (indices into ``mols``)."""
    sizes, ap, ep = mols["sizes"], mols["atom_ptr"], mols["edge_ptr"]
    graphs = np.asarray(graphs, np.int64)
    n = sizes[graphs]
    first = np.concatenate([[0], np.cumsum(n)[:-1]])
    atoms = np.concatenate([np.arange(ap[g], ap[g + 1]) for g in graphs])
    ne = ep[graphs + 1] - ep[graphs]
    edges = np.concatenate([np.arange(ep[g], ep[g + 1]) for g in graphs])
    shift = np.repeat(first, ne)

    def dev(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)
    return {"x": dev(mols["features"][atoms], torch.float32),
            "row": dev(mols["row"][edges] + shift, torch.long),
            "col": dev(mols["col"][edges] + shift, torch.long),
            "w": torch.ones(int(ne.sum()), dtype=torch.float32, device=device),
            "graph": dev(np.repeat(np.arange(len(graphs)), n), torch.long),
            "n_graphs": len(graphs),
            "labels": dev(mols["labels"][graphs], torch.long)}


def loss(p: Dict[str, torch.Tensor], b: dict, precision: str = "float32",
         half_batch: bool = False):
    """(loss to optimise, summed loss): both the summed cross-entropy.
    ``half_batch``: the batch's second half left out of the sum (a fault
    the comparison has to catch)."""
    x = b["x"]
    n_atoms = x.shape[0]
    i = 0
    while f"GraphConv_{i}.kernel" in p:
        w, bias = p[f"GraphConv_{i}.kernel"], p[f"GraphConv_{i}.bias"]
        out = None
        for c in range(w.shape[0]):
            hw = matmul(x, w[c], precision) + bias[c]
            agg = aggregate(hw, b["row"], b["col"], b["w"], n_atoms)
            out = agg if out is None else out + agg
        x = torch.relu(out)
        i += 1
    d = matmul(x, p["GraphDense_0.Dense_0.weight"].T, precision) + p["GraphDense_0.Dense_0.bias"]
    mean = d.mean(dim=0)
    var = ((d - mean) ** 2).mean(dim=0)
    d = ((d - mean) * torch.rsqrt(var + BN_EPSILON) * p["GraphBatchNormalization_0.scale"]
         + p["GraphBatchNormalization_0.bias"])
    x = torch.relu(d)
    h = x.new_zeros(b["n_graphs"], x.shape[1]).index_add_(0, b["graph"], x)
    logits = matmul(torch.tanh(h), p["Dense_0.weight"].T, precision) + p["Dense_0.bias"]
    ce = -torch.log_softmax(logits, dim=-1).gather(1, b["labels"][:, None])[:, 0]
    if half_batch:
        ce = ce[: b["n_graphs"] // 2]
    total = ce.sum()
    return total, total
