"""Knowledge-graph IG visualisation — the counterpart of
``kgcn_tpu/explain/kg_ig.py`` (reference: ``KnowledgeGraphVisualizer``,
kgcn/visualization.py:289-386): integrated gradients of a triple's score on
the node-embedding table of a whole-graph KG model, restricted to the
subgraph within ``graph_distance`` hops of the triple's two nodes, dumped
as node and edge CSVs.

* ``embedding_ig``: zero baseline; for ``k = 1 .. steps`` the gradient of
  ``Σ s(h, r, t)`` taken AT the table scaled by ``k / steps``, summed in
  step order; attributions ``(Σ g / steps) ⊙ table``.  The steps run one
  after another through the model's own forward and backward on its
  device and backend (on ``stream`` the stream scatter kernels, and their
  transposes for the table's gradient), as ``kgcn_tpu`` scans them.
* ``subgraph_within``: the nodes within ``hops`` of the targets over the
  channels' union graph, by the port's own breadth-first search (no
  ``networkx``); ``UndirectedGraph`` keeps networkx's ``Graph`` order (nodes
  and each node's neighbours in insertion order; ``edges()`` skips nodes
  already walked), so the CSVs are ``kgcn_tpu``'s byte for byte wherever the
  scores print the same.
* ``run_kg_visualization``: the ``visualize`` subcommand's KG route: the
  ``last`` checkpoint (or ``load_model``; the port's or ``kgcn_tpu``'s),
  ``visualize_target`` or the first ``visualize_num`` triples,
  ``ig_divide_number`` steps (30), ``graph_distance`` hops (2), names from
  the dataset's ``node_vocab``.
* ``dump_kg_ig_csv``: ``{prefix}_nodes.csv`` (``node,name,ig_score,
  is_target``) and ``{prefix}_edges.csv`` (``source,target,ig_score``, the
  mean of the two nodes' scores), numbers as ``%.6g``.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn
from torch.func import functional_call


class _TripleScore(nn.Module):
    """``Σ_k s(h_k, r_k, t_k)`` of a KG model's node embeddings: a module,
    so that ``functional_call`` can run it at a substituted table."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.m = model

    def forward(self, batch, heads, rels, tails):
        z = self.m.node_embeddings(batch)
        return torch.sum(self.m.distmult.score(z[heads], z[tails], rels))


def embedding_ig(model: nn.Module, variables: Dict[str, torch.Tensor], batch,
                 target_triples: np.ndarray, *, steps: int = 100) -> np.ndarray:
    """IG of the target triples' summed score with respect to the
    embedding table (``variables["embed.embedding"]``, ``[V, dim]``) →
    ``[V, dim]`` attributions.  ``variables``: the model's parameters and
    buffers, as ``functional_call`` takes them; ``target_triples``: ``[K,
    >=3]`` rows ``(h, r, t)``."""
    table = variables["embed.embedding"].detach()
    dev = table.device
    trip = torch.as_tensor(np.asarray(target_triples)[:, :3], dtype=torch.long, device=dev)
    scorer = _TripleScore(model)
    params = {f"m.{k}": v for k, v in variables.items()}
    acc = torch.zeros_like(table)
    for k in range(steps):
        # the scale as kgcn_tpu's float32 (arange + 1) / steps
        scale = (torch.tensor(float(k), dtype=torch.float32) + 1.0) / steps
        scaled = (table * scale.to(dev)).requires_grad_(True)
        with torch.enable_grad():
            score = functional_call(scorer, {**params, "m.embed.embedding": scaled},
                                    (batch, trip[:, 0], trip[:, 1], trip[:, 2]))
            (g,) = torch.autograd.grad(score, scaled)
        acc = acc + g
    return ((acc / steps) * table).cpu().numpy()


class UndirectedGraph:
    """An undirected graph in networkx ``Graph``'s order: nodes in insertion
    order, each node's neighbours in insertion order (an edge added again
    keeps its place), self-loops allowed."""

    def __init__(self):
        self.adj: Dict[int, Dict[int, None]] = {}

    def add_edges_from(self, pairs) -> None:
        for u, v in pairs:
            self.adj.setdefault(u, {})
            self.adj.setdefault(v, {})
            self.adj[u][v] = None
            self.adj[v][u] = None

    def __contains__(self, n) -> bool:
        return n in self.adj

    def edges(self):
        """Each edge once, as networkx's ``EdgeView`` walks them: nodes in
        order, a node's neighbours not yet walked."""
        seen = set()
        for n, nbrs in self.adj.items():
            for nbr in nbrs:
                if nbr not in seen:
                    yield (n, nbr)
            seen.add(n)

    def within(self, source: int, hops: int) -> set:
        """The nodes at most ``hops`` edges from ``source``."""
        found, frontier = {source}, [source]
        for _ in range(hops):
            nxt = []
            for n in frontier:
                for nbr in self.adj[n]:
                    if nbr not in found:
                        found.add(nbr)
                        nxt.append(nbr)
            if not nxt:
                break
            frontier = nxt
        return found


def subgraph_within(adjs, targets: Sequence[int], hops: int = 2):
    """(sorted node list within ``hops`` of the targets over the union of
    the channels ``adjs`` (``(row, col, val)`` per channel), the union
    graph); a target outside the graph keeps itself (reference: networkx
    ego graphs, kgcn/visualization.py:345-366)."""
    G = UndirectedGraph()
    for (r, c, _v) in adjs:
        G.add_edges_from(zip(map(int, r), map(int, c)))
    keep = set()
    for t in targets:
        if int(t) in G:
            keep |= G.within(int(t), hops)
        else:
            keep.add(int(t))
    return sorted(keep), G


def dump_kg_ig_csv(outdir: str, node_ig: np.ndarray, adjs, targets: Sequence[int], *,
                   hops: int = 2, node_names: Optional[dict] = None,
                   prefix: str = "kg"):
    """Write the node and edge CSVs of the IG-scored subgraph (reference:
    visualization.py:368-386) → their paths."""
    os.makedirs(outdir, exist_ok=True)
    nodes, G = subgraph_within(adjs, targets, hops)
    scores = node_ig.sum(axis=1)
    node_path = os.path.join(outdir, f"{prefix}_nodes.csv")
    with open(node_path, "w") as f:
        f.write("node,name,ig_score,is_target\n")
        tset = set(int(t) for t in targets)
        for n in nodes:
            name = (node_names or {}).get(n, str(n))
            f.write(f"{n},{name},{scores[n]:.6g},{int(n in tset)}\n")
    edge_path = os.path.join(outdir, f"{prefix}_edges.csv")
    nset = set(nodes)
    with open(edge_path, "w") as f:
        f.write("source,target,ig_score\n")
        for u, v in G.edges():
            if u in nset and v in nset:
                f.write(f"{u},{v},{(scores[u] + scores[v]) / 2:.6g}\n")
    print(f"[SAVE] {node_path}")
    print(f"[SAVE] {edge_path}")
    return node_path, edge_path


def run_kg_visualization(config, raw=None, device=None) -> list:
    """The KG route of ``visualize`` (reference: ``cal_feature_IG_for_kg``,
    kgcn/visualization.py:389-440): for each target triple, the IG of its
    score on the embedding table, dumped as ``edgepred-{h}-{t}-{k}`` node
    and edge CSVs (``k`` the triple's index, which keeps same-pair triples
    apart) restricted to ``graph_distance`` hops.  ``raw``: the dataset's
    dict, where the caller has read it.  Returns the paths written."""
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.kg import KGBatcher
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime import backend as backend_mod
    from kgcn_tpu_torch.runtime.train import Trainer

    if raw is None:
        raw = jbl.load(config["dataset"])
    ds, info = build_dataset(raw, config)
    node_names = raw.get("node_vocab") if isinstance(raw, dict) else None
    model_name = config.get("model.py", "kg_distmult")
    if model_name in ("model", "gcn"):
        model_name = "kg_distmult"
    trainer = Trainer(build_model(model_name, info, config), config, info, device=device)
    kb = KGBatcher(ds, info, label_batch_size=config.get("label_batch_size"),
                   seed=int(config.get("seed", 0)),
                   backend=backend_mod.resolve(config, info), device=trainer.device)
    batch = kb.init_batch()
    path = config.get("load_model") or os.path.join(
        config.get("save_model_path", "model"), "model.last.ckpt")
    state = trainer.restore(path)
    print(f"[LOAD] {path}")
    variables = {**state.params, **state.batch_stats}

    triples = np.asarray(ds.label_list[0], dtype=np.int32)[:, :3]  # (h, r, t)
    target = config.get("visualize_target")
    if target is None:
        n = int(config.get("visualize_num", len(triples)) or len(triples))
        targets = range(min(n, len(triples)))
    else:
        targets = [int(target)]
    outdir = config.get("visualize_path", "./visualization/")
    steps = int(config.get("ig_divide_number", 30))
    hops = int(config.get("graph_distance", 2))
    paths = []
    for t in targets:
        h, _r, tl = (int(x) for x in triples[t])
        ig = embedding_ig(trainer.model, variables, batch, triples[t:t + 1], steps=steps)
        print(f"edge target = {t} => {h}-{tl}")
        paths.extend(dump_kg_ig_csv(outdir, ig, ds.adjs[0], targets=[h, tl], hops=hops,
                                    node_names=node_names,
                                    prefix=f"edgepred-{h}-{tl}-{t}"))
    return paths
