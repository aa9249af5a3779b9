"""Neighbour-sampled subgraph batches of one big graph — the port's copy of
``kgcn_tpu/data/sampling.py``.

``NeighborSampler`` draws GraphSAGE-style fixed-fanout neighbourhoods
around seed nodes (the channels' union for the expansion, each channel's
edges kept in the induced subgraph) and packs them as the port's
``GraphBatch`` of fixed shape: a node budget ``1 + Σ fanoutᵏ`` a subgraph
(``max_sample_nodes``) and an edge budget that grows and then stays, so
batches keep their shapes.  It draws from ``np.random.RandomState(seed)``
in ``kgcn_tpu``'s order: one seed gives both packages the same samples.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from kgcn_tpu_torch.graph.batch import GraphBatch, pad_edge_budget


class NeighborSampler:
    """Fixed-fanout neighbourhood sampler over one multi-channel graph.

    ``adjs``: the graph's channel list ``[(row, col, val), ...]`` over
    ``num_nodes`` nodes."""

    def __init__(self, adjs: Sequence[Tuple], num_nodes: int,
                 fanout: int = 10, hops: int = 2, seed: int = 0):
        self.adjs = [tuple(np.asarray(a) for a in ch) for ch in adjs]
        self.num_nodes = int(num_nodes)
        self.fanout = int(fanout)
        self.hops = int(hops)
        self._rng = np.random.RandomState(seed)
        self._auto_edge_budget = 1  # grows, then stays (sample_batch)
        nbrs: List[List[int]] = [[] for _ in range(self.num_nodes)]
        for (row, col, _val) in self.adjs:
            for r, c in zip(row, col):
                nbrs[int(r)].append(int(c))
        self._nbr_idx = [np.asarray(sorted(set(n)), np.int32) for n in nbrs]

    @property
    def max_sample_nodes(self) -> int:
        n, total = 1, 1
        for _ in range(self.hops):
            n *= self.fanout
            total += n
        return total

    def sample_nodes(self, seed_node: int) -> np.ndarray:
        """The seed's sampled k-hop neighbourhood, sorted."""
        frontier = {int(seed_node)}
        nodes = {int(seed_node)}
        for _ in range(self.hops):
            nxt = set()
            for v in frontier:
                nb = self._nbr_idx[v]
                if len(nb) == 0:
                    continue
                take = (nb if len(nb) <= self.fanout
                        else self._rng.choice(nb, self.fanout, replace=False))
                nxt.update(int(u) for u in take)
            frontier = nxt - nodes
            nodes |= nxt
        return np.asarray(sorted(nodes), np.int32)

    def induced_subgraph(self, nodes: np.ndarray):
        """Per-channel ``(row_local, col_local, val)`` among ``nodes``."""
        pos = -np.ones(self.num_nodes, np.int64)
        pos[nodes] = np.arange(len(nodes))
        out = []
        for (row, col, val) in self.adjs:
            keep = (pos[row] >= 0) & (pos[col] >= 0)
            out.append((pos[row[keep]].astype(np.int32), pos[col[keep]].astype(np.int32),
                        np.asarray(val)[keep].astype(np.float32)))
        return out

    def sample_batch(self, seeds: Sequence[int], *, features: Optional[np.ndarray] = None,
                     node_budget: Optional[int] = None,
                     edge_budget: Optional[int] = None) -> Tuple[GraphBatch, np.ndarray]:
        """One ``GraphBatch`` of sampled subgraphs, one a seed, and the
        global node ids ``[B, N]`` (-1 for padding); the seed is local node
        0 of its subgraph."""
        B = len(seeds)
        N = int(node_budget or self.max_sample_nodes)
        C = len(self.adjs)
        all_nodes, all_edges = [], []
        need = 1
        for s in seeds:
            nodes = self.sample_nodes(int(s))
            nodes = np.concatenate([[int(s)], nodes[nodes != int(s)]]).astype(np.int32)[:N]
            sub = self.induced_subgraph(nodes)
            need = max(need, sum(len(ch[0]) for ch in sub))
            all_nodes.append(nodes)
            all_edges.append(sub)
        total_need = pad_edge_budget(need * B)
        if edge_budget is not None:
            E = int(edge_budget)
            if total_need > E:
                raise ValueError(f"edge_budget {E} < {total_need} edges sampled this "
                                 "batch — raise the budget (or omit it to auto-size)")
        else:
            self._auto_edge_budget = max(self._auto_edge_budget, total_need)
            E = self._auto_edge_budget
        senders = np.zeros((C, E), np.int32)
        receivers = np.zeros((C, E), np.int32)
        weights = np.zeros((C, E), np.float32)
        n_edge = np.zeros((C,), np.int32)
        for c in range(C):
            off = 0
            for g, sub in enumerate(all_edges):
                r, cc, v = sub[c]
                k = len(r)
                receivers[c, off:off + k] = r + g * N
                senders[c, off:off + k] = cc + g * N
                weights[c, off:off + k] = v
                off += k
            n_edge[c] = off
        nn_ = np.asarray([len(x) for x in all_nodes], np.int32)
        mask = (np.arange(N)[None, :] < nn_[:, None]).astype(np.float32).reshape(-1)
        gids = -np.ones((B, N), np.int64)
        for g, nodes in enumerate(all_nodes):
            gids[g, :len(nodes)] = nodes
        nodes_arr = ids = None
        if features is not None:
            buf = np.zeros((B, N, features.shape[1]), np.float32)
            for g, nodes in enumerate(all_nodes):
                buf[g, :len(nodes)] = features[nodes]
            nodes_arr = torch.from_numpy(buf.reshape(B * N, -1))
        else:
            idbuf = np.zeros((B, N), np.int32)
            for g, nodes in enumerate(all_nodes):
                idbuf[g, :len(nodes)] = nodes
            ids = torch.from_numpy(idbuf.reshape(-1))
        batch = GraphBatch(
            senders=torch.from_numpy(senders), receivers=torch.from_numpy(receivers),
            edge_weights=torch.from_numpy(weights), n_edge=torch.from_numpy(n_edge),
            n_node=torch.from_numpy(nn_), node_mask=torch.from_numpy(mask),
            nodes=nodes_arr, node_ids=ids, n_graph=B, max_nodes=N)
        return batch, gids
