"""The benchmark's traffic: every input a run feeds the port, drawn from
``--seed`` by one generator per kind of data, with the sizes of a cell's
traffic mix (``cells/<cell>.json``, key ``mix``) and its configuration
(``configs/<config>.json``, key ``data``).

* ``molecules``: chain-and-ring molecular graphs (a chain closed into rings
  by one bond per ten atoms, mean degree about 2.2), atom features a one-hot
  type among 44, a one-hot degree and a ring bit, one class label each.
  Every seed draws the same multiset of atom counts (each count from the
  mix's ``min_atoms`` to ``max_atoms`` equally often) in another order, so
  two seeds give the same work.
* ``knowledge_graph``: triples of a published knowledge graph's shape (its
  entity count, its relations at their training-set shares, its number of
  distinct triples), heads and tails Zipf-distributed over a random ranking
  of the entities, every entity at least once, no duplicate and no self
  triple; a held-out share split off as the test set.

Both return plain NumPy arrays, which the reference reads as they are and
``port_data_*`` lays out as the ``.jbl`` dict that the port's
``data/dataset.build_dataset`` takes.
"""
from __future__ import annotations

import numpy as np

TYPES = 44  # one-hot atom types; the degree one-hot follows, the ring bit is last


def rng_for(seed: int) -> np.random.Generator:
    """The data's generator for ``seed``, any whole number."""
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, 0]))


def port_seed(seed: int) -> int:
    """The 31-bit seed handed to the port's own generators (its batchers
    draw with ``np.random.RandomState``, which takes 32 bits)."""
    return int(np.random.SeedSequence([seed % 2**64, 99]).generate_state(1)[0] >> 1)


def molecules(mix: dict, features: int, classes: int, rng: np.random.Generator) -> dict:
    """``mix["graphs"]`` molecules of ``mix["min_atoms"]``-``mix["max_atoms"]``
    atoms: {"sizes" [G], "edge_ptr" [G+1], "row"/"col" [E] graph-local
    atom indices (both directions of every bond; ``row`` receives from
    ``col``), "features" [sum(sizes), features] (the atoms of graph g at
    ``atom_ptr[g]:atom_ptr[g+1]``), "atom_ptr" [G+1], "labels" [G]}."""
    G, lo, hi = int(mix["graphs"]), int(mix["min_atoms"]), int(mix["max_atoms"])
    if lo < 6 or hi < lo:
        raise ValueError(f"molecules need 6 or more atoms: {lo}-{hi}")
    sizes = rng.permutation(lo + (np.arange(G) * (hi - lo + 1)) // G).astype(np.int64)
    rings = np.maximum(sizes // 10, 1)
    # k distinct ring starts among the first n-5 atoms of each graph
    keys = rng.random((G, hi - 5))
    keys[np.arange(hi - 5)[None, :] >= (sizes - 5)[:, None]] = np.inf
    starts = np.argsort(keys, axis=1)
    pick = np.arange(hi - 5)[None, :] < rings[:, None]
    ring_g = np.repeat(np.arange(G), rings)
    ring_a = starts[pick]  # graph by graph, as ring_g
    chain_g = np.repeat(np.arange(G), sizes - 1)
    chain_a = np.arange(chain_g.size) - np.repeat(np.cumsum(sizes - 1) - (sizes - 1), sizes - 1)
    g = np.concatenate([chain_g, ring_g])
    a = np.concatenate([chain_a, ring_a])
    b = np.concatenate([chain_a + 1, ring_a + 5])
    # both directions, grouped by graph
    g2 = np.concatenate([g, g])
    row = np.concatenate([a, b])
    col = np.concatenate([b, a])
    order = np.argsort(g2, kind="stable")
    g2, row, col = g2[order], row[order], col[order]
    edge_ptr = np.zeros(G + 1, np.int64)
    np.cumsum(np.bincount(g2, minlength=G), out=edge_ptr[1:])
    atom_ptr = np.zeros(G + 1, np.int64)
    np.cumsum(sizes, out=atom_ptr[1:])
    n_atoms = int(atom_ptr[-1])
    glob = atom_ptr[g2] + row
    deg = np.bincount(glob, minlength=n_atoms)
    feats = np.zeros((n_atoms, features), np.float32)
    feats[np.arange(n_atoms), rng.integers(0, TYPES, n_atoms)] = 1.0
    feats[np.arange(n_atoms), TYPES + deg] = 1.0
    ring_atoms = np.concatenate([atom_ptr[ring_g] + ring_a, atom_ptr[ring_g] + ring_a + 5])
    feats[ring_atoms, features - 1] = 1.0
    return {"sizes": sizes, "edge_ptr": edge_ptr, "row": row.astype(np.int32),
            "col": col.astype(np.int32), "features": feats, "atom_ptr": atom_ptr,
            "labels": rng.integers(0, classes, G).astype(np.int64)}


def port_data_molecules(mols: dict) -> dict:
    """The molecules as the ``.jbl`` dict of the reaction engine's data
    (what ``data/tfrecord.load_tfrecord_dataset`` builds from TFRecords):
    per-graph COO adjacency tuples, features padded to the largest graph,
    one label column."""
    sizes, ep, ap = mols["sizes"], mols["edge_ptr"], mols["atom_ptr"]
    G, n_max = len(sizes), int(sizes.max())
    rc = np.stack([mols["row"], mols["col"]], axis=1)
    adj = [(rc[ep[i]:ep[i + 1]], np.ones(ep[i + 1] - ep[i], np.float32),
            (int(sizes[i]), int(sizes[i]))) for i in range(G)]
    feats = np.zeros((G, n_max, mols["features"].shape[1]), np.float32)
    g_of = np.repeat(np.arange(G), sizes)
    feats[g_of, np.arange(len(g_of)) - ap[g_of]] = mols["features"]
    return {"adj": adj, "feature": feats, "label": mols["labels"][:, None].astype(np.int32),
            "max_node_num": np.int64(n_max)}


def knowledge_graph(shape: dict, rng: np.random.Generator) -> dict:
    """A knowledge graph of ``shape``'s size: {"entities", "relations",
    "train" [T, 3], "test" [T', 3]} as (head, relation, tail) rows."""
    n = int(shape["entities"])
    counts = np.asarray(shape["relation_triples"], np.float64)
    total = int(shape["triples"])
    per_rel = np.maximum((counts / counts.sum() * total).astype(np.int64), 1)
    per_rel[0] += total - per_rel.sum()
    R = len(per_rel)
    p = (np.arange(n) + 1.0) ** -float(shape["zipf_exponent"])
    p /= p.sum()
    rank_to_id = rng.permutation(n)

    def draw(k):
        return rank_to_id[rng.choice(n, k, p=p)]

    rel = np.repeat(np.arange(R), per_rel)
    heads, tails = draw(total), draw(total)
    tails[rng.choice(total, n, replace=False)] = rng.permutation(n)  # every entity
    while True:
        key = (heads * R + rel) * n + tails
        _, first = np.unique(key, return_index=True)
        bad = np.ones(total, bool)
        bad[first] = False
        bad |= heads == tails
        if not bad.any():
            break
        heads[bad] = draw(int(bad.sum()))
    triples = np.stack([heads, rel, tails], axis=1)[rng.permutation(total)].astype(np.int64)
    n_test = int(total * float(shape["test_rate"]))
    return {"entities": n, "relations": R, "train": triples[n_test:],
            "test": triples[:n_test]}


def port_data_kg(kg: dict) -> dict:
    """The knowledge graph as the ``.jbl`` dict ``cli.kg`` writes: one
    adjacency channel a relation over the training triples, with reverse
    edges and self loops, and the 6-column label lists (the negative
    columns echo the positives: the port's batcher draws the negatives)."""
    n, R, train = kg["entities"], kg["relations"], kg["train"]
    h, r, t = train[:, 0], train[:, 1], train[:, 2]
    loops = np.arange(n)
    adjs = []
    for c in range(R):
        m = r == c
        a = np.concatenate([h[m], t[m], loops])
        b = np.concatenate([t[m], h[m], loops])
        pairs = np.unique(a * n + b)
        idx = np.stack([pairs // n, pairs % n], axis=1).astype(np.int32)
        adjs.append((idx, np.ones(len(idx), np.float32), (n, n)))

    def six(x):
        return np.concatenate([x, x], axis=1).astype(np.int32)
    return {"node": [np.arange(n, dtype=np.int32)], "node_num": n, "adj": [adjs],
            "label_list": [six(train)], "test_label_list": [six(kg["test"])],
            "max_node_num": np.int64(n)}
