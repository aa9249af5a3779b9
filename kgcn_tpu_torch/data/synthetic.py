"""Synthetic datasets — the port's copy of ``kgcn_tpu/data/synthetic.py``
(the ring dataset: the reference's data_generator/synth_generator_ring.py:
10-60).

``make_ring_dataset`` draws M pairs of graphs, one holding a ``ring_a``-ring
and one a ``ring_b``-ring plus noise edges to the spare nodes, labelled one
hot, as the ``.jbl`` dict schema (``dense_adj``/``feature``/``label``/
``mask_label``/``max_node_num``).  It makes the same draws from the same
numpy ``RandomState`` as the JAX package, so one seed gives one dict.  With
``num_nodes=6`` (a 6-ring against a 5-ring and one spare node) every
in-degree is at most 4-6 and the padding is small: the ``Batcher``'s ELL
gate admits the dataset, which is how the ``pallas`` backend's ELL kernel
is driven from data of the repository's own kind.

``make_pair_dataset`` (ring graphs with a ``graph_index_list`` of
(worse, better) pairs), ``make_random_graphs`` (random sparse graphs for
benchmarks) and ``make_kg_dataset`` (a small multi-relation KG) draw as
``kgcn_tpu``'s do, so each seed gives the same dict.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _ring_adj(num_nodes: int, ring: int) -> np.ndarray:
    a = np.zeros((num_nodes, num_nodes), dtype=np.int64)
    for i in range(ring):
        a[i, i] = 1
        a[i, (i + 1) % ring] = 1
        a[(i + 1) % ring, i] = 1
    return a


def make_ring_dataset(num_pairs: int = 100, num_nodes: int = 10, ring_a: int = 6,
                      ring_b: int = 5, noise_p: float = 0.1, seed: int = 0) -> Dict:
    """``ring_a``-ring (label 0) vs ``ring_b``-ring (label 1) graphs of
    ``num_nodes`` nodes, shuffled, as a jbl-schema dict."""
    rng = np.random.RandomState(seed)
    adjs, labels = [], []
    for _ in range(num_pairs):
        for ring, lab in ((ring_a, 0), (ring_b, 1)):
            a = _ring_adj(num_nodes, ring)
            # noise edges from ring nodes to the spare nodes
            for i in range(num_nodes - ring):
                for j in range(ring):
                    e = rng.binomial(1, noise_p)
                    a[ring + i, j] = e
                    a[j, ring + i] = e
            # spare nodes get self loops so they are "real" nodes
            for i in range(ring, num_nodes):
                a[i, i] = 1
            adjs.append(a)
            labels.append(lab)

    order = rng.permutation(len(adjs))
    dense_adj = np.stack([adjs[i] for i in order])
    lab = np.array([labels[i] for i in order])

    # cyclic 3-dim one-hot node features (the reference's "Level=1" mode)
    feature = np.zeros((len(adjs), num_nodes, 3), dtype=np.float64)
    for i in range(num_nodes):
        feature[:, i, i % 3] = 1.0

    label = np.zeros((len(adjs), 2), dtype=np.float64)
    label[lab == 0, 0] = 1.0
    label[lab == 1, 1] = 1.0

    return {
        "feature": feature,
        "dense_adj": dense_adj,
        "label": label,
        "mask_label": np.ones_like(label, dtype=np.int64),
        "max_node_num": np.int64(num_nodes),
    }


def make_pair_dataset(num_pairs: int = 60, num_nodes: int = 10,
                      seed: int = 0) -> Dict:
    """Preference-ranking dataset: ring graphs plus a ``graph_index_list``
    of (worse, better) pairs, 5-rings (class 1) preferred over 6-rings,
    for the pair engine (reference: gcn_pair.py + feed pairs)."""
    data = make_ring_dataset(num_pairs=max(num_pairs // 2, 4),
                             num_nodes=num_nodes, seed=seed)
    y = np.argmax(data["label"], axis=1)
    idx0 = np.nonzero(y == 0)[0]
    idx1 = np.nonzero(y == 1)[0]
    rng = np.random.RandomState(seed + 1)
    pairs = np.stack([rng.choice(idx0, num_pairs),
                      rng.choice(idx1, num_pairs)], axis=1)
    data["graph_index_list"] = pairs.tolist()
    return data


def make_random_graphs(num_graphs: int, num_nodes: int, feature_dim: int,
                       avg_degree: float = 4.0, num_channels: int = 1,
                       label_dim: int = 2, seed: int = 0) -> Dict:
    """Random sparse graphs with self loops (a COO tuple a channel), random
    features and one-hot labels, for benchmarks."""
    rng = np.random.RandomState(seed)
    p = min(avg_degree / max(num_nodes - 1, 1), 1.0)
    adjs = []
    for _ in range(num_graphs):
        chans = []
        for _ in range(num_channels):
            mask = rng.random_sample((num_nodes, num_nodes)) < p
            mask |= np.eye(num_nodes, dtype=bool)
            row, col = np.nonzero(mask)
            indices = np.stack([row, col], axis=1).astype(np.int32)
            values = np.ones(len(row), np.float32)
            chans.append((indices, values, (num_nodes, num_nodes)))
        adjs.append(chans)
    feature = rng.standard_normal((num_graphs, num_nodes, feature_dim)).astype(np.float32)
    y = rng.randint(0, label_dim, size=num_graphs)
    label = np.eye(label_dim)[y]
    return {
        "feature": feature,
        "adj": adjs,
        "label": label,
        "mask_label": np.ones_like(label, dtype=np.int64),
        "max_node_num": np.int64(num_nodes),
    }


def make_kg_dataset(num_entities: int = 50, num_relations: int = 2,
                    seed: int = 0) -> Dict:
    """A small multi-relation knowledge graph (the ``node``/``node_num``/
    ``adj``/``label_list`` schema of ``cli.kg``'s output) where relation r
    links h to (h + r + 1) mod N (reference: kgcn/preprocessing/kg.py:
    78-152)."""
    rng = np.random.RandomState(seed)
    chans = []
    triples = []
    for r in range(num_relations):
        rows = np.arange(num_entities, dtype=np.int32)
        cols = (rows + r + 1) % num_entities
        indices = np.stack([rows, cols], axis=1)
        values = np.ones(num_entities, np.float32)
        chans.append((indices, values, (num_entities, num_entities)))
        triples.extend([(int(h), r, int(t)) for h, t in zip(rows, cols)])
    rng.shuffle(triples)
    label_list = np.asarray(triples, dtype=np.int32)
    return {
        "node": [np.arange(num_entities, dtype=np.int32)],
        "node_num": num_entities,
        "adj": [chans],
        "label_list": [label_list],
        "test_label_list": [label_list[: max(len(label_list) // 5, 1)]],
        "max_node_num": np.int64(num_entities),
    }
