"""Synthetic ring-classification dataset — the port's copy of
``kgcn_tpu/data/synthetic.py:17-71`` (the reference's
data_generator/synth_generator_ring.py:10-60).

``make_ring_dataset`` draws M pairs of graphs, one holding a ``ring_a``-ring
and one a ``ring_b``-ring plus noise edges to the spare nodes, labelled one
hot, as the ``.jbl`` dict schema (``dense_adj``/``feature``/``label``/
``mask_label``/``max_node_num``).  It makes the same draws from the same
numpy ``RandomState`` as the JAX package, so one seed gives one dict.  With
``num_nodes=6`` (a 6-ring against a 5-ring and one spare node) every
in-degree is at most 4-6 and the padding is small: the ``Batcher``'s ELL
gate admits the dataset, which is how the ``pallas`` backend's ELL kernel
is driven from data of the repository's own kind.
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
