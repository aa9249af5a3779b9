"""Knowledge-graph preprocessing — the port's own copy of
``kgcn_tpu/cli/kg.py`` (reference: ``kgcn-kg``, kgcn/preprocessing/kg.py).

    python -m kgcn_tpu_torch.cli.kg --input triples.tsv --output kg.jbl \\
        [--test-rate 0.1] [--seed 0] [--no-swap] [--no-self]

Triple TSV files (head, relation, tail) → a ``.jbl`` dict with node and edge
vocabularies, one adjacency channel per relation (with reverse edges and
self loops), a train/test split, and 6-column ``label_list`` /
``test_label_list`` rows ``[h, r, t, h, r, t_neg]`` whose negative tails are
drawn from the entities seen with the same relation.  The same seed gives
the same file content as ``kgcn_tpu``'s.

The file is a plain pickle (protocol 4), not a joblib stream: the port does
without joblib.  ``joblib.load`` and the port's ``data/jbl.load`` both read
it.  The reference's ``build_adjs`` fills each relation's adjacency with one
repeated pair (kg.py:89-96); this copy, like ``kgcn_tpu``'s, indexes the
pairs correctly (SURVEY.md §7).
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import Dict, List, Tuple

import numpy as np


def read_triples(paths) -> List[Tuple[str, str, str]]:
    triples = []
    for path in paths:
        with open(path) as f:
            for line in f:
                # strip CRLF too: a Windows-edited TSV would otherwise give
                # phantom 'name\r' entities
                parts = line.rstrip("\r\n").split("\t")
                if len(parts) >= 3:
                    triples.append((parts[0], parts[1], parts[2]))
    return triples


def build_vocab(triples):
    nodes: Dict[str, int] = {}
    edges: Dict[str, int] = {}
    for h, r, t in triples:
        for n in (h, t):
            if n not in nodes:
                nodes[n] = len(nodes)
        if r not in edges:
            edges[r] = len(edges)
    return nodes, edges


def build_adjs(triples, node_map, edge_map, with_swap=True, with_self=True):
    """Per-relation adjacency channels (+reverse, +self) as COO tuples
    ``(indices [E, 2], values [E], (n, n))``, pairs sorted."""
    n = len(node_map)
    by_rel: Dict[int, set] = {r: set() for r in range(len(edge_map))}
    for h, r, t in triples:
        hi, ri, ti = node_map[h], edge_map[r], node_map[t]
        by_rel[ri].add((hi, ti))
        if with_swap:
            by_rel[ri].add((ti, hi))
    adjs = []
    for r in range(len(edge_map)):
        pairs = set(by_rel[r])
        if with_self:
            pairs |= {(i, i) for i in range(n)}
        pairs = sorted(pairs)
        idx = np.asarray(pairs, np.int32).reshape(-1, 2)
        val = np.ones(len(pairs), np.float32)
        adjs.append((idx, val, (n, n)))
    return adjs


def build_label_list(triples, node_map, edge_map, rng, negative=True):
    """``[h, r, t, h, r, t_neg]`` rows; negatives drawn from the entities
    seen with the same relation (kg.py:131-152)."""
    by_rel: Dict[int, List[int]] = {}
    enc = []
    for h, r, t in triples:
        hi, ri, ti = node_map[h], edge_map[r], node_map[t]
        enc.append((hi, ri, ti))
        by_rel.setdefault(ri, []).extend([hi, ti])
    # one array per relation: rng.choice draws the same numbers from an
    # array as from the list, without converting the list at every draw
    by_rel_arr = {r: np.asarray(v) for r, v in by_rel.items()}
    rows = []
    for hi, ri, ti in enc:
        if negative:
            x = int(rng.choice(by_rel_arr[ri]))
            rows.append([hi, ri, ti, hi, ri, x])
        else:
            rows.append([hi, ri, ti, 0, 0, 0])
    return np.asarray(rows, np.int32)


def build_kg(triples, test_rate: float = 0.1, seed: int = 0,
             with_swap: bool = True, with_self: bool = True) -> dict:
    """The ``.jbl`` dict of a triple list (what ``main`` writes)."""
    node_map, edge_map = build_vocab(triples)
    print(f"[INFO] {len(node_map)} entities, {len(edge_map)} relations")
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(triples))
    n_test = int(len(triples) * test_rate)
    test_triples = [triples[i] for i in order[:n_test]]
    train_triples = [triples[i] for i in order[n_test:]]

    adjs = build_adjs(train_triples, node_map, edge_map,
                      with_swap=with_swap, with_self=with_self)
    label_list = build_label_list(train_triples, node_map, edge_map, rng)
    test_label_list = (
        build_label_list(test_triples, node_map, edge_map, rng)
        if test_triples
        else label_list[:1]
    )
    n = len(node_map)
    return {
        "node": [np.arange(n, dtype=np.int32)],
        "node_num": n,
        "adj": [adjs],
        "label_list": [label_list],
        "test_label_list": [test_label_list],
        "max_node_num": np.int64(n),
        "node_vocab": {v: k for k, v in node_map.items()},
        "edge_vocab": {v: k for k, v in edge_map.items()},
    }


def main(argv=None):
    p = argparse.ArgumentParser(prog="kgcn-tpu-torch-kg", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input", nargs="*", required=True, help="triple TSV files")
    p.add_argument("--output", default="./data/kg.jbl")
    p.add_argument("--test-rate", type=float, default=0.1)
    p.add_argument("--no-swap", action="store_true")
    p.add_argument("--no-self", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    triples = read_triples(args.input)
    print(f"[INFO] {len(triples)} triples")
    data = build_kg(triples, test_rate=args.test_rate, seed=args.seed,
                    with_swap=not args.no_swap, with_self=not args.no_self)
    d = os.path.dirname(args.output)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(args.output, "wb") as f:
        pickle.dump(data, f, protocol=4)
    print(f"[SAVE] {args.output}")
    return data


if __name__ == "__main__":
    main()
