"""The port's neighbour sampler (kgcn_tpu_torch/data/sampling.py) and its
synthetic datasets (data/synthetic.py) against the JAX package's, per
seed, on the CPU: the same draws from the same ``RandomState``, so the
sampled node sets, the packed ``GraphBatch`` arrays and the global ids are
equal array for array, and so are the datasets' arrays."""
import jax
import numpy as np
import pytest

from kgcn_tpu_torch.data import sampling as ts
from kgcn_tpu_torch.data import synthetic as tsyn


def _adjs(seed, V=60, E=180, C=2):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, V, E), rng.randint(0, V, E),
             rng.random_sample(E).astype(np.float32)) for _ in range(C)], V


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("with_features", [False, True])
def test_sampler_matches_jax_per_seed(seed, with_features):
    from kgcn_tpu.data.sampling import NeighborSampler as JSampler

    adjs, V = _adjs(seed)
    feats = np.random.RandomState(9).standard_normal((V, 5)).astype(np.float32)
    got = ts.NeighborSampler(adjs, V, fanout=3, hops=2, seed=seed)
    want = JSampler(adjs, V, fanout=3, hops=2, seed=seed)
    assert got.max_sample_nodes == want.max_sample_nodes == 13
    assert np.array_equal(got.sample_nodes(5), want.sample_nodes(5))
    for seeds in ([0, 7, 11], [2, 2, 40, 59]):  # the edge budget grows, then stays
        kw = {"features": feats} if with_features else {}
        gb, gids = got.sample_batch(seeds, **kw)
        jb, jids = want.sample_batch(seeds, **kw)
        assert np.array_equal(gids, jids)
        assert (gb.n_graph, gb.max_nodes) == (jb.n_graph, jb.max_nodes)
        for name in ("senders", "receivers", "edge_weights", "n_edge", "n_node",
                     "node_mask", "nodes", "node_ids"):
            a, b = getattr(gb, name), getattr(jb, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert np.array_equal(a.numpy(), np.asarray(jax.device_get(b))), name


def test_edge_budget_too_small_raises():
    adjs, V = _adjs(1)
    with pytest.raises(ValueError, match="edge_budget"):
        ts.NeighborSampler(adjs, V, fanout=3, seed=0).sample_batch([0, 1], edge_budget=1)


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


@pytest.mark.parametrize("name,kw", [
    ("make_pair_dataset", {"num_pairs": 12, "num_nodes": 8, "seed": 2}),
    ("make_random_graphs", {"num_graphs": 5, "num_nodes": 9, "feature_dim": 4,
                            "num_channels": 2, "seed": 1}),
    ("make_kg_dataset", {"num_entities": 23, "num_relations": 3, "seed": 4}),
    ("make_ring_dataset", {"num_pairs": 6, "num_nodes": 7, "seed": 5}),
])
def test_synthetic_datasets_equal_per_seed(name, kw):
    from kgcn_tpu.data import synthetic as jsyn

    _same(getattr(tsyn, name)(**kw), getattr(jsyn, name)(**kw))
