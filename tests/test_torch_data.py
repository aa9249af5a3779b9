"""The port's data path (jbl reader, build_dataset, Batcher, GraphBatch)
against the JAX package's, array for array, on the repository's datasets."""
import glob
import gzip
import pickle
import zlib

import joblib
import numpy as np
import pytest
import torch

from kgcn_tpu.data import Batcher as JBatcher
from kgcn_tpu.data import build_dataset as j_build_dataset
from kgcn_tpu.data import load_jbl as j_load_jbl
from kgcn_tpu_torch.data import jbl
from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
from kgcn_tpu_torch.data.dataset import build_dataset as t_build_dataset
from kgcn_tpu_torch.data.dataset import load_jbl as t_load_jbl

torch.set_num_threads(1)

JBL_FILES = sorted(glob.glob("example_jbl/*.jbl") + glob.glob("examples/solubility/*.jbl"))
SYNTH = "example_jbl/synthetic.jbl"
SOLUBILITY = "examples/solubility/solubility_cls.jbl"


def _assert_same(a, b, path="root"):
    """Deep equality of decoded jbl objects: same types, dtypes, values."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        if a.dtype.hasobject:
            for i, (u, v) in enumerate(zip(a.ravel(), b.ravel())):
                _assert_same(u, v, f"{path}[{i}]")
        else:
            np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _assert_same(u, v, f"{path}[{i}]")
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("path", JBL_FILES)
def test_jbl_reader_matches_joblib(path):
    _assert_same(jbl.load(path), joblib.load(path))


def test_jbl_reader_refuses_other_streams(tmp_path):
    raw = pickle.dumps({"a": 1}, protocol=4)
    assert jbl.loads(raw) == {"a": 1}
    assert jbl.loads(zlib.compress(raw)) == {"a": 1}
    with pytest.raises(ValueError, match="not a .jbl file"):
        jbl.loads(gzip.compress(raw))
    with pytest.raises(ValueError, match="zlib"):
        jbl.loads(b"\x78garbage")


def _assert_datasets_equal(jds, jinfo, tds, tinfo):
    assert tds.num == jds.num and tds.max_node_num == jds.max_node_num
    np.testing.assert_array_equal(tds.enabled_node_nums, jds.enabled_node_nums)
    for name in ("features", "labels", "mask_label"):
        a, b = getattr(tds, name), getattr(jds, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert len(tds.adjs) == len(jds.adjs)
    for g, (tg, jg) in enumerate(zip(tds.adjs, jds.adjs)):
        assert len(tg) == len(jg)
        for tc, jc in zip(tg, jg):
            for ta, ja in zip(tc, jc):
                np.testing.assert_array_equal(ta, ja, err_msg=f"graph {g}")
    for name in ("feature_dim", "graph_node_num", "graph_num", "label_dim",
                 "adj_channel_num", "feature_enabled", "edge_budget_per_graph"):
        assert getattr(tinfo, name) == getattr(jinfo, name), name
    for name in ("pos_weight", "class_weight"):
        a, b = getattr(tinfo, name), getattr(jinfo, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(a, b, err_msg=name)


CONFIGS = [
    {},
    {"normalize_adj_flag": True},
    {"order": 2, "split_adj_flag": True, "normalize_adj_flag": True},
]


@pytest.mark.parametrize("path", [SYNTH, SOLUBILITY])
@pytest.mark.parametrize("cfg", CONFIGS, ids=["plain", "normalize", "order2_split"])
def test_load_jbl_matches_jax(path, cfg):
    jds, jinfo = j_load_jbl(path, cfg)
    tds, tinfo = t_load_jbl(path, cfg)
    _assert_datasets_equal(jds, jinfo, tds, tinfo)


def test_multi_dense_adj_matches_jax():
    """multi_dense_adj: channels' active rows unite for the enabled count,
    and an isolated early node does not cut a trailing one."""
    rng = np.random.RandomState(0)
    m = (rng.rand(4, 2, 6, 6) > 0.6).astype(np.float32)
    m[:, :, 5:, :] = 0      # node 5 is padding everywhere
    m[0, :, 1, :] = 0       # graph 0: node 1 isolated in both channels
    m[1, 0, 4, :] = 0       # graph 1: node 4 active in channel 1 only
    m[1, 1, 4, 0] = 1.0
    data = {"multi_dense_adj": list(m), "feature": rng.rand(4, 6, 3),
            "label": np.eye(2)[[0, 1, 0, 1]]}
    jds, jinfo = j_build_dataset(dict(data), {})
    tds, tinfo = t_build_dataset(dict(data), {})
    _assert_datasets_equal(jds, jinfo, tds, tinfo)


def _assert_batches_equal(jb, tb):
    for name in ("labels", "mask_label", "pad_mask"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)), err_msg=name)
        assert getattr(tb, name).numpy().dtype == np.asarray(getattr(jb, name)).dtype
    jg, tg = jb.graph, tb.graph
    assert (tg.n_graph, tg.max_nodes) == (jg.n_graph, jg.max_nodes)
    for name in ("senders", "receivers", "edge_weights", "n_edge", "n_node",
                 "node_mask", "nodes"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                      np.asarray(getattr(jg, name)), err_msg=name)
    np.testing.assert_allclose(tg.dense_adjacency().numpy(),
                               np.asarray(jg.dense_adjacency()), rtol=0, atol=1e-7)


@pytest.mark.parametrize("path,batch_size,idx", [
    (SYNTH, 8, [3, 1, 4, 1 + 4, 9, 2, 6, 5]),        # full batch
    (SYNTH, 8, [7, 0, 2]),                            # partial batch
    (SOLUBILITY, 32, list(range(32))),                # the serving shape
    (SOLUBILITY, 32, [600, 5, 17, 42, 622]),          # partial, real molecules
])
def test_batcher_matches_jax(path, batch_size, idx):
    cfg = {"normalize_adj_flag": True}
    jds, jinfo = j_load_jbl(path, cfg)
    tds, tinfo = t_load_jbl(path, cfg)
    jbat, tbat = JBatcher(jds, jinfo, batch_size), TBatcher(tds, tinfo, batch_size)
    assert (tbat.max_nodes, tbat.edge_budget) == (jbat.max_nodes, jbat.edge_budget)
    _assert_batches_equal(jbat.make_batch(np.array(idx)), tbat.make_batch(np.array(idx)))


def test_batcher_rounds_nodes_past_128_and_iterates_like_jax():
    """max_nodes > 128 rounds up to a multiple of 128 (kgcn_tpu's rule);
    shuffled epochs follow the same (seed, epoch) permutation."""
    from kgcn_tpu.data.synthetic import make_random_graphs

    data = make_random_graphs(5, 130, 4, seed=1)
    jds, jinfo = j_build_dataset(dict(data), {})
    tds, tinfo = t_build_dataset(dict(data), {})
    jbat, tbat = JBatcher(jds, jinfo, 2, seed=3), TBatcher(tds, tinfo, 2, seed=3)
    assert tbat.max_nodes == jbat.max_nodes == 256
    jlist = list(jbat.batches(shuffle=True, epoch=2))
    tlist = list(tbat.batches(shuffle=True, epoch=2))
    assert len(jlist) == len(tlist) == 3
    for jb, tb in zip(jlist, tlist):
        _assert_batches_equal(jb, tb)
