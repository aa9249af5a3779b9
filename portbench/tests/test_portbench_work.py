"""The least-work counts against hand counts at tiny sizes."""
from __future__ import annotations

import pytest

from portbench import work
from portbench.registry import Registry

H100 = work.peaks("NVIDIA H100 80GB HBM3")


def test_primitives():
    assert work.matmul_flops(2, 3, 4) == 48
    assert work.matmul_flops(2, 3, 4, grads=2) == 144
    c = work.graph_conv_call(atoms=5, edges=8, fin=3, fout=2)
    # 2·5·3·2 projection + 2·8·2 aggregation
    assert c["flops"] == 60 + 32
    # X 5·3·4, W and b 1·(3+1)·2·4, edges 8·(4+4), row pointers 6·4, Y 5·2·4
    assert c["bytes"] == 60 + 32 + 64 + 24 + 40
    s = work.scatter_call(edges=10, senders=4, receivers=3, features=2, weight_bytes=2)
    assert s["flops"] == 40
    assert s["bytes"] == 4 * 2 * 4 + 3 * 2 * 4 + 10 * 6 + 4 * 4
    assert work.least_seconds(67e12, 0, H100) == pytest.approx(1.0)
    assert work.least_seconds(0, 3.35e12, H100) == pytest.approx(1.0)
    assert work.peaks("a card the table lacks") is None


def test_sparse_step_flops_by_hand():
    reg = Registry()
    mfu = reg.metric("mfu.rxn")
    cfg = {"program": {"out_dims": [4, 4], "dense_dim": 3, "num_classes": 5},
           "data": {"atom_features": 2, "bond_channels": 1}}
    step = {"graphs": 2, "atoms": 7, "edges": 10}
    want = (2 * 7 * 2 * 4 * 2      # layer 1: forward and dW (its input is data)
            + 2 * 7 * 4 * 4 * 3    # layer 2: forward, dX, dW
            + 2 * (2 * 10 * 4) * 2  # two aggregations, forward and backward
            + 2 * 7 * 4 * 3 * 3    # GraphDense
            + 2 * 2 * 3 * 5 * 3)   # the head over the real graphs
    assert mfu.step_flops(cfg, step) == want


def test_kg_step_flops_by_hand():
    mfu = Registry().metric("mfu.kg")
    graph = {"dim": 2, "channels": [{"edges": 6, "senders": 3, "receivers": 4}]}
    want = 2 * (2 * 3 * 2 * 2 * 3 + 2 * 2 * 6 * 2) + 5 * 2 * 9 * 2
    assert mfu.step_flops(graph, {"labels": 5, "rows": 8}) == want


def test_roofline_counts_by_hand():
    reg = Registry()
    g = reg.metric("gconv_roofline")
    cfg = {"program": {"out_dims": [4]}, "data": {"atom_features": 2, "bond_channels": 1}}
    step = {"graphs": 1, "atoms": 3, "edges": 4}
    flops = 2 * 3 * 2 * 4 + 2 * 4 * 4
    nbytes = 3 * 2 * 4 + (2 + 1) * 4 * 4 + 4 * 8 + 4 * 4 + 3 * 4 * 4
    assert g.step_least_seconds(cfg, step, H100) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))
    s = reg.metric("stream_roofline")
    graph = {"dim": 2, "payload": "bfloat16",
             "channels": [{"edges": 5, "senders": 3, "receivers": 2}]}
    fwd = 3 * 2 * 4 + 2 * 2 * 4 + 5 * 6 + 3 * 4
    bwd = 2 * 2 * 4 + 3 * 2 * 4 + 5 * 6 + 4 * 4
    assert s.step_least_seconds(graph, H100) == pytest.approx(2 * (fwd + bwd) / 3.35e12)
