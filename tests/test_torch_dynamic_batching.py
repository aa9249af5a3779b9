"""Dynamic batching of the port (kgcn_tpu_torch/runtime/serve.DynamicBatcher,
cli/serve.py --dynamic-batching) on the CPU — the counterparts of
tests/test_serve.py's DynamicBatcher tests:

* concurrent requests coalesce into fewer ``Predictor`` calls, each reply
  equal to its molecule's solo reply (1e-6: per-graph arithmetic in
  batches of another size) and to ``kgcn_tpu``'s ``DynamicBatcher`` on the
  same weights (1e-5); the same for gcn_multimodal's sequence requests;
* a bad request inside a merged call fails alone (the merged call is
  retried one request at a time);
* ``sequence_length`` merges per graph; requests with unmergeable keys run
  alone; ``max_graphs`` splits a window's requests; ``close()`` refuses
  new requests;
* ``--dynamic-batching`` end to end over HTTP.
"""
import json
import os
import threading

import numpy as np
import pytest
import torch

from kgcn_tpu_torch.runtime.serve import DynamicBatcher, Predictor, payload_to_data
from test_torch_export import _models, _multimodal_payload
from test_torch_serve import _checkpoints, _get, _post, _solubility_payload

torch.set_num_threads(1)

SAME = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)


def _concurrently(fn, payloads):
    """``fn(payload)`` for each payload, all from their own threads at once;
    the results (or exceptions) in order."""
    out = [None] * len(payloads)

    def run(i):
        try:
            out[i] = fn(payloads[i])
        except Exception as e:  # returned, for the caller to check
            out[i] = e

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    return out


def _solubility(tmp_path, molecules, batch_size=32):
    from kgcn_tpu.runtime.serve import Predictor as JPredictor

    data, _ = _solubility_payload([0])
    jcfg, tcfg = _checkpoints(tmp_path, data, batch_size)
    singles = [_solubility_payload([i])[1] for i in molecules]
    return JPredictor(jcfg), Predictor(tcfg, device="cpu"), tcfg, singles


def test_concurrent_requests_coalesce_and_match_solo_and_kgcn_tpu(tmp_path):
    from kgcn_tpu.runtime.serve import DynamicBatcher as JDynamicBatcher

    jbase, base, tcfg, singles = _solubility(tmp_path, range(8))
    solo = Predictor(tcfg, device="cpu")
    want = [np.asarray(solo.predict(p)["prediction"]) for p in singles]
    db = DynamicBatcher(base, window_ms=200.0)
    got = _concurrently(db.predict, singles)
    jdb = JDynamicBatcher(jbase, window_ms=200.0)
    jgot = _concurrently(jdb.predict, singles)
    for i, (r, jr) in enumerate(zip(got, jgot)):
        assert not isinstance(r, Exception), r
        assert r["num"] == 1
        np.testing.assert_allclose(r["prediction"], want[i], err_msg=str(i), **SAME)
        np.testing.assert_allclose(r["prediction"], jr["prediction"], err_msg=str(i), **TOL)
    assert db.coalesced_calls >= 1 and base.requests < 8
    assert max(r.get("coalesced", 1) for r in got) > 1
    h = db.health()
    assert h["dynamic_batching"] == {"window_ms": 200.0, "max_graphs": 256,
                                     "coalesced_calls": db.coalesced_calls}
    assert h["graphs_served"] == 8
    db.close()
    jdb.close()


def test_multimodal_sequence_requests_coalesce(tmp_path):
    data, _ = _multimodal_payload([0])
    cfg, _, _, ckpt, _, _ = _models(tmp_path, "gcn_multimodal", data, batch_size=25)
    singles = [_multimodal_payload([i])[1] for i in range(10)]
    solo = Predictor(cfg, checkpoint=ckpt, device="cpu")
    want = [solo.predict(p)["prediction"] for p in singles]
    base = Predictor(cfg, checkpoint=ckpt, device="cpu")
    db = DynamicBatcher(base, window_ms=200.0)
    got = _concurrently(db.predict, singles)
    for r, w in zip(got, want):
        assert not isinstance(r, Exception), r
        np.testing.assert_allclose(r["prediction"], w, **SAME)
    assert db.coalesced_calls >= 1
    db.close()


def test_a_bad_request_in_a_merged_call_fails_alone(tmp_path):
    """The bad request has the good ones' schema (COO adjacency) but a node
    index past max_node_num: the merged call fails, and the retry one by
    one fails it alone."""
    _, base, tcfg, singles = _solubility(tmp_path, range(4))
    bad = json.loads(json.dumps(singles[0]))
    bad["adj"][0][0][0][0] = [0, 90]  # an edge to node 90 of a 47-node graph
    db = DynamicBatcher(base, window_ms=500.0)  # all five in one window
    got = _concurrently(db.predict, singles[:2] + [bad] + singles[2:])
    assert isinstance(got[2], Exception)
    solo = Predictor(tcfg, device="cpu")
    for i, r in zip((0, 1, 2, 3), got[:2] + got[3:]):
        assert not isinstance(r, Exception), r
        assert "coalesced" not in r  # answered by the retry, alone
        np.testing.assert_allclose(r["prediction"], solo.predict(singles[i])["prediction"],
                                   **SAME)
    assert db.coalesced_calls == 0
    db.close()


def test_merge_concatenates_sequence_lengths():
    d1 = payload_to_data({
        "feature": np.zeros((2, 4, 3)).tolist(),
        "dense_adj": np.eye(4)[None].repeat(2, 0).tolist(),
        "max_node_num": 4,
        "sequence": np.ones((2, 6), np.int32).tolist(),
        "sequence_length": [5, 6],
        "sequence_symbol_num": 7,
    })
    d2 = payload_to_data({
        "feature": np.zeros((1, 4, 3)).tolist(),
        "dense_adj": np.eye(4)[None].tolist(),
        "max_node_num": 3,
        "sequence": np.ones((1, 6), np.int32).tolist(),
        "sequence_length": [3],
        "sequence_symbol_num": 7,
    })
    assert d1["sequence_length"].dtype == np.int32
    db = object.__new__(DynamicBatcher)  # _merge and _schema read no state
    assert db._schema(d1) == db._schema(d2)
    merged = db._merge([d1, d2])
    assert merged["sequence"].shape == (3, 6) and merged["feature"].shape == (3, 4, 3)
    np.testing.assert_array_equal(merged["sequence_length"], [5, 6, 3])
    assert merged["max_node_num"] == 4 and int(merged["sequence_symbol_num"]) == 7


def test_unmergeable_requests_run_solo(tmp_path):
    db = object.__new__(DynamicBatcher)
    ok = payload_to_data({"feature": np.zeros((1, 4, 3)).tolist(),
                          "dense_adj": np.eye(4)[None].tolist(), "max_node_num": 4})
    assert db._coalescable(ok)
    assert not db._coalescable(dict(ok, graph_index_list=[(0, 0)]))
    assert not db._coalescable(dict(ok, mol_info=[{"name": "x"}]))
    assert db._coalescable(dict(ok, node=[np.arange(4, dtype=np.int32)], node_num=4))
    # end to end: requests with mol_info (a per-graph key without merge
    # semantics) are answered alone, beside coalesced ones
    _, base, _, singles = _solubility(tmp_path, range(4))
    tagged = [dict(p, mol_info=[f"m{i}"]) for i, p in enumerate(singles[:2])]
    dbx = DynamicBatcher(base, window_ms=500.0)  # all four in one window
    got = _concurrently(dbx.predict, tagged + singles[2:])
    assert all("coalesced" not in r for r in got[:2])
    assert all(r.get("coalesced") == 2 for r in got[2:])
    dbx.close()


def test_max_graphs_splits_a_window(tmp_path):
    _, base, _, singles = _solubility(tmp_path, range(7))
    db = DynamicBatcher(base, window_ms=300.0, max_graphs=3)
    got = _concurrently(db.predict, singles)
    assert all(not isinstance(r, Exception) for r in got)
    assert all(r.get("coalesced", 1) <= 3 for r in got)
    assert base.requests >= 3 and base.graphs_served == 7
    db.close()


def test_close_refuses_new_requests(tmp_path):
    _, base, _, singles = _solubility(tmp_path, range(1))
    db = DynamicBatcher(base, window_ms=1.0)
    assert db.predict(singles[0])["num"] == 1
    db.close()
    db._worker.join(timeout=10)
    assert not db._worker.is_alive()
    with pytest.raises(RuntimeError, match="closed"):
        db.predict(singles[0])


def test_dynamic_batching_over_http(tmp_path):
    from kgcn_tpu_torch.cli.serve import build_server

    data, _ = _solubility_payload([0])
    _, tcfg = _checkpoints(tmp_path, data, 32)
    singles = [_solubility_payload([i])[1] for i in range(6)]
    solo = Predictor(tcfg, device="cpu")
    want = [solo.predict(p)["prediction"] for p in singles]
    server, predictor = build_server(tcfg, host="127.0.0.1", port=0, device="cpu",
                                     dynamic_batching=True, window_ms=200.0,
                                     max_graphs=64)
    assert isinstance(predictor, DynamicBatcher)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        got = _concurrently(lambda p: _post(base + "/predict", json.dumps(p).encode()),
                            singles)
        for (code, resp), w in zip(got, want):
            assert code == 200
            np.testing.assert_allclose(resp["prediction"], w, **SAME)
        code, health = _get(base + "/healthz")
        assert code == 200 and health["dynamic_batching"]["coalesced_calls"] >= 1
        assert health["dynamic_batching"]["max_graphs"] == 64
        code, err = _post(base + "/predict", b'{"feature": "x"}')
        assert code == 400 and "error" in err
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
        predictor.close()
