"""The port's serving path (kgcn_tpu_torch/runtime/serve.py, cli/serve.py)
against the JAX package's ``Predictor`` on the same requests and weights,
on the CPU.  Tolerance: float32, rtol = atol = 1e-5."""
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from kgcn_tpu.data import Batcher as JBatcher
from kgcn_tpu.data import build_dataset as j_build_dataset
from kgcn_tpu.data.synthetic import make_ring_dataset
from kgcn_tpu.runtime import checkpoint as jckpt
from kgcn_tpu.runtime.config import default_config
from kgcn_tpu.runtime.serve import Predictor as JPredictor
from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.data import jbl
from kgcn_tpu_torch.runtime import checkpoint as tckpt
from kgcn_tpu_torch.runtime.serve import Predictor as TPredictor

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _ring_payload(n_pairs=6):
    data = make_ring_dataset(num_pairs=n_pairs, num_nodes=10, seed=0)
    return data, {
        "feature": np.asarray(data["feature"]).tolist(),
        "dense_adj": np.asarray(data["dense_adj"]).tolist(),
        "max_node_num": int(data["max_node_num"]),
    }


def _solubility_payload(idx):
    """Real molecules as a COO-adjacency request (the jbl ``adj`` schema)."""
    data = jbl.load("examples/solubility/solubility_cls.jbl")
    return data, {
        "feature": np.asarray(data["feature"])[idx].tolist(),
        "adj": [[[np.asarray(data["adj"][i][0]).tolist(),
                  np.asarray(data["adj"][i][1]).tolist(),
                  list(data["adj"][i][2])]] for i in idx],
        "max_node_num": int(data["max_node_num"]),
    }


def _checkpoints(tmp_path, data, batch_size):
    """A seeded GCN of the JAX package with noisy BN statistics, saved as a
    JAX checkpoint and, converted, as a port checkpoint.  Returns the two
    configs."""
    from kgcn_tpu.models.registry import build_model
    from kgcn_tpu.runtime.train import Trainer

    cfg = default_config()
    cfg.update({"model.py": "gcn", "task": "classification",
                "batch_size": batch_size, "normalize_adj_flag": True,
                "label_dim": 2, "save_model_path": str(tmp_path / "jax")})
    ds, info = j_build_dataset(dict(data), cfg)
    trainer = Trainer(build_model("gcn", info, cfg), cfg, info)
    state = trainer.init_state(JBatcher(ds, info, batch_size).make_batch(np.arange(2)),
                               seed=3)
    rng = np.random.RandomState(0)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32) * 0.3 + 0.1,
        jax.device_get(state.batch_stats),
    )
    state = state.replace(batch_stats=stats)
    jckpt.save_checkpoint(str(tmp_path / "jax" / "model.best.ckpt"),
                          trainer.state_tree(state, 0, 0.0))
    tree = params_from_jax(jax.device_get(state.params), stats)
    tckpt.save_checkpoint(str(tmp_path / "torch" / "model.best.ckpt"),
                          tree["params"], tree["batch_stats"])
    return cfg, dict(cfg, save_model_path=str(tmp_path / "torch"))


@pytest.mark.parametrize("request_kind", ["ring_dense_adj", "solubility_coo_adj"])
def test_predictor_matches_jax_predictor(tmp_path, request_kind):
    if request_kind == "ring_dense_adj":
        data, payload = _ring_payload()
        batch_size = 5   # 12 graphs: two full batches and a partial one
    else:
        data, payload = _solubility_payload([0, 5, 17, 42, 300, 622])
        batch_size = 4
    jcfg, tcfg = _checkpoints(tmp_path, data, batch_size)
    want = JPredictor(jcfg).predict(payload)
    port = TPredictor(tcfg, device="cpu")
    got = port.predict(payload)
    assert got["num"] == want["num"]
    np.testing.assert_allclose(np.asarray(got["prediction"]),
                               np.asarray(want["prediction"]), **TOL)
    # a second request reuses the built model
    again = port.predict(payload)
    np.testing.assert_allclose(again["prediction"], got["prediction"])
    assert port.requests == 2 and port.graphs_served == 2 * got["num"]
    assert port.health()["backend"] == "cpu"


def test_denser_request_after_a_small_one(tmp_path):
    """The edge budget follows each request: kgcn_tpu's Predictor keeps the
    first request's and refuses a later, denser one (ROADMAP.md C)."""
    data, small = _solubility_payload([0])
    _, large = _solubility_payload(list(range(1, 33)))
    _, tcfg = _checkpoints(tmp_path, data, 32)
    p = TPredictor(tcfg, device="cpu")
    p.predict(small)
    got = p.predict(large)
    want = TPredictor(tcfg, device="cpu").predict(large)
    assert got["num"] == 32
    np.testing.assert_allclose(got["prediction"], want["prediction"], **TOL)


def test_serve_info_sidecar_and_label_free_requests(tmp_path):
    """serve_info.json fills label_dim / serve_max_nodes that the request
    does not carry; requests without labels get zero labels."""
    data, payload = _ring_payload(2)
    _, tcfg = _checkpoints(tmp_path, data, 4)
    del tcfg["label_dim"]
    with open(tmp_path / "torch" / "serve_info.json", "w") as f:
        json.dump({"label_dim": 2, "graph_node_num": 12}, f)
    p = TPredictor(tcfg, device="cpu")
    assert p.config["label_dim"] == 2 and p.max_nodes == 12
    resp = p.predict(payload)
    assert resp["num"] == 4 and p.health()["max_nodes"] == 12
    np.testing.assert_allclose(np.sum(resp["prediction"], axis=1), 1.0, rtol=1e-6)


def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return r.status, json.loads(r.read())


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_http_server_end_to_end(tmp_path):
    from kgcn_tpu_torch.cli.serve import build_server

    data, payload = _ring_payload(3)
    jcfg, tcfg = _checkpoints(tmp_path, data, 4)
    want = np.asarray(JPredictor(jcfg).predict(payload)["prediction"])
    server, _ = build_server(tcfg, host="127.0.0.1", port=0, device="cpu")
    base = f"http://127.0.0.1:{server.server_address[1]}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        code, health = _get(base + "/healthz")
        assert code == 200 and health["status"] == "ok" and health["ready"] is False
        code, resp = _post(base + "/predict", json.dumps(payload).encode())
        assert code == 200 and resp["latency_ms"] > 0
        np.testing.assert_allclose(np.asarray(resp["prediction"]), want, **TOL)
        code, health = _get(base + "/healthz")
        assert health["ready"] is True and health["requests"] == 1
        code, err = _post(base + "/predict", b'{"feature": "x"}')
        assert code == 400 and "error" in err
        code, err = _post(base + "/nope", b"{}")
        assert code == 404
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_missing_checkpoint_is_503(tmp_path):
    from kgcn_tpu_torch.cli.serve import make_handler
    from http.server import ThreadingHTTPServer

    data, payload = _ring_payload(1)
    cfg = dict(default_config(), **{"model.py": "gcn", "label_dim": 2,
                                    "save_model_path": str(tmp_path / "none")})
    server = ThreadingHTTPServer(("127.0.0.1", 0),
                                 make_handler(TPredictor(cfg, device="cpu")))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        code, err = _post(f"http://127.0.0.1:{server.server_address[1]}/predict",
                          json.dumps(payload).encode())
        assert code == 503 and "checkpoint not found" in err["error"]
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
