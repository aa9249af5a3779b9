"""Export and the exported program's serving (kgcn_tpu_torch/runtime/export.py,
runtime/serve.ExportPredictor, cli/serve.py --export, cli.main train's
``export_model``) on the CPU:

* ``export_model`` → ``ExportPredictor`` against the port's ``Predictor``
  on the same checkpoint (1e-6: the same ops, traced) and against
  ``kgcn_tpu``'s ``ExportPredictor`` of its own export from the same
  weights (1e-5), for gcn (solubility molecules, COO requests) and
  gcn_multimodal (example_jbl/multimodal.jbl, dense requests with
  sequences);
* the program holds the ``kgcn_torch::gconv`` custom op, once per
  GraphConv, and the dense adjacency goes into nothing else;
* a request smaller than the traced batch is padded; one with more nodes,
  other per-graph widths or a missing modality raises ``ValueError``;
  ``export_model`` on the tiled backend raises;
* ``cli.main train`` with ``export_model`` writes both files, and
  ``cli/serve.py --export`` answers over HTTP.
"""
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.runtime import checkpoint as tckpt
from kgcn_tpu_torch.runtime import export as tex
from kgcn_tpu_torch.runtime.serve import ExportPredictor, Predictor
from test_torch_serve import _get, _post, _solubility_payload

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAME = dict(rtol=1e-6, atol=1e-6)
TOL = dict(rtol=1e-5, atol=1e-5)


def _multimodal_payload(idx):
    from kgcn_tpu_torch.data import jbl

    data = jbl.load(os.path.join(REPO, "example_jbl", "multimodal.jbl"))
    return data, {
        "feature": np.asarray(data["feature"])[idx].tolist(),
        "dense_adj": np.asarray(data["dense_adj"])[idx].tolist(),
        "sequence": np.asarray(data["sequence"])[idx].tolist(),
        "sequence_length": np.asarray(data["sequence_length"])[idx].tolist(),
        "sequence_symbol_num": int(data["sequence_symbol_num"]),
        "max_node_num": int(data["max_node_num"]),
    }


def _models(tmp_path, name, data, batch_size, graphs=None):
    """A seeded ``kgcn_tpu`` model (noisy BN statistics where it has BN)
    exported by both packages from the same weights, and the port's
    checkpoint of them: (cfg, port export path, JAX export path,
    checkpoint path, port model, sample batch).  ``graphs``: the request's
    graph indices, which ``kgcn_tpu``'s sample batch is built from: its
    exported signature must be what its ``ExportPredictor`` builds for the
    request (edge budget, ELL arrays by a per-dataset gate)."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.models.registry import build_model as j_model
    from kgcn_tpu.runtime.export import export_model as j_export
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model

    cfg = {"model.py": name, "task": "classification", "batch_size": batch_size,
           "normalize_adj_flag": True, "label_dim": 2,
           "save_model_path": str(tmp_path / "model")}
    jdata = dict(data)
    if graphs is not None:
        for k in ("feature", "dense_adj", "adj", "label", "mask_label", "sequence",
                  "sequence_length"):
            if k in jdata:
                jdata[k] = [jdata[k][i] for i in graphs]
    jds, jinfo = j_build(jdata, cfg)
    jtr = JTrainer(j_model(name, jinfo, cfg), cfg, jinfo)
    jsample = JBatcher(jds, jinfo, batch_size).make_batch(np.arange(batch_size))
    state = jtr.init_state(jsample, seed=3)
    rng = np.random.RandomState(0)
    stats = jax.tree_util.tree_map(
        lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32) * 0.3 + 0.1,
        jax.device_get(state.batch_stats))
    variables = {"params": jax.device_get(state.params), "batch_stats": stats}
    jpath = str(tmp_path / "jax.export")
    j_export(jtr.model, variables, jsample, jpath)

    ds, info = build_dataset(dict(data), cfg)
    model = build_model(name, info, cfg)
    tree = params_from_jax(variables["params"], stats, model)
    ckpt = tckpt.save_checkpoint(str(tmp_path / "model" / "model.best.ckpt"),
                                 tree["params"], tree["batch_stats"])
    sample = Batcher(ds, info, batch_size).make_batch(np.arange(batch_size))
    path = tex.export_model(model, tree["params"], tree["batch_stats"], sample,
                            str(tmp_path / "port.pt2"))
    return cfg, path, jpath, ckpt, model, sample


GRAPHS = {"gcn": [0, 5, 17, 42, 300, 622, 7, 8, 9], "gcn_multimodal": list(range(11))}
CASES = {
    "gcn": lambda: _solubility_payload(GRAPHS["gcn"]),
    "gcn_multimodal": lambda: _multimodal_payload(GRAPHS["gcn_multimodal"]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_exported_program_answers_as_the_predictor_and_kgcn_tpu(tmp_path, name):
    from kgcn_tpu.runtime.serve import ExportPredictor as JExportPredictor

    data, payload = CASES[name]()
    cfg, path, jpath, ckpt, _, _ = _models(tmp_path, name, data, batch_size=4,
                                           graphs=GRAPHS[name])
    assert os.path.exists(path + ".params")
    ep = ExportPredictor(path, cfg, device="cpu")
    assert (ep.batch_size, ep.label_dim) == (4, 2)
    got = ep.predict(payload)  # 9 or 11 graphs: chunks of 4, the last padded
    want = Predictor(cfg, checkpoint=ckpt, device="cpu").predict(payload)
    assert got["num"] == want["num"] == len(payload["feature"])
    np.testing.assert_allclose(got["prediction"], want["prediction"], **SAME)
    jwant = JExportPredictor(jpath, cfg).predict(payload)
    np.testing.assert_allclose(got["prediction"], jwant["prediction"], **TOL)
    assert ep.health() == {"status": "ok", "export": path, "ready": True, "requests": 1}
    params = tckpt.load_checkpoint(path + ".params")
    assert set(params["params"]) == set(torch.load(ckpt)["params"])


@pytest.mark.parametrize("name,calls", [("gcn", 3), ("gcn_multimodal", 1)])
def test_the_program_holds_the_gconv_op(tmp_path, name, calls):
    data, _ = CASES[name]()
    _, path, _, _, _, _ = _models(tmp_path, name, data, batch_size=4)
    ep = tex.load_exported(path)
    op = torch.ops.kgcn_torch.gconv.default
    nodes = [n for n in ep.graph.nodes if n.op == "call_function" and n.target == op]
    assert len(nodes) == calls
    adj = [n for n in ep.graph.nodes if n.op == "placeholder" and "dense_adj" in n.name]
    assert len(adj) == 1 and {u.target for u in adj[0].users} == {op}
    assert not any("einsum" in str(n.target) for n in ep.graph.nodes)


def test_small_wrong_and_overflowing_requests(tmp_path):
    data, payload = _multimodal_payload(list(range(3)))
    cfg, path, _, ckpt, _, _ = _models(tmp_path, "gcn_multimodal", data, batch_size=8)
    ep = ExportPredictor(path, cfg, device="cpu")
    got = ep.predict(payload)  # 3 graphs into the traced batch of 8
    assert got["num"] == 3 and np.asarray(got["prediction"]).shape == (3, 2)
    want = Predictor(cfg, checkpoint=ckpt, device="cpu").predict(payload)
    np.testing.assert_allclose(got["prediction"], want["prediction"], **SAME)
    no_seq = {k: v for k, v in payload.items()
              if k not in ("sequence", "sequence_length", "sequence_symbol_num")}
    with pytest.raises(ValueError, match="exported signature"):
        ep.predict(no_seq)
    wide = dict(payload, feature=np.pad(np.asarray(payload["feature"]),
                                        ((0, 0), (0, 0), (0, 1))).tolist())
    with pytest.raises(ValueError, match="shape"):
        ep.predict(wide)
    n = len(payload["dense_adj"][0]) + 2
    big = dict(payload, max_node_num=n,
               dense_adj=np.pad(np.asarray(payload["dense_adj"]),
                                ((0, 0), (0, 2), (0, 2)), constant_values=1.0).tolist(),
               feature=np.pad(np.asarray(payload["feature"]),
                              ((0, 0), (0, 2), (0, 0)), constant_values=1.0).tolist())
    with pytest.raises(ValueError, match="nodes"):
        ep.predict(big)
    assert ep.requests == 1


def test_export_refuses_the_tiled_backend(tmp_path):
    data, _ = CASES["gcn"]()
    _, _, _, _, model, sample = _models(tmp_path, "gcn", data, batch_size=4)
    tiled = sample.replace(graph=sample.graph.replace(backend="tiled"))
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.4"):
        tex.export_model(model, dict(model.named_parameters()),
                         dict(model.named_buffers()), tiled, str(tmp_path / "t.pt2"))
    assert not os.path.exists(tmp_path / "t.pt2")


def test_cli_train_export_model_and_serve_export_over_http(tmp_path):
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.cli.serve import build_server

    data, payload = _multimodal_payload(list(range(30)))
    with open(os.path.join(REPO, "example_config", "multimodal.json")) as f:
        cfg = json.load(f)
    cfg.update(dataset=os.path.join(REPO, cfg["dataset"]), epoch=1, save_interval=0,
               save_model_path=str(tmp_path / "model"),
               export_model=str(tmp_path / "export" / "model.pt2"))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    t_main(["train", "--config", str(path), "--cpu"])
    assert os.path.exists(cfg["export_model"]) and os.path.exists(cfg["export_model"] + ".params")
    want = Predictor(cfg, checkpoint=cfg["export_model"] + ".params",
                     device="cpu").predict(payload)
    server, predictor = build_server(cfg, host="127.0.0.1", port=0,
                                     export=cfg["export_model"], dynamic_batching=True,
                                     device="cpu")
    assert isinstance(predictor, ExportPredictor)  # an export is not batched
    base = f"http://127.0.0.1:{server.server_address[1]}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        code, resp = _post(base + "/predict", json.dumps(payload).encode())
        assert code == 200 and resp["num"] == 30
        np.testing.assert_allclose(resp["prediction"], want["prediction"], **SAME)
        code, health = _get(base + "/healthz")
        assert code == 200 and health["export"] == cfg["export_model"]
        code, err = _post(base + "/predict", json.dumps(
            {k: v for k, v in payload.items() if k != "sequence"}).encode())
        assert code == 400 and "error" in err
    finally:
        server.shutdown()
        server.server_close()
        t.join(timeout=10)
