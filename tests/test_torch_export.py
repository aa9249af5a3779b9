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
* on the ``tiled``, ``stream``, ``pallas`` and ``xla`` backends the
  exported program answers as the ``Predictor`` does (1e-6) and as
  ``kgcn_tpu``'s exported program of the same backend (1e-5), through its
  backend's custom op once per layer;
* called as a trace calls them, the custom ops' registered backward gives
  the eager autograd Functions' gradients, bitwise; a ``Batcher`` given
  the traced structure budgets builds the same batches and raises where a
  batch needs more;
* ``cli.main train`` with ``export_model`` writes both files, and
  ``cli/serve.py --export`` answers over HTTP.
"""
import contextlib
import functools
import importlib
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


# case → (backend, payload dtype, model, nodes a ring graph, batch size, the
# custom op each layer calls and its call count in the program).  The bf16
# stream case takes the one-hot route (baked bf16 one-hots); its answers
# are bf16 products, so it is held to the port's own model, not to the
# Predictor's dense float32 path
SPARSE = {"tiled": ("tiled", "float32", "gcn", 40, 4, "tiled_spmm", 3),
          "stream": ("stream", "float32", "gcn", 40, 1, "stream_scatter", 3),
          "stream-bf16": ("stream", "bfloat16", "gcn", 40, 1, "stream_scatter_mat", 3),
          "pallas": ("pallas", "float32", "gin", 6, 4, "ell_spmm", 2),
          "xla": ("xla", "float32", "gin", 6, 4, None, 0)}


@contextlib.contextmanager
def _jax_backend(name, dtype):
    """The JAX package's globals for ``name`` (Pallas interpreted on the
    CPU), restored after."""
    from jax.experimental import pallas as pl
    from kgcn_tpu.graph.batch import set_dense_path
    from kgcn_tpu.ops import pallas_spmm
    from kgcn_tpu.runtime.backend import apply_backend

    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    apply_backend(name, {"tiled_compute_dtype": dtype}, log=False)
    try:
        yield
    finally:
        apply_backend("dense", log=False)
        importlib.import_module("kgcn_tpu.ops.spmm").set_backend("xla")
        set_dense_path(True)
        pl.pallas_call = orig
        pallas_spmm._KERNEL_OK.clear()


@pytest.mark.parametrize("case", sorted(SPARSE))
def test_export_on_the_sparse_backends(tmp_path, case):
    """``export_model`` of a model trained on ``tiled``, ``stream``,
    ``pallas`` or ``xla`` (ring graphs; GCN, and GIN on the ELL arrays):
    the ``ExportPredictor``'s answers equal the port's ``Predictor`` on the
    same checkpoint (1e-6; bf16 stream: the port's model on the same
    batches), including a chunk padded below the traced batch; the
    program's answers on the same batches equal the port's model's (1e-6)
    and ``kgcn_tpu``'s
    exported program of its own backend (1e-5; ``jax.export`` of its
    inference function, as its ``export_model`` traces it); the program
    holds the backend's custom op once per layer and no other."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.models.registry import build_model as j_model
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.backend import resolve

    backend, dtype, name, nodes, bs, op, calls = SPARSE[case]
    data = make_ring_dataset(num_pairs=6, num_nodes=nodes, seed=1)
    cfg = {"model.py": name, "task": "classification", "batch_size": bs,
           "label_dim": 2, "spmm_backend": backend, "tiled_compute_dtype": dtype,
           "save_model_path": str(tmp_path / "model")}
    chunks = [np.arange(i, min(i + bs, 10)) for i in range(0, 10, bs)]
    with _jax_backend(backend, dtype):
        jds, jinfo = j_build(dict(data), dict(cfg))
        jtr = JTrainer(j_model(name, jinfo, dict(cfg)), dict(cfg), jinfo)
        jb = JBatcher(jds, jinfo, bs)
        jsample = jb.make_batch(np.arange(bs))
        state = jtr.init_state(jsample, seed=3)
        rng = np.random.RandomState(0)
        stats = jax.tree_util.tree_map(
            lambda a: np.abs(rng.standard_normal(a.shape)).astype(np.float32) * 0.3 + 0.1,
            jax.device_get(state.batch_stats))
        variables = {"params": jax.device_get(state.params), "batch_stats": stats}
        # kgcn_tpu's export_model traces this function with jax.export; its
        # serialization has no entry for the tiled and stream structures,
        # so the program is taken as jax.export makes it, in memory
        exported = jax.export.export(jax.jit(
            lambda batch: jtr.model.apply(variables, batch, train=False).prediction))(jsample)
        jwant = [np.asarray(exported.call(jb.make_batch(idx))) for idx in chunks]

    ds, info = build_dataset(dict(data), cfg)
    model = build_model(name, info, cfg)
    tree = params_from_jax(variables["params"], stats, model)
    ckpt = tckpt.save_checkpoint(str(tmp_path / "model" / "model.best.ckpt"),
                                 tree["params"], tree["batch_stats"])
    b = Batcher(ds, info, bs, backend=resolve(cfg, info, log=False))
    path = tex.export_model(model, tree["params"], tree["batch_stats"],
                            b.make_batch(np.arange(bs)), str(tmp_path / "port.pt2"))
    ep = tex.load_exported(path)
    model.load_state_dict({**tree["params"], **tree["batch_stats"]})
    model.eval()
    for idx, want in zip(chunks, jwant):
        batch = b.make_batch(idx)
        with torch.no_grad():
            got = ep.module()(tex.export_batch(batch))
            mine = model(batch, train=False).prediction
        np.testing.assert_allclose(got.numpy(), mine.numpy(), **SAME)
        np.testing.assert_allclose(got.numpy(), want, **TOL)

    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert sum(t.startswith("kgcn_torch.") for t in targets) == calls
    if op is not None:
        assert targets.count(f"kgcn_torch.{op}.default") == calls

    payload = {"feature": np.asarray(data["feature"])[:7].tolist(),
               "dense_adj": np.asarray(data["dense_adj"])[:7].tolist(),
               "max_node_num": nodes}
    got = ExportPredictor(path, cfg, device="cpu").predict(payload)
    if dtype == "float32":
        want = Predictor(cfg, checkpoint=ckpt, device="cpu").predict(payload)["prediction"]
    else:  # batch 1: the port's model graph by graph
        with torch.no_grad():
            want = np.concatenate([model(b.make_batch(np.array([i])), train=False).prediction
                                   for i in range(7)])
    assert got["num"] == 7
    np.testing.assert_allclose(got["prediction"], want, **SAME)


def _op_case(kind):
    """(the product as the wrapper runs it: fn(w, x), its custom op's module
    and name, w, x, whether w takes a gradient) on a small seeded graph."""
    from kgcn_tpu_torch.ops import ell_spmm as tes
    from kgcn_tpu_torch.ops import stream_spmm as ts
    from kgcn_tpu_torch.ops import tiled_spmm as tt

    rng = np.random.RandomState(5)
    V, E, F = 64, 300, 8
    s, r = rng.randint(0, V, E).astype(np.int32), rng.randint(0, V, E).astype(np.int32)
    w = rng.standard_normal(E).astype(np.float32)
    x = rng.standard_normal((V, F)).astype(np.float32)
    if kind == "tiled":
        te = tt.build_tiled(s, r, V, weights=w, ts=32, tr=32, chunk=16)
        return (lambda wv, xv: tt.tiled_spmm(te, wv, xv, compute_dtype="float32"),
                tt, "_tiled_spmm_op", w, x, True)
    if kind == "stream":
        ss = ts.build_stream(s, r, V, weights=w, tr_w=16, chunk=8, mc=4, wb=2,
                             materialize=False)
        return (lambda wv, xv: ts.stream_spmm_edges(ss, wv, xv, compute_dtype="float32"),
                ts, "_stream_op", w, x, True)
    if kind == "stream-onehot":
        ss = ts.build_stream(s, r, V, weights=w, tr_w=16, chunk=8, mc=4, wb=2,
                             materialize=True)
        return (lambda wv, xv: ts.stream_spmm(ss, None, xv, compute_dtype="bfloat16"),
                ts, "_stream_mat_op", w, x, False)
    idx = rng.randint(0, V, (V, 5)).astype(np.int32)
    we = rng.standard_normal((V, 5)).astype(np.float32)
    return (lambda wv, xv: tes.SpmmEll.apply(torch.from_numpy(idx), wv, xv),
            tes, "_ell_op", we, x, True)


@pytest.mark.parametrize("kind", ["tiled", "stream", "stream-onehot", "ell"])
def test_the_traced_ops_differentiate_as_the_eager_functions(monkeypatch, kind):
    """Under a trace the wrappers call the custom ops (``tiled_spmm``,
    ``stream_scatter``, ``stream_scatter_mat``, ``ell_spmm``), whose
    registered backward runs what the eager autograd Functions run: the
    same output and the same gradients, bitwise, on the CPU."""
    fn, mod, op_name, w, x, need_w = _op_case(kind)
    cot = torch.from_numpy(np.random.RandomState(6).standard_normal(
        (x.shape[0], x.shape[1])).astype(np.float32))
    op, calls = getattr(mod, op_name), []

    def spy(*args):
        calls.append(1)
        return op(*args)

    monkeypatch.setattr(mod, op_name, spy)

    def run(tracing):
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: tracing)
        wt = torch.tensor(w, requires_grad=need_w)
        xt = torch.tensor(x, requires_grad=True)
        out = fn(wt, xt)
        (out * cot).sum().backward()
        return out.detach(), wt.grad, xt.grad

    eager = run(False)
    assert not calls
    traced = run(True)
    assert calls == [1]
    for a, b in zip(traced, eager):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (eager[1] is not None) == need_w and eager[2] is not None


@pytest.mark.parametrize("backend", ["tiled", "stream"])
def test_a_pinned_structure_budget_raises_instead_of_growing(backend):
    """A ``Batcher`` given the structures' settings (as the
    ``ExportPredictor`` gives it the traced ones) builds the batches a
    probing ``Batcher`` builds, and raises ``ValueError`` where a batch
    needs more chunks or macros than given, keeping the budget."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.runtime.backend import resolve

    data = make_ring_dataset(num_pairs=6, num_nodes=100, seed=1)
    cfg = {"model.py": "gcn", "task": "classification", "batch_size": 4, "label_dim": 2,
           "spmm_backend": backend, "tiled_compute_dtype": "float32"}
    ds, info = build_dataset(dict(data), cfg)
    be = resolve(cfg, info, log=False)
    probe = Batcher(ds, info, 4, backend=be)
    want = probe.make_batch(np.arange(4)).graph
    if backend == "tiled":
        m = want.tiled_adj[0].meta
        pinned = dict(tiling=(m.ts, m.tr, m.chunk), chunk_budget=m.n_chunks,
                      locality=tuple(t.node_perm is not None for t in want.tiled_adj))
        unpadded = want.replace(tiled_adj=None).with_tiled(
            tiling=pinned["tiling"], feature_dim=int(info.feature_dim),
            locality=pinned["locality"]).tiled_adj
        need = max(max(t.meta.n_chunks, t.transpose.meta.n_chunks) for t in unpadded)
        small, key = dict(pinned, chunk_budget=need - 1), "_tiled_budget"
    else:
        pinned = dict(macro_budget=want.stream_adj[0].meta.n_macros)
        need = max(max(t.meta.n_macros, t.transpose.meta.n_macros)
                   for t in want.replace(stream_adj=None).with_stream().stream_adj)
        small, key = dict(macro_budget=need - 1), "_stream_budget"
    got = Batcher(ds, info, 4, backend=be, **pinned).make_batch(np.arange(4)).graph
    for a, b in zip(got.tiled_adj or got.stream_adj, want.tiled_adj or want.stream_adj):
        assert a.meta == b.meta
        np.testing.assert_array_equal(a.slot_src.numpy(), b.slot_src.numpy())
    b = Batcher(ds, info, 4, backend=be, **small)
    with pytest.raises(ValueError, match="budget"):
        b.make_batch(np.arange(4))
    assert need > 1 and getattr(b, key) == need - 1
    with pytest.raises(ValueError, match="together"):
        Batcher(ds, info, 4, backend=be, chunk_budget=8)


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
