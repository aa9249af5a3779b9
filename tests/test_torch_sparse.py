"""The port's sparse reaction engine (kgcn_tpu_torch/models/sparse.py,
cli/sparse.py) against the JAX package's on the CPU, from the same weights
(``params_from_jax``):

* ``SparseGCN`` at small width (``out_dims`` (16, 16), 64 classes, top-k
  at 3 and 5): probabilities, the summed cost and every metric count
  within rtol 1e-5, parameter gradients within 1e-4 (relative, and of
  the tensor's largest entry where sums cancel), on dense batches (≤
  256 nodes) and on tiled batches beyond 256 nodes (float32 payload, each
  package's tiled path); a batch whose label ties the k-th probability,
  counted by both;
* ``split_fold`` equal to ``kgcn_tpu``'s;
* ``cli.sparse train`` (2 epochs of examples/run_sparse.sh's data cut to 40
  graphs) from kgcn_tpu's initial weights: every epoch's training cost
  within 1e-4 relative (the validation cost within 1e-2: see the test),
  and ``_report``'s keys; ``infer`` of the port's checkpoint and of the
  one ``kgcn_tpu`` wrote (its answers within 1e-5 of ``kgcn_tpu``'s own
  infer).
"""
import json
import os
import pickle
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from test_torch_tiled import jax_backend

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)
CLASSES = 64


def _molecule_data(n_graphs, lo, hi, F=9, seed=0):
    """Chain-and-ring graphs of ``lo``-``hi`` nodes (a .jbl-schema dict with
    COO ``adj`` tuples), one-hot atom features, one class label each."""
    rng = np.random.RandomState(seed)
    adjs, feats, labels = [], [], []
    for _ in range(n_graphs):
        n = rng.randint(lo, hi + 1)
        i = np.arange(n - 1)
        ring = rng.choice(n - 5, size=max(n // 10, 1), replace=False)
        r = np.concatenate([i, i + 1, ring, ring + 5, np.arange(n)])
        c = np.concatenate([i + 1, i, ring + 5, ring, np.arange(n)])
        adjs.append((np.stack([r, c], 1), np.ones(len(r), np.float32), (n, n)))
        f = np.zeros((hi, F), np.float32)
        f[np.arange(n), rng.randint(0, F, n)] = 1.0
        feats.append(f)
        labels.append([rng.randint(0, CLASSES)])
    return {"adj": adjs, "feature": np.stack(feats), "label": np.asarray(labels, np.int64),
            "max_node_num": np.int64(hi)}


def _both(data, backend, bs=6, topk=(3, 5)):
    """(JAX model, variables, JAX batch, port model with the same weights,
    port batch) of a partial batch (padding rows included)."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.models.sparse import SparseGCN as JSparse
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.sparse import SparseGCN
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = {"normalize_adj_flag": True}
    jds, jinfo = j_build(dict(data), cfg)
    ds, info = build_dataset(dict(data), cfg)
    idx = np.arange(bs - 2)
    with jax_backend(backend):
        jb = JBatcher(jds, jinfo, bs).make_batch(idx)
    b = Batcher(ds, info, bs, backend=Backend(backend, "float32")).make_batch(idx)
    jm = JSparse(channels=1, num_classes=CLASSES, out_dims=(16, 16), dense_dim=8, topk=topk)
    with jax_backend(backend):
        variables = jax.device_get(jm.init(jax.random.PRNGKey(3), jb))
    m = SparseGCN(in_features=info.feature_dim, num_classes=CLASSES, out_dims=(16, 16),
                  dense_dim=8, topk=topk)
    tree = params_from_jax(variables["params"], variables["batch_stats"], m)
    m.load_state_dict({**tree["params"], **tree["batch_stats"]})
    return jm, variables, jb, m, b


def _check(jm, variables, jb, m, b, backend, train):
    def cost(params):
        return jm.apply({**variables, "params": params}, jb, train=train,
                        mutable=["batch_stats"])[0].cost_opt

    with jax_backend(backend):
        jout, _ = jm.apply(variables, jb, train=train, mutable=["batch_stats"])
        jgrad = jax.grad(cost)(jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    out = m(b, train=train)
    np.testing.assert_allclose(out.prediction.detach().numpy(), np.asarray(jout.prediction),
                               **TOL)
    np.testing.assert_allclose(float(out.cost_sum.detach()), float(jout.cost_sum), **TOL)
    assert set(out.metrics) == set(jout.metrics)
    for k, v in jout.metrics.items():
        assert float(out.metrics[k]) == float(v), k
    names = [k for k, _ in m.named_parameters()]
    grads = torch.autograd.grad(out.cost_opt, [p for _, p in m.named_parameters()])
    want = params_from_jax(jax.device_get(jgrad), {}, m)["params"]
    assert set(want) == set(names)
    scale = max(float(np.abs(w.numpy()).max()) for w in want.values())
    for k, g in zip(names, grads):
        w = want[k].numpy()
        if train and k == "GraphDense_0.Dense_0.bias":
            # batch norm in training mode removes this bias: its gradient is
            # exactly 0, and both packages give rounding noise
            assert max(np.abs(w).max(), g.abs().max()) <= 1e-5 * scale, k
            continue
        # sums over every node of the batch, in another order: entries that
        # cancel to near 0 are held to 1e-4 of the tensor's largest
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=k)
    return out


@pytest.mark.parametrize("backend,lo,hi", [("dense", 20, 60), ("tiled", 257, 300)])
@pytest.mark.parametrize("train", [False, True])
def test_sparse_gcn_matches_jax(backend, lo, hi, train):
    data = _molecule_data(8, lo, hi, seed=1)
    jm, variables, jb, m, b = _both(data, backend)
    assert (b.graph.max_nodes <= 256) == (backend == "dense")
    out = _check(jm, variables, jb, m, b, backend, train)
    assert set(out.metrics) == {"correct_count", "count", "top3_count", "top5_count"}
    assert float(out.metrics["count"]) == 4.0  # padding graphs weigh 0


def test_topk_counts_ties_as_jax():
    """A head whose logits tie in blocks: each label's probability equals
    the k-th largest (or the one above), so ``>=`` counts it where ``>``
    would not; both packages count the same."""
    data = _molecule_data(8, 10, 30, seed=2)
    jm, variables, jb, m, b = _both(data, "dense", topk=(3, 5, 40))
    head = variables["params"]["Dense_0"]
    bias = np.repeat(np.arange(CLASSES // 8, dtype=np.float32), 8)[::-1].copy()
    variables["params"]["Dense_0"] = {"kernel": np.zeros_like(head["kernel"]), "bias": bias}
    tree = params_from_jax(variables["params"], variables["batch_stats"], m)
    m.load_state_dict({**tree["params"], **tree["batch_stats"]})
    labels = np.array([[5], [7], [8], [20], [0], [0]], np.int32)
    jb = jb.replace(labels=jnp.asarray(labels))
    b = b.replace(labels=torch.from_numpy(labels))
    out = _check(jm, variables, jb, m, b, "dense", False)
    # classes 0-7 share the top logit: k = 3 and 5 hit the four graphs of
    # labels 5, 7 (tied at the k-th) and not 8 and 20; k = 40 hits all four
    assert [float(out.metrics[f"top{k}_count"]) for k in (3, 5, 40)] == [2.0, 2.0, 4.0]


@pytest.mark.parametrize("n,folds", [(40, 5), (41, 3), (7, 7)])
def test_split_fold_equals_jax(n, folds):
    from kgcn_tpu.cli.sparse import split_fold as j_split
    from kgcn_tpu_torch.cli.sparse import split_fold

    for f in range(folds):
        for got, want in zip(split_fold(n, f, folds), j_split(n, f, folds)):
            np.testing.assert_array_equal(got, want)


def _write_run_sparse_data(path, n=40):
    """examples/run_sparse.sh's TFRecords (ring graphs, two classes), cut to
    ``n`` graphs, written by the port's writer."""
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.data.tfrecord import example_from_graph, write_tfrecord

    d = make_ring_dataset(num_pairs=60, seed=0)
    y = np.argmax(d["label"], 1)
    write_tfrecord(path, [example_from_graph(d["dense_adj"][i], d["feature"][i],
                                             label=[int(y[i])], mask_label=[1])
                          for i in range(n)])


def _config(tmp_path, side, data):
    d = tmp_path / side
    d.mkdir(exist_ok=True)
    cfg = {"dataset": data, "test_dataset": data, "num_classes": 2, "batch_size": 8,
           "epoch": 2, "learning_rate": 0.001, "out_dims": [64, 64], "dense_dim": 64,
           "num_folds": 5, "task": "classification", "save_model_path": str(d / "model"),
           "save_interval": 0, "shuffle_data": True, "seed": 0,
           "save_info_valid": str(d / "valid.json"), "save_info_test": str(d / "test.json"),
           "prediction_output": str(d / "pred.jbl")}
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _costs(out):
    return [[float(x) for x in m] for m in re.findall(
        r"training cost ([-\d.e+]+).*validation cost ([-\d.e+]+)", out)]


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """kgcn_tpu's ``train`` and ``infer`` of the run_sparse.sh config: (its
    output, the initial parameters it drew, the directory)."""
    from kgcn_tpu.cli.sparse import main as j_main
    from kgcn_tpu.runtime.train import Trainer as JTrainer

    tmp = tmp_path_factory.mktemp("sparse")
    data = str(tmp / "train.tfrecords")
    _write_run_sparse_data(data)
    initial = {}
    j_init = JTrainer.init_state

    def record(self, sample, seed=0):
        state = j_init(self, sample, seed=seed)
        initial.setdefault("tree", (jax.device_get(state.params),
                                    jax.device_get(state.batch_stats)))
        return state

    JTrainer.init_state = record
    try:
        import contextlib
        import io

        buf = io.StringIO()
        with jax_backend("dense"), contextlib.redirect_stdout(buf):
            j_main(["train", "--config", _config(tmp, "jax", data), "--cpu"])
            j_main(["infer", "--config", _config(tmp, "jax", data), "--cpu"])
    finally:
        JTrainer.init_state = j_init
    return buf.getvalue(), initial["tree"], tmp, data


def test_cli_train_and_infer_match_jax(jax_run, monkeypatch, capsys):
    from kgcn_tpu_torch.cli.sparse import main as t_main
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    jout, (params, stats), tmp, data = jax_run
    monkeypatch.setattr(TTrainer, "init_state", lambda self, seed=0: self.state_from_tree(
        params_from_jax(params, stats, self.model), seed=seed))
    t_main(["train", "--config", _config(tmp, "port", data), "--cpu"])
    tout = capsys.readouterr().out
    want, got = np.array(_costs(jout)), np.array(_costs(tout))
    assert got.shape == want.shape == (2, 2)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-4)  # training costs
    # The validation cost reads the BN running mean, which follows
    # GraphDense_0's bias; batch norm removes that bias in training, so its
    # gradient is rounding noise, which Adam turns into steps of the
    # learning rate's size in either package (ROADMAP C.9's mechanism).
    # Validation from one set of weights is held to 1e-5 below.
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=1e-2)
    with open(tmp / "jax" / "valid.json") as f, open(tmp / "port" / "valid.json") as g:
        jv, tv = json.load(f), json.load(g)
    assert set(tv) == set(jv) == {"valid_cost", "valid_accuracy"}
    assert "model.0.best.ckpt" in os.listdir(tmp / "port" / "model")
    ev = t_main(["infer", "--config", _config(tmp, "port", data), "--cpu"])
    with open(tmp / "port" / "test.json") as f:
        assert set(json.load(f)) == {"test_cost", "test_accuracy"}
    with open(tmp / "port" / "pred.jbl", "rb") as f:
        pred = pickle.load(f)
    assert pred.shape == (40, 2) and ev["num"] == 40


def test_infer_reads_the_jax_checkpoint(jax_run, tmp_path):
    from kgcn_tpu_torch.cli.sparse import main as t_main

    _, _, tmp, data = jax_run
    path = _config(tmp_path, "port", data)
    with open(path) as f:
        cfg = json.load(f)
    cfg["load_model"] = str(tmp / "jax" / "model" / "model.0.best.ckpt")
    with open(path, "w") as f:
        json.dump(cfg, f)
    t_main(["infer", "--config", path, "--cpu"])
    for name in ("test.json", "pred.jbl"):
        if name.endswith(".json"):
            with open(tmp / "jax" / name) as f, open(tmp_path / "port" / name) as g:
                jv, tv = json.load(f), json.load(g)
            assert set(tv) == set(jv)
            for k in jv:
                np.testing.assert_allclose(tv[k], jv[k], rtol=1e-5, err_msg=k)
        else:
            with open(tmp / "jax" / name, "rb") as f, open(tmp_path / "port" / name, "rb") as g:
                import joblib

                np.testing.assert_allclose(pickle.load(g), joblib.load(f), rtol=1e-5,
                                           atol=1e-6)
