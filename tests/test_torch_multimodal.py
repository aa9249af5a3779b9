"""The multimodal model family of the port (kgcn_tpu_torch/nn/multimodal.py,
models/multimodal.py, the sequence and vector-modal fields of data/) against
the JAX package on the CPU, from the same weights (``params_from_jax`` with
the port's model: Conv1D and LSTM layouts, ``shared1``/``head`` Dense):

* forward and cost within 1e-5, parameter gradients within 1e-4 (float32,
  sums in another order), for gcn_multimodal, gcn_vector_modal and seq_cnn
  and the regression variants, on example_jbl/multimodal.jbl and on the
  seeded data of tests/test_multimodal.py;
* ``SequenceEncoder`` alone, at padded lengths that ``SAME`` pads unevenly;
* two resident epochs against the JAX ``run_epoch`` (costs within 1e-4);
* ``cli.main train`` and ``infer`` of example_config/multimodal.json.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _seq_data(num_pairs=20, seq_len=12, vocab=5, seed=0):
    """tests/test_multimodal.py's ring dataset with a label-correlated
    sequence."""
    from kgcn_tpu.data.synthetic import make_ring_dataset

    data = make_ring_dataset(num_pairs=num_pairs, seed=seed)
    n = len(data["label"])
    rng = np.random.RandomState(seed)
    y = np.argmax(data["label"], axis=1)
    seq = rng.randint(1, vocab, size=(n, seq_len)).astype(np.int32)
    seq[y == 1, :3] = 0
    data["sequence"] = seq
    data["sequence_length"] = [seq_len] * n
    data["sequence_symbol_num"] = np.int64(vocab)
    return data


def _vm_data(modals=("vector_modal",), seed=0):
    """tests/test_multimodal.py's ring dataset with vector modals."""
    from kgcn_tpu.data.synthetic import make_ring_dataset

    data = make_ring_dataset(num_pairs=15, seed=seed)
    n = len(data["label"])
    rng = np.random.RandomState(seed)
    for m, name in enumerate(modals):
        vm = rng.standard_normal((n, 8 - 3 * m)).astype(np.float32)
        vm[np.argmax(data["label"], 1) == 1] += 2.0
        data[name] = vm
    return data


def _multimodal_jbl():
    from kgcn_tpu_torch.data import jbl

    return jbl.load(os.path.join(REPO, "example_jbl", "multimodal.jbl"))


DATA = {
    "multimodal.jbl": _multimodal_jbl,
    "seq": _seq_data,
    "vm": _vm_data,
    "vm2": lambda: _vm_data(("profeat", "dragon")),
}
CASES = [
    ("gcn_multimodal", "multimodal.jbl", "classification"),
    ("gcn_multimodal", "multimodal.jbl", "regression"),
    ("gcn_multimodal", "seq", "classification"),
    ("seq_cnn", "multimodal.jbl", "classification"),
    ("seq_cnn", "seq", "classification"),
    ("gcn_vector_modal", "vm", "classification"),
    ("gcn_vector_modal", "vm", "regression"),
    ("gcn_vector_modal", "vm2", "classification"),
]


def _both(name, data, task, bs=8):
    """(JAX model, variables, JAX batch, port model loaded with the same
    weights, port batch, cfg)."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.models.registry import build_model as j_model
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model

    cfg = {"task": task, "normalize_adj_flag": True, "dropout_rate": 0.0}
    jds, jinfo = j_build(dict(data), cfg)
    ds, info = build_dataset(dict(data), cfg)
    idx = np.arange(bs - 2)  # a partial batch: padding rows included
    jb = JBatcher(jds, jinfo, bs).make_batch(idx)
    b = Batcher(ds, info, bs).make_batch(idx)
    jm = j_model(name, jinfo, cfg)
    variables = jax.device_get(jm.init({"params": jax.random.PRNGKey(1),
                                        "dropout": jax.random.PRNGKey(2)}, jb, train=False))
    m = build_model(name, info, cfg)
    tree = params_from_jax(variables["params"], variables.get("batch_stats", {}), m)
    m.load_state_dict({**tree["params"], **tree["batch_stats"]})
    return jm, variables, jb, m, b, cfg


@pytest.mark.parametrize("name,data,task", CASES)
def test_forward_cost_and_gradients_match_jax(name, data, task):
    jm, variables, jb, m, b, _ = _both(name, DATA[data](), task)

    def cost(params):
        return jm.apply({**variables, "params": params}, jb, train=False).cost_opt

    jout = jm.apply(variables, jb, train=False)
    jgrad = jax.grad(cost)(jax.tree_util.tree_map(jnp.asarray, variables["params"]))
    out = m(b)
    np.testing.assert_allclose(out.prediction.detach().numpy(),
                               np.asarray(jout.prediction), **TOL)
    np.testing.assert_allclose(float(out.cost_sum.detach()), float(jout.cost_sum), **TOL)
    for k in jout.metrics:
        np.testing.assert_allclose(float(out.metrics[k].detach()), float(jout.metrics[k]),
                                   **TOL)
    names = [k for k, _ in m.named_parameters()]
    grads = torch.autograd.grad(out.cost_opt, [p for _, p in m.named_parameters()])
    want = params_from_jax(jax.device_get(jgrad), {}, m)["params"]
    assert set(want) == set(names)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("length", [16, 17, 9, 6, 4])
def test_sequence_encoder_alone(length):
    """Embed → Conv1D SAME (1 before, 2 after at kernel 4) → MaxPool 4 →
    the reversed LSTM's last state, at lengths whose padding and pooling
    are uneven."""
    from kgcn_tpu.nn.multimodal import SequenceEncoder as JEncoder
    from kgcn_tpu_torch.nn.multimodal import SequenceEncoder

    rng = np.random.RandomState(length)
    seq = rng.randint(0, 7, size=(3, length)).astype(np.int32)
    jenc = JEncoder(vocab_size=7)
    variables = jax.device_get(jenc.init(jax.random.PRNGKey(0), seq))
    enc = SequenceEncoder(7)
    enc.load_state_dict(params_from_jax(variables["params"], {}, enc)["params"])
    want = np.asarray(jenc.apply(variables, seq))
    got = enc(torch.from_numpy(seq)).detach().numpy()
    assert got.shape == want.shape == (3, 32)
    np.testing.assert_allclose(got, want, **TOL)


def test_the_dataset_and_batches_carry_sequences_and_modals():
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset, split_dataset
    from kgcn_tpu_torch.runtime import resident

    data = _seq_data()
    rng = np.random.RandomState(1)
    data["profeat"] = rng.standard_normal((40, 7)).astype(np.float32)
    data["dragon"] = rng.standard_normal((40, 3)).astype(np.float32)
    jds, jinfo = j_build(dict(data), {})
    ds, info = build_dataset(dict(data), {})
    for key in ("sequence_max_length", "sequence_symbol_num", "vector_modal_dim",
                "vector_modal_name"):
        assert getattr(info, key) == getattr(jinfo, key), key
    train, valid, _, _ = split_dataset(ds, 0.25, seed=0)
    assert train.sequences.shape[0] == train.num and len(valid.vector_modal) == 2
    idx = np.array([3, 0, 7])
    jb = JBatcher(jds, jinfo, 5).make_batch(idx)
    for b in (Batcher(ds, info, 5).make_batch(idx),
              resident.ResidentBatcher(ds, info, 5).make_batch(idx)):
        np.testing.assert_array_equal(b.sequences.numpy(), np.asarray(jb.sequences))
        np.testing.assert_array_equal(b.sequences_len.numpy(), np.asarray(jb.sequences_len))
        assert len(b.vector_modal) == 2
        for v, jv in zip(b.vector_modal, jb.vector_modal):
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


def test_two_resident_epochs_match_the_jax_epochs():
    """gcn_multimodal on example_jbl/multimodal.jbl (batch 25): two epochs of
    the port's resident runner against the JAX ``run_epoch`` on its
    ``ResidentBatcher``, from the same weights and schedule: costs within
    1e-4, parameters within rtol 2e-4, atol 2e-5 (tests/test_torch_train.py's
    STEP_TOL for Adam steps), then the evaluation."""
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.models.registry import build_model as j_model
    from kgcn_tpu.runtime.resident import ResidentBatcher as JResident
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.backend import Backend
    from kgcn_tpu_torch.runtime.resident import ResidentBatcher
    from kgcn_tpu_torch.runtime.train import Trainer
    from test_torch_tiled import jax_backend

    cfg = {"task": "classification", "normalize_adj_flag": True, "learning_rate": 0.01}
    data = _multimodal_jbl()
    jds, jinfo = j_build(dict(data), cfg)
    ds, info = build_dataset(dict(data), cfg)
    model = build_model("gcn_multimodal", info, cfg)
    with jax_backend("dense"):
        jrb = JResident(jds, jinfo, 25, seed=3)
        jtr = JTrainer(j_model("gcn_multimodal", jinfo, cfg), cfg, jinfo)
        jstate = jtr.init_state(jrb.make_batch(np.arange(25)), seed=0)
        start = params_from_jax(jax.device_get(jstate.params), {}, model)
        jcosts = []
        for ep in range(2):
            jstate, c, _, _ = jtr.run_epoch(jstate, jrb, epoch=ep)
            jcosts.append(c)
        jev = jtr.evaluate(jstate, jrb)
    want = params_from_jax(jax.device_get(jstate.params), {}, model)["params"]
    tr = Trainer(model, cfg, info, device="cpu")
    rb = ResidentBatcher(ds, info, 25, seed=3, backend=Backend("dense"))
    state = tr.state_from_tree(start)
    costs = []
    for ep in range(2):
        state, c, _, _ = tr.run_epoch(state, rb, epoch=ep)
        costs.append(c)
    np.testing.assert_allclose(costs, jcosts, rtol=0, atol=1e-4)
    assert costs[1] < costs[0]
    ev = tr.evaluate(state, rb)
    assert abs(ev["cost"] - jev["cost"]) < 1e-4
    for k, v in state.params.items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), err_msg=k,
                                   rtol=2e-4, atol=2e-5)


def test_cli_train_and_infer_of_the_shipped_multimodal_config(tmp_path, capsys):
    from kgcn_tpu_torch.cli.main import main as t_main

    with open(os.path.join(REPO, "example_config", "multimodal.json")) as f:
        cfg = json.load(f)
    cfg.update(dataset=os.path.join(REPO, cfg["dataset"]), epoch=3, save_interval=0,
               save_model_path=str(tmp_path / "model"),
               save_info_train=str(tmp_path / "info_train.json"),
               save_info_test=str(tmp_path / "info_test.json"),
               save_result_test=str(tmp_path / "result_test.csv"))
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    t_main(["train", "--config", str(path), "--cpu"])
    with open(cfg["save_info_train"]) as f:
        costs = json.load(f)["training_cost"]
    assert len(costs) == 3 and np.isfinite(costs).all() and costs[-1] < costs[0]
    assert {"model.best.ckpt", "model.last.ckpt", "serve_info.json"} <= set(
        os.listdir(tmp_path / "model"))
    result = t_main(["infer", "--config", str(path), "--cpu"])
    assert np.isfinite(result["test_cost"]) and 0.0 <= result["test_metrics"]["auc"] <= 1.0
    pred = np.loadtxt(cfg["save_result_test"], delimiter=",")
    assert pred.shape == (200, 2)
    np.testing.assert_allclose(pred.sum(axis=1), 1.0, atol=1e-5)
