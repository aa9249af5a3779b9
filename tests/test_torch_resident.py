"""The port's whole-epoch runners (runtime/resident.py, runtime/runner.py,
the runner dispatch of runtime/train.py, KGBatcher's scanned epoch, the
optimizer's per-step tables, cli/main.py's ``device_resident``) against the
JAX package and against the port's own streaming loop, on the CPU, where
the runners run eagerly (the captured CUDA graphs are checked on the card
by chip_smoke.py, phase 11).

Inputs are ring-graph datasets made from a seed with NumPy and a 300-entity
KG; both packages read the same dicts.  Tolerances: a gathered batch equal
to the streaming batch (aggregation 1e-6); the resident epoch against the
streaming epoch 1e-5 (GAT 1e-3), the precedent of tests/test_resident.py;
two resident epochs against the JAX resident epochs, costs 1e-4 and
parameters at tests/test_torch_train.py's STEP_TOL; the scanned KG epoch as
tests/test_torch_kg.py's three steps (STEP_TOL); the optimizer tables bitwise.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.data.batcher import Batcher, aligned_max_nodes
from kgcn_tpu_torch.runtime import optim as topt
from kgcn_tpu_torch.runtime import resident
from kgcn_tpu_torch.runtime.backend import Backend
from test_torch_kg import _config as kg_config
from test_torch_kg import _jax_side, _kg300, _port_side, jax_globals
from test_torch_tiled import jax_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = dict(rtol=2e-4, atol=2e-5)
CFG = {"task": "classification", "normalize_adj_flag": True, "learning_rate": 0.01,
       "dropout_rate": 0.0}


def _ring(num_nodes=6, n_graphs=90):
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    return make_ring_dataset(num_pairs=n_graphs // 2, num_nodes=num_nodes, seed=0)


def _port(data, **over):
    from kgcn_tpu_torch.data.dataset import build_dataset

    return build_dataset(data, dict(CFG, **over))


def _jax(data, **over):
    from kgcn_tpu.data import build_dataset

    return build_dataset(data, dict(CFG, **over))


def _trainer(model, info, cfg=None, **kw):
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    cfg = dict(CFG, **(cfg or {}))
    return Trainer(build_model(model, info, cfg), cfg, info, device="cpu", **kw)


# ---- gather_batch -----------------------------------------------------------------


@pytest.mark.parametrize("backend", ["dense", "xla", "pallas"])
def test_gather_batch_matches_the_streaming_and_the_jax_batch(backend):
    """A partial batch (20 of 25, padding graphs): nodes, masks, labels,
    pad_mask and the edge_valid count equal the port's Batcher's and the
    JAX gather_batch's; the aggregation over the gathered edge lists equals
    both within 1e-6; on xla and pallas the ELL weights and their transpose
    (the dx kernel's slot lists) equal the Batcher's."""
    from kgcn_tpu.ops.spmm import spmm_multichannel as j_spmm
    from kgcn_tpu.runtime.resident import build_device_dataset as j_build
    from kgcn_tpu.runtime.resident import gather_batch as j_gather
    from kgcn_tpu_torch.ops.spmm import spmm_multichannel

    data = _ring()
    ds, info = _port(data)
    be = Backend(backend)
    ref = Batcher(ds, info, 25, backend=be).make_batch(np.arange(20))
    got = resident.ResidentBatcher(ds, info, 25, backend=be).make_batch(np.arange(20))
    jds, jinfo = _jax(data)
    sched = np.concatenate([np.arange(20), np.zeros(5, np.int64)]).astype(np.int32)
    valid = (np.arange(25) < 20).astype(np.float32)
    jgot = j_gather(j_build(jds, jinfo), jnp.asarray(sched), jnp.asarray(valid))
    for name in ("nodes", "node_mask", "n_node"):
        np.testing.assert_array_equal(getattr(got.graph, name).numpy(),
                                      getattr(ref.graph, name).numpy(), err_msg=name)
        np.testing.assert_array_equal(getattr(got.graph, name).numpy(),
                                      np.asarray(getattr(jgot.graph, name)), err_msg=name)
    for name in ("labels", "pad_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(ref, name).numpy())
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(jgot, name)))
    for name in ("senders", "receivers", "edge_weights", "edge_valid", "n_edge"):
        np.testing.assert_array_equal(getattr(got.graph, name).numpy(),
                                      np.asarray(getattr(jgot.graph, name)), err_msg=name)
    assert float(got.graph.edge_valid.sum()) == float(ref.graph.edge_mask().sum())
    V = got.graph.total_nodes
    x = np.random.RandomState(0).standard_normal((V, 7)).astype(np.float32)
    g = got.graph
    out = spmm_multichannel(g.senders, g.receivers, g.edge_weights, torch.from_numpy(x), V,
                            segments=g.receiver_segments())
    want = spmm_multichannel(ref.graph.senders, ref.graph.receivers, ref.graph.edge_weights,
                             torch.from_numpy(x), V)
    jwant = j_spmm(jgot.graph.senders, jgot.graph.receivers, jgot.graph.edge_weights,
                   jnp.asarray(x), V)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(jwant), atol=1e-6)
    if backend != "dense":
        np.testing.assert_array_equal(g.ell_weights.numpy(), ref.graph.ell_weights.numpy())
        (o1, s1), (o2, s2) = ref.graph.ell_transpose(), g.ell_transpose()
        np.testing.assert_array_equal(o2.numpy(), o1.numpy())
        np.testing.assert_array_equal(s2[:len(s1)].numpy(), s1.numpy())
    else:
        assert g.ell_transpose() is None


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_gathered_segments_are_the_stable_sort_of_the_batch_receivers(backend):
    """GAT's (per channel) and the xla scatter's (all channels) segments of a
    gathered batch equal ``sort_segments`` of its receivers: the same stable
    order and offsets, several channels, a shuffled partial batch."""
    from kgcn_tpu_torch.ops.segment import sort_segments

    ds, info = _port(_ring(num_nodes=10), split_adj_flag=True)
    rb = resident.ResidentBatcher(ds, info, 25, backend=Backend(backend))
    g = rb.make_batch(np.random.RandomState(1).permutation(ds.num)[:17]).graph
    C = g.senders.shape[0]
    assert C > 1 and g.segments is not None
    for c in (None, *range(C)):
        r = g.receivers.reshape(-1) if c is None else g.receivers[c]
        ids, order, offsets = g.receiver_segments(c)
        want = sort_segments(r, g.total_nodes)
        for a, b in zip((ids, order, offsets), want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---- epochs ---------------------------------------------------------------------


@pytest.mark.parametrize("model,backend", [("gcn", "dense"), ("gin", "pallas"),
                                           ("gin", "xla"), ("gat", "xla"), ("gat", "dense")])
def test_resident_epoch_matches_the_streaming_epoch(model, backend):
    """Two shuffled epochs from one seed through the resident runner and the
    streaming loop: costs, parameters and an evaluation agree (1e-5; GAT
    1e-3, tests/test_resident.py:81-110), and the runner keeps the step
    count."""
    tol = 1e-3 if model == "gat" else 1e-5
    ds, info = _port(_ring())
    tr = _trainer(model, info)
    sb = Batcher(ds, info, 25, seed=3, backend=Backend(backend))
    rb = resident.ResidentBatcher(ds, info, 25, seed=3, backend=Backend(backend))
    s1, s2 = tr.init_state(0), tr.init_state(0)
    for ep in range(2):
        s1, c1, m1, n1 = tr.run_epoch(s1, sb, epoch=ep)
        s2, c2, m2, n2 = tr.run_epoch(s2, rb, epoch=ep)
        assert n1 == n2 and abs(c1 - c2) < 1e-5
        assert [float(m["correct_count"]) for m in m1] == [float(m["correct_count"])
                                                            for m in m2]
    assert s1.step == s2.step == 8
    for k in s1.params:
        np.testing.assert_allclose(s2.params[k].numpy(), s1.params[k].numpy(), atol=tol,
                                   err_msg=k)
    e1, e2 = tr.evaluate(s1, sb), tr.evaluate(s1, rb)
    assert abs(e1["cost"] - e2["cost"]) < 1e-4 and e1["num"] == e2["num"] == ds.num
    np.testing.assert_allclose(e2["prediction"], e1["prediction"], atol=tol)


def test_the_runner_leaves_the_input_state_as_it_was():
    """The state is data: an epoch through the runner returns a new state
    and changes nothing of the one it was given (parameters, statistics,
    the optimizer's tensors and host step counts), across epochs that
    reuse the runner's buffers; the step counts advance in the new one."""
    ds, info = _port(_ring())
    tr = _trainer("gcn", info)
    rb = resident.ResidentBatcher(ds, info, 25, seed=3, backend=Backend("dense"))
    def flat(t, pre=""):
        if isinstance(t, dict):
            return {k2: v2 for k, v in t.items() for k2, v2 in flat(v, f"{pre}{k}/").items()}
        return {pre: t.clone()}

    def snapshot(*states):
        return flat({str(n): {"p": st.params, "b": st.batch_stats, "o": st.opt_state}
                     for n, st in enumerate(states)})
    s0 = tr.init_state(0)
    s1 = tr.run_epoch(s0, rb, epoch=0)[0]
    before = snapshot(s0, s1)
    s2 = tr.run_epoch(s1, rb, epoch=1)[0]
    tr.run_epoch(s2, rb, epoch=2)
    after = snapshot(s0, s1)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert (s0.step, s1.step, s2.step) == (0, 4, 8)
    counts = [int(v) for k, v in flat(s2.opt_state).items() if k.endswith("count/")]
    assert counts and all(c == 8 for c in counts)


@pytest.mark.parametrize("model", ["gcn", "gin", "gat"])
def test_resident_epochs_match_the_jax_resident_epochs(model):
    """Two resident epochs of the port against the JAX ``Trainer.run_epoch``
    on its ``ResidentBatcher`` (whole-epoch scan), from the same weights
    (``params_from_jax``) and schedule: costs within 1e-4, parameters at
    STEP_TOL; then the evaluation of both."""
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime.resident import ResidentBatcher as JResident
    from kgcn_tpu.runtime.train import Trainer as JTrainer

    data = _ring()
    jds, jinfo = _jax(data)
    with jax_backend("dense"):
        jrb = JResident(jds, jinfo, 25, seed=3)
        jtr = JTrainer(j_build(model, jinfo, CFG), CFG, jinfo)
        jstate = jtr.init_state(jrb.make_batch(np.arange(25)), seed=0)
        tree = params_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
        jcosts = []
        for ep in range(2):
            jstate, c, _, _ = jtr.run_epoch(jstate, jrb, epoch=ep)
            jcosts.append(c)
        jev = jtr.evaluate(jstate, jrb)
        want = params_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
    ds, info = _port(data)
    tr = _trainer(model, info)
    rb = resident.ResidentBatcher(ds, info, 25, seed=3, backend=Backend("dense"))
    state = tr.state_from_tree(tree)
    costs = []
    for ep in range(2):
        state, c, _, _ = tr.run_epoch(state, rb, epoch=ep)
        costs.append(c)
    np.testing.assert_allclose(costs, jcosts, rtol=0, atol=1e-4)
    for group, got in (("params", state.params), ("batch_stats", state.batch_stats)):
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), want[group][k].numpy(),
                                       err_msg=f"{group} {k}", **STEP_TOL)
    ev = tr.evaluate(state, rb)
    assert abs(ev["cost"] - jev["cost"]) < 1e-4
    np.testing.assert_allclose(ev["prediction"], jev["prediction"], **STEP_TOL)


# ---- the gate --------------------------------------------------------------------


@pytest.mark.parametrize("flag,want", [
    (False, "off"), ("false", "off"), ("off", "off"), (0, "off"), ("0", "off"),
    (True, "force"), ("true", "force"), ("force", "force"), (1, "force"), ("1", "force"),
    ("auto", "auto"), (None, "auto"),
])
def test_resident_flag_spellings(flag, want):
    from kgcn_tpu.runtime.resident import resident_flag as j_flag

    cfg = {} if flag is None else {"device_resident": flag}
    assert resident.resident_flag(cfg) == j_flag(cfg) == want


def test_the_gate_declines_as_the_jax_gate_does(capsys):
    """Tiled and stream decline (said when forced, in the JAX words);
    ``auto`` holds the budget, ``true`` passes it; a KG dataset declines;
    ``estimate_bytes`` equals the JAX value."""
    from kgcn_tpu.runtime.resident import estimate_bytes as j_estimate

    data = _ring(num_nodes=10)
    ds, info = _port(data)
    jds, _ = _jax(data)
    assert resident.estimate_bytes(ds, 10) == j_estimate(jds, 10)
    assert isinstance(resident.estimate_bytes(ds, 10), int)
    for name in ("tiled", "stream"):
        assert not resident.resident_enabled({}, ds, info, Backend(name))
        assert capsys.readouterr().out == ""
        assert not resident.resident_enabled({"device_resident": True}, ds, info,
                                             Backend(name))
        assert capsys.readouterr().out == (f"[resident] spmm_backend={name} needs host "
                                           "batching; streaming batcher\n")
    for name in ("dense", "xla", "pallas"):
        assert resident.resident_enabled({}, ds, info, Backend(name))
    small = {"resident_budget_bytes": 1000}
    assert not resident.resident_enabled(small, ds, info, "dense")
    assert resident.resident_enabled(dict(small, device_resident="true"), ds, info, "dense")
    assert not resident.resident_enabled({"device_resident": "off"}, ds, info, "dense")
    kg, kinfo, _ = _port_side(_kg300(), kg_config())
    capsys.readouterr()
    assert not resident.resident_enabled({"device_resident": "force"}, kg, kinfo, "dense")
    assert capsys.readouterr().out == "[resident] dataset unsupported; streaming batcher\n"


def test_estimate_bytes_matches_jax_on_the_shipped_datasets():
    from kgcn_tpu.data import load_jbl as j_load
    from kgcn_tpu.runtime.resident import _aligned_max_nodes as j_aligned
    from kgcn_tpu.runtime.resident import estimate_bytes as j_estimate
    from kgcn_tpu_torch.data.dataset import load_jbl

    for path in ("examples/solubility/solubility_cls.jbl", "example_jbl/synthetic.jbl"):
        cfg = {"normalize_adj_flag": True}
        ds, info = load_jbl(os.path.join(REPO, path), cfg)
        jds, jinfo = j_load(os.path.join(REPO, path), cfg)
        n = aligned_max_nodes(ds, info)
        assert n == j_aligned(jds, jinfo)
        assert resident.estimate_bytes(ds, n) == j_estimate(jds, n)


# ---- the scanned KG epoch -----------------------------------------------------------


def test_scanned_kg_epoch_slices_and_costs():
    """One seed: the scanned epoch's slices equal ``batches()``'; its costs
    equal the per-batch loop's (the same steps) and the JAX scanned epoch's
    (``run_epoch`` on the JAX KGBatcher, stream kernels in interpret mode)
    at STEP_TOL, from the same weights; 3 steps an epoch."""
    from kgcn_tpu.models.kg import KGBatcher as JKG
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.models.kg import KGBatcher

    cfg = kg_config(kg_encoder="gcn", tiled_compute_dtype="float32", embedding_dim=16)
    L = 512
    with jax_globals():
        jds, jinfo, _ = _jax_side(_kg300(), cfg)
        jkb = JKG(jds, jinfo, label_batch_size=L, seed=0)
        jtr = JTrainer(j_build("kg_distmult", jinfo, cfg), cfg, jinfo)
        jstate = jtr.init_state(jkb.init_batch(), seed=0)
        tree = params_from_jax(jax.device_get(jstate.params), {})
        jstate, jcost, _, _ = jtr.run_epoch(jstate, jkb)
    tds, tinfo, be = _port_side(_kg300(), cfg)
    kb = KGBatcher(tds, tinfo, label_batch_size=L, seed=0, backend=be)
    const, (lls, lvs) = kb.epoch_scan_inputs()
    ref = list(KGBatcher(tds, tinfo, label_batch_size=L, seed=0, backend=be).batches())
    assert lls.shape == (3, 1, L, 6) and lls.dtype == np.int32 and const is kb.graph_batch
    for s, b in enumerate(ref):
        np.testing.assert_array_equal(lls[s], b.label_list.numpy())
        np.testing.assert_array_equal(lvs[s], b.label_valid.numpy())
    loop = _trainer("kg_distmult", tinfo, cfg)
    s1 = loop.state_from_tree(tree)
    steps = []
    for b in ref:
        s1, c, _ = loop.train_step(s1, b)
        steps.append(float(c))
    scan = _trainer("kg_distmult", tinfo, cfg)
    s2, cost, metrics, n = scan.run_epoch(
        scan.state_from_tree(tree), KGBatcher(tds, tinfo, label_batch_size=L, seed=0,
                                              backend=be))
    assert n == 3 and len(metrics) == 3 and s2.step == 3
    np.testing.assert_allclose(cost, np.sum(np.float32(steps)) / 3, rtol=1e-6)
    np.testing.assert_allclose(cost, jcost, **STEP_TOL)
    for k in s1.params:
        np.testing.assert_allclose(s2.params[k].numpy(), s1.params[k].numpy(), atol=1e-6)


# ---- the optimizer's per-step tables ---------------------------------------------------

SCHEDULES = {
    "constant": {},
    "cosine": {"lr_schedule": "cosine", "decay_steps": 4000},
    "warmup_cosine": {"lr_schedule": "warmup_cosine", "warmup_steps": 500,
                      "decay_steps": 6000},
    "exponential": {"lr_schedule": "exponential", "decay_steps": 300, "decay_rate": 0.9},
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("optimizer", ["adam", "rmsprop"])
def test_optimizer_table_equals_the_host_arithmetic(optimizer, schedule):
    """Steps 1-10 000 of the table, in two pieces (the counts carried by
    ``advance``), bitwise equal to the numbers the eager update computes on
    the host: Adam's bias corrections of count k and the scheduled rate of
    count k - 1, as float32."""
    cfg = dict(SCHEDULES[schedule], optimizer=optimizer, learning_rate=0.003)
    tx = topt.make_optimizer(cfg)
    state = tx.init({"w": torch.zeros(3)})
    table = []
    for n in (4000, 6000):
        table.append(tx.table(state, n))
        state = tx.advance(state, n)
    table = np.concatenate(table)
    lr = topt.make_schedule(cfg)
    cols = []
    if optimizer == "adam":
        for b in (0.9, 0.999):
            cols.append([topt._bias_correction(b, torch.tensor(k, dtype=torch.int32))
                         for k in range(1, 10_001)])
    if callable(lr):
        cols.append([-float(lr(k)) for k in range(10_000)])
    want = np.array(cols, np.float32).T.reshape(10_000, len(cols))
    assert table.shape == want.shape and table.dtype == np.float32
    np.testing.assert_array_equal(table.view(np.int32), want.view(np.int32))


OPTIMIZERS = {
    "adam": {}, "adamw": {"optimizer": "adamw", "weight_decay": 0.01},
    "adam_clip": {"gradient_clip": 0.1}, "sgd": {"optimizer": "sgd"},
    "momentum": {"optimizer": "momentum"}, "rmsprop": {"optimizer": "rmsprop"},
    "lamb": {"optimizer": "lamb", "weight_decay": 0.01},
    "grad_accum": {"grad_accum_steps": 3},
    "warmup_cosine": {"lr_schedule": "warmup_cosine", "warmup_steps": 2, "decay_steps": 6},
    "accum_exponential": {"grad_accum_steps": 2, "lr_schedule": "exponential",
                          "decay_steps": 2, "decay_rate": 0.5},
}


@pytest.mark.parametrize("name,route", [
    *(pytest.param(n, "update_row", id=n) for n in sorted(OPTIMIZERS)),
    *(pytest.param(n, "apply_row", id=f"{n}-apply_row") for n in sorted(OPTIMIZERS))])
def test_table_driven_updates_equal_the_eager_updates(name, route):
    """Seven updates through ``update_row`` (rows of the table, in epochs of 4
    and 3 steps, counts moved by ``advance``), or through ``apply_row`` in
    place into the buffers, give the eager ``update``'s parameters and
    state bit for bit on the CPU."""
    cfg = dict(OPTIMIZERS[name], learning_rate=0.1)
    tx = topt.make_optimizer(cfg)
    rng = np.random.RandomState(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32), "b": np.zeros(5, np.float32)}
    pe = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    pr = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    se, sr = tx.init(pe), tx.init(pr)
    grads = [{k: torch.from_numpy((rng.standard_normal(v.shape) * (s + 1)).astype(np.float32))
              for k, v in p0.items()} for s in range(7)]
    for g in grads:
        u, se = tx.update(g, se, pe)
        pe = {k: pe[k] + u[k] for k in pe}
    plan = tx.plan(sr, pr)
    assert plan is None  # no card: no fused launch
    for chunk in (grads[:4], grads[4:]):
        table = torch.from_numpy(tx.table(sr, len(chunk)))
        for j, g in enumerate(chunk):
            if route == "apply_row":
                assert tx.apply_row(g, sr, pr, table[j], plan) == 0
                continue
            u, sr = tx.update_row(g, sr, pr, table[j])
            pr = {k: pr[k] + u[k] for k in pr}
        sr = tx.advance(sr, len(chunk))

    def leaves(t):
        return [x for v in t.values() for x in leaves(v)] if isinstance(t, dict) else [t]
    for k in pe:
        assert torch.equal(pe[k], pr[k]), k
    assert all(torch.equal(a, b) for a, b in zip(leaves(se), leaves(sr)))


# ---- the CLI -----------------------------------------------------------------------


def _cli_config(tmp_path, name, src, **over):
    import json

    with open(os.path.join(REPO, src)) as f:
        cfg = json.load(f)
    cfg.update(over)
    d = tmp_path / name
    cfg.update(dataset=os.path.join(REPO, cfg["dataset"]) if "dataset" not in over
               else over["dataset"], save_model_path=str(d / "model"),
               save_info_train=str(d / "info_train.json"),
               save_info_test=str(d / "info_test.json"),
               save_result_test=str(d / "result_test.csv"),
               save_info_valid=str(d / "info_valid.json"),
               save_result_valid=str(d / "result_valid.csv"))
    d.mkdir()
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path), cfg


@pytest.mark.parametrize("src,over", [
    ("example_config/solubility_cls.json", {}),
    ("example_config/gat.json", {}),
    ("example_config/gin.json", {"spmm_backend": "pallas", "ring6": True}),
])
def test_cli_train_and_infer_with_device_resident(tmp_path, monkeypatch, capsys, src, over):
    """``train`` and ``infer --cpu`` with ``device_resident`` false, "auto"
    (default) and true: false runs the streaming loop, the others the
    resident runners (epochs and evaluations through them); the training
    costs of all three agree (1e-5) and each infer writes its files."""
    import json
    import pickle

    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.runtime.train import Trainer

    over = dict(over, epoch=2, save_interval=0)
    if over.pop("ring6", False):
        path = tmp_path / "ring6.jbl"
        with open(path, "wb") as f:
            pickle.dump(_ring(n_graphs=300), f, protocol=4)
        over["dataset"] = str(path)
    calls = []
    for name in ("epoch_on_device", "_evaluate_resident"):
        orig = getattr(Trainer, name)

        def counted(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(Trainer, name, counted)
    costs = {}
    for flag in (False, None, True):
        extra = {} if flag is None else {"device_resident": flag}
        path, cfg = _cli_config(tmp_path, f"run_{flag}", src, **over, **extra)
        calls.clear()
        t_main(["train", "--config", path, "--cpu"])
        with open(cfg["save_info_train"]) as f:
            costs[flag] = json.load(f)["training_cost"]
        assert (calls.count("epoch_on_device"), calls.count("_evaluate_resident")) == (
            (0, 0) if flag is False else (2, 3)), (flag, calls)
        calls.clear()
        result = t_main(["infer", "--config", path, "--cpu"])
        assert calls == ([] if flag is False else ["_evaluate_resident"])
        assert np.isfinite(result["test_cost"]) and os.path.exists(cfg["save_result_test"])
    capsys.readouterr()
    np.testing.assert_allclose(costs[None], costs[False], rtol=1e-5)
    np.testing.assert_allclose(costs[True], costs[False], rtol=1e-5)


def test_cli_device_resident_true_on_tiled_says_it_declines(tmp_path, capsys):
    from kgcn_tpu_torch.cli.main import main as t_main

    path, _ = _cli_config(tmp_path, "tiled", "example_config/gat.json", epoch=1,
                          spmm_backend="tiled", device_resident=True)
    t_main(["train", "--config", path, "--cpu"])
    out = capsys.readouterr().out
    assert out.count("[resident] spmm_backend=tiled needs host batching; "
                     "streaming batcher") == 2  # the training and validation sets
