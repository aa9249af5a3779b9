"""The port's GPipe trainer (kgcn_tpu_torch/parallel/pp.py) against the JAX
package's (kgcn_tpu/parallel/pp.py), on the CPU.

The port runs as gloo ranks, one a stage ((S, k, M) = (2, 1, 2) in a world
of 2, (4, 2, 4) in a world of 4; tests/torch_parallel_worker.py);
``kgcn_tpu``'s pipeline runs here on as many virtual devices, from the same
stacked weights.  Tolerances are tests/test_pp.py's: the loss rtol 2e-5,
each stage's gradients rtol 5e-4 and atol 1e-4, against ``kgcn_tpu``'s
``pipeline_logits`` under ``jax.grad`` and against the port's
``sequential_logits`` under autograd; 10 PPTrainer steps on the ring
dataset within 1e-3 of ``kgcn_tpu``'s PPTrainer."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tiled import jax_backend
from torch_parallel_worker import launch_scenarios

torch.set_num_threads(1)

LOSS = dict(rtol=2e-5)
GRADS = dict(rtol=5e-4, atol=1e-4)
STEPS_RTOL = 1e-3
CASES = {2: (2, 1, 2), 4: (4, 2, 4)}  # world → (S, k, M)
TOY = dict(hidden=16, channels=2, label_dim=3)
G_PER_M, N, F = 4, 10, 7
RING = dict(num_pairs=16, seed=0)
LR = 0.02
STEPS = 10


def _toy(S, k, M):
    """tests/test_pp.py's microbatches (kgcn_tpu's layout)."""
    rng = np.random.RandomState(0)
    G = M * G_PER_M
    x = rng.standard_normal((G, N, F)).astype(np.float32)
    adj = (rng.rand(G, TOY["channels"], N, N) < 0.3).astype(np.float32)
    nmask = np.ones((G, N), np.float32)
    nmask[:, N - 2:] = 0.0
    labels = np.eye(TOY["label_dim"], dtype=np.float32)[
        rng.randint(0, TOY["label_dim"], G)]
    pad = np.ones((G,), np.float32)
    mb = G // M
    return (x.reshape(M, mb, N, F), adj.reshape(M, mb, TOY["channels"], N, N),
            nmask.reshape(M, mb, N), labels.reshape(M, mb, -1), pad.reshape(M, mb))


def _mean_loss(logits, labels, pad):
    logp = jax.nn.log_softmax(logits, -1)
    cost = -jnp.sum(labels * logp, axis=-1) * pad
    return jnp.sum(cost) / jnp.maximum(jnp.sum(pad), 1.0)


def _ring_cfg():
    from kgcn_tpu.runtime.config import default_config

    cfg = default_config()
    cfg.update({"normalize_adj_flag": True})
    return cfg


def _jax_side(S, k, M):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from kgcn_tpu.data import Batcher, build_dataset
    from kgcn_tpu.data.synthetic import make_ring_dataset
    from kgcn_tpu.parallel.mesh import make_mesh
    from kgcn_tpu.parallel.pp import (PPConfig, PPTrainer, init_pipeline_params,
                                      pipeline_logits)
    cfg = PPConfig(stages=S, layers_per_stage=k, microbatches=M, **TOY)
    mesh = make_mesh({"pipe": S})
    toy = _toy(S, k, M)
    x, adj, nmask, labels, pad = (jnp.asarray(a) for a in toy)
    params = init_pipeline_params(jax.random.PRNGKey(0), cfg, F)
    forward = shard_map(partial(pipeline_logits, cfg=cfg, axis="pipe"), mesh=mesh,
                        in_specs=(P("pipe"), P(), P(), P()), out_specs=P(),
                        check_vma=False)

    def loss(p):
        return _mean_loss(forward(p, x, adj, nmask), labels, pad)

    out = {"toy": toy, "params": jax.tree_util.tree_map(np.asarray, params),
           "loss": float(jax.jit(loss)(params)),
           "grads": jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(loss))(params))}
    with jax_backend("dense"):
        ds, info = build_dataset(make_ring_dataset(**RING), _ring_cfg())
        rcfg = PPConfig(stages=S, layers_per_stage=k, hidden=TOY["hidden"], microbatches=M,
                        channels=info.adj_channel_num, label_dim=info.label_dim)
        tr = PPTrainer(rcfg, mesh, learning_rate=LR)
        state = tr.init_state(feature_dim=info.feature_dim, seed=0)
        out["ring_params"] = jax.tree_util.tree_map(np.asarray, state["params"])
        batch = Batcher(ds, info, 8, seed=0).make_batch(np.arange(8))
        costs = []
        for _ in range(STEPS):
            state, c, _ = tr.train_step(state, batch)
            costs.append(float(c))
        out["costs"] = costs
        out["final"] = jax.tree_util.tree_map(np.asarray, state["params"])
        out["logits"] = np.asarray(tr.logits(state, batch))
        out["ring_cfg"] = dict(stages=S, layers_per_stage=k, hidden=TOY["hidden"],
                               microbatches=M, channels=info.adj_channel_num,
                               label_dim=info.label_dim)
        out["feature_dim"] = info.feature_dim
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = {}
    for world, (S, k, M) in CASES.items():
        jx = _jax_side(S, k, M)
        d = tmp_path_factory.mktemp(f"pp{world}")
        x, adj, nmask, labels, pad = jx["toy"]
        port_toy = (x, np.ascontiguousarray(adj.transpose(0, 2, 1, 3, 4)), nmask, labels, pad)
        inp = {"pp": jx["ring_cfg"], "lr": LR, "params": jx["ring_params"],
               "feature_dim": jx["feature_dim"], "toy": port_toy, "toy_params": jx["params"],
               "toy_pp": dict(stages=S, layers_per_stage=k, microbatches=M, **TOY),
               "ring": RING, "cfg": _ring_cfg(), "rows": list(range(8)),
               "steps": STEPS, "odd": 2 * M + 1}
        out[world] = (jx, launch_scenarios(d, world, {"pp": inp})["pp"])
    return out


def _stage_grads(full, s, S):
    """Stage ``s``'s slices of a stacked gradient tree, as the rank holds
    them."""
    names = ("body_w", "body_b") + (("embed_w", "embed_b") if s == 0 else ()) + (
        ("head_w", "head_b") if s == S - 1 else ())
    return {n: np.asarray(full[n])[s] for n in names}


@pytest.mark.parametrize("world", list(CASES))
def test_pipeline_loss_and_grads_match_jax(runs, world):
    """The toy microbatches: every rank's loss, and each stage's gradients,
    against kgcn_tpu's GPipe pipeline (``pipeline_logits``, jax.grad)."""
    jx, ranks = runs[world]
    S = CASES[world][0]
    for r in ranks:
        np.testing.assert_allclose(r["loss"], jx["loss"], **LOSS)
        want = _stage_grads(jx["grads"], r["stage"], S)
        assert set(r["grads"]) == set(want)
        for n, w in want.items():
            np.testing.assert_allclose(r["grads"][n], w, err_msg=n, **GRADS)
    assert sorted(r["stage"] for r in ranks) == list(range(S))


@pytest.mark.parametrize("world", list(CASES))
def test_pipeline_matches_sequential_logits(runs, world):
    """The same loss and gradients against the port's ``sequential_logits``
    on one device (the plain path)."""
    from kgcn_tpu_torch.parallel.pp import PPConfig, masked_xent, sequential_logits

    jx, ranks = runs[world]
    S, k, M = CASES[world]
    cfg = PPConfig(stages=S, layers_per_stage=k, microbatches=M, **TOY)
    x, adj, nmask, labels, pad = (torch.from_numpy(a) for a in jx["toy"])
    G = x.shape[0] * x.shape[1]
    params = {n: torch.from_numpy(np.array(v)).requires_grad_(True)
              for n, v in jx["params"].items()}
    logits = sequential_logits(params, x.reshape(G, N, F), adj.reshape(G, *adj.shape[2:]),
                               nmask.reshape(G, N), cfg=cfg)
    loss, _, _ = masked_xent(logits, labels.reshape(G, -1), pad.reshape(G))
    names = list(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[n] for n in names])))
    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(loss.detach()), **LOSS)
        for n, w in _stage_grads({n: g.numpy() for n, g in grads.items()},
                                 r["stage"], S).items():
            np.testing.assert_allclose(r["grads"][n], w, err_msg=n, **GRADS)


@pytest.mark.parametrize("world", list(CASES))
def test_pp_trainer_steps_match_jax(runs, world):
    """10 Adam steps of PPTrainer on a ring batch: the cost sums, each
    stage's parameters and the logits against kgcn_tpu's PPTrainer."""
    jx, ranks = runs[world]
    S = CASES[world][0]
    for r in ranks:
        np.testing.assert_allclose(r["costs"], jx["costs"], rtol=STEPS_RTOL)
        for n, w in _stage_grads(jx["final"], r["stage"], S).items():
            np.testing.assert_allclose(r["final"][n], w, rtol=STEPS_RTOL, atol=1e-5,
                                       err_msg=n)
        np.testing.assert_allclose(r["logits"], jx["logits"], rtol=STEPS_RTOL, atol=1e-4)
    assert jx["costs"][-1] < jx["costs"][0]


@pytest.mark.parametrize("world", list(CASES))
def test_batch_that_does_not_divide_raises(runs, world):
    """A batch of 2M + 1 graphs does not divide into M microbatches."""
    _, ranks = runs[world]
    assert all(r["odd_raises"] for r in ranks)


@pytest.mark.parametrize("world", list(CASES))
def test_one_stage_beside_a_data_axis_is_sequential(runs, world):
    """A PPTrainer of one stage on ``{"data": world}`` (no pipe axis): each
    rank's logits are ``sequential_logits``', not summed over the world."""
    _, ranks = runs[world]
    for r in ranks:
        np.testing.assert_allclose(r["solo"], r["solo_want"], rtol=1e-6, atol=1e-6)


def test_pp_at_one_stage_is_sequential():
    """``{"pipe": 1}`` in a plain process: PPTrainer's logits are
    ``sequential_logits``' and its loss falls over steps."""
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset
    from kgcn_tpu_torch.parallel import mesh as pmesh
    from kgcn_tpu_torch.parallel.pp import (PPConfig, PPTrainer, init_pipeline_params,
                                            sequential_logits)

    ds, info = build_dataset(make_ring_dataset(**RING), _ring_cfg())
    cfg = PPConfig(stages=1, layers_per_stage=3, hidden=16, microbatches=4,
                   channels=info.adj_channel_num, label_dim=info.label_dim)
    tr = PPTrainer(cfg, pmesh.make_mesh({"pipe": 1}), learning_rate=LR, device="cpu")
    full = init_pipeline_params(torch.Generator().manual_seed(0), cfg, info.feature_dim)
    state = tr.init_state(info.feature_dim, params=full)
    batch = Batcher(ds, info, 8, seed=0).make_batch(np.arange(8))
    g = batch.graph
    want = sequential_logits(full, g.nodes.reshape(8, g.max_nodes, -1),
                             g.dense_adjacency(torch.float32).transpose(0, 1),
                             g.mask_batched(), cfg=cfg)
    torch.testing.assert_close(tr.logits(state, batch), want, rtol=1e-6, atol=1e-6)
    costs = []
    for _ in range(5):
        state, c, _ = tr.train_step(state, batch)
        costs.append(float(c))
    assert costs[-1] < costs[0]
