"""The port's edge-partitioned aggregation (kgcn_tpu_torch/parallel/
edge_partition.py) against the JAX package, on the CPU.

``partition_edges`` against kgcn_tpu's, array for array (NumPy, bitwise).
The ring and allgather halos at D = 1 (in this process, a world of one),
2 and 4 (gloo ranks, one launch a world size, tests/torch_parallel_worker.
py): each rank's rows of the output and of the input's gradient against
kgcn_tpu's ``spmm_edge_partitioned`` on D virtual devices (and its
``jax.grad``) and against the dense sum ``A x`` (and ``Aᵀ g``), rtol =
atol = 1e-5 (sums of a few float32 terms in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.parallel import edge_partition as tep
from torch_parallel_worker import launch_scenarios

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
WORLDS = (2, 4)
V, E, F = 48, 400, 6


def _graph(seed=0):
    rng = np.random.RandomState(seed)
    s = rng.randint(0, V, E).astype(np.int32)
    r = rng.randint(0, V, E).astype(np.int32)
    w = (rng.random_sample(E) + 0.1).astype(np.float32)
    w[::17] = 0.0  # padding edges drop out of the partition
    x = rng.standard_normal((V, F)).astype(np.float32)
    cot = rng.standard_normal((V, F)).astype(np.float32)
    return s, r, w, x, cot


def _dense(s, r, w):
    a = np.zeros((V, V), np.float64)
    np.add.at(a, (r, s), w)
    return a


def _jax(D, strategy):
    """kgcn_tpu's value and input gradient on D virtual devices."""
    from kgcn_tpu.parallel.edge_partition import partition_edges, spmm_edge_partitioned
    from kgcn_tpu.parallel.mesh import make_mesh

    s, r, w, x, cot = _graph()
    part = partition_edges(s, r, w, V, D)
    mesh = make_mesh({"data": D})

    def f(xx):
        return spmm_edge_partitioned(part, xx, mesh, strategy=strategy)

    y = np.asarray(f(jnp.asarray(x)))
    dx = np.asarray(jax.grad(lambda xx: jnp.sum(f(xx) * cot))(jnp.asarray(x)))
    return y, dx


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    s, r, w, x, cot = _graph()
    inp = {"V": V, "s": s, "r": r, "w": w, "x": x, "cot": cot}
    return {D: launch_scenarios(tmp_path_factory.mktemp(f"ep{D}"), D, {"ep": inp})["ep"]
            for D in WORLDS}


@pytest.mark.parametrize("D", [1, 2, 3, 4, 8])
def test_partition_edges_matches_jax(D):
    from kgcn_tpu.parallel.edge_partition import partition_edges as j_part

    s, r, w, _, _ = _graph(D)
    n = V if V % D == 0 else V + D - V % D
    got, want = tep.partition_edges(s, r, w, n, D), j_part(s, r, w, n, D)
    assert got.v_local == want.v_local
    for a, b in zip(got[:3], want[:3]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError):
        tep.partition_edges(s, r, w, n + 1, D) if D > 1 else tep.partition_edges(
            s + n, r, w, n, D)


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
def test_world_of_one(strategy):
    """D = 1 in a plain process: the halo is the identity."""
    s, r, w, x, cot = _graph()
    part = tep.DevicePartition.of(tep.partition_edges(s, r, w, V, 1), 0, "cpu")
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tep.spmm_edge_partitioned(part, xt, strategy)
    (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(cot))
    a = _dense(s, r, w)
    np.testing.assert_allclose(y.detach().numpy(), a @ x, **TOL)
    np.testing.assert_allclose(dx.numpy(), a.T @ cot, **TOL)
    jy, jdx = _jax(1, strategy)
    np.testing.assert_allclose(y.detach().numpy(), jy, **TOL)
    np.testing.assert_allclose(dx.numpy(), jdx, **TOL)


@pytest.mark.parametrize("strategy", ["ring", "allgather"])
@pytest.mark.parametrize("D", WORLDS)
def test_halos_match_jax_and_the_dense_sum(ranks, D, strategy):
    s, r, w, x, cot = _graph()
    y = np.concatenate([out[strategy]["y"] for out in ranks[D]])
    dx = np.concatenate([out[strategy]["dx"] for out in ranks[D]])
    jy, jdx = _jax(D, strategy)
    np.testing.assert_allclose(y, jy, **TOL)
    np.testing.assert_allclose(dx, jdx, **TOL)
    a = _dense(s, r, w)
    np.testing.assert_allclose(y, a @ x, **TOL)
    np.testing.assert_allclose(dx, a.T @ cot, **TOL)


def test_unknown_strategy_and_world_mismatch():
    s, r, w, x, _ = _graph()
    part = tep.DevicePartition.of(tep.partition_edges(s, r, w, V, 2), 0, "cpu")
    with pytest.raises(ValueError, match="halo"):
        tep.spmm_edge_partitioned(part, torch.from_numpy(x[:24]), "tree")
    with pytest.raises(ValueError, match="2 ranks"):
        tep.spmm_edge_partitioned(part, torch.from_numpy(x[:24]), "ring")
