"""``"precision"`` in the port (PyTorch, CPU) against the JAX package: the
bf16 cast of the payload (``Batch.cast_compute`` / ``GraphBatch.astype``),
the dtype every layer computes in, the bf16 gconv's plain version against
the Pallas kernel, training steps and the engines at bf16, and the
``"highest"`` / ``"default"`` mapping.

Tolerances, each with its reason:

* the bf16 gconv's plain version and ``gconv_fused`` in interpret mode on
  bf16 operands: each within one bf16 rounding of the float64 sum, ``|d| <=
  2^-8 |ref| + 1e-6`` (both sum in f32 and round once), hence within one
  bf16 ulp of each other (their f32 sums differ in order and can fall on
  either side of a rounding boundary);
* the bf16 CUDA kernel's arithmetic, emulated on the CPU
  (``_emulate_bf16_tc``: the f32 projection split into three bf16 terms):
  within one bf16 rounding of the float64 sum plus two f32 ulps of
  ``sum |A| |X W + b|`` (``_exact_and_limit``; at 203 and 256 nodes outputs
  that cancel sit that far from the float64 sum in any f32 summation, the
  plain version's included, which the test holds to the same bound);
* against ``gconv_dense`` (the XLA einsum the JAX layers call, whose
  intermediates XLA rounds to bf16 where it chooses): 2e-2 of the output's
  largest magnitude;
* three training steps from the same weights: costs within 2e-2 relative
  (``BF16_COST_RTOL``).  The two packages round bf16 at other places (the
  port's gconv and ELL sums are f32 with one rounding, XLA's einsums round
  where XLA chooses), so the costs agree to a few bf16 ulps of the
  activations.  ``test_bf16_tolerance_is_above_jax_against_itself``
  measures the JAX package against itself from weights one bf16 ulp apart
  and checks that this tolerance is no tighter than that spread is wide.
"""
import contextlib
import functools
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from kgcn_tpu_torch.convert import params_from_jax
from kgcn_tpu_torch.data.synthetic import make_ring_dataset
from test_torch_tiled import jax_backend

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_COST_RTOL = 2e-2
ONE_ROUNDING = 2.0 ** -8


@pytest.fixture(autouse=True)
def jax_state():
    """Restore the JAX package's globals after each test (xdist runs a
    whole file in one process)."""
    yield
    from kgcn_tpu.graph.batch import set_dense_path
    from kgcn_tpu.ops import pallas_spmm
    from kgcn_tpu.ops import stream_spmm as js
    from kgcn_tpu.ops import tiled_spmm as jt

    importlib.import_module("kgcn_tpu.ops.spmm").set_backend("xla")
    js.set_compute_dtype(jnp.bfloat16)
    jt.set_compute_dtype(jnp.bfloat16)
    set_dense_path(True)
    pallas_spmm._KERNEL_OK.clear()


@contextlib.contextmanager
def pallas_interpret():
    orig = pl.pallas_call
    pl.pallas_call = functools.partial(orig, interpret=True)
    try:
        yield
    finally:
        pl.pallas_call = orig


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


# ---- the cast ------------------------------------------------------------------


def _ring_batches(backend):
    """One JAX and one port batch of ring6 graphs (ELL arrays attached)."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.runtime.config import load_config as j_config
    from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
    from kgcn_tpu_torch.data.dataset import build_dataset as t_build
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = j_config(os.path.join(REPO, "example_config", "gin.json"),
                   {"spmm_backend": backend, "tiled_compute_dtype": "float32"})
    data = make_ring_dataset(num_pairs=20, num_nodes=6, seed=0)
    jds, jinfo = j_build(dict(data), cfg)
    tds, tinfo = t_build(dict(data), cfg)
    with jax_backend(backend, "float32"):
        jb = next(iter(JBatcher(jds, jinfo, 10, seed=0).batches(shuffle=False)))
    tb = next(iter(TBatcher(tds, tinfo, 10, seed=0,
                            backend=Backend(backend, "float32")).batches(shuffle=False)))
    return jb, tb


def _dtype_name(x):
    return None if x is None else str(x.dtype).replace("torch.", "")


@pytest.mark.parametrize("backend", ["pallas", "dense"])
def test_cast_compute_field_dtypes_match_jax(backend):
    """Every field of the cast batch has ``kgcn_tpu``'s dtype: the float
    payload bf16, ids, labels and masks as they were; the ELL layout kept."""
    jb, tb = _ring_batches(backend)
    rng = np.random.RandomState(0)
    vm = (rng.standard_normal((10, 4)).astype(np.float32),)
    jb = jb.replace(vector_modal=tuple(jnp.asarray(v) for v in vm),
                    rng_normal=jnp.zeros((10, 6, 3), jnp.float32))
    tb = tb.replace(vector_modal=tuple(torch.from_numpy(v) for v in vm),
                    rng_normal=torch.zeros((10, 6, 3)))
    if backend == "dense":
        jb = jb.replace(graph=jb.graph.with_dense_adj())
        tb = tb.replace(graph=tb.graph.with_dense_adj())
    jc, tc = jb.cast_compute(jnp.bfloat16), tb.cast_compute(torch.bfloat16)
    fields = ("senders", "receivers", "edge_weights", "n_edge", "n_node", "node_mask",
              "nodes", "dense_adj", "edge_valid", "ell_senders", "ell_weights")
    for f in fields:
        if f.startswith("ell") and backend == "dense":
            # kgcn_tpu attaches ELL arrays on every backend, the port only on
            # the two that read them (data/batcher.py's docstring)
            assert getattr(tc.graph, f) is None
            continue
        assert _dtype_name(getattr(tc.graph, f)) == _dtype_name(getattr(jc.graph, f)), f
    for f in ("labels", "mask_label", "pad_mask", "rng_normal"):
        assert _dtype_name(getattr(tc, f)) == _dtype_name(getattr(jc, f)), f
    assert [_dtype_name(v) for v in tc.vector_modal] == ["bfloat16"]
    assert tc.graph.edge_weights.dtype == torch.bfloat16
    if backend == "pallas":
        assert tc.graph.ell_weights.dtype == torch.bfloat16
        assert tc.graph.ell_pack is tb.graph.ell_pack  # the layout is kept
        assert tc.graph.ell_transpose() is not None
    np.testing.assert_array_equal(tc.graph.edge_weights.float().numpy(),
                                  _bf16(tb.graph.edge_weights.numpy()))
    # a dense adjacency built after the cast follows the payload
    assert tc.graph.replace(dense_adj=None).dense_adjacency().dtype == torch.bfloat16


# ---- the bf16 gconv ---------------------------------------------------------------


def _gconv_inputs(shape, seed):
    C, B, N, Fin, Fout = shape
    rng = np.random.RandomState(seed)
    adj = (rng.random_sample((C, B, N, N)) < 0.2) * rng.random_sample((C, B, N, N))
    arrs = [adj, rng.standard_normal((B, N, Fin)), rng.standard_normal((C, Fin, Fout)),
            rng.standard_normal((C, Fout))]
    return [_bf16(a.astype(np.float32)) for a in arrs]


# the serving shape (C 1, 47 atoms, 81 features → 50) and a misaligned one
GCONV_SHAPES = [(1, 4, 47, 81, 50), (2, 3, 13, 7, 5)]


@pytest.mark.parametrize("shape", GCONV_SHAPES)
def test_gconv_bf16_plain_version_within_one_rounding_of_pallas(shape):
    """The port's plain bf16 version (the CPU path of ``gconv``) against
    the Pallas kernel on bf16 operands in interpret mode: both sum in f32
    and round once, so they agree within one bf16 rounding."""
    from kgcn_tpu_torch.ops.gconv import gconv

    arrs = _gconv_inputs(shape, seed=3)
    with pallas_interpret():
        from kgcn_tpu.ops.pallas_gconv import gconv_fused

        want = gconv_fused(*(jnp.asarray(a, jnp.bfloat16) for a in arrs))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = gconv(*(torch.from_numpy(a.copy()).to(torch.bfloat16) for a in arrs))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    adj, x, w, b = (a.astype(np.float64) for a in arrs)
    exact = np.einsum("cbnm,cbmf->bnf", adj, np.einsum("bmi,cif->cbmf", x, w)
                      + b[:, None, None, :])
    for out in (got, want):  # each one rounding of the exact sum
        assert np.all(np.abs(out - exact) <= ONE_ROUNDING * np.abs(exact) + 1e-6)
    # so the two differ by one bf16 ulp at most, where their f32 sums fall
    # on either side of a rounding boundary
    assert np.all(np.abs(got - want) <= 2 * ONE_ROUNDING * np.abs(want) + 1e-6)
    assert np.mean(got == want) > 0.95


@pytest.mark.parametrize("shape", GCONV_SHAPES)
def test_gconv_bf16_against_the_jax_einsum(shape):
    """Against ``gconv_dense`` on bf16 operands (what ``kgcn_tpu``'s dense
    layers call): within 2e-2 of the output's largest magnitude; and the
    backward (the einsums of ``_bwd`` in bf16) likewise."""
    from kgcn_tpu.ops.spmm import gconv_dense
    from kgcn_tpu_torch.ops.gconv import gconv

    arrs = _gconv_inputs(shape, seed=5)
    cot = _bf16(np.random.RandomState(6).standard_normal(
        (shape[1], shape[2], shape[4])).astype(np.float32))
    jin = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    want, vjp = jax.vjp(gconv_dense, *jin)
    jgrads = vjp(jnp.asarray(cot, jnp.bfloat16))
    tin = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in arrs]
    got = gconv(*tin)
    tgrads = torch.autograd.grad(got, tin, torch.from_numpy(cot).to(torch.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=2e-2 * np.abs(want).max())
    for name, g, w in zip(("adj", "x", "w", "b"), tgrads, jgrads):
        assert g.dtype == torch.bfloat16, name
        w = np.asarray(w.astype(jnp.float32))
        np.testing.assert_allclose(g.float().numpy(), w, rtol=0,
                                   atol=2e-2 * np.abs(w).max(), err_msg=name)


# the bf16 kernel's own arithmetic (csrc/gconv.cu, kgcn_gconv_bf16): the two
# shapes above, graphs of 203 and 256 nodes (the reaction shapes) at a small
# batch, and Fin and Fout that are not multiples of 16
EMULATION_SHAPES = GCONV_SHAPES + [(3, 2, 203, 81, 128), (1, 2, 256, 256, 256),
                                   (2, 3, 37, 21, 45)]


def _emulate_bf16_tc(adj, x, w, b, terms=3):
    """What the bf16 tensor-core kernel computes, in torch on the CPU: per
    channel the f32 projection ``X W_c + b_c`` (bf16 products are exact in
    f32), split into ``terms`` bf16 terms (``hi = bf16(p)``, ``lo = bf16(p -
    hi)``, ``lo2 = bf16(p - hi - lo)``), each multiplied by the bf16 ``A_c``
    and summed in f32 into one accumulator, channel by channel; the result
    rounded to bf16 once.  bf16 tensors in and out."""
    a, x, w, b = (t.float() for t in (adj, x, w, b))
    acc = torch.zeros(x.shape[0], x.shape[1], w.shape[2])
    for c in range(a.shape[0]):
        rest = x @ w[c] + b[c]
        for _ in range(terms):
            part = rest.to(torch.bfloat16).float()
            rest = rest - part
            acc = acc + a[c] @ part
    return acc.to(torch.bfloat16)


def _exact_and_limit(arrs):
    """The f64 sum and the bound held to: one bf16 rounding of it, plus
    1e-6, plus two f32 ulps of ``sum_c |A_c| |X W_c + b_c|``: where an output
    cancels (the 203- and 256-node graphs here reach |out| 300 and cross
    zero), an f32 sum of these terms is that far from the f64 one, the plain
    version's as much as the kernel's."""
    adj, x, w, b = (a.astype(np.float64) for a in arrs)
    p = np.einsum("bmi,cif->cbmf", x, w) + b[:, None, None, :]
    exact = np.einsum("cbnm,cbmf->bnf", adj, p)
    scale = np.einsum("cbnm,cbmf->bnf", np.abs(adj), np.abs(p))
    return exact, ONE_ROUNDING * np.abs(exact) + 1e-6 + 2.0 ** -23 * scale


@pytest.mark.parametrize("shape", EMULATION_SHAPES)
def test_gconv_bf16_tensor_core_emulation_within_one_rounding(shape):
    """The kernel's arithmetic (``_emulate_bf16_tc``: three bf16 terms of the
    f32 projection) and the plain version each within one bf16 rounding of
    the f64 sum (``_exact_and_limit``), and the emulation within two
    roundings of ``gconv_fused`` on bf16 operands in interpret mode, equal
    to it in most outputs."""
    from kgcn_tpu_torch.ops.gconv import gconv

    arrs = _gconv_inputs(shape, seed=7)
    with pallas_interpret():
        from kgcn_tpu.ops.pallas_gconv import gconv_fused

        want = gconv_fused(*(jnp.asarray(a, jnp.bfloat16) for a in arrs))
    want = np.asarray(want.astype(jnp.float32)).astype(np.float64)
    ops = [torch.from_numpy(a.copy()).to(torch.bfloat16) for a in arrs]
    emulated = _emulate_bf16_tc(*ops)
    assert emulated.dtype == torch.bfloat16
    got = emulated.float().numpy().astype(np.float64)
    plain = gconv(*ops).float().numpy().astype(np.float64)
    exact, limit = _exact_and_limit(arrs)
    for out in (got, plain):
        assert np.all(np.abs(out - exact) <= limit)
    assert np.all(np.abs(got - want) <= 2 * limit)
    assert np.mean(got == want) > 0.95


@pytest.mark.parametrize("shape", [(1, 4, 47, 81, 50), (1, 2, 256, 256, 256)])
def test_gconv_bf16_two_terms_are_not_enough(shape):
    """Why the kernel splits the f32 projection into three bf16 terms: with
    two (``hi + lo``, 2^-16 of each value lost) outputs that cancel fall
    outside one bf16 rounding of the f64 sum, at the serving shape and at
    N 256; with three they do not."""
    arrs = _gconv_inputs(shape, seed=7)
    ops = [torch.from_numpy(a.copy()).to(torch.bfloat16) for a in arrs]
    exact, limit = _exact_and_limit(arrs)
    over = {terms: np.abs(_emulate_bf16_tc(*ops, terms=terms).float().numpy()
                          .astype(np.float64) - exact) > limit for terms in (2, 3)}
    assert over[2].any() and not over[3].any()


def test_gconv_kernel_refuses_a_mix_of_types():
    """The CUDA wrapper takes all-float32 or all-bf16 operands and raises
    on a mix (it makes no float32 copies of bf16 operands)."""
    from kgcn_tpu_torch.ops import gconv as gmod

    arrs = [torch.from_numpy(a) for a in _gconv_inputs((1, 2, 5, 3, 4), seed=0)]
    with pytest.raises(TypeError, match="all-float32 or all-bfloat16"):
        gmod._launch(arrs[0].to(torch.bfloat16), *arrs[1:])


# ---- training steps at bf16 --------------------------------------------------------


def _graph_pair(config_file, source, backend, n, **over):
    """JAX and port (config, info, batches) of ``n`` examples spread over a
    dataset, batched alike, with ``"precision": "bfloat16"``."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.runtime.config import load_config as j_config
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.batcher import Batcher as TBatcher
    from kgcn_tpu_torch.data.dataset import build_dataset as t_build
    from kgcn_tpu_torch.runtime.backend import Backend

    cfg = j_config(os.path.join(REPO, "example_config", config_file), dict(
        {"spmm_backend": backend, "dropout_rate": 0.0, "precision": "bfloat16",
         "tiled_compute_dtype": "float32"}, **over))
    data = (make_ring_dataset(num_pairs=50, num_nodes=6, seed=0) if source == "ring6"
            else jbl.load(os.path.join(REPO, cfg["dataset"])))
    jds, jinfo = j_build(dict(data), cfg)
    tds, tinfo = t_build(dict(data), cfg)
    bs = int(cfg["batch_size"])
    idx = np.linspace(0, jds.num - 1, n).astype(np.int64)
    with jax_backend(backend, "float32"):
        jbatches = list(JBatcher(jds.subset(idx), jinfo, bs, seed=0).batches(shuffle=False))
    tbatches = list(TBatcher(tds.subset(idx), tinfo, bs, seed=0,
                             backend=Backend(backend, "float32")).batches(shuffle=False))
    return cfg, jinfo, jbatches, tinfo, tbatches


def _jax_steps(cfg, model, jinfo, jbatches, backend, order, perturb=None):
    """Three JAX ``train_step``s → (costs, the initial parameter tree)."""
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime.train import Trainer as JTrainer

    with jax_backend(backend, "float32"), pallas_interpret():
        jtr = JTrainer(j_build(model, jinfo, cfg), cfg, jinfo)
        jstate = jtr.init_state(jbatches[0], seed=0)
        if perturb is not None:
            jstate = jstate.replace(params=jax.tree_util.tree_map(perturb, jstate.params))
        tree = params_from_jax(jax.device_get(jstate.params),
                               jax.device_get(jstate.batch_stats))
        costs = []
        for i in order:
            jstate, cost, _ = jtr.train_step(jstate, jbatches[i])
            costs.append(float(cost))
    return costs, tree


def _port_steps(cfg, model, tinfo, tbatches, tree, order):
    from kgcn_tpu_torch.models.registry import build_model as t_build
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer

    ttr = TTrainer(t_build(model, tinfo, cfg), cfg, tinfo, device="cpu")
    assert ttr.compute_dtype is torch.bfloat16
    tstate = ttr.state_from_tree(tree)
    costs = []
    for i in order:
        tstate, cost, _ = ttr.train_step(tstate, tbatches[i])
        costs.append(float(cost))
    assert all(v.dtype == torch.float32 for v in tstate.params.values())
    return costs


BF16_CASES = [
    ("solubility_cls.json", "solubility", "gcn", "dense", 64),
    ("gin.json", "ring6", "gin", "pallas", 100),
    ("gin.json", "ring6", "gin", "xla", 100),
    ("gat.json", "synthetic", "gat", "tiled", 50),
]


@pytest.mark.parametrize("config_file,source,model,backend,n", BF16_CASES)
def test_bf16_train_steps_match_jax(config_file, source, model, backend, n):
    """Three ``train_step``s at ``"precision": "bfloat16"`` from the same
    weights: the costs within ``BF16_COST_RTOL`` of ``kgcn_tpu``'s; the
    parameters stay float32."""
    cfg, jinfo, jbatches, tinfo, tbatches = _graph_pair(config_file, source, backend, n)
    if backend == "pallas":
        assert tbatches[0].graph.ell_senders is not None
    order = [0, 1, 0]
    jcosts, tree = _jax_steps(cfg, model, jinfo, jbatches, backend, order)
    tcosts = _port_steps(cfg, model, tinfo, tbatches, tree, order)
    print("bf16 costs", model, backend, tcosts, jcosts)
    np.testing.assert_allclose(tcosts, jcosts, rtol=BF16_COST_RTOL)


def test_bf16_tolerance_is_above_jax_against_itself():
    """The measure behind ``BF16_COST_RTOL``: ``kgcn_tpu``'s bf16 GCN steps
    from weights one bf16 ulp apart (each parameter moved by 2^-8 of
    itself) differ from its own by less than the tolerance, and by more
    than a float32 rounding (the spread bf16 makes)."""
    cfg, jinfo, jbatches, _, _ = _graph_pair("solubility_cls.json", "solubility",
                                             "dense", 64)
    order = [0, 1, 0]
    base, _ = _jax_steps(cfg, "gcn", jinfo, jbatches, "dense", order)
    moved, _ = _jax_steps(cfg, "gcn", jinfo, jbatches, "dense", order,
                          perturb=lambda p: p * (1 + ONE_ROUNDING))
    gap = np.max(np.abs(np.asarray(moved) - base) / np.abs(base))
    print("jax against itself, one bf16 ulp apart:", gap)
    assert 1e-6 < gap < BF16_COST_RTOL, gap


def test_bf16_kg_train_steps_on_stream_match_jax():
    """Three KG steps (300 entities, the gcn encoder, the stream backend and
    its bf16 payload) at ``"precision": "bfloat16"``: costs within
    ``BF16_COST_RTOL`` of ``kgcn_tpu``'s."""
    from kgcn_tpu.models.kg import KGBatcher as JKG
    from kgcn_tpu.models.registry import build_model as j_build
    from kgcn_tpu.runtime.train import Trainer as JTrainer
    from kgcn_tpu_torch.models.kg import KGBatcher as TKG
    from kgcn_tpu_torch.models.registry import build_model as t_build
    from kgcn_tpu_torch.runtime.train import Trainer as TTrainer
    from test_torch_kg import _config, _data, _jax_side, _port_side, jax_globals

    cfg = _config(kg_encoder="gcn", embedding_dim=16, precision="bfloat16")
    data = _data("random 300 entities")
    with jax_globals():
        jds, jinfo, jname = _jax_side(data, cfg)
        jkb = JKG(jds, jinfo, label_batch_size=64, seed=0)
        jtr = JTrainer(j_build("kg_distmult", jinfo, cfg), cfg, jinfo)
        jstate = jtr.init_state(jkb.init_batch(), seed=0)
        tree = params_from_jax(jax.device_get(jstate.params), {})
        jcosts = []
        for batch in list(jkb.batches())[:3]:
            jstate, cost, _ = jtr.train_step(jstate, batch)
            jcosts.append(float(cost))
    tds, tinfo, be = _port_side(data, cfg)
    assert be.name == jname == "stream"
    tkb = TKG(tds, tinfo, label_batch_size=64, seed=0, backend=be)
    ttr = TTrainer(t_build("kg_distmult", tinfo, cfg), cfg, tinfo, device="cpu")
    tstate = ttr.state_from_tree(tree)
    tcosts = []
    for batch in list(tkb.batches())[:3]:
        tstate, cost, _ = ttr.train_step(tstate, batch)
        tcosts.append(float(cost))
    np.testing.assert_allclose(tcosts, jcosts, rtol=BF16_COST_RTOL)


# ---- the dtype of every layer ----------------------------------------------------


def _leaf_dtypes(out):
    leaves = jax.tree_util.tree_leaves(
        out, is_leaf=lambda x: isinstance(x, torch.Tensor))
    return tuple(str(x.dtype).replace("torch.", "") for x in leaves
                 if hasattr(x, "dtype") and getattr(x, "ndim", 0) > 0)


def _jax_layer_dtypes(jm, variables, jbatch, **kw):
    """Each flax submodule's outputs' dtypes, per call, by module path."""
    import re

    _, state = jm.apply(variables, jbatch, capture_intermediates=True,
                        mutable=["intermediates"], **kw)
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if k == "__call__":
                if path:
                    out[".".join(path)] = [_leaf_dtypes(o) for o in v]
            elif isinstance(v, dict):
                walk(v, path + [k])

    walk(jax.device_get(state["intermediates"]), [])
    return {re.sub(r"_(\d+)$", r"_\1", k): v for k, v in out.items()}


def _port_layer_dtypes(m, batch, **kw):
    """Each submodule's outputs' dtypes, per call; ``ModuleList`` items
    named as flax names a list in ``setup`` (``name_i``)."""
    import re

    out, hooks = {}, []
    for name, mod in m.named_modules():
        if not name:
            continue
        key = re.sub(r"\.(\d+)", r"_\1", name)
        hooks.append(mod.register_forward_hook(
            lambda mod, args, o, key=key: out.setdefault(key, []).append(_leaf_dtypes(o))))
    try:
        with torch.no_grad():
            m(batch, **kw)
    finally:
        for h in hooks:
            h.remove()
    return out


def _models_for_dtypes(name, payload="float32"):
    """(JAX model, variables, JAX batch, port model with the same weights,
    port batch, backend) for one registry model at a few layers' width;
    ``payload``: the tiled and stream kernels' ``tiled_compute_dtype``."""
    from kgcn_tpu.data import Batcher as JBatcher
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.models.registry import build_model as j_model
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.batcher import Batcher
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.backend import Backend

    if name == "gcn_multimodal":
        from test_torch_multimodal import _both, _multimodal_jbl

        jm, variables, jb, m, b, _ = _both(name, _multimodal_jbl(), "classification")
        return jm, variables, jb, m, b, "dense"
    if name == "gcn_vae":
        from test_torch_vae import _batches, _vae_both

        jb, b, info = _batches()
        jm, variables, m = _vae_both(False, jb, info)
        return jm, variables, jb, m, b, "dense"
    if name == "kg_distmult":
        from kgcn_tpu.models.kg import KGBatcher as JKG
        from kgcn_tpu_torch.models.kg import KGBatcher as TKG
        from test_torch_kg import _config, _data, _jax_side, _port_side

        cfg = _config(kg_encoder="gcn", embedding_dim=16, tiled_compute_dtype=payload)
        data = _data("random 300 entities")
        jds, jinfo, _ = _jax_side(data, cfg)
        jb = JKG(jds, jinfo, label_batch_size=64, seed=0).init_batch()
        tds, tinfo, be = _port_side(data, cfg)
        b = TKG(tds, tinfo, label_batch_size=64, seed=0, backend=be).init_batch()
        jm = j_model("kg_distmult", jinfo, cfg)
        m = build_model("kg_distmult", tinfo, cfg)
        backend = be.name
    else:
        backend, source = {"gcn": ("dense", "synthetic.jbl"), "gin": ("pallas", "ring6"),
                           "gat": ("tiled", "synthetic.jbl")}[name]
        cfg = {"spmm_backend": backend, "dropout_rate": 0.0,
               "tiled_compute_dtype": payload}
        data = (make_ring_dataset(num_pairs=10, num_nodes=6, seed=0) if source == "ring6"
                else jbl.load(os.path.join(REPO, "example_jbl", source)))
        jds, jinfo = j_build(dict(data), cfg)
        ds, info = build_dataset(dict(data), cfg)
        with jax_backend(backend, payload):
            jb = JBatcher(jds, jinfo, 8).make_batch(np.arange(6))
        b = Batcher(ds, info, 8, backend=Backend(backend, payload)).make_batch(np.arange(6))
        jm, m = j_model(name, jinfo, cfg), build_model(name, info, cfg)
    variables = jax.device_get(jm.init({"params": jax.random.PRNGKey(1),
                                        "dropout": jax.random.PRNGKey(2)}, jb, train=False))
    tree = params_from_jax(variables["params"], variables.get("batch_stats", {}), m)
    m.load_state_dict({**tree["params"], **tree["batch_stats"]})
    return jm, variables, jb, m, b, backend


@pytest.mark.parametrize("name,payload", [
    ("gcn", "float32"), ("gin", "float32"), ("gat", "float32"), ("gat", "bfloat16"),
    ("gcn_multimodal", "float32"), ("gcn_vae", "float32"), ("kg_distmult", "bfloat16"),
    ("kg_distmult", "float32")])
def test_layer_output_dtypes_match_jax(name, payload):
    """On a batch cast to bf16, every layer's outputs have ``kgcn_tpu``'s
    dtypes (bf16 through the graph layers, float32 from a flax ``Dense``
    without ``dtype``, the moments' and losses' float32), call by call;
    the tiled (GAT) and stream (KG) wrappers with either payload dtype."""
    jm, variables, jb, m, b, backend = _models_for_dtypes(name, payload)
    jb, b = jb.cast_compute(jnp.bfloat16), b.cast_compute(torch.bfloat16)
    with jax_backend(backend, payload), pallas_interpret():
        want = _jax_layer_dtypes(jm, variables, jb, train=False)
    got = _port_layer_dtypes(m.eval(), b, train=False)
    import collections
    import re

    def calls(layers):
        # flax names a parameterless layer anew at each call in a compact
        # module (GraphGather_0, GraphGather_1, ...) where the port calls one
        # module twice: count the calls by layer kind
        return collections.Counter((re.sub(r"_\d+$", "", k), d)
                                   for k, v in layers.items() for d in v)

    want_c, got_c = calls(want), calls(got)
    kinds = {k for k, _ in want_c} & {k for k, _ in got_c}
    assert len(kinds) >= 3, (sorted(want), sorted(got))
    for kind in sorted(kinds):
        assert ({d: n for (k, d), n in got_c.items() if k == kind}
                == {d: n for (k, d), n in want_c.items() if k == kind}), kind
    # the KG's embeddings are float32 (a float32 table times the bf16 mask)
    bf16 = any("bfloat16" in d for (k, ds) in got_c for d in ds if k in kinds)
    assert bf16 == (name != "kg_distmult")


# ---- the precision switch, and the engines at bf16 ----------------------------------


def _set_keys(path, **over):
    with open(path) as f:
        cfg = json.load(f)
    cfg.update(over)
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _gat_config(tmp, name, **over):
    with open(os.path.join(REPO, "example_config", "gat.json")) as f:
        cfg = json.load(f)
    d = tmp / name
    d.mkdir()
    cfg.update({"dataset": os.path.join(REPO, cfg["dataset"]), "epoch": 2,
                "save_model_path": str(d / "model"), "seed": 0}, **over)
    path = d / "config.json"
    path.write_text(json.dumps(cfg))
    return str(path), d


def test_highest_is_float32_and_default_is_accepted(tmp_path):
    """``"highest"`` trains bitwise as ``"float32"`` (both keep float32
    products in float32; ``kgcn_tpu`` maps both to JAX's ``highest``);
    ``"default"`` is accepted and allows TF32 for library matmuls, as JAX's
    ``default`` on a GPU; the setting goes back with ``"float32"``."""
    from kgcn_tpu_torch.cli.main import main as t_main
    from kgcn_tpu_torch.runtime import checkpoint as ckpt
    from kgcn_tpu_torch.runtime.device import set_precision

    trees = {}
    try:
        for precision in ("float32", "highest", "default"):
            path, d = _gat_config(tmp_path, precision, precision=precision)
            t_main(["train", "--config", path, "--cpu"])
            trees[precision] = ckpt.load_checkpoint(str(d / "model" / "model.last.ckpt"))
            assert torch.backends.cuda.matmul.allow_tf32 == (precision == "default")
            assert torch.backends.cudnn.allow_tf32 == (precision == "default")
    finally:
        set_precision("float32")
    assert not torch.backends.cuda.matmul.allow_tf32
    for k, v in trees["float32"]["params"].items():
        assert torch.equal(trees["highest"]["params"][k], v), k
        assert torch.isfinite(trees["default"]["params"][k]).all(), k


@pytest.mark.parametrize("engine", ["sparse", "pair", "gen"])
def test_engines_train_at_bf16(tmp_path, engine, capsys):
    """One epoch of ``cli.sparse``, ``cli.pair`` and ``cli.gen train`` at
    ``"precision": "bfloat16"``: finite costs and every file written."""
    from kgcn_tpu_torch.runtime.device import set_precision

    try:
        if engine == "sparse":
            from kgcn_tpu_torch.cli.sparse import main as t_main
            from test_torch_sparse import _config, _write_run_sparse_data

            data = str(tmp_path / "ring.tfrecords")
            _write_run_sparse_data(data)
            path = _set_keys(_config(tmp_path, "port", data), precision="bfloat16",
                             epoch=1)
            t_main(["train", "--config", path, "--cpu"])
            want = ["model/model.0.best.ckpt", "model/model.0.last.ckpt", "valid.json"]
        elif engine == "pair":
            from kgcn_tpu_torch.cli.pair import main as t_main
            from test_torch_pair import _config

            path = _config(tmp_path, "port", precision="bfloat16", epoch=1)
            t_main(["train", "--config", path, "--cpu"])
            t_main(["infer", "--config", path, "--cpu"])
            want = ["model/model.last.ckpt", "scores.csv"]
        else:
            from kgcn_tpu_torch.cli.gen import main as t_main
            from test_torch_vae import _config

            path = _config(tmp_path, "port", precision="bfloat16", epoch=1)
            t_main(["train", "--config", path, "--cpu"])
            t_main(["reconstruct", "--config", path, "--cpu"])
            want = ["model/model.last.ckpt", "reconstruction.jbl"]
    finally:
        set_precision("float32")
    out = capsys.readouterr().out
    costs = [float(line.split("training cost ")[1].split()[0].rstrip(","))
             for line in out.splitlines() if "training cost " in line]
    assert costs and np.isfinite(costs).all(), out
    for name in want:
        assert (tmp_path / "port" / name).exists(), name
