"""The port's flax-msgpack reader (kgcn_tpu_torch/runtime/flax_msgpack.py)
against ``flax.serialization.msgpack_restore``, exactly: hypothesis trees,
a chunked array, real ``kgcn_tpu`` checkpoints, the committed fixture, and
the error cases."""
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from kgcn_tpu_torch.runtime import flax_msgpack as fm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "jax_gcn_solubility")


def assert_same(got, want, where="tree"):
    """Exact equality of a decoded tree and flax's: same structure, array
    types, shapes and bits (bfloat16 through its uint16 bits)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, where
        assert tuple(got.shape) == np.shape(want), where
        np.testing.assert_array_equal(got.view(torch.uint16).numpy(),
                                      np.asarray(want).view(np.uint16), err_msg=where)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, np.generic):
        assert type(got) is type(want) and got.dtype == want.dtype, where
        assert got.tobytes() == want.tobytes(), where
    else:
        assert type(got) is type(want) and got == want, where


DTYPES = [np.float32, np.float64, np.int32, np.int64, np.uint32, np.bool_,
          ml_dtypes.bfloat16]


@st.composite
def arrays(draw):
    dtype = draw(st.sampled_from(DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 4), min_size=0, max_size=4)))
    n = int(np.prod(shape))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.RandomState(seed)
    if dtype == np.bool_:
        arr = rng.rand(n) < 0.5
    elif np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        arr = rng.randint(max(info.min, -2**62), min(info.max, 2**62), size=n,
                          dtype=np.int64)
    else:
        arr = rng.standard_normal(n) * 10.0 ** rng.randint(-30, 30)
    return np.asarray(arr).astype(dtype).reshape(shape)


SCALARS = st.one_of(
    st.integers(-2**63, 2**64 - 1),
    st.floats(allow_nan=False),
    st.text(max_size=40),
    st.booleans(),
    st.none(),
    st.builds(np.float32, st.floats(width=32, allow_nan=False)),
    st.builds(np.int64, st.integers(-2**63, 2**63 - 1)),
    st.builds(np.int32, st.integers(-2**31, 2**31 - 1)),
)
LEAVES = st.one_of(arrays(), SCALARS, st.just({}))
TREES = st.recursive(
    st.dictionaries(st.text(min_size=1, max_size=12), LEAVES, max_size=5),
    lambda children: st.dictionaries(st.text(min_size=1, max_size=12),
                                     st.one_of(LEAVES, children), max_size=5),
    max_leaves=25,
)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(TREES)
def test_hypothesis_trees_decode_as_flax_restores_them(tree):
    blob = serialization.to_bytes(tree)
    assert_same(fm.restore(blob), serialization.msgpack_restore(blob))


@pytest.mark.parametrize("size", [0, 15, 16, 17, 31, 32, 255, 256, 65535, 65536, 70000])
def test_every_length_width(size):
    """fix/8/16/32 widths of maps, arrays, str and bin, and ints at each
    width boundary."""
    tree = {"s": "x" * size, "b": b"\x01" * size,
            "m": {f"k{i}": i for i in range(min(size, 70000))},
            "ints": np.arange(3, dtype=np.int64) + size,
            "i": size, "neg": -size, "big": size * 2**33, "nbig": -size * 2**33 - 1}
    blob = serialization.msgpack_serialize(tree)
    assert_same(fm.restore(blob), serialization.msgpack_restore(blob))


def test_chunked_array_is_rebuilt(monkeypatch):
    """flax splits arrays over MAX_CHUNK_SIZE bytes into chunks; lowered
    here, so a small array takes that path (and a bf16 one)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 40)
    tree = {"a": np.arange(60, dtype=np.float32).reshape(3, 4, 5),
            "nested": {"b": np.arange(7, dtype=np.int64)},
            "bf": jnp.arange(50, dtype=jnp.bfloat16).reshape(5, 10)}
    blob = serialization.to_bytes(tree)
    assert b"__msgpack_chunked_array__" in blob
    want = serialization.msgpack_restore(blob)
    got = fm.restore(blob)
    assert_same(got, want)
    assert got["a"].shape == (3, 4, 5)


def _ext(code: int, payload: bytes) -> bytes:
    assert len(payload) < 256
    return bytes([0xc7, len(payload), code & 0xff]) + payload


def test_errors_are_clear():
    blob = serialization.to_bytes({"w": np.ones((4, 4), np.float32)})
    for cut in (1, len(blob) // 2, len(blob) - 1):
        with pytest.raises(ValueError, match="truncated"):
            fm.restore(blob[:cut])
    with pytest.raises(ValueError, match="ext 2"):
        fm.restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="unknown msgpack ext code 9"):
        fm.restore(b"\x81\xa1x" + _ext(9, b"abc"))
    with pytest.raises(ValueError, match="starts no msgpack object"):
        fm.restore(b"\xc1")
    with pytest.raises(ValueError, match="after the first object"):
        fm.restore(blob + b"\x00")
    with pytest.raises(ValueError, match="unknown msgpack ext code 9"):
        fm.restore(bytes([0xd6, 9]) + b"abcd")  # fixext 4


@pytest.mark.parametrize("head", ["ext8", "ext16", "ext32"])
def test_ndarray_ext_in_every_ext_width(head):
    """An ext-1 ndarray behind each ext head (flax's packer picks the
    narrowest; a file written by another packer may not)."""
    arr = np.arange(12, dtype=np.float64).reshape(3, 4)
    payload = serialization._ndarray_to_bytes(arr)
    n = len(payload)
    prefix = {"ext8": bytes([0xc7, n]), "ext16": bytes([0xc8]) + n.to_bytes(2, "big"),
              "ext32": bytes([0xc9]) + n.to_bytes(4, "big")}[head]
    got = fm.restore(b"\x81\xa1a" + prefix + b"\x01" + payload)
    np.testing.assert_array_equal(got["a"], arr)
    assert got["a"].dtype == np.float64


def _jax_checkpoint(tmp_path, model, data, cfg):
    """``Trainer.fit`` of the JAX package for one epoch, its last checkpoint."""
    from kgcn_tpu.data import Batcher, build_dataset
    from kgcn_tpu.models.registry import build_model
    from kgcn_tpu.runtime.train import Trainer

    cfg = dict(cfg, epoch=1, save_interval=0, save_model_path=str(tmp_path / model))
    ds, info = build_dataset(data, cfg)
    trainer = Trainer(build_model(model, info, cfg), cfg, info)
    b = Batcher(ds, info, 10)
    state = trainer.init_state(b.make_batch(np.arange(10)), seed=0)
    trainer.fit(state, b, None, log=lambda s: None)
    return str(tmp_path / model / "model.last.ckpt")


@pytest.mark.parametrize("model", ["gcn", "gat", "gin", "gcn_multimodal", "kg_distmult"])
def test_real_kgcn_tpu_checkpoints_decode_as_flax_restores_them(tmp_path, model):
    from kgcn_tpu.data.synthetic import make_ring_dataset

    cfg = {"task": "classification", "normalize_adj_flag": True, "learning_rate": 0.01}
    if model == "kg_distmult":
        from kgcn_tpu.models.kg import KGBatcher as JKG
        from kgcn_tpu.models.registry import build_model
        from kgcn_tpu.runtime import checkpoint as jckpt
        from kgcn_tpu.runtime.train import Trainer
        from test_torch_kg import _config, _jax_side, _kg300, jax_globals

        cfgk = _config(kg_encoder="gcn", embedding_dim=16)
        with jax_globals():
            jds, jinfo, _ = _jax_side(_kg300(), cfgk)
            jtr = Trainer(build_model("kg_distmult", jinfo, cfgk), cfgk, jinfo)
            jstate = jtr.init_state(JKG(jds, jinfo, seed=0).init_batch(), seed=0)
        ckpt = jckpt.save_checkpoint(str(tmp_path / "kg.ckpt"),
                                     jtr.state_tree(jstate, 0, 0.0))
    else:
        data = make_ring_dataset(num_pairs=10, num_nodes=8, seed=0)
        if model == "gcn_multimodal":
            rng = np.random.RandomState(0)
            data["sequence"] = rng.randint(0, 5, size=(20, 12)).astype(np.int32)
            data["sequence_length"] = [12] * 20
            data["sequence_symbol_num"] = np.int64(5)
        ckpt = _jax_checkpoint(tmp_path, model, data, cfg)
    with open(ckpt, "rb") as f:
        blob = f.read()
    want = serialization.msgpack_restore(blob)
    got = fm.load(ckpt)
    assert_same(got, want)
    assert {"params", "opt_state", "step", "rng", "epoch", "best_cost"} <= set(got)


def test_the_committed_fixture_decodes_as_flax_restores_it():
    path = os.path.join(FIXTURE, "model.best.ckpt")
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read())
    got = fm.load(path)
    assert_same(got, want)
    assert got["params"]["GraphConv_0"]["kernel"].shape == (1, 81, 50)
    assert int(got["step"]) > 0
