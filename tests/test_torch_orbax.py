"""The port's reader of kgcn_tpu's orbax checkpoints (kgcn_tpu_torch/
runtime/orbax.py, its zstd decoder ops/csrc/zstd_host.cc) and the
big-graph restore from one (parallel/big_graph.py), on the CPU.

Each checkpoint is written here by ``kgcn_tpu`` (orbax and tensorstore are
installed in this environment, not in the port's) and read by the port
without them; every read is bitwise equal to what ``kgcn_tpu``'s
``load_checkpoint`` or ``BigGraphKGTrainer.restore`` (``load_sharded``)
gives.  The big-graph checkpoint is written over 4 virtual devices and
restored in the port at world 1 (here) and 2 and 4 (gloo ranks,
tests/torch_parallel_worker.py)."""
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from kgcn_tpu_torch.parallel.big_graph import EMBED
from kgcn_tpu_torch.runtime import orbax
from torch_parallel_worker import launch_scenarios

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "jax_orbax_big_graph")
KG = dict(num_entities=512, num_relations=2, seed=0)
DIM = 32
WRITER_D = 4
WORLDS = (2, 4)


def _np_tree(tree):
    """A restored pytree as nested dicts of NumPy arrays keyed like the
    port's raw tree (a tuple's items by ``"0"``, ``"1"``, …)."""
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", getattr(k, "name", k))))
                for k in path]
        node = out
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(v)
    return out


def _assert_same(got, want, where=""):
    """Every array leaf of ``want`` in ``got``, bitwise and of the same
    dtype (bfloat16 leaves: the port's tensor against JAX's array)."""
    for k, w in want.items():
        if isinstance(w, dict):
            _assert_same(got[k], w, f"{where}{k}.")
            continue
        g = got[k]
        if isinstance(g, torch.Tensor):
            g = g.view(torch.uint16).numpy()
            w = np.asarray(w).view(np.uint16)
        assert g.dtype == w.dtype and g.shape == w.shape, where + k
        assert np.array_equal(g, w), where + k


# ---- a Trainer's state tree -------------------------------------------------------
@pytest.fixture(scope="module")
def state_ckpt(tmp_path_factory):
    """kgcn_tpu's Trainer (gcn on ring graphs, Adam, one step): its state
    tree written as orbax and as msgpack."""
    from kgcn_tpu.data import Batcher, build_dataset
    from kgcn_tpu.data.synthetic import make_ring_dataset
    from kgcn_tpu.models.registry import build_model
    from kgcn_tpu.runtime import checkpoint as jckpt
    from kgcn_tpu.runtime.config import default_config
    from kgcn_tpu.runtime.train import Trainer

    d = tmp_path_factory.mktemp("state")
    cfg = default_config()
    cfg.update({"task": "classification", "save_interval": 0, "model.py": "gcn"})
    data = make_ring_dataset(num_pairs=10, seed=0)
    ds, info = build_dataset(data, cfg)
    tr = Trainer(build_model("gcn", info, cfg), cfg, info)
    b = Batcher(ds, info, 8, seed=0)
    state = tr.init_state(b.make_batch(np.arange(8)), seed=0)
    state, _, _ = tr.train_step(state, b.make_batch(np.arange(8)))
    tree = tr.state_tree(state, 3, 0.25)
    jckpt.save_checkpoint(str(d / "state.orbax"), tree, fmt="orbax")
    jckpt.save_checkpoint(str(d / "state.msgpack"), tree)
    return d, cfg, data


def test_state_tree_reads_as_kgcn_tpu_loads_it(state_ckpt):
    """The raw tree (``orbax.load_tree``) against ``kgcn_tpu``'s
    ``load_checkpoint`` of the same directory, leaf by leaf."""
    from kgcn_tpu.runtime.checkpoint import load_checkpoint

    d, _, _ = state_ckpt
    got = orbax.load_tree(str(d / "state.orbax"))
    want = _np_tree(load_checkpoint(str(d / "state.orbax")))
    _assert_same(got, want)
    assert got["opt_state"]["1"] is None  # optax's EmptyState: no data


def test_orbax_state_equals_the_msgpack_route(state_ckpt):
    """``load_checkpoint`` of the orbax directory gives the port's tree of
    the msgpack file of the same state, parameters and optimizer state
    (converted for the port's model and optimizer)."""
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.checkpoint import load_checkpoint
    from kgcn_tpu_torch.runtime.optim import make_optimizer

    d, cfg, data = state_ckpt
    _, info = build_dataset(data, cfg)
    model, tx = build_model("gcn", info, cfg), make_optimizer(cfg)
    a = load_checkpoint(str(d / "state.orbax"), model, tx)
    b = load_checkpoint(str(d / "state.msgpack"), model, tx)
    assert set(a) == set(b) == {"params", "batch_stats", "opt_state", "step", "rng",
                                "epoch", "best_cost"}

    def same(x, y, where):
        if isinstance(y, dict):
            assert set(x) == set(y), where
            for k in y:
                same(x[k], y[k], f"{where}.{k}")
        else:
            assert torch.equal(x, y) and x.dtype == y.dtype, where
    same(a, b, "tree")
    assert int(a["epoch"]) == 3 and float(a["best_cost"]) == 0.25


def test_trainer_restores_an_orbax_state(state_ckpt):
    """``Trainer.restore`` takes the orbax directory and resumes after its
    epoch."""
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.models.registry import build_model
    from kgcn_tpu_torch.runtime.train import Trainer

    d, cfg, data = state_ckpt
    _, info = build_dataset(data, cfg)
    state = Trainer(build_model("gcn", info, cfg), cfg, info, device="cpu").restore(
        str(d / "state.orbax"))
    assert state.epoch == 4 and state.step == 1


def test_bfloat16_and_empty_leaves(tmp_path):
    """A bfloat16 leaf comes back as a ``torch.bfloat16`` tensor (as the
    msgpack reader gives it), None and empty dicts as themselves, int
    arrays and scalars with their dtype."""
    import jax.numpy as jnp

    from kgcn_tpu.runtime.checkpoint import save_checkpoint

    tree = {"params": {"w": jnp.arange(300, dtype=jnp.bfloat16).reshape(3, 100) / 7},
            "n": None, "e": {}, "i": np.arange(7, dtype=np.int64),
            "s": np.float32(2.5), "u": np.arange(4, dtype=np.uint32)}
    save_checkpoint(str(tmp_path / "bf"), tree, fmt="orbax")
    got = orbax.load_tree(str(tmp_path / "bf"))
    assert got["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["params"]["w"], torch.from_numpy(
        np.asarray(tree["params"]["w"]).view(np.uint16).copy()).view(torch.bfloat16))
    assert got["n"] is None and got["e"] == {}
    _assert_same(got, {"i": tree["i"], "s": np.asarray(tree["s"]), "u": tree["u"]})


# ---- zstd ---------------------------------------------------------------------------
@pytest.mark.parametrize("level", [1, 3, 19])
def test_zstd_chunks_that_tensorstore_writes(tmp_path, level):
    """An array written by tensorstore (zarr v2 over OCDBT) with zstd at
    ``level`` (2 MB chunks of a smooth signal plus noise, the last chunk
    cut by the array's edge) reads back bitwise through the port's
    decoder, by rows."""
    import tensorstore as ts

    rng = np.random.default_rng(level)
    shape, chunks = (1200, 1024), (512, 1024)
    data = (np.sin(np.arange(shape[0] * shape[1]) / 50.0).reshape(shape)
            + 0.01 * rng.standard_normal(shape)).astype(np.float32)
    data[:, :300] = np.round(data[:, :300], 2)
    arr = ts.open({"driver": "zarr",
                   "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/", "path": "a/"},
                   "metadata": {"compressor": {"id": "zstd", "level": level},
                                "dtype": "<f4", "shape": list(shape), "chunks": list(chunks)},
                   "create": True}).result()
    arr.write(data).result()
    store = orbax.OcdbtStore(str(tmp_path))
    z = orbax.ZarrArray(store, "a")
    assert np.array_equal(z.read(), data)
    assert np.array_equal(z.read((500, 1100)), data[500:1100])
    sizes = [len(store.get(f"a/{i}.0")) for i in range(3)]
    assert max(sizes) < chunks[0] * chunks[1] * 4  # the chunks are compressed


@pytest.mark.parametrize("level,checksum", [(1, False), (3, True), (19, True), (-5, True)])
def test_zstd_frames_of_the_reference_library(level, checksum):
    """Frames of the zstd library (the ``zstandard`` binding) at several
    levels, with and without the content checksum and the content size,
    several frames in one buffer: the port's decoder gives their content."""
    import zstandard

    rng = np.random.default_rng(0)
    parts = [rng.integers(0, 7, 200_000).astype(np.int32).tobytes(),
             np.sort(rng.standard_normal(50_000)).astype(np.float32).tobytes(),
             b"kgcn " * 30_000, b"", bytes(rng.integers(0, 256, 5000, dtype=np.uint8))]
    for with_size in (True, False):
        c = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                     write_content_size=with_size)
        for p in parts:
            assert orbax.zstd_decompress(c.compress(p)) == p
        assert orbax.zstd_decompress(b"".join(c.compress(p) for p in parts)) == b"".join(parts)


def test_corrupt_frames_and_checksums_raise(state_ckpt, tmp_path):
    """A corrupt zstd frame, a content checksum that does not match and an
    OCDBT node whose crc32c does not match raise ValueError."""
    import zstandard

    data = np.arange(100_000, dtype=np.float32).tobytes()
    frame = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data))
    bad = bytearray(frame)
    bad[len(bad) // 2] ^= 0x5A
    with pytest.raises(ValueError, match="zstd"):
        orbax.zstd_decompress(bytes(bad))
    bad = bytearray(frame)
    bad[-1] ^= 1
    with pytest.raises(ValueError, match="checksum"):
        orbax.zstd_decompress(bytes(bad))
    with pytest.raises(ValueError, match="bad magic"):
        orbax.zstd_decompress(b"\x00" * 16, 16)
    d, _, _ = state_ckpt
    copy = tmp_path / "state.orbax"
    shutil.copytree(d / "state.orbax", copy)
    node = next(p for p in (copy / "d").iterdir())
    raw = bytearray(node.read_bytes())
    raw[-1] ^= 0xFF
    node.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        orbax.load_tree(str(copy))
    manifest = copy / "manifest.ocdbt"
    raw = bytearray(manifest.read_bytes())
    raw[20] ^= 0x01
    manifest.write_bytes(bytes(raw))
    with pytest.raises(ValueError, match="crc32c"):
        orbax.load_tree(str(copy))


def test_inner_btree_nodes(tmp_path):
    """An OCDBT store deep enough for inner nodes (tensorstore at a small
    node limit) and values out of line: every key and value found."""
    import tensorstore as ts

    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    txn = ts.Transaction()
    want = {f"k{i:04d}/x".encode(): (b"v%d" % i) * (1 + i % 9) for i in range(300)}
    for k, v in want.items():
        kv.with_transaction(txn).write(k, v).result()
    txn.commit_async().result()
    store = orbax.OcdbtStore(str(tmp_path))
    assert set(store.index) == set(want)
    for k, v in want.items():
        assert store.get(k.decode()) == v


# ---- the big-graph checkpoint -------------------------------------------------------
def _kg_dataset():
    from kgcn_tpu_torch.data.synthetic import make_kg_dataset

    return make_kg_dataset(**KG)


def _trainer_kwargs(num_nodes):
    return dict(num_nodes=num_nodes, channels=KG["num_relations"], embedding_dim=DIM,
                encoder="gcn", learning_rate=0.05)


KG_CFG = {"task": "link_prediction", "with_feature": False, "with_node_embedding": True,
          "embedding_dim": DIM, "kg_encoder": "gcn", "learning_rate": 0.05, "seed": 0}


@pytest.fixture(scope="module")
def big_graph(tmp_path_factory):
    """kgcn_tpu's BigGraphKGTrainer over 4 virtual devices (its CLI's
    route, ``from_kg_dataset``): 3 steps, then ``save`` (orbax, sharded);
    and what its ``restore`` gives back."""
    from kgcn_tpu.data import build_dataset
    from kgcn_tpu.parallel.big_graph import from_kg_dataset
    from kgcn_tpu.parallel.mesh import make_mesh

    d = tmp_path_factory.mktemp("bg")
    ds, info = build_dataset(_kg_dataset(), dict(KG_CFG))
    bg = from_kg_dataset(ds, info, dict(KG_CFG), make_mesh({"data": WRITER_D}))
    state, _ = bg.fit(bg.init_state(seed=0), np.asarray(ds.label_list[0], np.int32),
                      epochs=3, seed=0)
    path = str(d / "model.big_graph.ckpt")
    bg.save(path, state)
    restored = _np_tree(jax.device_get(bg.restore(path, bg.init_state(seed=1))))
    return path, int(info.all_node_num), restored


@pytest.fixture(scope="module")
def bg_runs(big_graph, tmp_path_factory):
    path, V, _ = big_graph
    out = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"bgorbax{world}")
        out[world] = launch_scenarios(d, world, {"bgorbax": {
            "path": path, "trainer": _trainer_kwargs(V)}})["bgorbax"]
    return out


def _port_names(i):
    return {"embed": EMBED, "theta.distmult": "distmult.kernel",
            "theta.w0": "conv1.kernel", "theta.b0": "conv1.bias",
            "theta.w1": "conv2.kernel", "theta.b1": "conv2.bias"}[i]


def _check_rows(got_params, want, V, world, rank):
    """One rank's restored state against kgcn_tpu's: its rows of the first
    V (zero past V), the replicated leaves whole, the Adam moments alike."""
    v_loc = -(-V // world)
    lo, hi = rank * v_loc, min((rank + 1) * v_loc, V)

    def rows(table):
        out = np.zeros((v_loc, DIM), np.float32)
        out[:max(hi - lo, 0)] = table[lo:hi]
        return out

    flat = {"embed": want["embed"], **{f"theta.{k}": v for k, v in want["theta"].items()}}
    for j, w in flat.items():
        w = rows(w) if j == "embed" else w
        assert np.array_equal(np.asarray(got_params[_port_names(j)]), w), j


def test_big_graph_restores_at_world_one(big_graph):
    """The port's trainer at world 1 restores the D-4 checkpoint: the
    table, theta, both Adam moments and the step, bitwise."""
    from kgcn_tpu_torch.parallel.big_graph import BigGraphKGTrainer

    path, V, want = big_graph
    bg = BigGraphKGTrainer(device="cpu", **_trainer_kwargs(V))
    state = bg.restore(path, bg.init_state(0))
    _check_rows(state["params"], want["params"], V, 1, 0)
    adam = state["opt_state"]["0"]["0"]
    for m in ("mu", "nu"):
        _check_rows(adam[m], want["opt_state"]["0"][m], V, 1, 0)
    assert int(adam["count"]) == int(want["opt_state"]["0"]["count"])
    assert state["step"] == int(np.asarray(want["step"]).reshape(-1)[0]) == 3


@pytest.mark.parametrize("world", WORLDS)
def test_big_graph_restores_at_other_worlds(big_graph, bg_runs, world):
    """At world 2 and 4 (gloo ranks) each rank gets its rows; together the
    ranks hold the whole table and moments, and each read fewer bytes than
    the whole checkpoint holds at world 4."""
    path, V, want = big_graph
    for rank, r in enumerate(bg_runs[world]):
        _check_rows(r["params"], want["params"], V, world, rank)
        adam = r["opt_state"]["0"]["0"]
        for m in ("mu", "nu"):
            _check_rows(adam[m], want["opt_state"]["0"][m], V, world, rank)
        assert r["step"] == 3
    total = sum(os.path.getsize(os.path.join(dp, n)) for dp, _, ns in os.walk(path)
                for n in ns)
    if world == 4:
        assert all(r["bytes_read"] < total for r in bg_runs[world])


def test_big_graph_restore_refuses_another_model(big_graph):
    """A trainer whose encoder does not fit the checkpoint's theta raises."""
    from kgcn_tpu_torch.parallel.big_graph import BigGraphKGTrainer

    path, V, _ = big_graph
    bg = BigGraphKGTrainer(device="cpu", **dict(_trainer_kwargs(V), encoder="gin"))
    with pytest.raises(ValueError, match="do not fit a gin trainer"):
        bg.restore(path, bg.init_state(0))


def test_committed_fixture_is_what_kgcn_tpu_loads():
    """tests/fixtures/jax_orbax_big_graph: its ``.npy`` arrays are what
    ``kgcn_tpu``'s ``load_checkpoint`` reads from its orbax directory, and
    the port's reader gives the same, bitwise (chip_smoke.py's phase 20
    restores this checkpoint on the card without JAX)."""
    from kgcn_tpu.runtime.checkpoint import load_checkpoint

    path = os.path.join(FIXTURE, "model.big_graph.ckpt")
    want = _np_tree(load_checkpoint(path))
    arrays = os.path.join(FIXTURE, "arrays")
    names = sorted(n[:-4] for n in os.listdir(arrays))
    flat = {}

    def walk(t, pre=""):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{pre}{k}.")
            else:
                flat[pre + k] = v
    walk(want)
    assert names == sorted(flat)
    for n in names:
        a = np.load(os.path.join(arrays, f"{n}.npy"))
        assert a.dtype == flat[n].dtype and np.array_equal(a, flat[n]), n
    _assert_same(orbax.load_tree(path), want)
    with open(os.path.join(FIXTURE, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["kg"] == KG and cfg["embedding_dim"] == DIM
    assert flat["params.embed"].shape == (KG["num_entities"], DIM)
    assert sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FIXTURE)
               for n in ns) < 1 << 20
