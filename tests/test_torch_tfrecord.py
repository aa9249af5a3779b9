"""The port's TFRecord reader and writer (kgcn_tpu_torch/data/tfrecord.py and
its host parser ops/csrc/tfrecord_host.cc) against the JAX package's
(kgcn_tpu/data/tfrecord.py), on the CPU:

* CRC32C's known vectors, in Python and in the host library;
* ``build_example`` and ``example_from_graph`` bytes equal to ``kgcn_tpu``'s;
* files written by either package read by the other, bit for bit;
* the host parser's arrays equal to the Python codec's record by record;
* ``load_tfrecord_dataset`` equal to ``kgcn_tpu``'s, over several files;
* a corrupted checksum, a truncated file and labels on some records only
  raise.
"""
import numpy as np
import pytest

from kgcn_tpu_torch.data import tfrecord as tf


def _ring_examples(module, n=20, seed=0, label=True, mask=True):
    from kgcn_tpu_torch.data.synthetic import make_ring_dataset

    d = make_ring_dataset(num_pairs=max(n // 2, 1), seed=seed)
    y = np.argmax(d["label"], axis=1)
    return [module.example_from_graph(d["dense_adj"][i], d["feature"][i],
                                      label=[int(y[i])] if label else None,
                                      mask_label=[1] if mask else None)
            for i in range(n)]


def _molecules(n_graphs, lo, hi, F=9, seed=0):
    """Chain-and-ring graphs of ``lo``-``hi`` nodes with sparse one-hot
    features, as (dense adjacency, features, label) triples."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_graphs):
        n = rng.randint(lo, hi + 1)
        a = np.zeros((n, n), np.float32)
        i = np.arange(n - 1)
        a[i, i + 1] = a[i + 1, i] = 1.0
        for s in rng.choice(n - 5, size=max(n // 10, 1)):
            a[s, s + 5] = a[s + 5, s] = 1.0
        f = np.zeros((n, F), np.float32)
        f[np.arange(n), rng.randint(0, F, n)] = 1.0
        out.append((a, f, [int(rng.randint(0, 50))]))
    return out


@pytest.mark.parametrize("crc", [tf.crc32c, tf.crc32c_native], ids=["python", "native"])
def test_crc32c_known_vectors(crc):
    # RFC 3720's test vector, and the check value of CRC-32C
    assert crc(b"\x00" * 32) == 0x8A9136AA
    assert crc(b"123456789") == 0xE3069283
    data = np.random.RandomState(0).bytes(4099)
    assert crc(data) == tf.crc32c(data)


@pytest.mark.parametrize("feats", [
    {"ints": np.array([1, -2, 300000, 0, 2**63 - 1, -2**63], np.int64),
     "floats": np.array([1.5, -2.25], np.float32)},
    {"big": np.random.RandomState(1).randint(-10**15, 10**15, 500),
     "bits": np.array([True, False, True]), "u": np.array([2**64 - 1, 127, 128], np.uint64)},
    {"empty_i": np.zeros(0, np.int64), "empty_f": np.zeros(0, np.float32),
     "f64": np.random.RandomState(2).randn(33)},
])
def test_build_example_bytes_equal_jax(feats):
    from kgcn_tpu.data import tfrecord as jt

    ex = tf.build_example(feats)
    assert ex == jt.build_example(feats)
    back = tf.parse_example(ex)
    for k, v in feats.items():
        want = (np.asarray(v).astype(np.int64) if np.asarray(v).dtype.kind in "iub"
                else np.asarray(v, np.float32))
        np.testing.assert_array_equal(back[k], want, err_msg=k)


@pytest.mark.parametrize("label,mask", [(True, True), (True, False), (False, False)])
def test_example_from_graph_bytes_equal_jax(label, mask):
    from kgcn_tpu.data import tfrecord as jt

    assert _ring_examples(tf, label=label, mask=mask) == _ring_examples(
        jt, label=label, mask=mask)
    # weighted adjacency and a lone node without edges
    a, f, y = _molecules(1, 30, 30, seed=3)[0]
    a[5] *= 0.5
    a[:, 7] = a[7] = 0
    assert tf.example_from_graph(a, f, y, [1]) == jt.example_from_graph(a, f, y, [1])


def test_files_read_across_packages(tmp_path):
    from kgcn_tpu.data import tfrecord as jt

    recs = _ring_examples(tf) + [b"", bytes(range(256))]
    ours, theirs = str(tmp_path / "port.tfrecords"), str(tmp_path / "jax.tfrecords")
    tf.write_tfrecord(ours, recs)
    jt.write_tfrecord(theirs, recs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert list(jt.read_tfrecord(ours, verify_crc=True)) == recs
    assert list(tf.read_tfrecord(theirs, verify_crc=True)) == recs


def test_native_arrays_equal_python_codec(tmp_path):
    path = str(tmp_path / "mol.tfrecords")
    mols = _molecules(40, 8, 60, seed=1)
    tf.write_tfrecord(path, [tf.example_from_graph(a, f, y, [1]) for a, f, y in mols])
    res = tf.parse_tfrecord_arrays(path, tf._SCHEMA_KEYS + ["adj_degrees", "absent"])
    payloads = list(tf.read_tfrecord(path, verify_crc=True))
    assert len(res["size"][1]) == len(payloads) + 1
    assert res["absent"][0].size == 0
    for i, payload in enumerate(payloads):
        ex = tf.parse_example(payload)
        for key, (vals, off) in res.items():
            if key == "absent":
                continue
            got = vals[off[i]:off[i + 1]]
            assert got.dtype == ex[key].dtype, key
            np.testing.assert_array_equal(got, ex[key], err_msg=f"record {i} {key}")


def test_dataset_equals_jax(tmp_path):
    """Two files of different graph sizes and feature widths: the port's
    Dataset and info equal ``kgcn_tpu``'s (max_node_num and the feature
    width are maxima over the files; enabled_node_nums each graph's size)."""
    from kgcn_tpu.data import tfrecord as jt

    paths, sizes = [], []
    for k, (lo, hi, F) in enumerate(((10, 40, 7), (30, 90, 11))):
        p = str(tmp_path / f"part{k}.tfrecords")
        mols = _molecules(25, lo, hi, F=F, seed=k)
        tf.write_tfrecord(p, [tf.example_from_graph(a, f, y, [1]) for a, f, y in mols])
        paths.append(p)
        sizes += [len(a) for a, _, _ in mols]
    cfg = {"normalize_adj_flag": True}
    ds, info = tf.load_tfrecord_dataset(paths, dict(cfg))
    jds, jinfo = jt.load_tfrecord_dataset(paths, dict(cfg))
    assert ds.num == jds.num == 50
    assert ds.max_node_num == jds.max_node_num == max(sizes)
    assert info.feature_dim == 11
    for name in ("features", "labels", "mask_label", "enabled_node_nums"):
        np.testing.assert_array_equal(getattr(ds, name), getattr(jds, name), err_msg=name)
    for g in range(ds.num):
        for (r, c, v), (jr, jc, jv) in zip(ds.adjs[g], jds.adjs[g]):
            np.testing.assert_array_equal(r, jr)
            np.testing.assert_array_equal(c, jc)
            np.testing.assert_allclose(v, jv, rtol=1e-6)
    for name in ("feature_dim", "graph_node_num", "graph_num", "label_dim",
                 "adj_channel_num", "edge_budget_per_graph"):
        assert getattr(info, name) == getattr(jinfo, name), name


def test_bad_files_raise(tmp_path):
    path = str(tmp_path / "x.tfrecords")
    tf.write_tfrecord(path, _ring_examples(tf, n=4))
    raw = bytearray(open(path, "rb").read())
    bad = str(tmp_path / "bad.tfrecords")
    raw[20] ^= 0xFF  # a payload byte: its checksum no longer holds
    open(bad, "wb").write(bytes(raw))
    with pytest.raises(ValueError, match="code -4"):
        tf.load_tfrecord_dataset(bad)
    with pytest.raises(ValueError, match="CRC mismatch"):
        list(tf.read_tfrecord(bad, verify_crc=True))
    short = str(tmp_path / "short.tfrecords")
    open(short, "wb").write(open(path, "rb").read()[:-3])
    with pytest.raises(ValueError, match="code -2"):
        tf.parse_tfrecord_arrays(short, tf._SCHEMA_KEYS)
    mixed = str(tmp_path / "mixed.tfrecords")
    tf.write_tfrecord(mixed, _ring_examples(tf, n=2) + _ring_examples(tf, n=2, label=False))
    with pytest.raises(ValueError, match="mixed labeled/unlabeled"):
        tf.load_tfrecord_dataset(mixed)
    some_masks = str(tmp_path / "masks.tfrecords")
    tf.write_tfrecord(some_masks, _ring_examples(tf, n=2) + _ring_examples(tf, n=2, mask=False))
    with pytest.raises(ValueError, match="mask_label present on only some"):
        tf.load_tfrecord_dataset(some_masks)
    empty = str(tmp_path / "empty.tfrecords")
    open(empty, "wb").close()
    with pytest.raises(ValueError, match="no records"):
        tf.load_tfrecord_dataset(empty)
