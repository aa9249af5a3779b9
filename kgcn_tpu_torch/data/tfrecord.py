"""TFRecord files and the ``tf.train.Example`` codec, without TensorFlow —
the port's copy of ``kgcn_tpu/data/tfrecord.py``.

Reads and writes the reference's molecular TFRecord schema
(kgcn/preprocessing/utils.py:178-226, task_sparse_gcn.py:153-166):
``adj_row/adj_column/adj_values/adj_elem_len/adj_degrees``,
``feature_row/feature_column/feature_values/feature_elem_len``,
``label/mask_label/size``.

TFRecord framing: {uint64 length, uint32 masked_crc32c(length), payload,
uint32 masked_crc32c(payload)}.  Example protos use three wire shapes
(varint, packed repeated, length-delimited).

Two readers of one format:

* the Python codec (``read_tfrecord``, ``parse_example``): the plain
  version, which the tests hold the other against;
* the host library ``ops/csrc/tfrecord_host.cc`` (the port's copy of
  ``kgcn_tpu/native/tfrecord.cpp``: framing, CRC32C, the Example walk in
  parallel over records), behind ``parse_tfrecord_arrays``.
  ``load_tfrecord_dataset`` reads through it; the library is built at first
  use and required, with no fallback to the Python codec.

The writer (``build_example``, ``example_from_graph``, ``write_tfrecord``)
gives ``kgcn_tpu``'s bytes: the varints of a feature are encoded in NumPy,
all at once, and the framing's checksums come from the host library.
"""
from __future__ import annotations

import ctypes
import struct
from typing import Dict, Iterator, List, Union

import numpy as np

from kgcn_tpu_torch.data.dataset import build_dataset
from kgcn_tpu_torch.ops import _build

# ---------------------------------------------------------------- crc32c ---
_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    """CRC32C of ``data``, byte by byte in Python (the plain version of the
    host library's ``kgcn_crc32c``)."""
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _host():
    """The host library ``ops/csrc/tfrecord_host.cc``, built at first use."""
    lib = _build.load("tfrecord_host")
    if lib.kgcn_crc32c.argtypes is None:
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.kgcn_crc32c.argtypes = [ptr, i64]
        lib.kgcn_crc32c.restype = ctypes.c_uint32
        lib.kgcn_tfrecord_num_records.argtypes = [ptr, i64, ctypes.c_int]
        lib.kgcn_tfrecord_num_records.restype = i64
        lib.kgcn_tfrecord_count.argtypes = [ptr, i64, ctypes.c_int, ctypes.c_char_p,
                                            ptr, i32, ptr, ptr]
        lib.kgcn_tfrecord_count.restype = i64
        lib.kgcn_tfrecord_extract.argtypes = [ptr, i64, ctypes.c_char_p, ptr, i32,
                                              ptr, ptr, ptr]
        lib.kgcn_tfrecord_extract.restype = i64
    return lib


def crc32c_native(data: bytes) -> int:
    """CRC32C of ``data`` by the host library."""
    buf = np.frombuffer(data, np.uint8)
    return int(_host().kgcn_crc32c(buf.ctypes.data, buf.size))


def _mask(crc: int) -> int:
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- tfrecord ----
def read_tfrecord(path: str, verify_crc: bool = False) -> Iterator[bytes]:
    """The records of a TFRecord file, in Python; ``verify_crc`` checks each
    payload's checksum (plain ``crc32c``) and raises on a mismatch."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,) = struct.unpack("<Q", header[:8])
            payload = f.read(length)
            crc = f.read(4)
            if verify_crc and _mask(crc32c(payload)) != struct.unpack("<I", crc)[0]:
                raise ValueError(f"payload CRC mismatch in {path}")
            yield payload


def write_tfrecord(path: str, records) -> None:
    """Write records with TFRecord framing (checksums by the host library)."""
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", _mask(crc32c_native(length))))
            f.write(rec)
            f.write(struct.pack("<I", _mask(crc32c_native(rec))))


# -------------------------------------------------------- protobuf wire ----
def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


_SHIFTS = np.arange(10, dtype=np.uint64) * np.uint64(7)


def _varints(u: np.ndarray) -> bytes:
    """Base-128 varints of uint64 values, concatenated (``_write_varint`` of
    each, in NumPy): a value takes one byte per nonzero remainder ``u >>
    7k``, at least one, the high bit set on all but its last."""
    u = np.asarray(u, np.uint64).reshape(-1, 1)
    rest = u >> _SHIFTS
    nbytes = np.maximum((rest != 0).sum(axis=1), 1)[:, None]
    k = np.arange(10)[None, :]
    out = (rest & np.uint64(0x7F)).astype(np.uint8) | ((k < nbytes - 1).astype(np.uint8) << 7)
    return out[k < nbytes].tobytes()


def _fields(buf: bytes):
    """Iterate (field_number, wire_type, value) over one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            length, pos = _read_varint(buf, pos)
            val = buf[pos: pos + length]
            pos += length
        elif wire == 5:  # 32-bit
            val = buf[pos: pos + 4]
            pos += 4
        elif wire == 1:  # 64-bit
            val = buf[pos: pos + 8]
            pos += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


FeatureValue = Union[np.ndarray, bytes, List[bytes]]


def parse_example(payload: bytes) -> Dict[str, FeatureValue]:
    """tf.train.Example → {name: np.ndarray (int64/float32) or list[bytes]}."""
    out: Dict[str, FeatureValue] = {}
    for field, _, features_buf in _fields(payload):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _fields(features_buf):
            if f2 != 1:  # Features.feature (map entry)
                continue
            key = None
            value_buf = None
            for f3, _, v in _fields(entry):
                if f3 == 1:
                    key = v.decode()
                elif f3 == 2:
                    value_buf = v
            if key is None or value_buf is None:
                continue
            out[key] = _parse_feature(value_buf)
    return out


def _signed(x: int) -> int:
    return x - (1 << 64) if x >= 1 << 63 else x


def _parse_feature(buf: bytes):
    for field, _, lst in _fields(buf):
        if field == 1:  # BytesList
            return [v for f, _, v in _fields(lst) if f == 1]
        if field == 2:  # FloatList
            vals: List[float] = []
            for f, wire, v in _fields(lst):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    vals.extend(struct.unpack(f"<{len(v) // 4}f", v))
                else:
                    vals.append(struct.unpack("<f", v)[0])
            return np.asarray(vals, np.float32)
        if field == 3:  # Int64List
            ints: List[int] = []
            for f, wire, v in _fields(lst):
                if f != 1:
                    continue
                if wire == 2:  # packed varints
                    pos = 0
                    while pos < len(v):
                        x, pos = _read_varint(v, pos)
                        ints.append(_signed(x))
                else:
                    ints.append(_signed(v))
            return np.asarray(ints, np.int64)
    return np.asarray([], np.float32)


def _encode_field(field: int, wire: int, payload: bytes) -> bytes:
    return _write_varint(field << 3 | wire) + (
        _write_varint(len(payload)) + payload if wire == 2 else payload
    )


def _encode_feature(values) -> bytes:
    arr = np.asarray(values)
    if arr.dtype.kind in "iub":
        # two's complement of the signed values, as int(v) & (2^64 - 1)
        u = (arr.ravel().astype(np.uint64) if arr.dtype.kind == "u"
             else arr.ravel().astype(np.int64).view(np.uint64))
        lst = _encode_field(1, 2, _varints(u))
        return _encode_field(3, 2, lst)  # Int64List
    packed = arr.ravel().astype("<f4").tobytes()
    lst = _encode_field(1, 2, packed)
    return _encode_field(2, 2, lst)  # FloatList


def build_example(features: Dict[str, np.ndarray]) -> bytes:
    entries = b""
    for key, values in features.items():
        entry = _encode_field(1, 2, key.encode()) + _encode_field(
            2, 2, _encode_feature(values)
        )
        entries += _encode_field(1, 2, entry)
    return _encode_field(1, 2, entries)  # Example.features


# --------------------------------------------------- reference schema ------
def example_from_graph(adj_dense: np.ndarray, feature: np.ndarray,
                       label=None, mask_label=None) -> bytes:
    """Serialise one molecule exactly like the reference's
    ``convert_to_example`` (kgcn/preprocessing/utils.py:178-214)."""
    adj = np.asarray(adj_dense)
    row, col = np.nonzero(adj)
    degrees = adj.sum(axis=0)
    adj_degrees = np.where(row == col, 0, degrees[row]).astype(np.int64)
    feature = np.asarray(feature)
    frow, fcol = np.nonzero(feature)
    feats = {
        "adj_row": row.astype(np.int64),
        "adj_column": col.astype(np.int64),
        "adj_values": adj[row, col].astype(np.float32),
        "adj_elem_len": np.asarray([len(row)], np.int64),
        "adj_degrees": adj_degrees,
        "feature_row": frow.astype(np.int64),
        "feature_column": fcol.astype(np.int64),
        "feature_values": feature[frow, fcol].astype(np.float32),
        "feature_elem_len": np.asarray([len(frow)], np.int64),
        "size": np.asarray(feature.shape, np.int64),
    }
    if label is not None:
        feats["label"] = np.nan_to_num(np.asarray(label)).astype(np.int64)
        if mask_label is not None:
            feats["mask_label"] = np.asarray(mask_label).astype(np.int64)
    return build_example(feats)


_SCHEMA_KEYS = [
    "adj_row", "adj_column", "adj_values", "feature_row", "feature_column",
    "feature_values", "size", "label", "mask_label",
]


def parse_tfrecord_arrays(path: str, keys, verify_crc: bool = True):
    """Parse every record of a TFRecord file with the host library.

    Returns ``{key: (values, offsets)}``: ``values`` one flat float32 or
    int64 array over ALL records, ``offsets`` ``[n_records + 1]`` prefix
    sums (record ``i``'s values are ``values[offsets[i]:offsets[i+1]]``).
    Keys absent from the file map to empty arrays.  A malformed file or a
    checksum mismatch raises ``ValueError``."""
    lib = _host()
    with open(path, "rb") as f:
        buf = np.frombuffer(f.read(), np.uint8)
    keys = list(keys)
    if buf.size == 0:
        return {k: (np.empty(0, np.float32), np.zeros(1, np.int64)) for k in keys}
    key_blob = "".join(keys).encode()
    key_lens = np.asarray([len(k.encode()) for k in keys], np.int32)
    nk = len(keys)
    key_types = np.zeros(nk, np.int32)
    n = lib.kgcn_tfrecord_num_records(buf.ctypes.data, buf.size, 1 if verify_crc else 0)
    if n < 0:
        raise ValueError(f"malformed TFRecord file {path} (code {n})")
    counts = np.zeros((n, nk), np.int64)
    rc = lib.kgcn_tfrecord_count(buf.ctypes.data, buf.size, 0, key_blob,
                                 key_lens.ctypes.data, nk, key_types.ctypes.data,
                                 counts.ctypes.data)
    if rc < 0:
        raise ValueError(f"malformed Example proto in {path} (code {rc})")
    offsets = np.zeros((nk, n + 1), np.int64)
    np.cumsum(counts.T, axis=1, out=offsets[:, 1:])
    out_arrays = [np.empty(int(offsets[k, -1]), np.int64 if key_types[k] == 3 else np.float32)
                  for k in range(nk)]
    ptrs = (ctypes.c_void_p * nk)(*[a.ctypes.data for a in out_arrays])
    rc = lib.kgcn_tfrecord_extract(buf.ctypes.data, buf.size, key_blob, key_lens.ctypes.data,
                                   nk, key_types.ctypes.data, offsets.ctypes.data, ptrs)
    if rc < 0:
        raise ValueError(f"malformed Example proto in {path} (code {rc})")
    return {keys[k]: (out_arrays[k], offsets[k]) for k in range(nk)}


def _collect_examples_native(res, adjs, feats, labels, masks, sizes):
    """Per-record views of the host parser's flat arrays."""
    size_vals, size_off = res["size"]
    G = len(size_off) - 1
    if G == 0:  # an empty file: (0, 0), as the Python codec gives
        return 0, 0
    dims = size_vals.reshape(G, 2)
    rows, r_off = res["adj_row"]
    cols, _ = res["adj_column"]
    vals, _ = res["adj_values"]
    frow, f_off = res["feature_row"]
    fcol, _ = res["feature_column"]
    fval, _ = res["feature_values"]
    lab, l_off = res["label"]
    mk, m_off = res["mask_label"]
    for i in range(G):
        n, fdim = int(dims[i, 0]), int(dims[i, 1])
        a0, a1 = int(r_off[i]), int(r_off[i + 1])
        indices = np.empty((a1 - a0, 2), np.int32)
        indices[:, 0] = rows[a0:a1]
        indices[:, 1] = cols[a0:a1]
        adjs.append((indices, vals[a0:a1], (n, n)))
        f0, f1 = int(f_off[i]), int(f_off[i + 1])
        feats.append((frow[f0:f1], fcol[f0:f1], fval[f0:f1], n, fdim))
        labels.append(lab[l_off[i]:l_off[i + 1]] if lab.size else None)
        masks.append(mk[m_off[i]:m_off[i + 1]] if mk.size else None)
        sizes.append(n)
    return int(dims[:, 0].max()), int(dims[:, 1].max())


def load_tfrecord_dataset(paths, config=None):
    """Reference-schema TFRecord files → the port's (Dataset, DatasetInfo),
    through the host parser.  ``max_node_num`` and the feature width are
    maxima over all files; ``enabled_node_nums`` holds each graph's
    ``size``.  ``label`` (and ``mask_label``) must be on all records or
    none."""
    if isinstance(paths, str):
        paths = [paths]
    adjs, feats, labels, masks, sizes = [], [], [], [], []
    max_n = feat_dim = 0
    for path in paths:
        mn, fd = _collect_examples_native(parse_tfrecord_arrays(path, _SCHEMA_KEYS),
                                          adjs, feats, labels, masks, sizes)
        max_n, feat_dim = max(max_n, mn), max(feat_dim, fd)
    G = len(adjs)
    if G == 0:
        raise ValueError(f"no records found in {paths}")
    features = np.zeros((G, max_n, feat_dim), np.float32)
    row_g = np.concatenate([np.full(len(f[0]), i, np.int64) for i, f in enumerate(feats)])
    features[row_g, np.concatenate([f[0] for f in feats]),
             np.concatenate([f[1] for f in feats])] = np.concatenate([f[2] for f in feats])
    data = {"adj": adjs, "feature": features, "max_node_num": np.int64(max_n)}
    # labels on ALL records or none: gating on the first record alone would
    # drop labels silently (or fail to stack a mix)
    n_lab = sum(1 for x in labels if x is not None and len(x))
    if n_lab:
        if n_lab != len(labels):
            raise ValueError(
                f"{n_lab}/{len(labels)} records carry a 'label' feature — "
                "mixed labeled/unlabeled TFRecords are not joinable"
            )
        data["label"] = np.stack(labels)
        n_msk = sum(1 for m in masks if m is not None and len(m))
        if n_msk == len(masks):
            data["mask_label"] = np.stack(masks)
        elif n_msk:
            raise ValueError("mask_label present on only some records")
    ds, info = build_dataset(data, config or {})
    ds.enabled_node_nums = np.asarray(sizes, np.int32)
    return ds, info
