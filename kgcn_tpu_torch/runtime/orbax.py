"""A reader for the orbax checkpoints of ``kgcn_tpu``, without orbax or
tensorstore.

``kgcn_tpu`` writes an orbax directory with ``save_checkpoint(fmt="orbax")``
and ``save_sharded`` (``kgcn_tpu/runtime/checkpoint.py``), and its
big-graph KG trainer writes every sharded run's ``model.big_graph.ckpt``
that way.  Such a directory holds:

* ``_METADATA``: JSON, the tree's key paths (``tree_metadata``: each leaf's
  keys, ``key_type`` 1 for a sequence index, 2 for a dict key, and its
  ``value_type``; ``"None"``, ``"Dict"`` and ``"List"`` leaves hold no
  data);
* a key-value store, tensorstore's OCDBT (``manifest.ocdbt`` at the root,
  the B+tree nodes and the out-of-line values in data files under ``d/``
  and ``ocdbt.process_<i>/d/``);
* in that store, one zarr v2 array a leaf: ``<path>/.zarray`` (JSON:
  ``shape``, ``chunks``, ``dtype``, ``compressor``) and a chunk a key
  (``<path>/i.j``), each chunk zstd-compressed.

The walk follows tensorstore's documented OCDBT format.  A manifest and a
node are ``magic (u32 big-endian), length (u64), version, compression``
(varints), a body (zstd-compressed where compression is 1) and a crc32c
(u32) of all the bytes before it, checked.  The manifest's body: the
config (uuid, manifest kind, inline-value limit, node-size limit, version
tree arity, compression), the table of data files, then the versions,
column by column (generation, root height, the root node's file, offset
and length, key count, tree bytes, out-of-line value bytes, commit time);
the last version is read.  A node's body: its height, its table of data
files and its entries, column by column; keys are stored as the length
shared with the previous key and the rest.  A leaf's entries carry their
values inline or as (file, offset) references with their lengths; an
inner node's entries point to children, whose keys drop the prefix that
the entry's ``subtree_common_prefix_length`` names.

The zstd frames (nodes, chunks) go through the port's own decoder,
``ops/csrc/zstd_host.cc`` (built with the host compiler at first use, as
the other host libraries; there is no fallback), the crc32c through
``ops/csrc/tfrecord_host.cc``'s.  A corrupt frame, a checksum that does not
match and a store that is not what this reader knows raise
``ValueError``.

``load_tree(path)`` gives the raw nested tree that ``runtime/flax_msgpack``
gives for the same state (dicts keyed by strings, a tuple's items by
``"0"``, ``"1"``, …; NumPy arrays, ``torch.bfloat16`` tensors for bfloat16
leaves), so ``convert.tree_from_jax`` takes either.
``Checkpoint(path).array(name).read(rows)`` reads rows ``[start, stop)``
of one leaf and touches only the chunks that hold them (the big-graph
restore, ``parallel/big_graph.py``).
Nothing here writes orbax."""
from __future__ import annotations

import ctypes
import json
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
METADATA = "_METADATA"
# the bytes a reader took from the store's files (value and node reads)
bytes_read = 0


# ---- zstd ---------------------------------------------------------------------
def _zstd():
    from kgcn_tpu_torch.ops import _build

    lib = _build.load("zstd_host")
    if lib.kgcn_zstd_decompress.argtypes is None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.kgcn_zstd_content_size.argtypes = [ctypes.c_char_p, i64]
        lib.kgcn_zstd_content_size.restype = i64
        lib.kgcn_zstd_decompress.argtypes = [ctypes.c_char_p, i64, ptr, i64,
                                             ctypes.c_char_p, i64]
        lib.kgcn_zstd_decompress.restype = i64
    return lib


def zstd_decompress(data: bytes, size: Optional[int] = None) -> bytes:
    """The content of the zstd frames in ``data`` (RFC 8878, no
    dictionaries), by the port's C++ decoder.  ``size``: the content's
    length when the caller knows it; else the frames' stated sizes, or a
    buffer that grows.  Raises ValueError for a corrupt frame."""
    lib = _zstd()
    data = bytes(data)
    if size is None:
        stated = lib.kgcn_zstd_content_size(data, len(data))
        if stated == -2:
            raise ValueError("zstd: not a well-formed frame header")
        size = stated if stated >= 0 else max(4 * len(data), 1 << 16)
        grow = stated < 0
    else:
        grow = False
    err = ctypes.create_string_buffer(256)
    while True:
        out = np.empty(max(int(size), 1), np.uint8)
        n = lib.kgcn_zstd_decompress(data, len(data), out.ctypes.data, int(size), err, 256)
        if n >= 0:
            return out[:n].tobytes()
        msg = err.value.decode(errors="replace")
        if grow and "larger than the buffer" in msg:
            size *= 4
            continue
        raise ValueError(f"zstd: {msg}")


def _crc32c(data: bytes) -> int:
    from kgcn_tpu_torch.data.tfrecord import crc32c_native

    return crc32c_native(data)


# ---- bytes ----------------------------------------------------------------------
class _Reader:
    def __init__(self, data: bytes, what: str):
        self.b = memoryview(data)
        self.at = 0
        self.what = what

    def take(self, n: int) -> bytes:
        if n < 0 or self.at + n > len(self.b):
            raise ValueError(f"{self.what}: truncated ({n} byte(s) wanted at "
                             f"{self.at} of {len(self.b)})")
        out = self.b[self.at:self.at + n].tobytes()
        self.at += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            c = self.byte()
            value |= (c & 0x7F) << shift
            if not c & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint too long")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def done(self) -> bool:
        return self.at == len(self.b)


def _body(raw: bytes, magic: int, what: str) -> _Reader:
    """The body of a manifest or node: header checked, crc32c checked,
    decompressed."""
    if len(raw) < 16 or struct.unpack(">I", raw[:4])[0] != magic:
        raise ValueError(f"{what}: not an OCDBT {'manifest' if magic == MANIFEST_MAGIC else 'node'}"
                         " (bad magic number)")
    length = struct.unpack("<Q", raw[4:12])[0]
    if length != len(raw):
        raise ValueError(f"{what}: length {length} in its header, {len(raw)} bytes read")
    want = struct.unpack("<I", raw[-4:])[0]
    if _crc32c(raw[:-4]) != want:
        raise ValueError(f"{what}: crc32c mismatch")
    r = _Reader(raw[:-4], what)
    r.at = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise ValueError(f"{what}: OCDBT format version {version} (0 is read)")
    rest = raw[r.at:-4]
    if compression == 1:
        rest = zstd_decompress(rest)
    elif compression != 0:
        raise ValueError(f"{what}: unknown compression {compression}")
    return _Reader(rest, what)


def _data_files(r: _Reader) -> List[str]:
    """A table of data files: each path stored as the length shared with the
    previous path, the rest's length and the base path's length (columns),
    then the rest of each path."""
    n = r.varint()
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: where the path's base ends, not needed
    paths: List[str] = []
    for i in range(n):
        prev = paths[-1] if paths else ""
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: bad data file table")
        paths.append(prev[:prefix[i]] + r.take(suffix[i]).decode())
    return paths


def _keys(r: _Reader, n: int, inner: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if inner else [0] * n
    keys: List[bytes] = []
    for i in range(n):
        prev = keys[-1] if keys else b""
        if prefix[i] > len(prev):
            raise ValueError(f"{r.what}: bad key prefix")
        keys.append(prev[:prefix[i]] + r.take(suffix[i]))
    return keys, common


# ---- stores ---------------------------------------------------------------------
class OcdbtStore:
    """The keys of an OCDBT store (its latest version) and their values,
    read on demand."""

    def __init__(self, root: str):
        self.root = root
        raw = self._read_file("manifest.ocdbt")
        r = _body(raw, MANIFEST_MAGIC, os.path.join(root, "manifest.ocdbt"))
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"{root}: OCDBT manifest kind {kind} (a numbered "
                             "manifest) is not read; orbax writes a single one")
        r.varint()  # max inline value bytes
        r.varint()  # max decoded node bytes
        r.byte()  # version tree arity (log2)
        if r.varint() == 1:
            r.take(4)  # zstd level, int32
        files = _data_files(r)
        n = r.varint()
        if n == 0:
            raise ValueError(f"{root}: the OCDBT manifest holds no version")
        r.varints(n)  # generation numbers
        heights = list(r.take(n))
        file_ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        self.index: Dict[bytes, Any] = {}
        if offsets[-1] != (1 << 64) - 1:  # the latest version; -1: empty
            self._walk(files[file_ids[-1]], offsets[-1], lengths[-1], heights[-1], b"")

    def _read_file(self, rel: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        global bytes_read
        path = os.path.join(self.root, rel)
        with open(path, "rb") as f:
            f.seek(offset)
            data = f.read() if length is None else f.read(length)
        if length is not None and len(data) != length:
            raise ValueError(f"{path}: {length} bytes wanted at {offset}, "
                             f"{len(data)} there")
        bytes_read += len(data)
        return data

    def _walk(self, path: str, offset: int, length: int, height: int, prefix: bytes):
        what = f"{os.path.join(self.root, path)}@{offset}"
        r = _body(self._read_file(path, offset, length), NODE_MAGIC, what)
        if r.byte() != height:
            raise ValueError(f"{what}: node height does not match its reference")
        files = _data_files(r)
        n = r.varint()
        keys, common = _keys(r, n, inner=height > 0)
        if height > 0:
            ids, offs, lens = r.varints(n), r.varints(n), r.varints(n)
            r.varints(n), r.varints(n), r.varints(n)  # keys, tree bytes, value bytes
            for i in range(n):
                self._walk(files[ids[i]], offs[i], lens[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        sizes = r.varints(n)
        kinds = list(r.take(n))
        out_of_line = [i for i in range(n) if kinds[i] == 1]
        ids = r.varints(len(out_of_line))
        offs = r.varints(len(out_of_line))
        refs = {i: (files[ids[j]], offs[j], sizes[i]) for j, i in enumerate(out_of_line)}
        for i in range(n):
            if kinds[i] == 0:
                self.index[prefix + keys[i]] = r.take(sizes[i])
            elif kinds[i] == 1:
                self.index[prefix + keys[i]] = refs[i]
            else:
                raise ValueError(f"{what}: unknown value kind {kinds[i]}")
        if not r.done():
            raise ValueError(f"{what}: bytes left after the leaf's values")

    def get(self, key: str) -> Optional[bytes]:
        value = self.index.get(key.encode())
        if value is None or isinstance(value, bytes):
            return value
        path, offset, length = value
        return self._read_file(path, offset, length)


# ---- checkpoints ------------------------------------------------------------------
def is_orbax_dir(path: str) -> bool:
    """Whether ``path`` is an orbax checkpoint directory (its ``_METADATA``)."""
    return os.path.isfile(os.path.join(path, METADATA))


def _metadata(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, METADATA)) as f:
        meta = json.load(f)
    if meta.get("use_zarr3") or not meta.get("use_ocdbt", True):
        raise ValueError(f"{path}: an orbax checkpoint without OCDBT or in zarr v3; "
                         "the reader knows OCDBT and zarr v2 (what kgcn_tpu writes)")
    return meta


class Checkpoint:
    """An orbax checkpoint directory: its tree metadata and its store."""

    def __init__(self, path: str):
        if not is_orbax_dir(path):
            raise ValueError(f"{path}: not an orbax checkpoint (no {METADATA})")
        self.path = path
        self.meta = _metadata(path)
        self.store = OcdbtStore(path)
        self._arrays: Dict[str, ZarrArray] = {}

    def leaves(self) -> List[Tuple[List[str], Dict[str, Any]]]:
        """(key path, value metadata) of every leaf, in the file's order."""
        out = []
        for entry in self.meta["tree_metadata"].values():
            keys = [str(k["key"]) for k in entry["key_metadata"]]
            out.append((keys, entry.get("value_metadata", {})))
        return out

    def array(self, name: str) -> "ZarrArray":
        arr = self._arrays.get(name)
        if arr is None:
            arr = self._arrays[name] = ZarrArray(self.store, name)
        return arr


_EMPTY = {"None": lambda: None, "Dict": dict, "List": list}


def load_tree(path: str) -> Dict[str, Any]:
    """The whole tree of the orbax checkpoint at ``path``, nested as
    ``flax_msgpack.load`` nests a msgpack checkpoint's."""
    ck = Checkpoint(path)
    tree: Dict[str, Any] = {}
    for keys, value in ck.leaves():
        if value.get("skip_deserialize"):
            leaf = _EMPTY.get(value.get("value_type"), lambda: None)()
        else:
            leaf = ck.array(".".join(keys)).read()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


# ---- zarr v2 ---------------------------------------------------------------------
class ZarrArray:
    """One zarr v2 array of a store: ``shape``, ``chunks``, ``dtype``
    (bfloat16 read as uint16 and viewed), zstd or raw chunks, C order."""

    def __init__(self, store: OcdbtStore, name: str):
        self.store, self.name = store, name
        raw = store.get(f"{name}/.zarray")
        if raw is None:
            raise ValueError(f"orbax checkpoint has no array {name!r}")
        meta = json.loads(raw)
        if meta.get("zarr_format") != 2:
            raise ValueError(f"{name}: zarr format {meta.get('zarr_format')} (2 is read)")
        if meta.get("order", "C") != "C" or meta.get("filters"):
            raise ValueError(f"{name}: order {meta.get('order')} / filters "
                             f"{meta.get('filters')} not read")
        comp = meta.get("compressor")
        if comp is not None and comp.get("id") != "zstd":
            raise ValueError(f"{name}: compressor {comp.get('id')!r} (zstd is read)")
        self.compressed = comp is not None
        self.shape = tuple(int(s) for s in meta["shape"])
        self.chunks = tuple(int(c) for c in meta["chunks"]) or ()
        self.sep = meta.get("dimension_separator", ".")
        self.bf16 = meta["dtype"] == "bfloat16"
        self.dtype = np.dtype("<u2" if self.bf16 else meta["dtype"])
        fill = meta.get("fill_value")
        self.fill = 0 if fill is None or self.bf16 else fill

    def _chunk(self, idx: Tuple[int, ...]) -> np.ndarray:
        key = self.sep.join(str(i) for i in idx) if idx else "0"
        raw = self.store.get(f"{self.name}/{key}")
        shape = self.chunks
        if raw is None:  # a chunk equal to the fill value need not be stored
            return np.full(shape, self.fill, self.dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * self.dtype.itemsize
        data = zstd_decompress(raw, nbytes) if self.compressed else raw
        if len(data) != nbytes:
            raise ValueError(f"{self.name}/{key}: {len(data)} bytes, {nbytes} expected")
        return np.frombuffer(data, self.dtype).reshape(shape)

    def read(self, rows: Optional[Tuple[int, int]] = None):
        if not self.shape:
            out = self._chunk(()).reshape(())
        else:
            lo, hi = (0, self.shape[0]) if rows is None else (int(rows[0]), int(rows[1]))
            lo, hi = max(lo, 0), min(hi, self.shape[0])
            shape = (max(hi - lo, 0),) + self.shape[1:]
            out = np.zeros(shape, self.dtype)
            grid = [range(-(-s // c)) for s, c in zip(self.shape, self.chunks)]
            first = lo // self.chunks[0]
            last = -(-hi // self.chunks[0])
            grid[0] = range(first, max(last, first))
            for idx in np.ndindex(*[len(g) for g in grid]):
                cidx = tuple(g[i] for g, i in zip(grid, idx))
                start = [c * s for c, s in zip(cidx, self.chunks)]
                chunk = self._chunk(cidx)
                src, dst = [], []
                for d, (st, c, n) in enumerate(zip(start, self.chunks, self.shape)):
                    a, b = st, min(st + c, n)
                    if d == 0:
                        a, b = max(a, lo), min(b, hi)
                        dst.append(slice(a - lo, b - lo))
                    else:
                        dst.append(slice(a, b))
                    src.append(slice(a - st, b - st))
                out[tuple(dst)] = chunk[tuple(src)]
        if self.bf16:
            return torch.from_numpy(np.ascontiguousarray(out)).view(torch.bfloat16)
        return out
