"""A msgpack decoder for the checkpoints of ``kgcn_tpu`` — what
``flax.serialization.to_bytes`` writes (``kgcn_tpu/runtime/checkpoint.py``),
read without ``msgpack`` or ``flax``.

``restore(data)`` gives what ``flax.serialization.msgpack_restore`` gives:

* maps (fix, 16, 32) as dicts, arrays (fix, 16, 32) as lists, str, bin
  (as bytes), nil, bool, every int and float width (float32 widened to a
  Python float, as msgpack does);
* ext 1, an ndarray: a nested msgpack ``(shape, dtype name, C-order
  buffer)``, as a read-only NumPy array over a copy of the buffer; ext 3, a
  NumPy scalar in the same form;
* ``bfloat16`` buffers, which NumPy has no type for, as ``torch.bfloat16``
  tensors (the buffer read through a ``uint16`` view);
* flax's chunked arrays (``'__msgpack_chunked_array__'``, written for
  arrays over 2³⁰ bytes) joined back into one array.

Ext 2 (a Python complex), any other ext code, a byte that starts no
msgpack object, and a truncated file raise ``ValueError``.  Nothing here
writes: the port's own checkpoints are ``torch.save`` files
(``runtime/checkpoint.py``).
"""
from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED = "__msgpack_chunked_array__"

# fixed-width heads: byte → (struct format, size)
_INTS = {0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
         0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
_FLOATS = {0xca: (">f", 4), 0xcb: (">d", 8)}
_LENGTHS = {1: ">B", 2: ">H", 4: ">I"}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_EXT = {0xc7: 1, 0xc8: 2, 0xc9: 4}           # ext 8/16/32: length width
_STR = {0xd9: 1, 0xda: 2, 0xdb: 4}
_BIN = {0xc4: 1, 0xc5: 2, 0xc6: 4}
_ARRAY = {0xdc: 2, 0xdd: 4}
_MAP = {0xde: 2, 0xdf: 4}


class _Reader:
    def __init__(self, data: bytes, raw: bool = False):
        self.buf = memoryview(data)
        self.pos = 0
        self.raw = raw  # str objects as bytes (flax's inner ndarray tuples)

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(
                f"truncated msgpack data: {n} byte(s) wanted at offset "
                f"{self.pos} of {len(self.buf)}")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def length(self, width: int) -> int:
        return self.unpack(_LENGTHS[width], width)

    def str(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def obj(self) -> Any:
        head = self.unpack(">B", 1)
        if head <= 0x7f:
            return head
        if head >= 0xe0:
            return head - 0x100
        if 0x80 <= head <= 0x8f:
            return self.map(head & 0x0f)
        if 0x90 <= head <= 0x9f:
            return [self.obj() for _ in range(head & 0x0f)]
        if 0xa0 <= head <= 0xbf:
            return self.str(head & 0x1f)
        if head == 0xc0:
            return None
        if head == 0xc2:
            return False
        if head == 0xc3:
            return True
        if head in _INTS:
            return self.unpack(*_INTS[head])
        if head in _FLOATS:
            return float(self.unpack(*_FLOATS[head]))
        if head in _STR:
            return self.str(self.length(_STR[head]))
        if head in _BIN:
            return bytes(self.take(self.length(_BIN[head])))
        if head in _ARRAY:
            return [self.obj() for _ in range(self.length(_ARRAY[head]))]
        if head in _MAP:
            return self.map(self.length(_MAP[head]))
        if head in _FIXEXT:
            code = self.unpack(">b", 1)
            return _ext(code, bytes(self.take(_FIXEXT[head])))
        if head in _EXT:
            n = self.length(_EXT[head])
            code = self.unpack(">b", 1)
            return _ext(code, bytes(self.take(n)))
        raise ValueError(f"byte 0x{head:02x} at offset {self.pos - 1} starts no "
                         "msgpack object")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _unpack_all(data: bytes, raw: bool = False) -> Any:
    r = _Reader(data, raw=raw)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} byte(s) of msgpack data after "
                         "the first object")
    return out


def _ndarray(data: bytes):
    """flax's ``_ndarray_from_bytes``: a NumPy array, or for bfloat16 a
    torch tensor."""
    parts = _unpack_all(data, raw=True)
    if not (isinstance(parts, list) and len(parts) == 3):
        raise ValueError("an ndarray ext must hold (shape, dtype, buffer)")
    shape, name, buf = parts
    shape = tuple(int(s) for s in shape)
    name = name.decode() if isinstance(name, bytes) else str(name)
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"unknown dtype {name!r} in an ndarray ext") from e
    return np.frombuffer(buf, dtype).reshape(shape)


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        arr = _ndarray(data)
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    if code == EXT_COMPLEX:
        raise ValueError("msgpack ext 2 (a complex number) is not read: no "
                         "kgcn_tpu checkpoint holds one")
    raise ValueError(f"unknown msgpack ext code {code} ({len(data)} bytes)")


def _join_chunks(d: dict):
    """flax's ``_unchunk``: the chunks concatenated, reshaped."""
    def as_tuple(x):
        return tuple(x[str(i)] for i in range(len(x)))

    chunks = as_tuple(d["chunks"])
    shape = tuple(int(s) for s in as_tuple(d["shape"]))
    if chunks and isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _join_chunks(tree)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def restore(data: bytes) -> Any:
    """The tree of a flax msgpack byte string (``msgpack_restore``)."""
    return _unchunk(_unpack_all(bytes(data)))


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return restore(f.read())

