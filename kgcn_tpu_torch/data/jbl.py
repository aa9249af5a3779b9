"""Read ``.jbl`` dataset files without joblib.

The JAX package loads datasets with ``joblib.load`` (``kgcn_tpu/data/
dataset.py:20,360``).  A joblib file is a pickle stream, either plain or
zlib-compressed as a whole, in which every numeric numpy array is replaced by
a ``joblib.numpy_pickle.NumpyArrayWrapper`` object whose raw bytes follow it
in the stream: one byte giving a padding length, that many padding bytes
(alignment), then the array's data in its stated order.  Arrays of Python
objects are a nested pickle instead of raw bytes.

``load`` rebuilds those arrays with a ``pickle`` unpickler subclass, so the
port reads every ``.jbl`` in the repository without joblib.  Like any pickle,
a ``.jbl`` file can run code when it is read: load only files you trust.
"""
from __future__ import annotations

import io
import pickle
import zlib
from typing import Any

import numpy as np

_PICKLE_PROTO = b"\x80"         # protocol 2+ streams start with PROTO
_ZLIB_PREFIX = b"\x78"          # zlib header (joblib's "zlib" compressor)
_WRAPPER = ("joblib.numpy_pickle", "NumpyArrayWrapper")


class _ArrayWrapper:
    """Stands in for joblib's ``NumpyArrayWrapper``; its pickled state
    (subclass, shape, order, dtype, ...) is set by BUILD."""

    def read(self, fh) -> np.ndarray:
        dtype = np.dtype(self.dtype)
        shape = tuple(int(s) for s in self.shape)
        if dtype.hasobject:
            return _JblUnpickler(fh).load()
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            pad = fh.read(1)
            if len(pad) != 1:
                raise ValueError("truncated .jbl: missing array padding byte")
            fh.read(pad[0])
        count = int(np.prod(shape, dtype=np.int64))
        nbytes = count * dtype.itemsize
        data = fh.read(nbytes)
        if len(data) != nbytes:
            raise ValueError(
                f"truncated .jbl: array of {nbytes} bytes has {len(data)}"
            )
        arr = np.frombuffer(data, dtype=dtype, count=count).copy()
        if self.order == "F":
            arr = arr.reshape(shape[::-1]).transpose()
        else:
            arr = arr.reshape(shape)
        if not arr.dtype.isnative:
            arr = arr.astype(arr.dtype.newbyteorder("="))
        return arr


class _JblUnpickler(pickle._Unpickler):
    """Pure-Python unpickler whose BUILD opcode swaps each array wrapper for
    the array read from the bytes that follow it (as joblib's
    ``NumpyUnpickler.load_build`` does)."""

    dispatch = dict(pickle._Unpickler.dispatch)

    def __init__(self, fh):
        super().__init__(fh)
        self._fh = fh

    def find_class(self, module, name):
        if (module, name) == _WRAPPER:
            return _ArrayWrapper
        if module.startswith("joblib"):
            raise pickle.UnpicklingError(
                f"unsupported joblib object {module}.{name} in .jbl stream "
                "(only NumpyArrayWrapper arrays are read)"
            )
        return super().find_class(module, name)

    def load_build(self):
        super().load_build()
        top = self.stack[-1]
        if isinstance(top, _ArrayWrapper):
            self.stack[-1] = top.read(self._fh)

    dispatch[pickle.BUILD[0]] = load_build


def loads(raw: bytes) -> Any:
    """Decode the bytes of a ``.jbl`` file."""
    if raw.startswith(_ZLIB_PREFIX):
        try:
            raw = zlib.decompress(raw)
        except zlib.error as e:
            raise ValueError(f"corrupt zlib-compressed .jbl stream: {e}") from e
    if not raw.startswith(_PICKLE_PROTO):
        raise ValueError(
            "not a .jbl file this reader handles: expected a pickle stream "
            f"(starts 0x80) or a zlib one (starts 0x78), got {raw[:4]!r} "
            "(gzip/bz2/lzma-compressed joblib files are not read)"
        )
    return _JblUnpickler(io.BytesIO(raw)).load()


def load(path: str) -> Any:
    """Read a ``.jbl`` file (plain or zlib-compressed joblib pickle)."""
    with open(path, "rb") as f:
        return loads(f.read())
