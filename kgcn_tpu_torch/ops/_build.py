"""Build the port's CUDA kernels with ``nvcc`` and load them through ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
into ``build/kernels/lib<name>-<hash>.so`` at the root of the checkout (the
directory is git-ignored).  The hash covers the source and the flags, so an
edited source is rebuilt and a stale library is never loaded.  Nothing here
includes PyTorch's headers, which keeps a build to seconds.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/libgconv-<hash>.so csrc/gconv.cu

A ``csrc/<name>.cc`` is host code (the tiled backend's structure and plan
builders, the ELL backends' batch packer, the Batcher's edge and feature
packer, the TFRecord reader, the orbax reader's zstd decoder): the host C++
compiler builds it the same way, on a machine with or without a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
CXX_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]
SOURCES = ("gconv", "tiled", "stream", "ell")  # every kernel source of the port, by stem
# host code, by stem
HOST_SOURCES = ("tiled_host", "ell_host", "batch_host", "tfrecord_host", "zstd_host")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """``nvcc`` from PATH, else ``$CUDA_HOME/bin``, else ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from kgcn_tpu_torch/ops/csrc at first "
        "use and need the CUDA toolkit"
    )


def find_cxx() -> str:
    """The host C++ compiler: ``$CXX``, else ``c++``, ``g++`` or ``clang++``
    from PATH."""
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError("no host C++ compiler (CXX, c++, g++, clang++) to build "
                       "kgcn_tpu_torch/ops/csrc/*.cc")


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cc" if name in HOST_SOURCES else f"{name}.cu")


def library_path(name: str) -> Path:
    flags = CXX_FLAGS if name in HOST_SOURCES else NVCC_FLAGS
    h = hashlib.sha256(_source(name).read_bytes() + " ".join(flags).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path):
    if name in HOST_SOURCES:
        return [find_cxx(), *CXX_FLAGS, "-o", str(out), str(_source(name))]
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(out), str(_source(name))]


def build(names: Iterable[str] = SOURCES + HOST_SOURCES, log=None) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, one
    compiler process per source, all started together.  Returns the paths.
    ``log``, if given, receives each successful build's compiler output
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    names = list(names)
    paths = {n: library_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        # write under a per-process name, then rename: a concurrent build
        # never sees a half-written library
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            _command(n, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True,
        ))
    failures = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"--- {_source(n).name} (exit {proc.returncode})\n{out}")
            continue
        os.replace(tmp, paths[n])
        if log is not None:
            log(f"--- {_source(n).name}\n{out}")
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of kernel library ``name``, built if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            if name not in HOST_SOURCES:
                lib.kgcn_cuda_error_string.argtypes = [ctypes.c_int]
                lib.kgcn_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point returned a ``cudaError_t`` other than 0."""
    if code != 0:
        msg = lib.kgcn_cuda_error_string(code).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
