"""Checkpoints of the port.

A checkpoint is ``torch.save({"params": {...}, "batch_stats": {...}})``: two
flat dicts of CPU tensors keyed by the model's ``state_dict`` names, loaded
with ``weights_only=True``.  File names follow ``kgcn_tpu``
(``model.best.ckpt``, ``model.last.ckpt``, ``model.<fold>.<tag>.ckpt``).

The JAX package's flax-msgpack checkpoints (``kgcn_tpu/runtime/
checkpoint.py:42-72``) are not read yet (ROADMAP.md queue A); convert JAX
parameters with ``kgcn_tpu_torch.convert.params_from_jax`` instead.
"""
from __future__ import annotations

import os
import zipfile
from typing import Dict, Optional

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    batch_stats: Dict[str, torch.Tensor]) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tree = {
        "params": {k: v.detach().cpu() for k, v in params.items()},
        "batch_stats": {k: v.detach().cpu() for k, v in batch_stats.items()},
    }
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(tree, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Tree:
    """``{"params": ..., "batch_stats": ...}`` on the CPU.  Raises
    FileNotFoundError for a missing file and ValueError for a file that is
    not a checkpoint of the port."""
    with open(path, "rb") as f:
        is_torch_file = zipfile.is_zipfile(f)  # torch.save writes a zip
    if not is_torch_file:
        raise ValueError(
            f"{path} is not a kgcn_tpu_torch checkpoint; flax-msgpack "
            "checkpoints of kgcn_tpu are not read yet — convert their "
            "parameters with kgcn_tpu_torch.convert.params_from_jax "
            "(ROADMAP.md)"
        )
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(tree, dict) or set(tree) != {"params", "batch_stats"}:
        raise ValueError(
            f"{path}: expected a dict with 'params' and 'batch_stats'"
        )
    return tree


def ckpt_name(base_dir: str, tag, fold: Optional[int] = None) -> str:
    """model.<fold>.<tag>.ckpt naming, as in kgcn_tpu."""
    if fold is None:
        return os.path.join(base_dir, f"model.{tag}.ckpt")
    return os.path.join(base_dir, f"model.{fold}.{tag}.ckpt")
