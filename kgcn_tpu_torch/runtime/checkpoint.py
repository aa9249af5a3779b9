"""Checkpoints of the port.

A checkpoint is ``torch.save`` of a dict of CPU tensors, loaded with
``weights_only=True``.  Two forms, as the JAX package's trees
(``kgcn_tpu/runtime/checkpoint.py``, ``Trainer.state_tree``):

* ``{"params", "batch_stats"}`` — flat dicts keyed by the model's
  ``state_dict`` names: what serving needs (and what the first slice wrote);
* the full training tree, which adds ``opt_state`` (the optimizer's nested
  dicts), ``step``, ``rng`` (the dropout generator's state), ``epoch`` and
  ``best_cost`` — written by ``Trainer.fit`` for best, interval and last
  checkpoints, and resumable.

File names follow ``kgcn_tpu`` (``model.best.ckpt``, ``model.last.ckpt``,
``model.<NNNNN>.ckpt``, ``model.<fold>.<tag>.ckpt``).  The JAX package's
flax-msgpack checkpoints are not read yet (ROADMAP.md queue A); convert JAX
parameters with ``kgcn_tpu_torch.convert.params_from_jax`` instead.
"""
from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Optional

import torch

Tree = Dict[str, Any]
PARAM_KEYS = {"params", "batch_stats"}
FULL_KEYS = PARAM_KEYS | {"opt_state", "step", "rng", "epoch", "best_cost"}


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_tree(path: str, tree: Tree) -> str:
    """Write a checkpoint tree (tensors moved to the CPU) atomically."""
    if set(tree) not in (PARAM_KEYS, FULL_KEYS):
        raise ValueError(f"not a checkpoint tree: keys {sorted(tree)}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, path)
    return path


def save_checkpoint(path: str, params: Dict[str, torch.Tensor],
                    batch_stats: Dict[str, torch.Tensor]) -> str:
    """Parameters and BN statistics only (a serving checkpoint)."""
    return save_tree(path, {"params": params, "batch_stats": batch_stats})


def load_checkpoint(path: str) -> Tree:
    """The tree of a checkpoint, on the CPU: ``params`` and ``batch_stats``,
    plus the training state when the file holds it.  Raises
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
    if not isinstance(tree, dict) or set(tree) not in (PARAM_KEYS, FULL_KEYS):
        raise ValueError(
            f"{path}: expected a dict with 'params' and 'batch_stats' "
            "(and, for a training checkpoint, the optimizer state)"
        )
    return tree


def ckpt_name(base_dir: str, tag, fold: Optional[int] = None) -> str:
    """model.<fold>.<tag>.ckpt naming, as in kgcn_tpu."""
    if fold is None:
        return os.path.join(base_dir, f"model.{tag}.ckpt")
    return os.path.join(base_dir, f"model.{fold}.{tag}.ckpt")
