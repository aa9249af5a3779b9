"""Checkpoints of the port.

A checkpoint is ``torch.save`` of a dict of CPU tensors, loaded with
``weights_only=True``.  Two forms, as the JAX package's trees
(``kgcn_tpu/runtime/checkpoint.py``, ``Trainer.state_tree``):

* ``{"params", "batch_stats"}`` — flat dicts keyed by the model's
  ``state_dict`` names: what serving needs (and what the first slice wrote);
* the full training tree, which adds ``opt_state`` (the optimizer's nested
  dicts), ``step``, ``rng`` (the dropout generator's state), ``epoch`` and
  ``best_cost`` — written by ``Trainer.fit`` for best, interval and last
  checkpoints, and resumable.  The data-parallel trainer's adds
  ``rng_ranks`` (every data rank's generator state, in rank order; ``rng``
  is rank 0's).

File names follow ``kgcn_tpu`` (``model.best.ckpt``, ``model.last.ckpt``,
``model.<NNNNN>.ckpt``, ``model.<fold>.<tag>.ckpt``).  ``load_checkpoint``
also reads the JAX package's flax-msgpack checkpoints (``runtime/
flax_msgpack.py``, ``convert.tree_from_jax``) and returns them as the
port's tree, so ``Trainer.restore``, ``infer``, ``retrain`` and the
``Predictor`` take a checkpoint that ``kgcn_tpu`` wrote wherever they take
one of the port, and so do its orbax directories (``save_checkpoint(fmt=
"orbax")``, ``save_sharded``), read without orbax by ``runtime/orbax.py``
into the same raw tree.  The port's own sharded checkpoint of the big-graph
KG trainer is a ``torch.distributed.checkpoint`` directory;
``parallel/big_graph.BigGraphKGTrainer.restore`` reads it and ``kgcn_tpu``'s
orbax ``model.big_graph.ckpt``.  The port writes no orbax.
"""
from __future__ import annotations

import os
import zipfile
from typing import Any, Dict, Optional

import torch

Tree = Dict[str, Any]
PARAM_KEYS = {"params", "batch_stats"}
FULL_KEYS = PARAM_KEYS | {"opt_state", "step", "rng", "epoch", "best_cost"}
DP_KEYS = FULL_KEYS | {"rng_ranks"}
TREE_KEYS = (PARAM_KEYS, FULL_KEYS, DP_KEYS)


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return tree


def save_tree(path: str, tree: Tree) -> str:
    """Write a checkpoint tree (tensors moved to the CPU) atomically."""
    if set(tree) not in TREE_KEYS:
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


def load_checkpoint(path: str, model=None, tx=None) -> Tree:
    """The tree of a checkpoint, on the CPU: ``params`` and ``batch_stats``,
    plus the training state when the file holds it.  A zip file is the
    port's own (``torch.save``); any other file is read as a flax-msgpack
    checkpoint of ``kgcn_tpu`` and converted (``convert.tree_from_jax``:
    ``model``, the port's model, decides the layouts; ``tx``, the port's
    optimizer, brings the training state along).  A directory is read as an
    orbax checkpoint of ``kgcn_tpu`` (``runtime/orbax.py``) and converted
    the same way.  Raises FileNotFoundError for a missing file and
    ValueError for a file that is neither, a directory that is neither orbax
    nor a big-graph ``torch.distributed.checkpoint``, or the latter."""
    from kgcn_tpu_torch.convert import tree_from_jax

    if os.path.isfile(os.path.join(path, ".metadata")):
        raise ValueError(
            f"{path} is a sharded big-graph checkpoint (torch.distributed.checkpoint, "
            "parallel/big_graph.py): resume it with the config's 'mesh' and "
            "'retrain'; infer reads the model.last.ckpt written beside it")
    if os.path.isdir(path):
        from kgcn_tpu_torch.runtime import orbax

        if not orbax.is_orbax_dir(path):
            raise ValueError(
                f"{path} is a directory that is neither an orbax checkpoint of "
                "kgcn_tpu (no _METADATA) nor a big-graph torch.distributed.checkpoint "
                "(no .metadata)")
        raw = orbax.load_tree(path)
    else:
        with open(path, "rb") as f:
            is_torch_file = zipfile.is_zipfile(f)  # torch.save writes a zip
        if is_torch_file:
            return _checked(path, torch.load(path, map_location="cpu", weights_only=True))
        from kgcn_tpu_torch.runtime import flax_msgpack

        try:
            raw = flax_msgpack.load(path)
        except ValueError as e:
            raise ValueError(f"{path} is neither a kgcn_tpu_torch checkpoint nor "
                             f"a flax-msgpack checkpoint of kgcn_tpu: {e}") from None
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: a kgcn_tpu file that holds no checkpoint tree")
    return tree_from_jax(raw, model, tx)


def _checked(path: str, tree) -> Tree:
    if not isinstance(tree, dict) or set(tree) not in TREE_KEYS:
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
