"""Carry parameters and training state of the JAX package over to the port.

``params_from_jax(params, batch_stats, model)`` takes the flax ``params``
and ``batch_stats`` trees of a ``kgcn_tpu`` model (nested dicts of numpy
arrays, e.g. ``jax.device_get(state.params)``) and returns the port's
checkpoint tree ``{"params": {name: tensor}, "batch_stats": {name:
tensor}}``, whose union loads into ``model`` with ``load_state_dict``.
``tree_from_jax`` does the same for a whole ``kgcn_tpu`` checkpoint
(``runtime/checkpoint.load_checkpoint`` reads one with
``runtime/flax_msgpack``): parameters, BN statistics, the optimizer state,
step, epoch and best cost.

The port's modules carry flax's scope and parameter names, so the mapping is
a rule, not a table: scopes join with ``.``, and what a ``kernel`` becomes
is decided by the port's module at that scope:

* an ``nn.Linear`` (flax ``Dense``, stored ``[in, out]``): its ``weight``,
  transposed to ``[out, in]`` — whatever the flax scope is called
  (``Dense_0``, or ``shared1``/``head`` named in a ``setup``);
* an ``nn.Conv1d`` (flax ``Conv``, ``[k, in, out]``): its ``weight``
  ``[out, in, k]``;
* an ``nn/multimodal.LSTMCell`` (flax ``OptimizedLSTMCell``: input kernels
  ``ii``/``if``/``ig``/``io`` ``[in, H]`` without bias, hidden kernels
  ``hi``/``hf``/``hg``/``ho`` ``[H, H]`` with biases): ``weight_ih``
  ``[4H, in]``, ``weight_hh`` ``[4H, H]`` and ``bias`` ``[4H]``, the gates
  stacked in the order i, f, g, o.

Every other leaf keeps its name and layout: GraphConv's ``kernel``
``[C, Fin, Fout]``, DistMult's relation table ``kernel`` ``[C, dim]``, the
VAE's ``GraphDecoderDistMult`` vector ``kernel`` ``[dim]``, the
``embedding`` table, GIN's ``epsilon``, biases, BN ``scale``/``mean``/
``var``.  The engines' models take the same rule: ``SparseGCN``'s
``Dense_0`` head, the pair tower's ``head`` and the VAE's ``mean_head``/
``std_head`` are Linear layers; the names of a flax ``setup`` (``conv1``,
``enc_bn1``, a list's ``link_dense1_0``) are the port's attribute names.  Without a ``model`` the ``Dense`` rule falls back to flax's
automatic scope name ``Dense_<n>`` (enough for the models whose dense
layers carry it).

The optimizer state is optax's as msgpack stores it: a chain as a dict
keyed ``'0'``, ``'1'``, …, each transform's state by its field names, empty
states as ``{}``.  ``opt_state_from_jax`` lays it onto the port's
``runtime/optim.py`` state for the same config: the states that hold
something, in chain order, pair one to one with the port's, field by field
(``count``, ``mu``, ``nu``, ``trace``; ``optax.MultiSteps``'
``mini_step``, ``gradient_step``, ``inner_opt_state`` and ``acc_grads``);
trees shaped like the parameters (``mu``, ``nu``, ``trace``, ``acc``) go
through the parameter rule, so the moments of a Dense kernel are transposed
like the kernel.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

_DENSE_SCOPE = re.compile(r"Dense_\d+")  # flax's automatic name for a Dense
_LSTM_INPUT = ("ii", "if", "ig", "io")
_LSTM_HIDDEN = ("hi", "hf", "hg", "ho")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = val
    return out


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _module(model: Optional[nn.Module], scope: str) -> Optional[nn.Module]:
    if model is None:
        return None
    try:
        return model.get_submodule(scope)
    except AttributeError:
        return None


def _is_lstm(mod) -> bool:
    from kgcn_tpu_torch.nn.multimodal import LSTMCell

    return isinstance(mod, LSTMCell)


def _convert_flat(flat: Dict[str, Any], model: Optional[nn.Module]) -> Dict[str, np.ndarray]:
    """flax leaf names → the port's names and layouts (module docstring)."""
    out: Dict[str, np.ndarray] = {}
    lstm: Dict[str, Dict[str, np.ndarray]] = {}
    for name, arr in flat.items():
        scope, dot, leaf = name.rpartition(".")
        owner, _, gate = scope.rpartition(".")
        if gate in _LSTM_INPUT + _LSTM_HIDDEN and _is_lstm(_module(model, owner)):
            lstm.setdefault(owner, {})[f"{gate}.{leaf}"] = _np(arr)
            continue
        arr = _np(arr)
        mod = _module(model, scope)
        if leaf == "kernel" and (isinstance(mod, nn.Linear) or (
                model is None and _DENSE_SCOPE.fullmatch(scope.rpartition(".")[2]))):
            name, arr = f"{scope}{dot}weight", arr.T
        elif leaf == "kernel" and isinstance(mod, nn.Conv1d):
            name, arr = f"{scope}{dot}weight", arr.transpose(2, 1, 0)
        out[name] = np.ascontiguousarray(arr)
    for owner, leaves in lstm.items():
        try:
            out[f"{owner}.weight_ih"] = np.concatenate(
                [leaves[f"{g}.kernel"].T for g in _LSTM_INPUT])
            out[f"{owner}.weight_hh"] = np.concatenate(
                [leaves[f"{g}.kernel"].T for g in _LSTM_HIDDEN])
            out[f"{owner}.bias"] = np.concatenate(
                [leaves[f"{g}.bias"] for g in _LSTM_HIDDEN])
        except KeyError as e:
            raise ValueError(f"LSTM cell {owner}: no flax leaf {e}") from None
    return out


def _tensors(tree: Mapping[str, Any], model) -> Dict[str, torch.Tensor]:
    return {k: torch.tensor(v, dtype=torch.float32)
            for k, v in _convert_flat(_flatten(tree), model).items()}


def params_from_jax(params: Mapping[str, Any], batch_stats: Mapping[str, Any],
                    model: Optional[nn.Module] = None) -> Dict[str, Dict[str, torch.Tensor]]:
    """flax trees → ``{"params": ..., "batch_stats": ...}`` of the port."""
    return {"params": _tensors(params, model), "batch_stats": _tensors(batch_stats, model)}


def _records(tree, out: list) -> list:
    """The transform states of a chain, in order: a dict keyed by digits is
    a chain (recursed in key order), an empty dict a state that holds
    nothing, any other dict one state."""
    if isinstance(tree, Mapping) and tree and all(str(k).isdigit() for k in tree):
        for k in sorted(tree, key=int):
            _records(tree[k], out)
    elif isinstance(tree, Mapping) and tree:
        out.append(tree)
    return out


def _count(x) -> torch.Tensor:
    return torch.tensor(int(np.asarray(x)), dtype=torch.int32)


def opt_state_from_jax(jax_state: Mapping[str, Any], template: Dict[str, Any],
                       model: Optional[nn.Module] = None) -> Dict[str, Any]:
    """optax's state (as msgpack restores it) → the port's, laid onto
    ``template``, the port optimizer's ``init`` for the same config (filled
    in place and returned)."""
    if "acc" in template:  # multi_steps
        for key in ("mini_step", "gradient_step", "inner_opt_state", "acc_grads"):
            if key not in jax_state:
                raise ValueError(f"the checkpoint's optimizer state has no {key!r}: "
                                 "it was not written with grad_accum_steps > 1")
        template["mini_step"] = _count(jax_state["mini_step"])
        template["gradient_step"] = _count(jax_state["gradient_step"])
        template["acc"] = _tensors(jax_state["acc_grads"], model)
        opt_state_from_jax(jax_state["inner_opt_state"], template["inner"], model)
        return template
    mine, theirs = _records(template, []), _records(jax_state, [])
    if [sorted(r) for r in mine] != [sorted(r) for r in theirs]:
        raise ValueError(
            "the checkpoint's optimizer state does not fit the config's optimizer: "
            f"states {[sorted(r) for r in theirs]}, want {[sorted(r) for r in mine]}")
    for rec, src in zip(mine, theirs):
        for key in rec:
            val = src[key]
            if isinstance(val, Mapping):
                conv = _tensors(val, model)
                if set(conv) != set(rec[key]):
                    raise ValueError(f"optimizer state {key!r}: names {sorted(conv)}, "
                                     f"want {sorted(rec[key])}")
                rec[key] = conv
            else:
                rec[key] = _count(val)
    return template


def tree_from_jax(raw: Mapping[str, Any], model: Optional[nn.Module] = None,
                  tx=None) -> Dict[str, Any]:
    """A whole ``kgcn_tpu`` checkpoint tree → the port's.  With ``tx`` (the
    port optimizer of the run that resumes) the training state comes too:
    the optimizer state, ``step``, ``epoch`` and ``best_cost``.  JAX's PRNG
    key does not map onto a ``torch.Generator``: ``rng`` comes back empty,
    so the resuming ``Trainer`` keeps the fresh generator it seeds from the
    config's seed, as it does for a checkpoint written on another device
    type."""
    if "params" not in raw:
        raise ValueError(f"not a kgcn_tpu checkpoint: keys {sorted(raw)}")
    tree = params_from_jax(raw["params"], raw.get("batch_stats") or {}, model)
    if tx is None or "opt_state" not in raw:
        return tree
    tree["opt_state"] = opt_state_from_jax(raw["opt_state"], tx.init(tree["params"]),
                                           model)
    tree["step"] = torch.tensor(int(np.asarray(raw["step"])), dtype=torch.int64)
    tree["rng"] = torch.zeros(0, dtype=torch.uint8)
    tree["epoch"] = torch.tensor(int(np.asarray(raw["epoch"])), dtype=torch.int32)
    tree["best_cost"] = torch.tensor(float(np.asarray(raw["best_cost"])),
                                     dtype=torch.float32)
    return tree
