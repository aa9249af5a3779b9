"""Tensor-parallel training over a ``model`` axis — the counterpart of
``kgcn_tpu/parallel/tp.py``, where GSPMD shards the wide kernels on their
output features and inserts the collectives.

``param_sharding_rules`` takes ``kgcn_tpu``'s rule: a leaf of rank 2 or
more whose last dimension is at least ``min_dim`` and divisible by T (the
axis size) is sharded on that dimension, every other leaf (1-D BN scales
and biases, Dense biases, narrow kernels) replicated.  It decides on
``kgcn_tpu``'s leaf shapes, which ``convert.py``'s mapping gives: a flax
``Dense`` kernel ``[in, out]`` is the port's ``nn.Linear.weight`` ``[out,
in]`` (sharded on its dim 0), a ``Conv`` kernel ``[k, in, out]`` the
port's ``Conv1d.weight`` ``[out, in, k]`` (dim 0), the four gate kernels
``[in, H]`` of an ``OptimizedLSTMCell`` the port's stacked ``weight_ih``/
``weight_hh`` ``[4H, ·]`` (dim 0, each of the four gate blocks split);
every other leaf keeps its layout (``GraphConv``'s kernel ``[C, Fin,
Fout]`` and bias ``[C, Fout]``: both on ``Fout``).

``TPTrainer`` holds, on each rank, only its column slice of every sharded
leaf (a contiguous tensor, not a view) and the optimizer moments of that
slice, so those leaves take 1/T of their weight and moment memory.  The
layers compute with the slices where their output columns split:

* ``GraphConv`` (the dense path: ``ops.gconv``, the CUDA kernel on the
  card, with ``w[:, :, cols]`` and ``b[:, cols]``) and ``nn.Linear``
  (``GraphDense``'s and the heads' ``Dense``: ``x @ W[cols]ᵀ + b[cols]``,
  the replicated bias sliced) give this rank's output columns, and an
  all-gather over the model group rebuilds the activation for the next
  layer — column-parallel, Megatron's f/g pair as two autograd Functions:
  the identity on the layer's input whose backward all-reduces the partial
  input gradient, and the all-gather whose backward takes this rank's
  slice of the (replicated) gradient;
* any other layer with a sharded leaf (an ``Embed`` table, a ``Conv1d``, an
  LSTM cell, DistMult's relations, GAT's attention) reads the leaf
  all-gathered, and the gather's backward takes the slice.

The batch is replicated over the model group, as in ``kgcn_tpu`` (its
batch is not sharded; on a ``data`` × ``model`` mesh every model group
runs the same step), and every rank draws dropout from the same generator.
``gradient_clip`` and LAMB take the norm of each sharded leaf over the
model group (``runtime/optim.make_optimizer``'s ``sq_norms``).
Checkpoints hold the gathered full tree, as ``kgcn_tpu``'s
``save_checkpoint`` does through ``device_get``: rank 0 writes it, the
single-device ``Trainer`` and the ``Predictor`` load it unchanged, and
``restore`` slices it again.  Steps run eagerly, as ``DPTrainer``'s do."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from kgcn_tpu_torch.nn.layers import GraphConv
from kgcn_tpu_torch.parallel import mesh as pmesh
from kgcn_tpu_torch.runtime import checkpoint as ckpt
from kgcn_tpu_torch.runtime.optim import make_optimizer
from kgcn_tpu_torch.runtime.train import Trainer, TrainState

@dataclasses.dataclass(frozen=True)
class Shard:
    """A leaf split over the model axis along ``dim``; ``blocks`` > 1:
    the dimension stacks that many equal blocks (an LSTM cell's gates),
    each split alike."""

    dim: int
    blocks: int = 1


def _flax_last_dim(name: str, shape, model: Optional[nn.Module]):
    """(the port's dim that is ``kgcn_tpu``'s last dim of this leaf, its
    blocks, ``kgcn_tpu``'s rank and last size), by ``convert.py``'s rule."""
    from kgcn_tpu_torch.nn.multimodal import LSTMCell

    scope, _, leaf = name.rpartition(".")
    mod = None
    if model is not None:
        try:
            mod = model.get_submodule(scope)
        except AttributeError:
            mod = None
    if isinstance(mod, (nn.Linear, nn.Conv1d)) and leaf == "weight":
        return 0, 1, len(shape), shape[0]
    if isinstance(mod, LSTMCell) and leaf in ("weight_ih", "weight_hh"):
        return 0, 4, 2, shape[0] // 4
    if isinstance(mod, LSTMCell) and leaf == "bias":
        return 0, 4, 1, shape[0] // 4  # four 1-D gate biases: replicated
    return len(shape) - 1, 1, len(shape), shape[-1] if shape else 0


def param_sharding_rules(params: Dict[str, Any], mesh: pmesh.Mesh, axis: str = "model",
                         min_dim: int = 128, model: Optional[nn.Module] = None
                         ) -> Dict[str, Optional[Shard]]:
    """``{name: Shard or None}`` for the port's parameters ``params``
    (``model``, the port's module, says what each leaf is in ``kgcn_tpu``;
    without it every leaf keeps its layout): sharded where ``kgcn_tpu``'s
    ``param_sharding_rules`` shards the same leaf, None (replicated)
    elsewhere."""
    size = mesh.axis_size(axis)
    rules: Dict[str, Optional[Shard]] = {}
    for name, value in params.items():
        dim, blocks, rank, last = _flax_last_dim(name, tuple(value.shape), model)
        rules[name] = (Shard(dim, blocks)
                       if rank >= 2 and last >= min_dim and last % size == 0 else None)
    return rules


# ---- slices of a leaf ----------------------------------------------------------
def _blocked(t: torch.Tensor, spec: Shard, T: int) -> torch.Tensor:
    """``t`` viewed ``[blocks, T, n/(blocks·T), rest...]`` with the split
    dim first."""
    x = t.movedim(spec.dim, 0)
    return x.reshape(spec.blocks, T, x.shape[0] // (spec.blocks * T), *x.shape[1:])


def take_slice(full: torch.Tensor, spec: Optional[Shard], t: int, T: int) -> torch.Tensor:
    """Rank ``t``'s slice of a whole leaf (a new contiguous tensor)."""
    if spec is None:
        return full
    x = _blocked(full, spec, T)[:, t]
    return x.reshape(-1, *x.shape[2:]).movedim(0, spec.dim).contiguous()


def join_slices(parts: torch.Tensor, spec: Shard) -> torch.Tensor:
    """The whole leaf from the T slices stacked on a new dim 0."""
    T = parts.shape[0]
    dim = spec.dim % (parts.dim() - 1)
    x = parts.movedim(dim + 1, 1)  # [T, n_local, rest...]
    x = x.reshape(T, spec.blocks, x.shape[1] // spec.blocks, *x.shape[2:])
    return x.transpose(0, 1).reshape(-1, *x.shape[3:]).movedim(0, dim).contiguous()


# ---- collectives over the model group -------------------------------------------
class _Group:
    """The model group of a TPTrainer: its size, this rank's index, the
    process group (None: the default group, or no group at all)."""

    def __init__(self, mesh: pmesh.Mesh, axis: str):
        self.T = mesh.axis_size(axis)
        self.t = mesh.coord(axis)
        self.pg = mesh.group(axis)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` stacked on a new dim 0."""
        out = torch.empty((self.T * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        return pmesh.all_gather_into_(out, x, self.pg).view(self.T, *x.shape)

    def all_reduce_(self, x: torch.Tensor) -> torch.Tensor:
        return pmesh.all_reduce_sum_(x, self.pg)


class _CopyToModel(torch.autograd.Function):
    """f: the identity; its backward sums the partial input gradients of
    the column-parallel layer over the model group."""

    @staticmethod
    def forward(ctx, x, group: _Group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce_(g.contiguous().clone()), None


class _GatherFromModel(torch.autograd.Function):
    """g (and a sharded leaf read whole): the slices all-gathered into the
    whole tensor along ``spec``; its backward takes this rank's slice of
    the gradient, which every rank holds whole and alike."""

    @staticmethod
    def forward(ctx, x, group: _Group, spec: Shard):
        ctx.group, ctx.spec = group, spec
        return join_slices(group.gather(x), spec)

    @staticmethod
    def backward(ctx, g):
        return take_slice(g, ctx.spec, ctx.group.t, ctx.group.T), None, None


class _SliceReplicated(torch.autograd.Function):
    """A replicated leaf's slice (``nn.Linear``'s bias beside its sharded
    weight); its backward all-gathers the slices' gradients, so the whole
    leaf's gradient is the same on every rank."""

    @staticmethod
    def forward(ctx, x, group: _Group, spec: Shard):
        ctx.group, ctx.spec = group, spec
        return take_slice(x, spec, group.t, group.T)

    @staticmethod
    def backward(ctx, g):
        return join_slices(ctx.group.gather(g), ctx.spec), None, None


_LAST = Shard(-1)


class TPTrainer(Trainer):
    """The port's ``Trainer`` with the wide leaves sharded over the
    ``model_axis`` of ``mesh`` (module docstring)."""

    def __init__(self, model, config, info=None, device=None, tx=None, *,
                 mesh: pmesh.Mesh, model_axis: str = "model", min_dim: int = 128):
        self.mesh, self.model_axis, self.min_dim = mesh, model_axis, int(min_dim)
        self.rules = param_sharding_rules(dict(model.named_parameters()), mesh,
                                          model_axis, min_dim, model=model)
        self.group = _Group(mesh, model_axis)
        super().__init__(model, config, info, device=device,
                         tx=tx if tx is not None else make_optimizer(config, self._sq_norms),
                         capture=False)
        self._column: Dict[str, nn.Module] = {}  # modules computed column-parallel
        self._sliced_bias = set()
        for scope, mod in self.model.named_modules():
            pre = f"{scope}." if scope else ""
            if isinstance(mod, GraphConv) and self.rules[pre + "kernel"] is not None:
                self._column[scope] = mod
            elif isinstance(mod, nn.Linear) and self.rules[pre + "weight"] == Shard(0):
                self._column[scope] = mod
                if mod.bias is not None:
                    self._sliced_bias.add(pre + "bias")
        # the sharded leaves of those modules: read as the local slice
        self._local = {name for name, spec in self.rules.items()
                       if spec is not None and name.rpartition(".")[0] in self._column}

    # ---- the sharded layers ----------------------------------------------------
    def _whole(self, name: str, value: torch.Tensor) -> torch.Tensor:
        """What the model reads for leaf ``name``: the slice in a
        column-parallel layer, else the whole leaf (gathered)."""
        spec = self.rules[name]
        if name in self._local:
            return value
        if name in self._sliced_bias:
            return _SliceReplicated.apply(value, self.group, Shard(0))
        if spec is not None:
            return _GatherFromModel.apply(value, self.group, spec)
        return value

    @contextlib.contextmanager
    def _column_parallel(self):
        group = self.group

        def column(mod):
            inner = type(mod).forward

            def forward(x, *args, **kwargs):
                out = inner(mod, _CopyToModel.apply(x, group), *args, **kwargs)
                return _GatherFromModel.apply(out, group, _LAST)
            return forward

        for mod in self._column.values():
            mod.forward = column(mod)
        try:
            yield
        finally:
            for mod in self._column.values():
                del mod.forward

    def apply(self, params, batch_stats, batch, **kwargs):
        whole = {k: self._whole(k, v) for k, v in params.items()}
        with self._column_parallel():
            return super().apply(whole, batch_stats, batch, **kwargs)

    def _sq_norms(self, sq: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each leaf's Σx² over its whole tensor: the sharded leaves' local
        sums added over the model group, in one all-reduce."""
        names = [k for k in sq if self.rules.get(k) is not None]
        if not names:
            return sq
        summed = self.group.all_reduce_(torch.stack([sq[k] for k in names]))
        return dict(sq, **{k: summed[i] for i, k in enumerate(names)})

    # ---- state -------------------------------------------------------------------
    def _map_params(self, tree, fn):
        """``tree`` (parameters, or an optimizer state of nested dicts) with
        each parameter-named leaf ``v`` replaced by ``fn(name, v)``."""
        if isinstance(tree, dict):
            if tree and set(tree) <= set(self.rules):
                return {k: fn(k, v) for k, v in tree.items()}
            return {k: self._map_params(v, fn) for k, v in tree.items()}
        return tree

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        return take_slice(full, self.rules[name], self.group.t, self.group.T)

    def unshard(self, name: str, local: torch.Tensor) -> torch.Tensor:
        spec = self.rules[name]
        return local if spec is None else join_slices(self.group.gather(local), spec)

    def state_from_tree(self, tree: ckpt.Tree, seed: int = 0) -> TrainState:
        """A whole tree (a fresh model's, or a checkpoint's) laid out
        sharded: this rank's slices of the parameters and moments."""
        state = super().state_from_tree(tree, seed)
        return dataclasses.replace(state, params=self._map_params(state.params, self.shard),
                                   opt_state=self._map_params(state.opt_state, self.shard))

    def state_tree(self, state: TrainState, epoch: int, best_cost: float) -> ckpt.Tree:
        """The whole tree (gathered: every rank takes part)."""
        whole = dataclasses.replace(state, params=self.whole_params(state),
                                    opt_state=self._map_params(state.opt_state, self.unshard))
        return super().state_tree(whole, epoch, best_cost)

    def save_tree(self, path: str, tree: ckpt.Tree) -> str:
        if pmesh.is_main_process():
            ckpt.save_tree(path, tree)
        pmesh.barrier()
        return path

    def whole_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """The state's parameters gathered whole (every rank takes part)."""
        return self._map_params(state.params, self.unshard)
