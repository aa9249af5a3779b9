"""The mesh of the port and its collectives — the counterpart of
``kgcn_tpu/parallel/mesh.py``.

One process drives one device, so a mesh is the process group laid out
along named axes: the config's ``mesh`` (``{"data": N}``, ``{"model": T}``,
``{"data": D, "model": T}``, ``{"pipe": S}``; one ``-1`` absorbs the rest)
must cover the world exactly (``make_mesh`` raises ``ValueError``
otherwise, naming the launcher).  Ranks lie on the mesh as
``np.asarray(devices).reshape(sizes)`` lays out ``kgcn_tpu``'s devices:
rank ``d·T + t`` at data ``d``, model ``t``.  Each axis has its process
group (``Mesh.group``): the ranks that differ only on that axis.  The
data-parallel trainer (``dp.py``) reduces over ``data``, the
tensor-parallel one (``tp.py``) gathers over ``model``, the pipeline
(``pp.py``) passes activations along ``pipe``.  An axis of size 1, or one
the mesh lacks, holds this rank alone (``ALONE``): its collectives are
the identity, so ``{"model": T}`` runs data parallel over a ``data``
axis of one.

A plain process, not started by ``kgcn-torch-launch`` or torchrun, is a
world of one: its collectives are the identity.  Under the launcher every
collective runs over the group, a world of one included, so a world of one
on the card goes through NCCL.

GPU ranks join with the backend ``"cpu:gloo,cuda:nccl"``: the tensors on
the card go through NCCL, the host objects of ``host_view`` and the
barrier through gloo; CPU ranks join with gloo alone."""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

ENV_TIMEOUT = "KGCN_TORCH_DIST_TIMEOUT"  # seconds a collective may wait (default 1800)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main_process() -> bool:
    """True on rank 0 (and in a plain process): the rank that writes a
    run's files."""
    return rank() == 0


def initialize_distributed(config: Optional[Dict[str, Any]] = None) -> bool:
    """Join the process group (``torch.distributed.init_process_group``)
    once per process, before the first device touch.

    ``config`` keys: ``init_method`` (``env://`` by default, or
    ``tcp://host:port``, ``file:///path``), ``world_size``, ``rank``,
    ``local_rank`` (the GPU of this rank) and ``cpu`` (gloo ranks on the
    CPU; else NCCL, one GPU a rank: this rank's GPU becomes the current
    device, and a rank without one raises).  Prints the rank's backend,
    rank and device once.  Returns False when the group is up already."""
    if initialized():
        return False
    cfg = dict(config or {})
    cpu = bool(cfg.get("cpu"))
    world, rk = int(cfg["world_size"]), int(cfg["rank"])
    local = int(cfg.get("local_rank", rk))
    if cpu:
        backend, device = "gloo", "cpu"
    else:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError(
                "no CUDA device visible: a GPU rank needs one (kgcn-torch-launch "
                "--cpu and the command's --cpu run gloo ranks on the CPU)")
        if local >= n:
            raise ValueError(f"rank {rk} wants GPU {local}, {n} GPU(s) visible: "
                             "start at most one rank a GPU")
        torch.cuda.set_device(local)
        backend, device = "cpu:gloo,cuda:nccl", f"cuda:{local}"
    timeout = datetime.timedelta(seconds=float(os.environ.get(ENV_TIMEOUT, 1800)))
    dist.init_process_group(backend, init_method=cfg.get("init_method") or "env://",
                            world_size=world, rank=rk, timeout=timeout)
    print(f"[dist] backend {'gloo' if cpu else 'nccl'}, rank {rk} of {world}, "
          f"device {device}", flush=True)
    return True


AXES = ("data", "model", "pipe")
ALONE = "alone"  # the group of an axis of size 1 in a larger world: this rank only
_GROUPS: Dict[Tuple[Tuple[str, int], ...], Dict[str, Any]] = {}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the job as a named mesh: ``shape`` (axis → size, in the
    config's order; the sizes multiply to the world size), this process's
    ``rank``, and the process group of each axis that holds this rank
    (``None``: the default group, or no group in a plain process;
    ``ALONE``: an axis of size 1, absent ones included, in a larger
    world)."""

    shape: Dict[str, int]
    rank: int
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict, compare=False)

    @property
    def size(self) -> int:
        """The data-parallel width: the size of the ``data`` axis (1 without
        one)."""
        return self.shape.get("data", 1)

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on an axis the mesh lacks)."""
        if axis not in self.shape:
            return 0
        names = list(self.shape)
        at = np.unravel_index(self.rank, [self.shape[a] for a in names])
        return int(at[names.index(axis)])

    def group(self, axis: str):
        """The process group of this rank's ``axis`` (None: the default
        group; ``ALONE``: this rank only)."""
        return self.groups.get(axis)


def _axis_groups(sizes: Dict[str, int], rk: int) -> Dict[str, Any]:
    """Each axis's process group holding ``rk``, for every axis of
    ``AXES`` (an absent one has size 1): every rank creates every group, in
    the same order (``dist.new_group`` is collective); an axis that spans
    the world takes the default group, one of size 1 in a larger world is
    ``ALONE``."""
    key = tuple(sizes.items())
    if key in _GROUPS:
        return _GROUPS[key]
    world = int(np.prod(list(sizes.values())))
    ranks = np.arange(world).reshape(list(sizes.values()))
    groups: Dict[str, Any] = {}
    for axis in AXES:
        size = sizes.get(axis, 1)
        if size == world:
            groups[axis] = None
            continue
        if size == 1:
            groups[axis] = ALONE
            continue
        i = list(sizes).index(axis)
        lines = np.moveaxis(ranks, i, -1).reshape(-1, sizes[axis])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if rk in line:
                groups[axis] = g
    _GROUPS[key] = groups
    return groups


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """Resolve and validate a config's ``mesh`` against the world.

    ``axes``: ordered ``{axis: size}`` over ``data``, ``model`` and
    ``pipe`` (``{"data": -1}`` by default); one ``-1`` takes what the other
    axes leave of the world.  The sizes must multiply to the world size."""
    world = world_size()
    axes = {k: int(v) for k, v in dict(axes or {"data": -1}).items()}
    unknown = sorted(set(axes) - set(AXES))
    if unknown:
        raise ValueError(f"mesh axes {unknown}: the port's axes are {list(AXES)}")
    free = [k for k, v in axes.items() if v == -1]
    if len(free) > 1:
        raise ValueError(f"mesh {axes}: at most one axis may be -1")
    if free:
        fixed = int(np.prod([v for v in axes.values() if v != -1]))
        if fixed <= 0 or world % fixed:
            raise ValueError(f"mesh {axes}: a world of {world} does not divide by the "
                             f"fixed axes (product {fixed})")
        axes[free[0]] = world // fixed
    n = int(np.prod(list(axes.values())))
    if n != world or min(axes.values()) < 1:
        raise ValueError(
            f"mesh {axes} asks for {n} ranks but this process is one of "
            f"a world of {world}: start {n} ranks with kgcn-torch-launch --nprocs "
            f"{n} [--cpu] -- <command> (one rank a device)")
    rk = rank()
    return Mesh(shape=axes, rank=rk, groups=_axis_groups(axes, rk) if initialized() else {})


def finalize() -> None:
    """Leave the process group at the end of a command (after a barrier, so
    no rank leaves while another still needs it)."""
    if initialized():
        dist.barrier()
        dist.destroy_process_group()
        _GROUPS.clear()


def barrier() -> None:
    """Wait for every rank (no-op in a world of one without a group)."""
    if initialized():
        dist.barrier()


def host_view(obj: Any, group=None) -> List[Any]:
    """Every rank's ``obj`` (picklable host data) of ``group`` (the world
    by default), in rank order, on every rank: an all-gather (``[obj]`` in
    a plain process or for ``ALONE``)."""
    if not initialized() or group is ALONE:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out


def all_reduce_sum_(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over the ranks of ``group`` (the world by default), in
    place (the identity for ``ALONE``)."""
    if initialized() and group is not ALONE:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_gather_into_(out: torch.Tensor, x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` of ``group`` (the world by default) concatenated on
    dim 0 into ``out`` (``x`` itself in a plain process or for ``ALONE``)."""
    if initialized() and group is not ALONE:
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    else:
        out.copy_(x)
    return out


def process_index_range(n_items: int, num_processes: Optional[int] = None,
                        process_id: Optional[int] = None):
    """This process's contiguous ``[start, stop)`` slice of ``n_items``
    (sizes differ by at most one), as ``kgcn_tpu``'s."""
    np_ = world_size() if num_processes is None else num_processes
    pid = rank() if process_id is None else process_id
    base, extra = divmod(n_items, np_)
    start = pid * base + min(pid, extra)
    stop = start + base + (1 if pid < extra else 0)
    return start, stop
