"""The mesh of the port and its collectives — the counterpart of
``kgcn_tpu/parallel/mesh.py``.

One process drives one device, so a mesh is the process group itself: the
config's ``mesh`` (``{"data": N}``, ``-1`` absorbing the rest) names how
many ranks share the data, and N must equal the world size (``make_mesh``
raises ``ValueError`` otherwise, naming the launcher).  A plain process,
not started by ``kgcn-torch-launch`` or torchrun, is a world of one: its
collectives are the identity.  Under the launcher every collective runs
over the group, a world of one included, so a world of one on the card
goes through NCCL.

GPU ranks join with the backend ``"cpu:gloo,cuda:nccl"``: the tensors on
the card go through NCCL, the host objects of ``host_view`` and the
barrier through gloo; CPU ranks join with gloo alone."""
from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, Dict, List, Optional

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


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of the job as a named mesh: ``shape`` ``{"data": N}``
    (N = the world size), and this process's ``rank``."""

    shape: Dict[str, int]
    rank: int

    @property
    def size(self) -> int:
        return self.shape["data"]


def make_mesh(axes: Optional[Dict[str, int]] = None) -> Mesh:
    """Resolve and validate a config's ``mesh`` against the world.

    ``axes``: ``{"data": N}``; ``-1`` takes the world size.  Other axes
    (``kgcn_tpu``'s tensor and pipeline parallel ``model`` axes) are not
    ported; an axis of size 1 is accepted and dropped."""
    world = world_size()
    axes = dict(axes or {"data": -1})
    other = {k: v for k, v in axes.items() if k != "data" and int(v) != 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {sorted(other)} (tensor / pipeline parallel, kgcn_tpu's "
            "parallel/tp.py and pp.py) are not yet ported to kgcn_tpu_torch "
            "(ROADMAP.md A.11)")
    n = int(axes.get("data", -1))
    if n == -1:
        n = world
    if n != world:
        raise ValueError(
            f"mesh {{'data': {n}}} asks for {n} ranks but this process is one of "
            f"a world of {world}: start {n} ranks with kgcn-torch-launch --nprocs "
            f"{n} [--cpu] -- <command> (one rank a device)")
    return Mesh(shape={"data": n}, rank=rank())


def finalize() -> None:
    """Leave the process group at the end of a command (after a barrier, so
    no rank leaves while another still needs it)."""
    if initialized():
        dist.barrier()
        dist.destroy_process_group()


def barrier() -> None:
    """Wait for every rank (no-op in a world of one without a group)."""
    if initialized():
        dist.barrier()


def host_view(obj: Any) -> List[Any]:
    """Every rank's ``obj`` (picklable host data), in rank order, on every
    rank: an all-gather (``[obj]`` in a plain process)."""
    if not initialized():
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place."""
    if initialized():
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


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
