"""Multi-process launcher and per-process bring-up — the counterpart of
``kgcn_tpu/parallel/launch.py``.

* ``kgcn-torch-launch --nprocs N [--cpu] -- <command>`` (``python -m
  kgcn_tpu_torch.parallel.launch``) spawns N ranks of ``command`` on this
  host with torchrun's variables (``MASTER_ADDR``, ``MASTER_PORT``,
  ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``), so a
  command started by ``torchrun`` joins the same way.  Each rank's output
  is streamed with a ``[pK]`` prefix; the first rank to fail ends the
  others (a rank left waiting in a collective would hang) and its exit
  code is the launcher's.  Without ``--cpu`` every rank takes one GPU
  (NCCL): the launcher refuses a machine with no GPU and more ranks than
  visible GPUs.  With ``--cpu`` the ranks run on the CPU over gloo, one
  thread each unless ``OMP_NUM_THREADS`` says otherwise, and the command
  must carry its own ``--cpu``.  ``--init-method URL`` (e.g.
  ``file:///tmp/rdzv``) rendezvous through that store in place of a TCP
  port.
* ``initialize_from_env(cpu)`` — called by every CLI entry point of the
  port before its first device touch: under the launcher (or torchrun) it
  joins the process group (``parallel/mesh.initialize_distributed``); in a
  plain process it does nothing, and the process is a world of one.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence

ENV_DEVICE = "KGCN_TORCH_DIST_DEVICE"  # "cpu" or "cuda": what the launcher started
ENV_INIT = "KGCN_TORCH_DIST_INIT"      # an init_method URL in place of env://


def initialize_from_env(cpu: bool) -> bool:
    """Join the process group the launcher (or torchrun) describes.

    ``cpu``: the command's own ``--cpu``; it picks gloo on the CPU or NCCL
    on the GPU of ``LOCAL_RANK``.  A command whose ``--cpu`` disagrees with
    the launcher's raises ``ValueError``: nothing switches device quietly.
    Returns True if a group was joined here, False without the variables
    or when this process has joined already."""
    from kgcn_tpu_torch.parallel.mesh import initialize_distributed, initialized

    if "WORLD_SIZE" not in os.environ or initialized():
        return False  # a plain process, or a command run in a rank that has joined
    launched = os.environ.get(ENV_DEVICE)
    if launched is not None and (launched == "cpu") != bool(cpu):
        raise ValueError(
            f"the launcher started {'CPU' if launched == 'cpu' else 'GPU'} ranks but "
            f"the command runs on the {'CPU' if cpu else 'GPU'}: give both "
            "kgcn-torch-launch and the command --cpu, or neither")
    return initialize_distributed({
        "init_method": os.environ.get(ENV_INIT) or "env://",
        "world_size": int(os.environ["WORLD_SIZE"]),
        "rank": int(os.environ["RANK"]),
        "local_rank": int(os.environ.get("LOCAL_RANK", os.environ["RANK"])),
        "cpu": bool(cpu),
    })


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_gpus(nprocs: int) -> None:
    """GPU ranks need one visible GPU each."""
    import torch

    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device visible: GPU ranks need one GPU each "
            "(kgcn-torch-launch --cpu runs gloo ranks on the CPU)")
    if nprocs > n:
        raise ValueError(f"{nprocs} GPU ranks asked for, {n} GPU(s) visible: "
                         "start at most one rank a GPU")


def launch(nprocs: int, command: Sequence[str], *, cpu: bool = False,
           init_method: Optional[str] = None, env: Optional[Dict[str, str]] = None,
           timeout: Optional[float] = None, stream: bool = True,
           ) -> List[subprocess.CompletedProcess]:
    """Run ``nprocs`` ranks of ``command`` as one job; returns one
    CompletedProcess a rank (stdout and stderr merged).  When a rank exits
    non-zero the others are ended; ``timeout`` (seconds, one deadline for
    the whole job) ends them all and raises ``subprocess.TimeoutExpired``."""
    if nprocs < 1:
        raise ValueError(f"--nprocs must be at least 1, got {nprocs}")
    if not cpu:
        check_gpus(nprocs)
    port = None if init_method else _free_port()
    procs = []
    for rank in range(nprocs):
        wenv = dict(os.environ)
        wenv.update(env or {})
        wenv.update({"RANK": str(rank), "WORLD_SIZE": str(nprocs),
                     "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(nprocs),
                     ENV_DEVICE: "cpu" if cpu else "cuda"})
        if init_method:
            wenv[ENV_INIT] = init_method
        else:
            wenv.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            wenv.pop(ENV_INIT, None)
        if cpu:
            wenv.setdefault("OMP_NUM_THREADS", "1")
        procs.append(subprocess.Popen(list(command), env=wenv, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outputs: List[List[str]] = [[] for _ in procs]

    def pump(i, p):
        for line in p.stdout:
            outputs[i].append(line)
            if stream:
                sys.stdout.write(f"[p{i}] {line}")
                sys.stdout.flush()

    threads = [threading.Thread(target=pump, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            if any(c not in (None, 0) for c in codes):
                break  # the first failure: the rest may wait on it forever
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(list(command), timeout)
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in threads:
            t.join(timeout=10)
    return [subprocess.CompletedProcess(list(command), p.returncode, "".join(out), None)
            for p, out in zip(procs, outputs)]


def first_failure(results: Sequence[subprocess.CompletedProcess]) -> int:
    """The exit code of the job: 0, or that of the first rank to fail (a
    rank the launcher ended reports a signal; a rank that failed itself
    wins over it)."""
    codes = [r.returncode for r in results]
    own = [c for c in codes if c > 0]
    if own:
        return own[0]
    bad = [c for c in codes if c != 0]
    return 128 - bad[0] if bad else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        prog="kgcn-torch-launch",
        description="Run a kgcn_tpu_torch command as N ranks of one "
                    "torch.distributed job on this host (one GPU a rank, "
                    "NCCL; or --cpu, gloo).")
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--cpu", action="store_true",
                    help="CPU ranks over gloo (the command needs --cpu too)")
    ap.add_argument("--init-method", default=None,
                    help="rendezvous URL (file:///path) instead of a TCP port")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="-- followed by the command of every rank")
    args = ap.parse_args(argv)
    cmd = list(args.command)
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (kgcn-torch-launch --nprocs 2 --cpu -- "
                 "kgcn-torch train --config c.json --cpu)")
    results = launch(args.nprocs, cmd, cpu=args.cpu, init_method=args.init_method)
    rc = first_failure(results)
    if rc:
        bad = [i for i, r in enumerate(results) if r.returncode]
        print(f"[launch] failed ranks: {bad}", file=sys.stderr)
    return rc


if __name__ == "__main__":
    sys.exit(main())
