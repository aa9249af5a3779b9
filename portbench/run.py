"""Run one cell of the port's benchmark on the card and print its result.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``cells/<cell>.json``) names its configuration and traffic.  A
run makes its data and weights from ``--seed``, warms up and captures its
own shapes (``setup_s``), trains for ``--seconds`` seconds in a closed
loop of whole epochs, and checks its first epoch, taken by the window's
own runner, against the plain reference (``check.py``).  With ``--trace 0`` the last line of standard
output holds the end-to-end metrics, with ``--trace 1`` the per-layer ones
(``metrics/``) read from a traced slice after the window; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key.

It needs a CUDA card (as many as the cell asks for) and never falls back
to the CPU; it exits non-zero and prints no result without one, or when a
module of JAX or of the JAX package was loaded.  Build, kernel and
bytecode caches go to fixed directories under ``build/`` in the checkout.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that may not be loaded (JAX and the JAX package)
BANNED = ("jax", "jaxlib", "flax", "optax", "kgcn_tpu")


def banned_modules(names) -> list:
    """The banned top-level names among module names (whole names only:
    ``kgcn_tpu_torch`` is not ``kgcn_tpu``)."""
    return sorted({n.split(".")[0] for n in names} & set(BANNED))


def _cache_dirs() -> None:
    """Fixed cache directories in the checkout, so that only a cell's first
    run there compiles: Python's bytecode of the libraries too (their own
    ``__pycache__`` may be missing or read-only, and compiling torch's
    modules from source took seconds of every run's set-up)."""
    build = ROOT / "build"
    sys.pycache_prefix = str(build / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    _cache_dirs()

    import torch

    from portbench.registry import Registry

    torch.set_num_threads(1)  # one process of few threads: the host's work repeats

    cell = Registry().cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2

    from portbench.bench import run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0), STARTED)
    loaded = banned_modules(sys.modules)
    if loaded:
        print(f"portbench: modules of {loaded} were loaded; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
