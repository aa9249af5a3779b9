"""The readings that a cell's limits are set from, on the card at the cell's
own size, many seeds in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1 2 3 ...

For each seed: the program's first epoch as a run takes it (set-up and
``bench.first_epoch``) against the plain reference (``program``: the lower
readings); the control, the reference in TF32 in the program's place
(``control``); and the fault of half the batch left out, planted in the
reference put in the program's place (``half_batch``), and a step that
returns its state unchanged (``state_unchanged``).  One JSON line a
seed, then the largest ``program`` and the smallest ``control`` and
fault's reading of each number.  The benchmark's runs do not run
this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from portbench import bench, check
from portbench.reference.common import full_float32
from portbench.registry import Registry


def readings(cell_name: str, seed: int, device, registry=None) -> dict:
    reg = registry or Registry()
    cell = reg.cell(cell_name)
    config = reg.config(cell["config"])
    wl = reg.family(config["family"]).Workload(config, cell, seed, device)
    wl.build()
    first = bench.first_epoch(wl)
    wl.free()
    gc.collect()
    out = {"seed": seed, "rows_ok": not wl.check_rows(first["rows"])}
    with full_float32():
        ref = wl.reference(first["rows"])
        out["program"] = check.numbers(first, ref)
        out["control"] = check.numbers(wl.reference(first["rows"], precision="tf32"), ref)
        out["half_batch"] = check.numbers(wl.reference(first["rows"], half_batch=True), ref)
        out["state_unchanged"] = check.numbers(wl.reference(first["rows"], frozen=True), ref)
    del wl
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def summary(rows) -> dict:
    out = {"lower": {k: max(r["program"][k] for r in rows) for k in check.NUMBERS}}
    for kind in ("control", "half_batch", "state_unchanged"):
        out[kind] = {k: min(r[kind][k] for r in rows) for k in check.NUMBERS}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.calibrate", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        rows.append(readings(args.workload, seed, torch.device("cuda", 0)))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"workload": args.workload, **summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
