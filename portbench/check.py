"""The comparison that decides ``correct``: the program's first epoch,
taken by the window's own runner, against the plain reference's steps from
the same weights on the same rows.

Readings (both sides): ``loss``, each step's summed loss; ``grad``, each
leaf's norm of the first gradient (the program's worked out from its Adam
state after step 1, ``m₁ / (1 − β₁)``); ``delta``, each leaf's norm of
the parameters' change over the first ``CHECK_STEPS`` steps;
``epoch_delta``, the same over the whole epoch; ``epoch_mu``, each leaf's
norm of Adam's first moment after the epoch.  The numbers:

* ``loss1``, ``loss3``, ``loss``: the largest relative gap of a step's
  loss over step 1, the first three steps and the whole epoch;
* ``grad``: the worst leaf's gap between the two norms, over the larger of
  the reference's norm of that leaf and of the median leaf; ``grad_median``:
  the median leaf's gap;
* ``delta``, ``epoch_delta``, ``epoch_mu``: the same over the leaves whose
  reference gradient is at least ``MOVED`` of the median leaf's (a leaf
  whose gradient is nought to rounding, as a bias before a batch norm,
  moves under Adam by round-off alone); ``delta_median``,
  ``epoch_delta_median``, ``epoch_mu_median``: the median of those
  leaves' gaps.

A cell compares the numbers its file gives limits for (``limits``), each
set between the readings that ``calibrate.py`` takes of the program and of
the control and the faults (PERF.md §4 gives them).
"""
from __future__ import annotations

import math
import statistics
from typing import Dict

NORMS = ("grad", "delta", "epoch_delta", "epoch_mu")
NUMBERS = ("loss1", "loss3", "loss",
           *(f"{n}{s}" for n in NORMS for s in ("", "_median")))
MOVED = 1e-3
ADAM_B1 = 0.9  # the configurations' optimizer: optax.adam's defaults


def _gap(a: float, b: float, base: float) -> float:
    g = abs(a - b) / max(base, 1e-30)
    return g if math.isfinite(g) else math.inf  # a NaN never passes


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The compared numbers of two sets of readings (see the module
    docstring); a missing or non-finite reading gives ``inf``."""
    out = {k: math.inf for k in NUMBERS}
    if (len(prog["loss"]) != len(ref["loss"]) or not ref["loss"]
            or any(set(prog[n]) != set(ref[n]) for n in NORMS)):
        return out
    losses = [_gap(a, b, abs(b)) for a, b in zip(prog["loss"], ref["loss"])]
    out.update(loss1=losses[0], loss3=max(losses[:3]), loss=max(losses))
    median_g = statistics.median(ref["grad"].values())
    for n in NORMS:
        keep = [k for k in ref[n] if n == "grad" or ref["grad"][k] >= MOVED * median_g]
        if not keep:
            continue
        median = statistics.median(ref[n][k] for k in keep)
        gaps = [_gap(prog[n][k], ref[n][k], max(ref[n][k], median)) for k in keep]
        out[n], out[f"{n}_median"] = max(gaps), statistics.median(gaps)
    return out


def verdict(nums: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number the cell compares is within its limit."""
    return bool(limits) and all(nums[k] <= limits[k] for k in limits)
