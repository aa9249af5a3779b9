"""Device timing by readback slope — the port's copy of
``kgcn_tpu/runtime/timing.py``.

A device-to-host copy of one element is the sync: the copy cannot finish
before the computation that produced it, on any device, so the timer does
not depend on what a backend's own wait call promises.  The cost of one
iteration is the two-point SLOPE between a short and a long run, which
cancels every fixed cost (launch, the readback itself); the long run is
doubled until its added work clearly dominates the jitter of those fixed
costs.  Run lengths shift by one per trial, as in ``kgcn_tpu``.

``chain_time`` iterates ``fn`` ``n`` times in a Python loop on the
tensor's device (one launch or more per step, queued without a sync): the
per-step time includes the host's launch cost where it exceeds the
kernel's, which is what a caller of ``fn`` pays.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.utils._pytree as pytree


def force(x) -> None:
    """Wait for ``x``'s computation through a one-element readback of its
    first tensor leaf."""
    leaves = [v for v in pytree.tree_leaves(x) if isinstance(v, torch.Tensor)]
    if not leaves:
        return
    leaf = leaves[0]
    if leaf.dim():
        leaf = leaf[(0,) * leaf.dim()]
    leaf.detach().cpu()


def slope_time(looped, args, iters, *, n1=None, trials=3):
    """Per-iteration seconds of ``looped(*args, n)`` (readback slope).

    ``args`` is a tuple of loop-invariant inputs; the iteration count n
    rides last.  Median of ``trials`` slopes, each between a short run and
    a long run grown until its added compute ≥ max(50 ms, the whole fixed
    base cost).
    """
    n1 = n1 if n1 is not None else max(iters // 4, 1)
    force(looped(*args, n1))  # warm
    t0 = time.perf_counter()
    force(looped(*args, n1 + 1))
    base = time.perf_counter() - t0
    n2 = max(iters, 2 * n1)
    for _ in range(14):
        t0 = time.perf_counter()
        force(looped(*args, n2))
        t_long = time.perf_counter() - t0
        # stop once the extra iterations cost >= max(50 ms, the whole
        # fixed base) — the slope is then signal, not jitter
        if t_long - base >= max(0.05, base):
            break
        n2 *= 2
    vals = []
    for k in range(trials):
        a, b = n1 + 1 + k, n2 + 1 + k
        t0 = time.perf_counter()
        force(looped(*args, a))
        t_short = time.perf_counter() - t0
        t0 = time.perf_counter()
        force(looped(*args, b))
        t_long = time.perf_counter() - t0
        vals.append((t_long - t_short) / (b - a))
    return max(float(np.median(vals)), 1e-12)


def chain_time(fn, x0, iters=1000):
    """Per-op seconds: ``fn`` applied ``n`` times in a row to its own
    output (a Python loop on ``x0``'s device, under ``torch.no_grad``),
    timed by the readback slope (see ``slope_time``)."""

    def looped(x, n):
        with torch.no_grad():
            for _ in range(n):
                x = fn(x)
        return x

    return slope_time(looped, (x0,), iters)
