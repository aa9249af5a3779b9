"""One run of one cell: set-up, the first epoch that the check follows,
the measured window, the traced slice, the check, and the result's line.

A run drives the port's ``Trainer.run_epoch`` on its captured whole-epoch
runner, epoch after epoch in a closed loop, over the batcher the family's
module builds (``families/<family>.py``).  The batcher is wrapped in a
``Feed``, which puts the benchmark's span around its per-epoch host call
(``epoch_schedule`` or ``epoch_scan_inputs``) and keeps the per-step inputs
it gave, from which the work counts of each step are worked out.

The first epoch from the seed is the check's (``first_epoch``): the same
trainer, state, runner and captured step that the window replays, called
as ``run_epoch`` calls it.  Its replays are split after step 1 and step
``CHECK_STEPS``, where the program's first gradient and its change are
read; its per-step costs and its state at the end are read after it.  The
window runs on from that state, and once it has closed, the peak memory
is read and the program is freed, the plain reference takes the same
steps on the same rows and ``check.py`` compares.
"""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from portbench import check, trace, work
from portbench.registry import Registry
from portbench.reference.common import full_float32, leaf_norm

CHECK_STEPS = 3
WARM_EPOCHS = 1  # a whole epoch after the check's: replays only, as in the window


class Feed:
    """The port's batcher as the Trainer takes it (every attribute passes
    through), with the per-epoch host call timed (``host_s``) and its
    per-step inputs kept (``inputs``)."""

    CALLS = ("epoch_schedule", "epoch_scan_inputs")

    def __init__(self, inner):
        self._inner = inner
        self.host_s: List[float] = []
        self.inputs: List[tuple] = []

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in self.CALLS:
            return attr

        def call(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function(f"portbench.data.{name}"):
                out = attr(*args, **kwargs)
            self.host_s.append(time.perf_counter() - t0)
            self.inputs.append(out if name == "epoch_schedule" else out[1])
            return out
        return call


def feed_for(batcher) -> Feed:
    """A Feed over ``batcher``; a scanned batcher's ``make_scan_batch``,
    which the Trainer looks up on the batcher's type, is passed on too."""
    attrs = {}
    if hasattr(type(batcher), "make_scan_batch"):
        attrs["make_scan_batch"] = staticmethod(type(batcher).make_scan_batch)
    return type(f"Fed{type(batcher).__name__}", (Feed,), attrs)(batcher)


def draw_weights(spec: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """Initial weights from ``seed``, drawn on ``device`` in one call:
    ``spec`` {leaf: (shape, init)}, init a uniform limit (a float),
    ``"zeros"`` or ``"ones"``."""
    sizes = {k: int(np.prod(shape)) for k, (shape, init) in spec.items()
             if not isinstance(init, str)}
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.empty(sum(sizes.values()), dtype=torch.float32,
                       device=device).uniform_(-1.0, 1.0, generator=gen)
    out, at = {}, 0
    for k, (shape, init) in spec.items():
        if init == "zeros":
            out[k] = torch.zeros(shape, dtype=torch.float32, device=device)
        elif init == "ones":
            out[k] = torch.ones(shape, dtype=torch.float32, device=device)
        else:
            out[k] = (flat[at:at + sizes[k]] * float(init)).view(shape)
            at += sizes[k]
    return out


def adam_mu(opt_state) -> Optional[dict]:
    """Adam's first moments in the program's optimizer state (optax's
    ``mu``, wherever the chain keeps it)."""
    if isinstance(opt_state, dict):
        if isinstance(opt_state.get("mu"), dict):
            return opt_state["mu"]
        for v in opt_state.values():
            found = adam_mu(v)
            if found is not None:
                return found
    return None


@contextlib.contextmanager
def _split_replays(read):
    """Within the block, a runner's run of ``n`` steps stops after step 1
    and after step ``CHECK_STEPS`` and calls ``read(steps done, runner)``
    there; the steps replayed, and their order, are the same."""
    from kgcn_tpu_torch.runtime import runner

    real = runner._Steps.run

    def run(steps, n):
        done = 0
        for stop in (1, CHECK_STEPS):
            if stop <= n:
                real(steps, stop - done)
                done = stop
                read(stop, steps.body.__self__)
        real(steps, n - done)

    runner._Steps.run = run
    try:
        yield
    finally:
        runner._Steps.run = real


def first_epoch(wl, log=lambda msg: None) -> dict:
    """The first epoch from the seed through the window's runner: the
    program's readings (see ``check.py``) and the rows the steps took
    (``rows``: the per-step inputs the feed gave, ``[S, ...]`` each)."""
    trainer, feed = wl.trainer, wl.feed
    before = {k: v.detach().clone() for k, v in wl.state.params.items()}
    out: dict = {"grad": {}, "delta": {}}

    def read(done, runner):
        if done == 1:
            mu = adam_mu(runner.opt) or {}
            out["grad"] = {k: leaf_norm(v) / (1.0 - check.ADAM_B1) for k, v in mu.items()}
        if done == CHECK_STEPS:
            out["delta"] = {k: leaf_norm(runner.params[k] - before[k]) for k in before}

    feed.inputs.clear()
    t0 = time.perf_counter()
    with _split_replays(read):
        state, costs, _ = trainer.epoch_on_device(wl.state, feed, **wl.epoch_kwargs(0))
    out["loss"] = [float(c) for c in costs.cpu()]
    log(f"first epoch: {len(out['loss'])} steps, {time.perf_counter() - t0:.3f} s")
    out["epoch_delta"] = {k: leaf_norm(state.params[k] - before[k]) for k in before}
    out["epoch_mu"] = {k: leaf_norm(v) for k, v in (adam_mu(state.opt_state) or {}).items()}
    out["rows"] = feed.inputs[-1]
    feed.inputs.clear()
    wl.state = state
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Context:
    """What a per-layer metric's reader gets: the configuration and cell,
    the end-to-end rate the cell reports (``rate``), the card's name and
    peaks, the window's seconds and per-step work
    (``window_steps``), the traced slice (``trace``, a ``trace.Trace``, and
    its steps ``traced_steps``), the data layer's host seconds an epoch
    (``data_host_s``) and the family's constant stats (``graph``)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool, device,
             started: float, registry: Optional[Registry] = None,
             log=lambda msg: print(msg, file=sys.stderr)) -> dict:
    """One run; returns the result's line as a dict (``checks`` last)."""
    reg = registry or Registry()
    cell = reg.cell(cell_name)
    config = reg.config(cell["config"])
    wl = reg.family(config["family"]).Workload(config, cell, seed, device)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    marks = [("start", time.perf_counter())]
    wl.build()
    marks.append(("data, program and weights", time.perf_counter()))
    first = first_epoch(wl, log)
    marks.append(("the check's epoch", time.perf_counter()))
    epoch = 1
    for _ in range(WARM_EPOCHS):
        wl.state = wl.trainer.run_epoch(wl.state, wl.feed, **wl.epoch_kwargs(epoch))[0]
        epoch += 1
    _sync(dev)
    marks.append(("warm-up epoch", time.perf_counter()))
    setup_s = marks[-1][1] - started
    log(f"set-up {setup_s:.3f} s: imports {marks[0][1] - started:.3f} s, " + ", ".join(
        f"{name} {t - marks[i][1]:.3f} s" for i, (name, t) in enumerate(marks[1:])))

    feed = wl.feed
    feed.host_s.clear()
    feed.inputs.clear()
    steps = items = failed = 0
    epoch_s = []
    t0 = time.perf_counter()
    while True:
        te = time.perf_counter()
        wl.state, cost, _, _ = wl.trainer.run_epoch(wl.state, feed, **wl.epoch_kwargs(epoch))
        epoch_s.append(time.perf_counter() - te)
        n = len(feed.inputs[-1][0])
        steps += n
        items += wl.items_per_epoch
        failed += 0 if math.isfinite(cost) else n
        epoch += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    window_steps = [s for xs in feed.inputs for s in wl.step_stats(xs)]
    data_host_s = list(feed.host_s)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    log(f"window {window_s:.4f} s: {steps} steps, {items} {wl.rate[1].split('/')[0]}; "
        f"epochs {len(epoch_s)}, s an epoch min {min(epoch_s):.4f} median "
        f"{statistics.median(epoch_s):.4f} max {max(epoch_s):.4f}")

    tr, traced_steps = None, []
    if traced:
        feed.inputs.clear()

        def slice_():
            nonlocal epoch
            for _ in range(int(config.get("trace_epochs", 2))):
                wl.state = wl.trainer.run_epoch(wl.state, feed, **wl.epoch_kwargs(epoch))[0]
                epoch += 1
        tr = trace.record(slice_, lambda: _sync(dev)) if dev.type == "cuda" else None
        traced_steps = [s for xs in feed.inputs for s in wl.step_stats(xs)]

    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    graph_stats = wl.graph_stats()
    wl.free()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    problems = wl.check_rows(first["rows"])
    t0 = time.perf_counter()
    with full_float32():
        ref = wl.reference(first["rows"])
    log(f"check: the reference's {len(ref['loss'])} steps {time.perf_counter() - t0:.3f} s")
    nums = check.numbers(first, ref)
    limits = cell["limits"]
    correct = not problems and failed == 0 and check.verdict(nums, limits)
    for p in problems:
        log(f"check: {p}")

    if traced:
        ctx = Context(config=config, cell=cell, rate=wl.rate[0], kind=kind,
                      peaks=work.peaks(kind),
                      window_s=window_s, window_steps=window_steps, trace=tr,
                      traced_steps=traced_steps, data_host_s=data_host_s, graph=graph_stats)
        metrics = {}
        for name, moves in reg.per_layer().items():
            if moves != wl.rate[0]:
                continue  # a metric of the cells that report another rate
            mod = reg.metric(name)
            value = mod.read(ctx)
            if value is not None:
                metrics[name] = {"value": float(value), "unit": mod.UNIT}
    else:
        metrics = {wl.rate[0]: {"value": items / window_s, "unit": wl.rate[1]},
                   "peak_mem_gib": {"value": peak / 2**30, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
    result = {"correct": bool(correct), "attempted": steps, "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if dev.type == "cuda" else dev.type,
                         "kind": kind,
                         "count": 1 if dev.type == "cuda" else 0,
                         "memory_peak_bytes": int(peak)}}
    if traced and tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.span_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["checks"] = {k: {"value": nums[k] if math.isfinite(nums[k]) else None,
                            "limit": limits[k]} for k in limits}
    if data_host_s:
        log(f"data host ms an epoch: median {statistics.median(data_host_s) * 1e3:.3f}")
    return result
