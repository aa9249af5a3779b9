"""Whole-epoch runners — the counterpart of the JAX trainer's scanned epochs
(``kgcn_tpu/runtime/train.py:266-333`` train, ``:389-421`` evaluate), where
one ``jax.jit(lax.scan)`` dispatch runs a whole epoch.

In PyTorch the counterpart of that one dispatch is one captured CUDA graph
of ONE step, replayed for each step of the epoch.  A step reads its inputs
from static device buffers, indexed by a step counter on the device:

* ``TrainRunner``: the batch (built on the device from the epoch's
  per-step inputs: a resident batcher's schedule row, a KG epoch's label
  slice, a pair epoch's two towers' rows; with the VAE's reparameterisation
  noise drawn on the device), forward, backward and the optimizer update,
  written into static
  buffers of the parameters, BN statistics and optimizer state (in place,
  ``optim.Transform.apply_row``: for Adam and AdamW on float32 leaves one
  launch of the fused kernel, ``ops/adam.py``, from the plan the runner
  makes of its buffers once, ``Transform.plan``); the
  optimizer's per-step numbers (bias corrections, scheduled learning
  rates, which the eager update computes as Python floats from host step
  counts) come from a table computed on the host once an epoch
  (``optim.Transform.table``) and indexed by the counter; dropout and the
  VAE's noise draw from a generator registered with the graph, so each
  replay draws anew;
* ``EvalRunner``: the batch and the forward, predictions (a tensor, or a
  dict of them: the VAE's ``feature`` and ``dense_adj``) and costs written
  per step.

The state is copied into the buffers at the start of an epoch and out at
its end; costs and metrics stay on the device for one read by the caller.
Nothing in a step reads the device from the host, and nothing in an epoch
synchronises with it (the per-epoch inputs go in by non-blocking copies
from pinned memory).

On the CPU, and on the card with ``capture=False``, the same step runs
eagerly, step by step.  A capture that fails raises with the reason; it
never runs eagerly in its place.  The kernels' launch counters count the
launches of the warm-up and of the capture only: a replay launches from
the graph.  An epoch's phases (the load, the optimizer's table, the
replays, the copy-out) and the capture are named spans of a profiler's
trace (``runtime/spans.py``), none of them inside the loop of steps.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from kgcn_tpu_torch.runtime.optim import copy_into
from kgcn_tpu_torch.runtime.spans import span

WARMUP_STEPS = 2  # eager steps on the capture stream before the capture
# one capture stream a device: cuBLAS keeps a workspace for each stream it
# has run on, for the life of the process, so a new stream a capture would
# hold one more workspace for every runner a process makes (HPO and NAS
# make one a trial)
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def capture_stream(device: torch.device) -> "torch.cuda.Stream":
    """The side stream every capture on ``device`` runs on."""
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _own_tree(tree, device):
    """A copy of an optimizer state: its floating tensors on ``device``, the
    host step counts copied on the host (never shared with the caller's
    state, which ``copy_into`` would otherwise overwrite)."""
    if isinstance(tree, dict):
        return {k: _own_tree(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device).clone() if tree.dtype.is_floating_point \
            else tree.clone()
    return tree


def _upload(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Copy a host array into a device buffer: from pinned memory without
    blocking on the card, or a plain copy on the CPU."""
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class _Packed:
    """Host arrays of fixed shapes and types kept in ONE device buffer
    (16-byte aligned views ``views``), refilled by one copy (``fill``)."""

    def __init__(self, arrays: Sequence[np.ndarray], device):
        self.offsets, at = [], 0
        for a in arrays:
            self.offsets.append(at)
            at += -(-a.nbytes // 16) * 16
        self.host = np.zeros(max(at, 16), np.uint8)
        self.buf = torch.empty(self.host.shape, dtype=torch.uint8, device=device)
        self.views = tuple(
            self.buf[o:o + a.nbytes].view(getattr(torch, a.dtype.name)).view(a.shape)
            for o, a in zip(self.offsets, arrays))

    def fill(self, arrays: Sequence[np.ndarray]) -> None:
        for o, a, v in zip(self.offsets, arrays, self.views):
            if tuple(a.shape) != tuple(v.shape) or a.dtype.name != str(v.dtype)[6:]:
                raise ValueError(f"per-step input {a.dtype}{a.shape} does not fit "
                                 f"its buffer {v.dtype}{tuple(v.shape)}")
            self.host[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
        _upload(self.buf, self.host)


class _Steps:
    """A step body run ``n`` times: eagerly, or, with ``capture``, captured
    once into a CUDA graph (after ``WARMUP_STEPS`` eager steps on the
    capture stream, each from step 0: ``reset``) and replayed.
    ``generator``: the CUDA generator the body draws from, registered with
    the graph; ``kind``: ``"train"`` or ``"eval"``, which names the
    capture's span."""

    def __init__(self, body: Callable[[], None], reset: Callable[[], None],
                 device: torch.device, capture: bool,
                 generator: Optional[torch.Generator], kind: str):
        self.body = body
        self.reset = reset
        self.device = device
        self.capture = capture
        self.generator = generator
        self.kind = kind
        self.graph = None

    def _capture(self) -> None:
        dev = self.device
        side = capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with span(f"{self.kind}.capture"), torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.reset()
                self.body()
            self.reset()
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None:
                graph.register_generator_state(self.generator)
            graph.capture_begin()
            try:
                self.body()
            except BaseException as e:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is invalid already; report the cause
                raise RuntimeError(
                    f"capturing the {self.kind} step into a CUDA graph failed: "
                    f"{type(e).__name__}: {e}") from e
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = graph

    def prepare(self) -> None:
        """Capture now if this runner captures and has not yet (the warm-up
        steps write the buffers, so the caller loads them afterwards)."""
        if self.capture and self.graph is None:
            self._capture()

    def run(self, n: int) -> None:
        for _ in range(n):
            if self.capture:
                self.graph.replay()
            else:
                self.body()


def _named(prediction) -> Dict[Optional[str], torch.Tensor]:
    """A prediction as ``{name: tensor}``: a dict as it is, a tensor under
    the name None."""
    return prediction if isinstance(prediction, dict) else {None: prediction}


class _Runner:
    """What the train and eval runners share: the per-step inputs ``xs``
    (static device buffers ``[S, ...]``, refilled each epoch), the step
    counter, the recorded costs, metrics and predictions, and the parameter
    and statistics buffers.  ``make_batch(i, xs, generator)`` builds step
    ``i``'s batch on the device; ``generator`` is the train runner's (the
    eval runner passes None)."""

    def __init__(self, trainer, n_steps: int,
                 make_batch: Callable[..., object],
                 xs: Sequence[np.ndarray], keep_alive=None):
        self.trainer = trainer
        self.device = trainer.device
        self.n_steps = int(n_steps)
        self.make_batch = make_batch
        self.keep_alive = keep_alive  # the device data the graph reads
        self._xs = _Packed(xs, self.device)
        self.xs = self._xs.views
        self.i = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.costs = None
        self.metrics: Optional[Dict[str, torch.Tensor]] = None
        self.preds: Optional[Dict[Optional[str], torch.Tensor]] = None
        self.params: Dict[str, torch.Tensor] = {}
        self.stats: Dict[str, torch.Tensor] = {}

    def _record(self, i, cost_sum, metrics, prediction=None) -> None:
        """Write step ``i``'s outputs into the per-step buffers (made at
        the first, eager step)."""
        if self.costs is None:
            S, dev = self.n_steps, self.device
            self.costs = torch.zeros(S, dtype=torch.float32, device=dev)
            self.metrics = {k: torch.zeros((S, *v.shape), dtype=v.dtype, device=dev)
                            for k, v in metrics.items()}
            if prediction is not None:
                self.preds = {k: torch.zeros((S, *v.shape), dtype=v.dtype, device=dev)
                              for k, v in _named(prediction).items()}
        self.costs.index_copy_(0, i, cost_sum.detach().reshape(1).to(torch.float32))
        for k, v in metrics.items():
            self.metrics[k].index_copy_(0, i, v.detach()[None])
        if prediction is not None:
            for k, v in _named(prediction).items():
                self.preds[k].index_copy_(0, i, v.detach()[None])

    def _load(self, xs: Sequence[np.ndarray], params, stats) -> None:
        self._xs.fill(xs)
        for k, v in params.items():
            self.params[k].copy_(v)
        for k, v in stats.items():
            self.stats[k].copy_(v)
        self.i.zero_()

    def _batch(self, generator=None):
        i = self.i
        return i, self.make_batch(i, self.xs, generator)


class TrainRunner(_Runner):
    """``n_steps`` training steps an epoch over per-step inputs ``xs``
    (each ``[S, ...]``); ``make_batch(i, xs)`` builds step ``i``'s batch
    on the device.  ``run(state, xs)`` → (state after the epoch, costs
    ``[S]``, metrics ``{name: [S, ...]}`` on the device)."""

    def __init__(self, trainer, n_steps, make_batch, xs, keep_alive=None):
        super().__init__(trainer, n_steps, make_batch, xs, keep_alive)
        self.opt = None
        self.table = None
        self.plan = None  # the optimizer's plan of the static buffers (Transform.plan)
        self.fused_leaves = 0  # the leaves the last step's fused update launch took
        self.gen = torch.Generator(device=self.device)
        self.names = None
        self.steps = _Steps(self._body, self.i.zero_, self.device, trainer.capture,
                            self.gen, "train")

    def _body(self) -> None:
        t = self.trainer
        i, batch = self._batch(self.gen)
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        out = t.apply(leaves, self.stats, batch, train=True, generator=self.gen)
        grads = torch.autograd.grad(out.cost_opt, [leaves[k] for k in self.names],
                                    allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(self.names, grads)}
        grads, cost_sum, metrics = t.reduce_step(grads, self.stats, out.cost_sum,
                                                 out.metrics)
        t.check_finite(out.cost_opt, grads)  # debug_nan only (eager steps)
        with torch.no_grad():
            row = self.table.index_select(0, i)[0]
            self.fused_leaves = t.tx.apply_row(grads, self.opt, self.params, row,
                                               self.plan)
            self._record(i, cost_sum, metrics)
            i.add_(1)

    def run(self, state, xs: Sequence[np.ndarray]):
        t, S = self.trainer, self.n_steps
        with span("train.table"):
            table = t.tx.table(state.opt_state, S)
        if self.opt is None:  # the static buffers, from the first state
            self.names = list(state.params)
            self.params = {k: v.detach().clone() for k, v in state.params.items()}
            self.stats = {k: v.detach().clone() for k, v in state.batch_stats.items()}
            self.opt = _own_tree(state.opt_state, self.device)
            self.plan = t.tx.plan(self.opt, self.params)
            self.table = torch.zeros(table.shape, dtype=torch.float32, device=self.device)
            _upload(self.table, table)
            self._xs.fill(xs)
            self.steps.prepare()
        with span("train.load"):
            self._load(xs, state.params, state.batch_stats)
            copy_into(self.opt, state.opt_state)
            _upload(self.table, table)
            if state.rng is not None:
                self.gen.set_state(state.rng.get_state())
        with span("train.replay"):
            self.steps.run(S)
        with span("train.unload"):
            if state.rng is not None:
                state.rng.set_state(self.gen.get_state())
            new = type(state)(
                params={k: v.clone() for k, v in self.params.items()},
                batch_stats={k: v.clone() for k, v in self.stats.items()},
                opt_state=t.tx.advance(_own_tree(self.opt, self.device), S),
                step=state.step + S, rng=state.rng, epoch=state.epoch)
            return new, self.costs.clone(), {k: v.clone() for k, v in self.metrics.items()}


class EvalRunner(_Runner):
    """``n_steps`` evaluation steps over per-step inputs ``xs``:
    ``run(params, batch_stats, xs)`` → (predictions ``{name: [S, B, ...]}``,
    a tensor prediction under the name None, costs ``[S]``, metrics
    ``{name: [S, ...]}``) on the device."""

    def __init__(self, trainer, n_steps, make_batch, xs, keep_alive=None):
        super().__init__(trainer, n_steps, make_batch, xs, keep_alive)
        self.steps = _Steps(self._body, self.i.zero_, self.device, trainer.capture,
                            None, "eval")

    @torch.no_grad()
    def _body(self) -> None:
        i, batch = self._batch()
        out = self.trainer.apply(self.params, self.stats, batch, train=False)
        self._record(i, out.cost_sum, out.metrics, out.prediction)
        i.add_(1)

    def run(self, params, batch_stats, xs: Sequence[np.ndarray]):
        if self.steps.graph is None and self.costs is None:  # the first run
            self.params = {k: v.detach().clone() for k, v in params.items()}
            self.stats = {k: v.detach().clone() for k, v in batch_stats.items()}
            self._xs.fill(xs)
            self.steps.prepare()
        with span("eval.load"):
            self._load(xs, params, batch_stats)
        with span("eval.replay"):
            self.steps.run(self.n_steps)
        return ({k: v.clone() for k, v in self.preds.items()}, self.costs.clone(),
                {k: v.clone() for k, v in self.metrics.items()})


def read_back(*tensors: torch.Tensor):
    """The tensors as NumPy arrays, copied from the device in ONE copy (one
    synchronisation): flattened into one float32 buffer, split on the host
    and cast back."""
    if not tensors:
        return []
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(t.shape).astype(
            str(t.dtype).replace("torch.", "")))
        at += n
    return out
