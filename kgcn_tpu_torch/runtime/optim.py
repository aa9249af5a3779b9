"""Optimizers and learning-rate schedules — the port's own copy of
``kgcn_tpu/runtime/optim.py``, written as small transforms over dicts of
tensors so that every update is the one optax 0.2.6 makes (``torch.optim``
differs: its RMSprop decays by 0.99 and adds eps outside the root, its
AdamW decays before the Adam scaling, its LAMB does not exist).

A transform has ``init(params) -> state`` and
``update(grads, state, params) -> (updates, state)``; states are nested
dicts of tensors (they go into checkpoints as they are) and updates are
added to the parameters.  Config keys as in ``kgcn_tpu``:

* ``optimizer``: adam (default) | adamw | sgd | momentum | rmsprop | lamb
* ``lr_schedule``: constant (default) | cosine | warmup_cosine | exponential,
  with ``warmup_steps``, ``decay_steps`` (10 000) and ``decay_rate`` (0.96)
* ``gradient_clip`` (global norm), ``weight_decay`` (decoupled),
  ``grad_accum_steps`` (optax.MultiSteps, mean of the micro-batch grads)

The chain order is clip → decay → optimizer, as there.

A run whose steps are replayed from one captured CUDA graph
(``runtime/runner.py``) cannot read the host step counts: a Python number
is frozen into the graph at capture.  So each transform also says which of
its numbers come from its counts (``width`` of them a step): ``table(state,
n)`` computes them on the host for the next ``n`` steps, with the same
float32 arithmetic as ``update`` (``[n, width]``); ``update_row`` is the
update with them read from a row of that table (tensors on the device), the
counts left as they are; ``advance(state, n)`` moves the counts on by ``n``
steps afterwards.  ``update`` itself is unchanged.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


class Transform:
    """``init``/``update`` as optax's; ``width``, ``table``, ``update_row``
    and ``advance`` for replayed steps (module docstring).  A transform
    whose update reads no count needs none of them: its ``update_row`` is
    its ``update``."""

    def __init__(self, init: Callable, update: Callable, *, width: int = 0,
                 table: Callable = None, update_row: Callable = None,
                 advance: Callable = None):
        self.init = init
        self.update = update
        self.width = width
        self.table = table or (lambda state, n: np.zeros((n, 0), np.float32))
        self.update_row = update_row or (
            lambda grads, state, params, row: update(grads, state, params))
        self.advance = advance or (lambda state, n: state)


def _zeros_like(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _count(params: Tensors) -> torch.Tensor:
    """Step counters live on the host, so no step waits on the device."""
    return torch.zeros((), dtype=torch.int32)


def _div(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` as the eager update computes it with a Python number ``c``:
    on the card PyTorch multiplies by the float32 reciprocal of a host
    scalar, so a ``c`` from a table on the card does the same (a replayed
    step then gives the eager step's bits); elsewhere a true division."""
    if isinstance(c, torch.Tensor) and c.is_cuda:
        return x * torch.reciprocal(c)
    return x / c


def _bias_correction(decay: float, count: torch.Tensor) -> float:
    """``1 - decay**count`` in float32, as optax computes it."""
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** count.float())


# ---- schedules (step count → learning rate, as optax.schedules) ----------


def _linear(init: float, end: float, steps: int):
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, decay_steps: int, alpha: float = 0.0):
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs positive decay_steps, got {decay_steps}")

    def schedule(count):
        count = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return init * ((1 - alpha) * cosine + alpha)
    return schedule


def _exponential(init: float, transition_steps: int, decay_rate: float):
    if transition_steps <= 0 or decay_rate == 0:
        return lambda count: init

    def schedule(count):
        if count <= 0:
            return init
        return init * decay_rate ** (count / transition_steps)
    return schedule


def make_schedule(config: Dict[str, Any]):
    """The learning rate: a float, or a function of the step count."""
    lr = float(config.get("learning_rate", 1e-3))
    kind = str(config.get("lr_schedule", "constant"))
    decay_steps = int(config.get("decay_steps", 10_000))
    if kind == "constant":
        return lr
    if kind == "cosine":
        return _cosine(lr, decay_steps)
    if kind == "warmup_cosine":
        warmup = int(config.get("warmup_steps", 0))
        warm, decay = _linear(0.0, lr, warmup), _cosine(lr, decay_steps - warmup)
        return lambda count: warm(count) if count < warmup else decay(count - warmup)
    if kind == "exponential":
        return _exponential(lr, decay_steps, float(config.get("decay_rate", 0.96)))
    raise ValueError(f"unknown lr_schedule {kind!r}")


# ---- transforms ----------------------------------------------------------


def scale_by_adam(b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    def init(params):
        return {"count": _count(params), "mu": _zeros_like(params),
                "nu": _zeros_like(params)}

    def moments(grads, state, c1, c2):
        mu, nu, out = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1 - b2) * g * g + b2 * state["nu"][k]
            out[k] = _div(mu[k], c1) / (torch.sqrt(_div(nu[k], c2)) + eps)
        return out, mu, nu

    def update(grads, state, params):
        count = state["count"] + 1
        out, mu, nu = moments(grads, state, _bias_correction(b1, count),
                              _bias_correction(b2, count))
        return out, {"count": count, "mu": mu, "nu": nu}

    def table(state, n):
        c0 = int(state["count"])
        rows = []
        for c in range(c0 + 1, c0 + n + 1):
            count = torch.tensor(c, dtype=torch.int32)
            rows.append((_bias_correction(b1, count), _bias_correction(b2, count)))
        return np.array(rows, np.float32).reshape(n, 2)

    def update_row(grads, state, params, row):
        out, mu, nu = moments(grads, state, row[0], row[1])
        return out, {"count": state["count"], "mu": mu, "nu": nu}

    def advance(state, n):
        return dict(state, count=state["count"] + n)
    return Transform(init, update, width=2, table=table, update_row=update_row,
                     advance=advance)


def scale_by_rms(decay=0.9, eps=1e-8) -> Transform:
    """optax.scale_by_rms with ``eps_in_sqrt=True``: ``g / √(ν + ε)``."""
    def init(params):
        return {"nu": _zeros_like(params)}

    def update(grads, state, params):
        nu = {k: (1 - decay) * g * g + decay * state["nu"][k] for k, g in grads.items()}
        return {k: torch.rsqrt(nu[k] + eps) * g for k, g in grads.items()}, {"nu": nu}
    return Transform(init, update)


def trace(decay: float) -> Transform:
    """Momentum: ``t ← g + decay·t``, the update is ``t``."""
    def init(params):
        return {"trace": _zeros_like(params)}

    def update(grads, state, params):
        t = {k: g + decay * state["trace"][k] for k, g in grads.items()}
        return t, {"trace": t}
    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(grads, state, params):
        return {k: g + weight_decay * params[k] for k, g in grads.items()}, state
    return Transform(lambda params: {}, update)


def scale_by_trust_ratio(sq_norms=None) -> Transform:
    """LAMB's per-tensor ``‖p‖ / ‖u‖`` (1 where either norm is 0).
    ``sq_norms``: see ``make_optimizer``."""
    def norms(tree):
        if sq_norms is None:
            return {k: torch.linalg.vector_norm(v) for k, v in tree.items()}
        return {k: torch.sqrt(v) for k, v in
                sq_norms({k: torch.sum(v * v) for k, v in tree.items()}).items()}

    def update(grads, state, params):
        out = {}
        p_norms, u_norms = norms(params), norms(grads)
        for k, u in grads.items():
            p_norm, u_norm = p_norms[k], u_norms[k]
            ratio = torch.where((p_norm == 0) | (u_norm == 0),
                                torch.ones_like(p_norm), p_norm / u_norm)
            out[k] = u * ratio
        return out, state
    return Transform(lambda params: {}, update)


def scale_by_learning_rate(lr) -> Transform:
    """``-lr`` times the update; a schedule reads its own step count."""
    if not callable(lr):
        return Transform(lambda params: {},
                         lambda grads, state, params: (
                             {k: -lr * g for k, g in grads.items()}, state))

    def init(params):
        return {"count": _count(params)}

    def update(grads, state, params):
        step = -float(lr(int(state["count"])))
        return ({k: step * g for k, g in grads.items()},
                {"count": state["count"] + 1})

    def table(state, n):
        c0 = int(state["count"])
        return np.array([-float(lr(c)) for c in range(c0, c0 + n)],
                        np.float32).reshape(n, 1)

    def update_row(grads, state, params, row):
        return {k: row[0] * g for k, g in grads.items()}, state

    def advance(state, n):
        return {"count": state["count"] + n}
    return Transform(init, update, width=1, table=table, update_row=update_row,
                     advance=advance)


def clip_by_global_norm(max_norm: float, sq_norms=None) -> Transform:
    """optax's clip by the global norm; ``sq_norms``: see
    ``make_optimizer``."""
    def update(grads, state, params):
        sq = {k: torch.sum(g * g) for k, g in grads.items()}
        if sq_norms is not None:
            sq = sq_norms(sq)
        norm = torch.sqrt(sum(sq.values()))
        keep = norm < max_norm
        return {k: torch.where(keep, g, (g / norm) * max_norm)
                for k, g in grads.items()}, state
    return Transform(lambda params: {}, update)


def chain(*parts: Transform) -> Transform:
    def init(params):
        return {str(i): p.init(params) for i, p in enumerate(parts)}

    def update(grads, state, params):
        new = {}
        for i, p in enumerate(parts):
            grads, new[str(i)] = p.update(grads, state[str(i)], params)
        return grads, new

    def table(state, n):
        return np.concatenate([np.zeros((n, 0), np.float32)] + [
            p.table(state[str(i)], n) for i, p in enumerate(parts)], axis=1)

    def update_row(grads, state, params, row):
        new, at = {}, 0
        for i, p in enumerate(parts):
            grads, new[str(i)] = p.update_row(grads, state[str(i)], params,
                                              row[at:at + p.width])
            at += p.width
        return grads, new

    def advance(state, n):
        return {str(i): p.advance(state[str(i)], n) for i, p in enumerate(parts)}
    return Transform(init, update, width=sum(p.width for p in parts), table=table,
                     update_row=update_row, advance=advance)


def _select(keep: torch.Tensor, new, old):
    """``new`` where ``keep`` else ``old``, leaf by leaf (leaves that are
    the same object, the host counts, stay as they are)."""
    if isinstance(new, dict):
        return {k: _select(keep, new[k], old[k]) for k in new}
    return old if new is old else torch.where(keep, new, old)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """optax.MultiSteps: average ``every_k`` micro-batch gradients, apply the
    inner transform on the last, emit zero updates on the others.  A
    replayed step computes the inner update every time and keeps it on the
    last micro-step only (its table's second column)."""
    def init(params):
        return {"mini_step": _count(params), "gradient_step": _count(params),
                "inner": inner.init(params), "acc": _zeros_like(params)}

    def update(grads, state, params):
        n = int(state["mini_step"])
        acc = {k: state["acc"][k] + (g - state["acc"][k]) / (n + 1)
               for k, g in grads.items()}
        if n == every_k - 1:
            updates, inner_state = inner.update(acc, state["inner"], params)
            return updates, {"mini_step": state["mini_step"] * 0,
                             "gradient_step": state["gradient_step"] + 1,
                             "inner": inner_state, "acc": _zeros_like(acc)}
        return ({k: torch.zeros_like(g) for k, g in grads.items()},
                {"mini_step": state["mini_step"] + 1,
                 "gradient_step": state["gradient_step"],
                 "inner": state["inner"], "acc": acc})

    def minis(state, n):
        m0 = int(state["mini_step"])
        return [(m0 + s) % every_k for s in range(n)]

    def table(state, n):
        ms = minis(state, n)
        inner_tab = inner.table(state["inner"], sum(m == every_k - 1 for m in ms) + 1)
        rows, done = [], 0  # done: the inner updates before step s
        for m in ms:
            rows.append(np.concatenate([[m + 1, float(m == every_k - 1)],
                                        inner_tab[done]]))
            done += m == every_k - 1
        return np.array(rows, np.float32).reshape(n, 2 + inner.width)

    def update_row(grads, state, params, row):
        acc = {k: state["acc"][k] + _div(g - state["acc"][k], row[0])
               for k, g in grads.items()}
        updates, inner_state = inner.update_row(acc, state["inner"], params, row[2:])
        keep = row[1] > 0
        return ({k: torch.where(keep, u, torch.zeros_like(u)) for k, u in updates.items()},
                dict(state, inner=_select(keep, inner_state, state["inner"]),
                     acc={k: torch.where(keep, torch.zeros_like(a), a)
                          for k, a in acc.items()}))

    def advance(state, n):
        ms = minis(state, n)
        done = sum(m == every_k - 1 for m in ms)
        return {"mini_step": torch.tensor((ms[-1] + 1) % every_k if n else int(
                    state["mini_step"]), dtype=torch.int32),
                "gradient_step": state["gradient_step"] + done,
                "inner": inner.advance(state["inner"], done), "acc": state["acc"]}
    return Transform(init, update, width=2 + inner.width, table=table,
                     update_row=update_row, advance=advance)


def make_optimizer(config: Dict[str, Any], sq_norms=None) -> Transform:
    """The configured chain (clip → decay → optimizer), as
    ``kgcn_tpu.runtime.optim.make_optimizer`` builds it with optax.
    ``sq_norms`` (``{name: Σx²}`` → the same, whole): for parameters
    that a rank holds in part (``parallel/tp.py``), the sums of squares of
    every leaf's whole tensor, for the global-norm clip and LAMB's trust
    ratio; None: each tensor is whole."""
    lr = make_schedule(config)
    name = str(config.get("optimizer", "adam")).lower()
    wd = float(config.get("weight_decay") or 0.0)
    opt_parts: List[Transform]
    if name in ("adam", "adamw"):
        # weight_decay on plain adam means adamw, as in kgcn_tpu
        opt_parts = [scale_by_adam()]
        if wd or name == "adamw":
            opt_parts.append(add_decayed_weights(wd))
        opt_parts.append(scale_by_learning_rate(lr))
        wd = 0.0
    elif name == "sgd":
        opt_parts = [scale_by_learning_rate(lr)]
    elif name == "momentum":
        opt_parts = [trace(float(config.get("momentum", 0.9))),
                     scale_by_learning_rate(lr)]
    elif name == "rmsprop":
        opt_parts = [scale_by_rms(), scale_by_learning_rate(lr)]
    elif name == "lamb":
        opt_parts = [scale_by_adam(eps=1e-6), add_decayed_weights(wd),
                     scale_by_trust_ratio(sq_norms), scale_by_learning_rate(lr)]
        wd = 0.0
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    parts = []
    clip = config.get("gradient_clip")
    if clip:
        parts.append(clip_by_global_norm(float(clip), sq_norms))
    if wd:
        parts.append(add_decayed_weights(wd))
    tx = chain(*parts, chain(*opt_parts))
    accum = int(config.get("grad_accum_steps") or 1)
    if accum > 1:
        tx = multi_steps(tx, accum)
    return tx
