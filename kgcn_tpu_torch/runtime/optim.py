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
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List

import torch

Tensors = Dict[str, torch.Tensor]


class Transform:
    def __init__(self, init: Callable, update: Callable):
        self.init = init
        self.update = update


def _zeros_like(params: Tensors) -> Tensors:
    return {k: torch.zeros_like(v) for k, v in params.items()}


def _count(params: Tensors) -> torch.Tensor:
    """Step counters live on the host, so no step waits on the device."""
    return torch.zeros((), dtype=torch.int32)


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

    def update(grads, state, params):
        count = state["count"] + 1
        c1, c2 = _bias_correction(b1, count), _bias_correction(b2, count)
        mu, nu, out = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1 - b2) * g * g + b2 * state["nu"][k]
            out[k] = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + eps)
        return out, {"count": count, "mu": mu, "nu": nu}
    return Transform(init, update)


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


def scale_by_trust_ratio() -> Transform:
    """LAMB's per-tensor ``‖p‖ / ‖u‖`` (1 where either norm is 0)."""
    def update(grads, state, params):
        out = {}
        for k, u in grads.items():
            p_norm = torch.linalg.vector_norm(params[k])
            u_norm = torch.linalg.vector_norm(u)
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
    return Transform(init, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    def update(grads, state, params):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
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
    return Transform(init, update)


def multi_steps(inner: Transform, every_k: int) -> Transform:
    """optax.MultiSteps: average ``every_k`` micro-batch gradients, apply the
    inner transform on the last, emit zero updates on the others."""
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
    return Transform(init, update)


def make_optimizer(config: Dict[str, Any]) -> Transform:
    """The configured chain (clip → decay → optimizer), as
    ``kgcn_tpu.runtime.optim.make_optimizer`` builds it with optax."""
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
                     scale_by_trust_ratio(), scale_by_learning_rate(lr)]
        wd = 0.0
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    parts = []
    clip = config.get("gradient_clip")
    if clip:
        parts.append(clip_by_global_norm(float(clip)))
    if wd:
        parts.append(add_decayed_weights(wd))
    tx = chain(*parts, chain(*opt_parts))
    accum = int(config.get("grad_accum_steps") or 1)
    if accum > 1:
        tx = multi_steps(tx, accum)
    return tx
