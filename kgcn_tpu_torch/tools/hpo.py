"""Bayesian hyper-parameter optimisation — the port's copy of
``kgcn_tpu/tools/hpo.py`` (reference: ``kgcn-opt``, opt_hyperparam.py:26-199,
GPyOpt over a JSON domain).

A self-contained Gaussian-process expected-improvement loop in NumPy (RBF
kernel, EI over random candidates) with the reference's domain JSON format
(``name`` / ``type`` continuous|discrete / ``domain`` / ``data_type``), so
``example_param`` files work unchanged.  Every draw is ``kgcn_tpu``'s: the
same ``RandomState`` calls in the same order, the same EI (``np.vectorize``
of ``math.erf``) and the same clamping of non-finite values, so a seeded
search proposes the same points in both packages.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List

import numpy as np


class Domain:
    """Reference-format search-space definition."""

    def __init__(self, spec: List[Dict]):
        self.spec = spec

    @classmethod
    def from_json(cls, path: str) -> "Domain":
        with open(path) as f:
            return cls(json.load(f))

    def sample(self, rng: np.random.RandomState) -> np.ndarray:
        """One point in normalised [0,1]^d coordinates."""
        return rng.random_sample(len(self.spec))

    def decode(self, u: np.ndarray) -> Dict:
        """Normalised coords → param dict with reference typing rules."""
        out = {}
        for ui, d in zip(u, self.spec):
            dom = d["domain"]
            if d["type"] == "discrete":
                val = dom[min(int(ui * len(dom)), len(dom) - 1)]
            else:
                lo, hi = float(dom[0]), float(dom[-1])
                val = lo + ui * (hi - lo)
            if d.get("data_type") == "int":
                val = int(round(val))
            out[d["name"]] = val
        return out


def _rbf(a: np.ndarray, b: np.ndarray, ls: float = 0.2) -> np.ndarray:
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    return np.exp(-0.5 * d2 / ls**2)


class GPOptimizer:
    """Minimise f over the domain with GP + expected improvement."""

    def __init__(self, domain: Domain, seed: int = 0, noise: float = 1e-4,
                 n_candidates: int = 512):
        self.domain = domain
        self.rng = np.random.RandomState(seed)
        self.noise = noise
        self.n_candidates = n_candidates
        self.X: List[np.ndarray] = []
        self.y: List[float] = []

    def suggest(self) -> np.ndarray:
        if len(self.X) < 3:  # bootstrap with random points
            return self.domain.sample(self.rng)
        X = np.stack(self.X)
        y = np.asarray(self.y)
        # diverged trials report inf/NaN (e.g. NAS on a bad learning rate);
        # a single such value would poison the GP normalisation and turn EI
        # into all-NaN (argmax→0: silent random search).  Clamp them to a
        # finite "very bad" score instead.
        finite = np.isfinite(y)
        if not finite.all():
            worst = y[finite].max() if finite.any() else 0.0
            span = (y[finite].max() - y[finite].min()) if finite.any() else 1.0
            y = np.where(finite, y, worst + max(span, 1.0))
        mu_y, sd_y = y.mean(), y.std() + 1e-9
        yn = (y - mu_y) / sd_y
        K = _rbf(X, X) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
        cand = self.rng.random_sample((self.n_candidates, X.shape[1]))
        Ks = _rbf(cand, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.clip(1.0 - (v**2).sum(axis=0), 1e-12, None)
        sd = np.sqrt(var)
        best = yn.min()
        z = (best - mu) / sd
        # expected improvement (minimisation)
        from math import erf

        cdf = 0.5 * (1.0 + np.vectorize(erf)(z / np.sqrt(2.0)))
        pdf = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
        ei = sd * (z * cdf + pdf)
        return cand[int(np.argmax(ei))]

    def suggest_batch(self, k: int) -> List[np.ndarray]:
        """Constant-liar batch acquisition: propose k points for one
        parallel round.  After each suggestion the point is provisionally
        observed at the current best ("lie"), pushing the next EI maximum
        away from it — diverse batches without a joint q-EI integral.  The
        lies are removed before returning."""
        lie = float(np.nanmin(self.y)) if self.y else 0.0
        if not np.isfinite(lie):
            lie = 0.0
        pts: List[np.ndarray] = []
        for _ in range(max(int(k), 1)):
            u = self.suggest()
            pts.append(u)
            self.observe(u, lie)
        del self.X[-len(pts):]
        del self.y[-len(pts):]
        return pts

    def observe(self, u: np.ndarray, value: float) -> None:
        self.X.append(np.asarray(u))
        self.y.append(float(value))

    @property
    def best(self):
        y = np.asarray(self.y, dtype=np.float64)
        y = np.where(np.isfinite(y), y, np.inf)  # NaN would win argmin
        i = int(np.argmin(y))
        return self.domain.decode(self.X[i]), self.y[i]


def optimize(
    objective: Callable[[Dict], float],
    domain: Domain,
    max_iter: int = 20,
    seed: int = 0,
    log: Callable[[str], None] = print,
):
    """Run the BO loop; returns (best_params, best_value, history)."""
    opt = GPOptimizer(domain, seed=seed)
    history = []
    for it in range(max_iter):
        u = opt.suggest()
        params = domain.decode(u)
        value = float(objective(params))
        opt.observe(u, value)
        history.append({"iteration": it, "params": params, "value": value})
        log(f"[opt] iter {it}: value={value:.6g} params={params}")
    best_params, best_value = opt.best
    return best_params, best_value, history


def optimize_parallel(
    objective_batch: Callable[[List[Dict]], List[float]],
    domain: Domain,
    max_iter: int = 20,
    batch: int = 4,
    seed: int = 0,
    log: Callable[[str], None] = print,
):
    """Batch BO: ceil(max_iter/batch) rounds of `batch` constant-liar
    proposals, each round's values from ``objective_batch`` (in
    ``kgcn_tpu`` one trial per device, ``tools/parallel_trials.py``; the
    port's trial pool comes with its parallel layer).  Same trial budget and
    history schema as ``optimize``."""
    opt = GPOptimizer(domain, seed=seed)
    history = []
    it = 0
    while it < max_iter:
        k = min(batch, max_iter - it)
        us = opt.suggest_batch(k)
        param_sets = [domain.decode(u) for u in us]
        values = objective_batch(param_sets)
        for u, params, value in zip(us, param_sets, values):
            opt.observe(u, float(value))
            history.append({"iteration": it, "params": params,
                            "value": float(value)})
            log(f"[opt] iter {it}: value={float(value):.6g} "
                f"params={params}")
            it += 1
    best_params, best_value = opt.best
    return best_params, best_value, history
