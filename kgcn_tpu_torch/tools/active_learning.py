"""Active learning: the uncertainty-sampling loop — the port's copy of
``kgcn_tpu/tools/active_learning.py`` (reference: active_learning/
active_learning/models.py:18-343): an ``ActiveLearner`` with query
strategies (entropy / least-confidence / margin / random) over the
estimators LabelPropagation / LabelSpreading / SVC on fingerprint
features, and a query→teach loop.  The estimators are the port's copies of
scikit-learn 1.9.0's (``tools/estimators.py``), so a seeded loop queries
the same examples as ``kgcn_tpu``'s.
"""
from __future__ import annotations

import numpy as np


def entropy_sampling(probs: np.ndarray) -> np.ndarray:
    p = np.clip(probs, 1e-12, 1.0)
    return -(p * np.log(p)).sum(axis=1)


def least_confidence_sampling(probs: np.ndarray) -> np.ndarray:
    return 1.0 - probs.max(axis=1)


def margin_sampling(probs: np.ndarray) -> np.ndarray:
    if probs.shape[1] < 2:
        # single-class fit (possible when the labeled pool starts one-class):
        # no margin exists — fall back to least-confidence
        return least_confidence_sampling(probs)
    part = np.sort(probs, axis=1)
    return -(part[:, -1] - part[:, -2])  # small margin → high uncertainty


STRATEGIES = {
    "entropy": entropy_sampling,
    "least_confidence": least_confidence_sampling,
    "margin": margin_sampling,
}


def make_estimator(name: str = "label_propagation", **kw):
    """Reference estimator zoo (models.py): label_propagation /
    label_spreading / svc."""
    from kgcn_tpu_torch.tools.estimators import SVC, LabelPropagation, LabelSpreading

    if name == "label_propagation":
        return LabelPropagation(**kw)
    if name == "label_spreading":
        return LabelSpreading(**kw)
    if name == "svc":
        kw.setdefault("probability", True)
        kw.setdefault("random_state", 0)  # Platt scaling uses the RNG
        return SVC(**kw)
    raise KeyError(name)


class ActiveLearner:
    """query/teach loop (reference: ActiveLearner, models.py:18-120)."""

    def __init__(self, estimator, X_pool: np.ndarray,
                 strategy: str = "entropy", seed: int = 0):
        self.estimator = estimator
        self.X_pool = np.asarray(X_pool)
        self.strategy = strategy
        self.rng = np.random.RandomState(seed)
        self.labeled_idx: list = []
        self.labels: list = []

    @property
    def unlabeled_idx(self) -> np.ndarray:
        mask = np.ones(len(self.X_pool), bool)
        mask[self.labeled_idx] = False
        return np.nonzero(mask)[0]

    def teach(self, idx, y) -> None:
        idx = np.atleast_1d(idx)
        y = np.atleast_1d(y)
        self.labeled_idx.extend(int(i) for i in idx)
        self.labels.extend(int(v) for v in y)
        X = self.X_pool[self.labeled_idx]
        self.estimator.fit(X, np.asarray(self.labels))

    def query(self, n: int = 1) -> np.ndarray:
        """Pick the n most informative unlabeled examples."""
        cand = self.unlabeled_idx
        if self.strategy == "random" or not self.labeled_idx:
            return self.rng.choice(cand, size=min(n, len(cand)), replace=False)
        probs = self.estimator.predict_proba(self.X_pool[cand])
        scores = STRATEGIES[self.strategy](probs)
        order = np.argsort(-scores)
        return cand[order[:n]]

    def score(self, X, y) -> float:
        return float(self.estimator.score(np.asarray(X), np.asarray(y)))


def run_loop(
    X_pool, y_oracle, X_test, y_test,
    *,
    estimator_name: str = "svc",
    strategy: str = "entropy",
    initial: int = 10,
    batch: int = 5,
    iterations: int = 10,
    seed: int = 0,
):
    """Full simulation loop; returns accuracy trajectory."""
    learner = ActiveLearner(
        make_estimator(estimator_name), X_pool, strategy=strategy, seed=seed
    )
    rng = np.random.RandomState(seed)
    init_idx = rng.choice(len(X_pool), initial, replace=False)
    learner.teach(init_idx, np.asarray(y_oracle)[init_idx])
    accs = [learner.score(X_test, y_test)]
    for _ in range(iterations):
        q = learner.query(batch)
        if len(q) == 0:
            break
        learner.teach(q, np.asarray(y_oracle)[q])
        accs.append(learner.score(X_test, y_test))
    return accs, learner
