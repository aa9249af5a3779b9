"""The port's active-learning loop (kgcn_tpu_torch/tools/active_learning.py,
over the port's estimators) against kgcn_tpu's (over scikit-learn): the
query strategies bitwise, and ``run_loop`` with ``label_propagation``,
``label_spreading`` and ``svc`` under each strategy queries the same
examples and scores the same accuracies."""
import warnings

import numpy as np
import pytest

warnings.filterwarnings("ignore")


def _fingerprints(seed=0, n_pool=150, n_test=60, bits=96):
    """Seeded fingerprint-like bit vectors and a label rule over them."""
    rng = np.random.RandomState(seed)
    X = (rng.rand(n_pool + n_test, bits) < 0.2).astype(np.float64)
    w = rng.randn(bits)
    y = (X @ w > np.median(X @ w)).astype(int)
    return X[:n_pool], y[:n_pool], X[n_pool:], y[n_pool:]


def test_strategies_bitwise():
    from kgcn_tpu.tools import active_learning as J
    from kgcn_tpu_torch.tools import active_learning as T

    rng = np.random.RandomState(3)
    for k in (1, 2, 4):
        probs = rng.dirichlet(np.ones(k), size=50)
        for name in T.STRATEGIES:
            np.testing.assert_array_equal(T.STRATEGIES[name](probs), J.STRATEGIES[name](probs))


@pytest.mark.parametrize("estimator", ["label_propagation", "label_spreading", "svc"])
@pytest.mark.parametrize("strategy", ["entropy", "margin", "least_confidence", "random"])
def test_run_loop_queries_as_kgcn_tpu(estimator, strategy):
    from kgcn_tpu.tools import active_learning as J
    from kgcn_tpu_torch.tools import active_learning as T

    Xp, yp, Xt, yt = _fingerprints()
    kw = dict(estimator_name=estimator, strategy=strategy, initial=12, batch=5,
              iterations=5, seed=1)
    accs, learner = T.run_loop(Xp, yp, Xt, yt, **kw)
    jaccs, jlearner = J.run_loop(Xp, yp, Xt, yt, **kw)
    assert learner.labeled_idx == jlearner.labeled_idx
    assert accs == jaccs
    assert len(accs) == 6
