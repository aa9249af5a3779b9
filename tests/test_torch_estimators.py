"""The port's copies of scikit-learn 1.9.0's estimators
(kgcn_tpu_torch/tools/estimators.py) against scikit-learn on seeded data:

* ``SVC`` (precomputed and rbf, 2 and 3 classes, with Platt probabilities):
  the same predictions and support indices, ``decision_function`` within
  1e-6 of its largest magnitude, ``predict_proba`` within 1e-4, the same
  accuracy; libsvm's random stream (``std::mt19937`` through
  ``newrand.h``'s ``bounded_rand_int``) reproduced;
* ``KernelRidge`` (precomputed) within 1e-10;
* ``LabelPropagation`` and ``LabelSpreading`` ``predict_proba`` within 1e-8.
"""
import warnings

import numpy as np
import pytest

from kgcn_tpu_torch.tools import estimators as est

warnings.filterwarnings("ignore", category=FutureWarning)


def _blobs(rng, n, d, k, spread=1.2):
    centres = rng.randn(k, d) * spread
    y = rng.randint(0, k, n)
    return rng.randn(n, d) + centres[y], y


@pytest.mark.parametrize("kernel", ["precomputed", "rbf"])
@pytest.mark.parametrize("classes", [2, 3])
def test_svc_matches_scikit_learn(kernel, classes):
    from sklearn.svm import SVC

    rng = np.random.RandomState(classes + (kernel == "rbf") * 10)
    X, y = _blobs(rng, 160, 6, classes)
    T, yt = _blobs(rng, 50, 6, classes)
    y = np.array(["a", "b", "c"])[y]  # labels of any type
    yt = np.array(["a", "b", "c"])[yt]
    if kernel == "precomputed":
        A = np.vstack([X, T])
        G = np.exp(-0.3 * ((A[:, None] - A[None]) ** 2).sum(-1))
        X, T = G[:160, :160], G[160:, :160]
    want = SVC(kernel=kernel, probability=True, random_state=0).fit(X, y)
    got = est.SVC(kernel=kernel, probability=True, random_state=0).fit(X, y)
    np.testing.assert_array_equal(got.predict(T), want.predict(T))
    np.testing.assert_array_equal(got.support_, want.support_)
    np.testing.assert_array_equal(got.n_support_, want.n_support_)
    dw, dg = want.decision_function(T), got.decision_function(T)
    assert dg.shape == dw.shape
    assert np.abs(dg - dw).max() <= 1e-6 * np.abs(dw).max()
    np.testing.assert_allclose(got.predict_proba(T), want.predict_proba(T), rtol=0, atol=1e-4)
    assert got.score(T, yt) == want.score(T, yt)


def test_svc_without_probability_and_its_refusals():
    from sklearn.svm import SVC

    rng = np.random.RandomState(4)
    X, y = _blobs(rng, 90, 4, 3)
    want = SVC(C=0.5, gamma="auto").fit(X, y)
    got = est.SVC(C=0.5, gamma="auto").fit(X, y)
    np.testing.assert_array_equal(got.support_, want.support_)
    assert np.abs(got.decision_function(X) - want.decision_function(X)).max() <= \
        1e-6 * np.abs(want.decision_function(X)).max()
    with pytest.raises(AttributeError):
        got.predict_proba(X)
    with pytest.raises(ValueError):
        est.SVC(kernel="poly")
    with pytest.raises(ValueError):
        est.SVC().fit(X, np.zeros(len(X)))


def test_libsvm_random_stream():
    """Values of ``std::mt19937`` seeded by ``set_seed`` and drawn with
    ``bounded_rand_int`` (newrand.h, compiled with g++): the port's
    ``_MT`` gives the same."""
    mt = est._MT()
    mt.seed(1234567)
    assert [mt.bounded_rand_int(100 - 7 * i) for i in range(6)] == [23, 43, 0, 28, 1, 60]
    mt.seed(209652396)
    assert [mt.bounded_rand_int(3_000_000_000) for _ in range(4)] == [
        1458141968, 2057136957, 953832171, 2956728145]


def test_kernel_ridge_matches_scikit_learn():
    from sklearn.kernel_ridge import KernelRidge

    rng = np.random.RandomState(2)
    F = rng.randn(70, 9)
    K = F @ F.T
    y = F[:, 0] - 0.5 * F[:, 1] + 0.1 * rng.randn(70)
    for alpha in (0.1, 1.0):
        want = KernelRidge(kernel="precomputed", alpha=alpha).fit(K[:50, :50], y[:50])
        got = est.KernelRidge(kernel="precomputed", alpha=alpha).fit(K[:50, :50], y[:50])
        np.testing.assert_allclose(got.predict(K[50:, :50]), want.predict(K[50:, :50]),
                                   rtol=0, atol=1e-10)
        np.testing.assert_allclose(got.dual_coef_, want.dual_coef_, rtol=0, atol=1e-10)


@pytest.mark.parametrize("name", ["LabelPropagation", "LabelSpreading"])
def test_label_propagation_matches_scikit_learn(name):
    from sklearn import semi_supervised

    rng = np.random.RandomState(5)
    X = (rng.rand(120, 40) < 0.25).astype(np.float64)  # fingerprint-like bits
    y = (X[:, :5].sum(1) > 1).astype(int) + (X[:, 5] > 0)
    y[rng.rand(120) < 0.6] = -1
    T = (rng.rand(30, 40) < 0.25).astype(np.float64)
    want = getattr(semi_supervised, name)().fit(X, y)
    got = getattr(est, name)().fit(X, y)
    np.testing.assert_allclose(got.predict_proba(T), want.predict_proba(T), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(got.predict(T), want.predict(T))
    np.testing.assert_array_equal(got.transduction_, want.transduction_)
