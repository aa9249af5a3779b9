"""The port's metric battery (kgcn_tpu_torch/runtime/metrics.py:
``compute_metrics``, ``_binary_metrics``, ``roc_curve``, ``auc``,
``r2_score``), written in NumPy, against ``kgcn_tpu.runtime.metrics`` and
so against scikit-learn (1.9.0 on this host), on the CPU.

Hypothesis draws the cases: scores rounded to one decimal (ties), all-zero
predictions, columns with one class (the AUC of such a column is NaN in
scikit-learn 1.9.0, and so here), masked multitask cells and empty tasks,
targets scikit-learn refuses (the multiclass AUC keys are then absent).
Every key of the JAX package's result must be the port's, every value
equal to rtol 1e-10 (NaN equal to NaN): the same definitions evaluated in
the same dtypes.
"""
import warnings

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from kgcn_tpu_torch.runtime import metrics as tm

TOL = dict(rtol=1e-10, atol=1e-12)
SETTINGS = settings(max_examples=60, deadline=None, derandomize=True)


def _same(got, want, path="result"):
    """``got`` has ``want``'s structure and keys; numbers equal to TOL."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (path, got, want)
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert isinstance(got, float) and isinstance(want, float), (path, got, want)
        np.testing.assert_allclose(got, want, err_msg=path, equal_nan=True, **TOL)


def _jax_metrics(*args):
    from kgcn_tpu.runtime.metrics import compute_metrics

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return compute_metrics(*args)


def _scores(draw, shape, zero):
    """Scores in [0, 1] at one decimal (many ties), or all zero."""
    if zero:
        return np.zeros(shape, np.float32)
    rng = np.random.RandomState(draw(st.integers(0, 2**31 - 1)))
    return np.round(rng.rand(*shape), 1).astype(np.float32)


@st.composite
def binary_case(draw):
    n = draw(st.integers(2, 40))
    rng = np.random.RandomState(draw(st.integers(0, 2**31 - 1)))
    one_class = draw(st.booleans())
    y = np.zeros(n, int) if one_class else rng.randint(0, 2, n)
    labels = np.eye(2)[y]
    p = _scores(draw, (n,), draw(st.booleans()))
    return labels, np.stack([1 - p, p], axis=1)


@given(binary_case())
@SETTINGS
def test_binary_battery_matches_jax(case):
    labels, pred = case
    cfg = {"task": "classification"}
    _same(tm.compute_metrics(cfg, labels, pred), _jax_metrics(cfg, labels, pred))


@st.composite
def multitask_case(draw):
    n, t = draw(st.integers(2, 30)), draw(st.integers(1, 5))
    rng = np.random.RandomState(draw(st.integers(0, 2**31 - 1)))
    labels = rng.randint(0, 2, (n, t)).astype(np.float64)
    mask = (rng.rand(n, t) < draw(st.sampled_from([0.0, 0.5, 1.0]))).astype(np.int64)
    if draw(st.booleans()):
        mask[:, 0] = 0  # a task with no measured cell
    labels[mask == 0] = 0.0  # unmeasured cells are 0-filled, as the datasets hold them
    p = _scores(draw, (n, t), draw(st.booleans()))
    return labels, np.stack([1 - p, p], axis=-1), (mask if draw(st.booleans()) else None)


@given(multitask_case())
@SETTINGS
def test_multitask_battery_matches_jax(case):
    labels, pred, mask = case
    cfg = {"task": "multitask_classification"}
    _same(tm.compute_metrics(cfg, labels, pred, mask),
          _jax_metrics(cfg, labels, pred, mask))


@st.composite
def multiclass_case(draw):
    n, c = draw(st.integers(2, 40)), draw(st.integers(3, 6))
    rng = np.random.RandomState(draw(st.integers(0, 2**31 - 1)))
    y = rng.randint(0, draw(st.integers(1, c)), n)  # some classes never present
    labels = np.eye(c)[y]
    kind = draw(st.sampled_from(["onehot", "soft", "int"]))
    if kind == "soft":  # a target scikit-learn refuses: no AUC keys
        labels = labels * 0.5
    elif kind == "int":
        labels = labels.astype(np.int64)
    pred = _scores(draw, (n, c), draw(st.booleans()))
    return labels, pred


@given(multiclass_case())
@SETTINGS
def test_multiclass_battery_matches_jax(case):
    labels, pred = case
    cfg = {"task": "classification"}
    got, want = tm.compute_metrics(cfg, labels, pred), _jax_metrics(cfg, labels, pred)
    _same(got, want)
    if np.all(np.isin(labels, (0, 1))):
        assert "auc_macro" in got


@st.composite
def regression_case(draw):
    n, t = draw(st.integers(2, 40)), draw(st.integers(1, 3))
    rng = np.random.RandomState(draw(st.integers(0, 2**31 - 1)))
    labels = rng.randn(n, t) * 2.0
    if draw(st.booleans()):
        labels[:, 0] = 1.5  # a constant target
    kind = draw(st.sampled_from(["random", "exact", "zero"]))
    pred = (labels if kind == "exact" else np.zeros_like(labels) if kind == "zero"
            else rng.randn(n, t)).astype(np.float32)
    return labels, pred


@pytest.mark.parametrize("task", ["regression", "regression_gmfe"])
@given(case=regression_case())
@SETTINGS
def test_regression_battery_matches_jax(task, case):
    labels, pred = case
    cfg = {"task": task}
    _same(tm.compute_metrics(cfg, labels, pred), _jax_metrics(cfg, labels, pred))


@given(binary_case())
@SETTINGS
def test_binary_metrics_match_jax(case):
    from kgcn_tpu.runtime.metrics import _binary_metrics

    labels, pred = case
    y, p = np.argmax(labels, axis=1), pred[:, 1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _binary_metrics(y, p)
    _same(tm._binary_metrics(y, p), want)


@pytest.mark.parametrize("drop_intermediate", [True, False])
@given(case=binary_case())
@SETTINGS
def test_roc_curve_and_auc_match_sklearn(drop_intermediate, case):
    """The curve point for point (thresholds too), and its area; a target
    with one class gives NaN rates, as scikit-learn's."""
    from sklearn.metrics import auc, roc_curve

    labels, pred = case
    y, p = np.argmax(labels, axis=1), pred[:, 1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = roc_curve(y, p, drop_intermediate=drop_intermediate)
    got = tm.roc_curve(y, p, drop_intermediate=drop_intermediate)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    if len(np.unique(y)) == 2:
        np.testing.assert_allclose(tm.auc(*got[:2]), auc(*want[:2]), **TOL)


def test_auc_of_a_decreasing_curve_and_refusals():
    from sklearn.metrics import auc

    x, y = np.array([1.0, 0.5, 0.0]), np.array([1.0, 0.7, 0.2])
    assert tm.auc(x, y) == auc(x, y)
    with pytest.raises(ValueError):
        tm.auc([0.0, 1.0, 0.5], [0.0, 1.0, 1.0])
    with pytest.raises(ValueError):
        tm.auc([0.0], [1.0])
    with pytest.raises(ValueError):
        tm.roc_curve([0, 2, 1], [0.1, 0.2, 0.3])


@given(regression_case())
@SETTINGS
def test_r2_score_matches_sklearn(case):
    from sklearn.metrics import mean_squared_error, r2_score

    labels, pred = case
    for lab, prd in ((labels, pred), (labels[:, 0], pred[:, 0]),
                     (labels.astype(np.float32), pred)):
        np.testing.assert_allclose(tm.r2_score(lab, prd), r2_score(lab, prd), **TOL)
        np.testing.assert_allclose(tm.mean_squared_error(lab, prd),
                                   mean_squared_error(lab, prd), **TOL)


def test_r2_of_one_sample_is_nan():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        from sklearn.metrics import r2_score

        assert np.isnan(r2_score([1.0], [2.0]))
    assert np.isnan(tm.r2_score([1.0], [2.0]))
