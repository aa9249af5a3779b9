"""Metric-dict aggregation and the offline metric battery — the port's own
copies of ``aggregate_metrics`` and ``compute_metrics``
(``kgcn_tpu/runtime/metrics.py:21-146``).

Models emit per-batch metric dicts (``correct_count``, ``count``,
``each_correct_count``, ``each_count``, ``error_sum`` — the reference
protocol, kgcn/core.py:168-209).  ``aggregate_metrics`` sums them across
batches and derives accuracy / mse / gmfe / each_accuracy.

``compute_metrics`` is the offline battery (reference: gcn.py:170-256):
ROC-AUC, average precision, accuracy, balanced accuracy, MCC, Jaccard,
precision/recall/F1 for classification; R2/MSE/gmfe for regression, with
the binary / multiclass / multitask shape handling of ``kgcn_tpu``.  The
JAX package calls scikit-learn; the GPU machine has none, so every score
here is written in NumPy after scikit-learn 1.9.0's definitions (the same
operations in the same dtypes, so the values agree to rounding):

* ``roc_curve`` (with ``drop_intermediate``) and ``auc``, the trapezoid
  under it: ties in the score form one threshold, which scores them by
  average rank, as ``roc_auc_score`` does; a column with one class scores
  NaN, as scikit-learn 1.9.0 returns it (with a warning, no error);
* average precision, the step integral of the precision-recall curve;
* accuracy, balanced accuracy, MCC from the confusion matrix; precision,
  recall, F1 and Jaccard of the positive class with ``zero_division=0``;
  macro F1 over the labels present;
* ``r2_score`` (uniform average over outputs, a constant target scored 1
  or 0 as ``force_finite`` does) and the mean squared error, in the
  matching float dtype of the two inputs.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# NumPy 2 names the trapezoid rule ``trapezoid``; NumPy 1 ``trapz``
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def aggregate_metrics(
    batch_metrics: List[Dict[str, np.ndarray]],
    num: int,
    task: str = "multitask_classification",
    key_prefix: str = "",
) -> Optional[Dict[str, np.ndarray]]:
    """Sum per-batch metric dicts, then derive task metrics
    (reference: kgcn/core.py:168-209)."""
    if not batch_metrics:
        return None
    summed: Dict[str, np.ndarray] = {}
    for m in batch_metrics:
        for k, v in m.items():
            v = np.asarray(v)
            summed[k] = v if k not in summed else summed[k] + v
    out = {key_prefix + k: v for k, v in summed.items()}

    def _ratio(a, b):
        return summed[a] / summed[b] if b in summed else summed[a] / num

    if task == "regression":
        if "error_sum" in summed:
            out[key_prefix + "mse"] = _ratio("error_sum", "count")
    elif task == "regression_gmfe":
        if "error_sum" in summed:
            out[key_prefix + "gmfe"] = np.exp(_ratio("error_sum", "count"))
    else:
        if "correct_count" in summed:
            out[key_prefix + "accuracy"] = _ratio("correct_count", "count")
        if "each_correct_count" in summed:
            out[key_prefix + "each_accuracy"] = _ratio(
                "each_correct_count", "each_count"
            )
        if key_prefix + "accuracy" not in out and key_prefix + "each_accuracy" in out:
            out[key_prefix + "accuracy"] = np.nanmean(
                out[key_prefix + "each_accuracy"]
            )
    return out


# ---- ranking: ROC and precision-recall curves --------------------------------


def _clf_curve(y_true, y_score):
    """(false positives, true positives, thresholds) at each distinct score,
    scores descending (scikit-learn's ``confusion_matrix_at_thresholds``,
    positive label 1)."""
    y_true = np.ravel(y_true)
    y_score = np.ravel(y_score)
    if not (np.all(np.isfinite(y_true)) and np.all(np.isfinite(y_score))):
        raise ValueError("input contains NaN or infinity")
    classes = np.unique(y_true)
    if len(classes) > 2 or not (np.all(np.isin(classes, (0, 1)))
                                or np.all(np.isin(classes, (-1, 1)))):
        raise ValueError(f"y_true takes value in {classes.tolist()}: not binary")
    order = np.argsort(y_score, kind="stable")[::-1]
    y_score = y_score[order]
    y_true = (y_true[order] == 1).astype(np.float64)
    distinct = np.nonzero(np.diff(y_score))[0]
    idx = np.concatenate([distinct, [y_true.size - 1]])
    tps = np.cumsum(y_true, dtype=np.float64)[idx]
    fps = 1 + idx.astype(np.float64) - tps
    return fps, tps, y_score[idx]


def roc_curve(y_true, y_score, drop_intermediate: bool = True):
    """(fpr, tpr, thresholds) of a binary target (``sklearn.metrics.
    roc_curve``): the curve starts at (0, 0) under an infinite threshold;
    ``drop_intermediate`` drops the points collinear with their
    neighbours; a target without negatives (positives) gives an fpr (tpr)
    of NaN."""
    fps, tps, thresholds = _clf_curve(y_true, y_score)
    if drop_intermediate and fps.shape[0] > 2:
        keep = np.nonzero(np.concatenate(
            [[True], np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), [True]]))[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.concatenate([[0.0], tps])
    fps = np.concatenate([[0.0], fps])
    thresholds = np.concatenate([[np.inf], thresholds.astype(np.float64)])
    fpr = np.full(fps.shape, np.nan) if fps[-1] <= 0 else fps / fps[-1]
    tpr = np.full(tps.shape, np.nan) if tps[-1] <= 0 else tps / tps[-1]
    return fpr, tpr, thresholds


def auc(x, y) -> float:
    """Area under a curve by the trapezoid rule (``sklearn.metrics.auc``):
    ``x`` monotonic, increasing or decreasing."""
    x, y = np.ravel(x), np.ravel(y)
    if x.shape[0] < 2:
        raise ValueError(f"At least 2 points are needed to compute area under "
                         f"curve, but x.shape = {x.shape}")
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if np.all(dx <= 0):
            direction = -1
        else:
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
    return float(direction * _trapezoid(y, x))


def roc_auc_binary(y_true, y_score) -> float:
    """ROC-AUC of one binary column; NaN when it holds one class."""
    if len(np.unique(y_true)) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def average_precision(y_true, y_score) -> float:
    """Average precision, the step integral of the precision-recall curve
    (``sklearn.metrics.average_precision_score`` of a binary target)."""
    fps, tps, _ = _clf_curve(y_true, y_score)
    ps = tps + fps
    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(ps != 0, tps / ps, 0.0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    precision = np.concatenate([precision[::-1], [1.0]])
    recall = np.concatenate([recall[::-1], [0.0]])
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def _multilabel_auc(labels, scores, average: str) -> float:
    """``roc_auc_score`` of a multilabel-indicator target: ``macro`` the
    mean of the columns' AUCs (NaN if one is NaN), ``micro`` the AUC of
    the flattened arrays."""
    if average == "micro":
        return roc_auc_binary(labels.ravel(), scores.ravel())
    return float(np.mean([roc_auc_binary(labels[:, c], scores[:, c])
                          for c in range(scores.shape[1])]))


# ---- classification from hard predictions -------------------------------------


def _confusion(y, yhat):
    """(confusion matrix over the sorted union of labels, those labels)."""
    labels, inv = np.unique(np.concatenate([y, yhat]), return_inverse=True)
    n = len(labels)
    t, p = inv[: len(y)], inv[len(y):]
    return np.bincount(t * n + p, minlength=n * n).reshape(n, n), labels


def balanced_accuracy(y, yhat) -> float:
    """Mean recall over the classes present in ``y``."""
    C, _ = _confusion(y, yhat)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(C) / C.sum(axis=1)
    return float(np.mean(per_class[~np.isnan(per_class)]))


def matthews_corrcoef(y, yhat) -> float:
    """MCC from the confusion matrix; 0 where it is undefined."""
    C, _ = _confusion(y, yhat)
    t_sum = C.sum(axis=1, dtype=np.float64)
    p_sum = C.sum(axis=0, dtype=np.float64)
    n_correct = np.trace(C, dtype=np.float64)
    n = p_sum.sum()
    cov_ytyp = n_correct * n - np.dot(t_sum, p_sum)
    cov_ypyp = n ** 2 - np.dot(p_sum, p_sum)
    cov_ytyt = n ** 2 - np.dot(t_sum, t_sum)
    denom = cov_ypyp * cov_ytyt
    return 0.0 if denom == 0 else float(cov_ytyp / np.sqrt(denom))


def _ratio0(num, den) -> float:
    """``num / den``, 0 where ``den`` is 0 (``zero_division=0``)."""
    return float(num / den) if den else 0.0


def _binary_counts(y, yhat):
    """(tp, fp, fn) of the positive label 1."""
    pos_t, pos_p = (y == 1), (yhat == 1)
    return (int(np.sum(pos_t & pos_p)), int(np.sum(~pos_t & pos_p)),
            int(np.sum(pos_t & ~pos_p)))


def f1_macro(y, yhat) -> float:
    """F1 averaged over the labels present in ``y`` or ``yhat``."""
    C, _ = _confusion(y, yhat)
    tp = np.diag(C).astype(np.float64)
    fp = C.sum(axis=0) - tp
    fn = C.sum(axis=1) - tp
    den = 2 * tp + fp + fn
    with np.errstate(divide="ignore", invalid="ignore"):
        f1 = np.where(den != 0, 2 * tp / den, 0.0)
    return float(np.mean(f1))


# ---- regression ---------------------------------------------------------------


def _reg_targets(y_true, y_pred):
    """Both targets as ``[N, outputs]`` in their matching float dtype (the
    wider float of the two; float64 when neither is float)."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    floats = [a.dtype for a in (y_true, y_pred) if a.dtype.kind == "f"]
    dtype = np.result_type(*floats) if floats else np.float64
    y_true, y_pred = y_true.astype(dtype), y_pred.astype(dtype)
    if y_true.ndim == 1:
        y_true = y_true.reshape(-1, 1)
    if y_pred.ndim == 1:
        y_pred = y_pred.reshape(-1, 1)
    return y_true, y_pred


def r2_score(y_true, y_pred) -> float:
    """R², uniform average over outputs (``sklearn.metrics.r2_score``): an
    output whose target is constant scores 1 if predicted exactly, else 0;
    NaN below two samples."""
    y_true, y_pred = _reg_targets(y_true, y_pred)
    if y_pred.shape[0] < 2:
        return float("nan")
    numerator = np.sum((y_true - y_pred) ** 2, axis=0)
    denominator = np.sum((y_true - np.mean(y_true, axis=0)) ** 2, axis=0)
    scores = np.ones([y_true.shape[1]], dtype=y_true.dtype)
    valid = (denominator != 0) & (numerator != 0)
    scores[valid] = 1 - numerator[valid] / denominator[valid]
    scores[(numerator != 0) & (denominator == 0)] = 0.0
    return float(np.mean(scores))


def mean_squared_error(y_true, y_pred) -> float:
    y_true, y_pred = _reg_targets(y_true, y_pred)
    return float(np.mean(np.mean((y_true - y_pred) ** 2, axis=0)))


# ---- the battery ----------------------------------------------------------------


def compute_metrics(config, labels, pred_data, mask_label=None):
    """Offline metric battery (reference: gcn.py:170-256), the keys of
    ``kgcn_tpu``'s ``compute_metrics``.

    Shapes: labels [N, L] one-hot or multitask binary; pred_data [N, classes]
    or [N, tasks, 2] (multitask).  Returns a JSON-serialisable dict.
    """
    task = config.get("task", "multitask_classification")
    result = {}
    labels = np.asarray(labels)
    pred_data = np.asarray(pred_data)

    if task in ("regression", "regression_gmfe"):
        result["r2"] = r2_score(labels, pred_data)
        result["mse"] = mean_squared_error(labels, pred_data)
        ratio = np.clip(np.abs(pred_data) + 1e-12, 1e-12, None) / np.clip(
            np.abs(labels) + 1e-12, 1e-12, None
        )
        result["gmfe"] = float(np.exp(np.mean(np.abs(np.log(ratio)))))
        return result

    if pred_data.ndim == 3:  # multitask: [N, tasks, 2]
        per_task = []
        for t in range(pred_data.shape[1]):
            m = (mask_label[:, t] > 0 if mask_label is not None
                 else np.ones(len(labels), bool))
            if m.sum() == 0:
                per_task.append({})
                continue
            per_task.append(_binary_metrics(labels[m, t], pred_data[m, t, 1]))
        result["each_task"] = per_task
        for key in ("auc", "acc", "ap"):
            vals = [d[key] for d in per_task if key in d]
            if vals:
                result[key] = float(np.nanmean(vals))
        return result

    if labels.ndim == 2 and labels.shape[1] == 2:  # binary one-hot
        result.update(_binary_metrics(np.argmax(labels, axis=1), pred_data[:, 1]))
        return result

    # multiclass
    y = np.argmax(labels, axis=1) if labels.ndim == 2 else labels
    yhat = np.argmax(pred_data, axis=1)
    result["acc"] = float(np.mean(y == yhat))
    result["balanced_acc"] = balanced_accuracy(y, yhat)
    # a multilabel-indicator target (0/1 columns); any other 2-D target is
    # one scikit-learn refuses, and kgcn_tpu leaves both keys out
    if labels.ndim == 2 and labels.shape[1] > 1 and np.all(np.isin(labels, (0, 1))):
        result["auc_macro"] = _multilabel_auc(labels, pred_data, "macro")
        result["auc_micro"] = _multilabel_auc(labels, pred_data, "micro")
    result["f1_macro"] = f1_macro(y, yhat)
    return result


def _binary_metrics(y, p):
    """The binary scores of one target ``y`` against scores ``p``, the
    prediction thresholded at 0.5; ``auc``/``ap`` only with both classes."""
    y = np.asarray(y)
    yhat = (p > 0.5).astype(int)
    tp, fp, fn = _binary_counts(y, yhat)
    out = {
        "acc": float(np.mean(y == yhat)),
        "balanced_acc": balanced_accuracy(y, yhat),
        "mcc": matthews_corrcoef(y, yhat),
        "jaccard": _ratio0(tp, tp + fp + fn),
        "precision": _ratio0(tp, tp + fp),
        "recall": _ratio0(tp, tp + fn),
        "f1": _ratio0(2 * tp, 2 * tp + fp + fn),
    }
    if len(np.unique(y)) > 1:
        out["auc"] = roc_auc_binary(y, p)
        out["ap"] = average_precision(y, p)
    return out
