"""Training plots: the cost curves, ROC curves and the R² scatter — the
counterpart of ``kgcn_tpu/tools/plots.py:16-102`` (reference:
kgcn/make_plots.py:15-179), with the same files and figures.

matplotlib is imported when a plot is drawn, with the ``Agg`` backend
(files only, no display); where it is not installed a plot raises
``ImportError``, as the JAX package's does.  The ROC curve, its area and
R² come from the port's own NumPy copies of scikit-learn's
(``runtime/metrics.py``): the GPU machine has no scikit-learn.
"""
from __future__ import annotations

import os

import numpy as np

from kgcn_tpu_torch.runtime.metrics import auc, r2_score, roc_curve


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _ensure_dir(config):
    path = config.get("plot_path", "./result/")
    os.makedirs(path, exist_ok=True)
    return path


def _save(plt, fig, path):
    fig.savefig(path)
    plt.close(fig)
    print(f"[SAVE] {path}")
    return path


def plot_cost(config, history, name: str = "") -> str:
    """``cost{name}.png``: the training (and validation) cost per epoch."""
    plt = _pyplot()
    path = _ensure_dir(config)
    epochs = [h["epoch"] for h in history]
    fig, ax = plt.subplots()
    ax.plot(epochs, [h["training_cost"] for h in history], label="train cost")
    if any("validation_cost" in h for h in history):
        ax.plot(epochs, [h.get("validation_cost", np.nan) for h in history],
                label="valid cost")
    ax.set_xlabel("epoch")
    ax.set_ylabel("cost")
    ax.legend()
    return _save(plt, fig, os.path.join(path, f"cost{name}.png"))


def plot_auc(config, labels, prediction, name: str = "", mask_label=None) -> str:
    """``auc{name}.png``: a ROC curve per class with both labels present
    (reference: kgcn/make_plots.py:70-134).  ``mask_label`` leaves out the
    unmeasured (masked) multitask cells."""
    plt = _pyplot()
    path = _ensure_dir(config)
    labels = np.asarray(labels)
    pred = np.asarray(prediction)
    if pred.ndim == 3:
        pred = pred[..., 1]
    mask = None if mask_label is None else np.asarray(mask_label)
    fig, ax = plt.subplots()
    for c in range(labels.shape[1]):
        keep = slice(None) if mask is None or mask.ndim < 2 else mask[:, c] > 0
        yl, yp = labels[keep, c], pred[keep, c]
        if len(np.unique(yl)) < 2:
            continue
        fpr, tpr, _ = roc_curve(yl, yp)
        ax.plot(fpr, tpr, label=f"class {c} (AUC={auc(fpr, tpr):.3f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.5)
    ax.set_xlabel("FPR")
    ax.set_ylabel("TPR")
    ax.legend()
    return _save(plt, fig, os.path.join(path, f"auc{name}.png"))


def plot_r2(config, labels, prediction, name: str = "") -> str:
    """``r2{name}.png``: predictions against labels, titled with R²."""
    plt = _pyplot()
    path = _ensure_dir(config)
    labels = np.asarray(labels).ravel()
    pred = np.asarray(prediction).ravel()
    fig, ax = plt.subplots()
    ax.scatter(labels, pred, s=8, alpha=0.6)
    lo, hi = min(labels.min(), pred.min()), max(labels.max(), pred.max())
    ax.plot([lo, hi], [lo, hi], "k--", lw=0.5)
    ax.set_xlabel("label")
    ax.set_ylabel("prediction")
    ax.set_title(f"R2 = {r2_score(labels, pred):.4f}")
    return _save(plt, fig, os.path.join(path, f"r2{name}.png"))
