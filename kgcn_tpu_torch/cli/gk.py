"""``kgcn-torch-gk`` — graph-kernel SVM baselines over a jbl dataset, the
port's copy of ``kgcn_tpu/cli/gk.py`` (reference: graph_kernel/gk.py +
compute_kernel.py):

    python -m kgcn_tpu_torch.cli.gk --dataset data.jbl [--kernel wl] [--folds 5]

Computes a WL-subtree, shortest-path or hash gram matrix of the dataset's
graphs and cross-validates a precomputed-kernel SVM (kernel ridge with
``--task regression``), printing the same JSON line as ``kgcn_tpu``.  The
``.jbl`` is read with the port's own reader (``data/jbl.py``), the
estimators are the port's copies of scikit-learn's
(``tools/estimators.py``).  Host only: no device is touched.
"""
from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(prog="kgcn-torch-gk", description=__doc__)
    p.add_argument("--dataset", required=True, help="jbl dataset with labels")
    p.add_argument("--kernel", default="wl",
                   choices=["wl", "shortest_path", "hash"])
    p.add_argument("--iterations", type=int, default=3, help="WL iterations")
    p.add_argument("--hash-iterations", type=int, default=20,
                   help="LSH rounds for the hash kernel")
    p.add_argument("--lsh-bin-width", type=float, default=1.0)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--task", default="classification",
                   choices=["classification", "regression"],
                   help="SVM (classification) or kernel ridge (regression), "
                        "matching graph_kernel/gk.py:10")
    p.add_argument("--folds", type=int, default=5)
    p.add_argument("--C", type=float, default=1.0)
    p.add_argument("--alpha", type=float, default=1.0,
                   help="kernel-ridge regularisation (regression)")
    p.add_argument("--output", default=None, help="save gram matrix (npy)")
    args = p.parse_args(argv)

    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.tools.graph_kernels import (
        dataset_to_attributed_graphs,
        dataset_to_kernel_graphs,
        hash_graph_kernel,
        kernel_ridge_cv,
        kernel_svm_cv,
        shortest_path_kernel,
        wl_kernel,
    )

    ds, info = build_dataset(jbl.load(args.dataset), {})
    if args.kernel == "hash":
        graphs = dataset_to_attributed_graphs(ds)
    else:
        graphs = dataset_to_kernel_graphs(ds)
    print(f"[INFO] {len(graphs)} graphs, kernel={args.kernel}")
    if args.kernel == "wl":
        K = wl_kernel(graphs, iterations=args.iterations)
    elif args.kernel == "hash":
        K = hash_graph_kernel(
            graphs, iterations=args.hash_iterations,
            wl_iterations=args.iterations,
            lsh_bin_width=args.lsh_bin_width, sigma=args.sigma,
        )
    else:
        K = shortest_path_kernel(graphs)
    if args.output:
        np.save(args.output, K)
        print(f"[SAVE] {args.output}")
    if ds.labels is not None:
        if args.task == "regression":
            y = ds.labels[:, 0] if ds.labels.ndim == 2 else ds.labels
            mse, std, r2 = kernel_ridge_cv(K, y, folds=args.folds,
                                           alpha=args.alpha)
            print(json.dumps({"kernel": args.kernel, "cv_mse": mse,
                              "cv_mse_std": std, "cv_r2": r2,
                              "folds": args.folds}))
        else:
            y = (np.argmax(ds.labels, axis=1) if ds.labels.ndim == 2
                 else ds.labels)
            acc, std = kernel_svm_cv(K, y, folds=args.folds, C=args.C)
            print(json.dumps({"kernel": args.kernel, "cv_accuracy": acc,
                              "cv_std": std, "folds": args.folds}))


if __name__ == "__main__":
    main()
