"""The port's graph kernels and their CV routines
(kgcn_tpu_torch/tools/graph_kernels.py, cli/gk.py) against kgcn_tpu's:

* the WL-subtree, shortest-path and hash gram matrices equal within 1e-12,
  on ring datasets and the first 200 molecules of
  ``examples/solubility/solubility_cls.jbl``;
* ``kernel_svm_cv`` and ``kernel_ridge_cv`` (the port's estimators and
  folds; kgcn_tpu calls scikit-learn) equal within 1e-9;
* ``cli.gk`` prints the same JSON line as ``kgcn_tpu.cli.gk``.
"""
import json
import os
import pickle

import numpy as np
import pytest

from kgcn_tpu_torch.data import jbl
from kgcn_tpu_torch.data.synthetic import make_ring_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLUBILITY = os.path.join(REPO, "examples", "solubility", "solubility_cls.jbl")
EXACT = dict(rtol=0, atol=1e-12)
CV = dict(rtol=0, atol=1e-9)


def _solubility(n=200):
    data = jbl.load(SOLUBILITY)
    out = dict(data)
    for k in ("feature", "adj", "label", "mask_label"):
        out[k] = [data[k][i] for i in range(n)] if isinstance(data[k], list) \
            else np.asarray(data[k])[:n]
    return out


DATA = {"ring10": lambda: make_ring_dataset(num_pairs=20, num_nodes=10, seed=0),
        "ring6": lambda: make_ring_dataset(num_pairs=30, num_nodes=6, seed=1),
        "solubility200": _solubility}


def _graphs(name, attributed=False):
    from kgcn_tpu.data import build_dataset as j_build
    from kgcn_tpu.tools import graph_kernels as J
    from kgcn_tpu_torch.data.dataset import build_dataset
    from kgcn_tpu_torch.tools import graph_kernels as T

    data = DATA[name]()
    jds, _ = j_build(dict(data), {})
    ds, _ = build_dataset(dict(data), {})
    if attributed:
        return T.dataset_to_attributed_graphs(ds), J.dataset_to_attributed_graphs(jds), ds
    return T.dataset_to_kernel_graphs(ds), J.dataset_to_kernel_graphs(jds), ds


@pytest.mark.parametrize("name", sorted(DATA))
def test_gram_matrices_equal_kgcn_tpu(name):
    from kgcn_tpu.tools import graph_kernels as J
    from kgcn_tpu_torch.tools import graph_kernels as T

    g, jg, _ = _graphs(name)
    for (a, la), (b, lb) in zip(g, jg):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)
    np.testing.assert_allclose(T.wl_kernel(g), J.wl_kernel(jg), **EXACT)
    np.testing.assert_allclose(T.wl_kernel(g, iterations=1, normalize=False),
                               J.wl_kernel(jg, iterations=1, normalize=False), **EXACT)
    np.testing.assert_allclose(T.shortest_path_kernel(g), J.shortest_path_kernel(jg), **EXACT)
    ga, jga, _ = _graphs(name, attributed=True)
    np.testing.assert_allclose(T.hash_graph_kernel(ga, iterations=4, seed=3),
                               J.hash_graph_kernel(jga, iterations=4, seed=3), **EXACT)


@pytest.mark.parametrize("name", ["ring10", "solubility200"])
def test_cv_routines_equal_kgcn_tpu(name):
    from kgcn_tpu.tools import graph_kernels as J
    from kgcn_tpu_torch.tools import graph_kernels as T

    g, _, ds = _graphs(name)
    K = T.wl_kernel(g)
    y = np.argmax(ds.labels, axis=1)
    for folds, C in ((5, 1.0), (3, 0.3)):
        np.testing.assert_allclose(T.kernel_svm_cv(K, y, folds=folds, C=C, seed=2),
                                   J.kernel_svm_cv(K, y, folds=folds, C=C, seed=2), **CV)
    target = ds.labels[:, 0] + 0.1 * np.arange(len(y)) / len(y)
    np.testing.assert_allclose(T.kernel_ridge_cv(K, target, folds=4, alpha=0.5, seed=1),
                               J.kernel_ridge_cv(K, target, folds=4, alpha=0.5, seed=1), **CV)


@pytest.mark.parametrize("argv", [["--kernel", "wl"],
                                  ["--kernel", "shortest_path", "--folds", "3"],
                                  ["--kernel", "hash", "--hash-iterations", "3"],
                                  ["--kernel", "wl", "--task", "regression", "--alpha", "0.5"]])
def test_cli_gk_prints_kgcn_tpus_line(tmp_path, capsys, argv):
    from kgcn_tpu.cli.gk import main as jgk
    from kgcn_tpu_torch.cli.gk import main as tgk

    path = tmp_path / "ring.jbl"
    with open(path, "wb") as f:
        pickle.dump(make_ring_dataset(num_pairs=15, num_nodes=8, seed=4), f)
    lines = []
    for fn, out in ((tgk, "port.npy"), (jgk, "jax.npy")):
        fn(["--dataset", str(path), "--output", str(tmp_path / out)] + argv)
        lines.append(capsys.readouterr().out.strip().splitlines())
    port, jax_ = lines
    assert port[0] == jax_[0]  # "[INFO] 30 graphs, kernel=..."
    assert port[-1] == jax_[-1]  # the JSON line, to the last digit
    assert set(json.loads(port[-1])) >= {"kernel", "folds"}
    np.testing.assert_allclose(np.load(tmp_path / "port.npy"), np.load(tmp_path / "jax.npy"),
                               **EXACT)
