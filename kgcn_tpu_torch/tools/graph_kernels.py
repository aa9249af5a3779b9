"""Graph-kernel SVM baselines — the port's copy of
``kgcn_tpu/tools/graph_kernels.py`` (reference: graph_kernel/, the
Weisfeiler-Lehman subtree kernel of graphkernel/wl_kernel.py:17-60, the
shortest-path kernel, the hash graph kernel and the gram-matrix
SVM/KernelRidge CV of gk.py and compute_kernel.py).

Graphs are (dense adjacency, node labels) pairs; the kernels return
float64 gram matrices, the same values as ``kgcn_tpu``'s (the same
vocabulary orders and sparse products).  The CV routines fit the port's
copies of scikit-learn's ``SVC`` and ``KernelRidge``
(``tools/estimators.py``) on the folds of ``data/dataset.kfold_indices``
(scikit-learn's ``StratifiedKFold`` / ``KFold`` with ``shuffle=True``),
scored with ``runtime/metrics``' ``mean_squared_error`` and ``r2_score``:
the GPU machine has SciPy and no scikit-learn.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.sparse as sp


Graph = Tuple[np.ndarray, np.ndarray]  # (dense adjacency, node label ints)


def _neighbors(adj: np.ndarray) -> List[np.ndarray]:
    a = np.asarray(adj)
    return [np.nonzero(a[i])[0] for i in range(len(a))]


def wl_subtree_features(graphs: Sequence[Graph], iterations: int = 3):
    """Weisfeiler-Lehman relabeling: per-iteration label histograms
    (reference: graphkernel/wl_kernel.py:17-60)."""
    labels = [np.asarray(lab, dtype=np.int64).copy() for _, lab in graphs]
    neigh = [_neighbors(adj) for adj, _ in graphs]
    # compress initial labels to a dense range
    vocab: dict = {}
    feats: List[dict] = [dict() for _ in graphs]

    def bump(gi, lab):
        feats[gi][lab] = feats[gi].get(lab, 0) + 1

    for gi, lab in enumerate(labels):
        for v in lab:
            key = ("init", int(v))
            if key not in vocab:
                vocab[key] = len(vocab)
            bump(gi, vocab[key])

    for it in range(iterations):
        new_labels = []
        for gi, (lab, nb) in enumerate(zip(labels, neigh)):
            nl = np.empty_like(lab)
            for v in range(len(lab)):
                sig = (it, int(lab[v]), tuple(sorted(int(lab[u]) for u in nb[v])))
                if sig not in vocab:
                    vocab[sig] = len(vocab)
                nl[v] = vocab[sig]
                bump(gi, nl[v])
            new_labels.append(nl)
        labels = new_labels

    mat = sp.lil_matrix((len(graphs), len(vocab)), dtype=np.float64)
    for gi, f in enumerate(feats):
        for k, c in f.items():
            mat[gi, k] = c
    return mat.tocsr()


def wl_kernel(graphs: Sequence[Graph], iterations: int = 3,
              normalize: bool = True) -> np.ndarray:
    """WL subtree gram matrix."""
    phi = wl_subtree_features(graphs, iterations)
    K = np.asarray((phi @ phi.T).todense(), dtype=np.float64)
    if normalize:
        d = np.sqrt(np.clip(np.diag(K), 1e-12, None))
        K = K / d[:, None] / d[None, :]
    return K


def shortest_path_kernel(graphs: Sequence[Graph], normalize: bool = True,
                         max_path: Optional[int] = None) -> np.ndarray:
    """Shortest-path kernel: histogram of (label_u, label_v, d(u,v)) triples
    (reference: graphkernel shortest-path kernel)."""
    from scipy.sparse.csgraph import shortest_path

    feats = []
    vocab: dict = {}
    for adj, lab in graphs:
        d = shortest_path(sp.csr_matrix(np.asarray(adj) != 0), unweighted=True)
        f: dict = {}
        n = len(lab)
        for i in range(n):
            for j in range(i + 1, n):
                dist = d[i, j]
                if not np.isfinite(dist):
                    continue
                if max_path and dist > max_path:
                    continue
                a, b = sorted((int(lab[i]), int(lab[j])))
                key = (a, b, int(dist))
                if key not in vocab:
                    vocab[key] = len(vocab)
                k = vocab[key]
                f[k] = f.get(k, 0) + 1
        feats.append(f)
    phi = sp.lil_matrix((len(graphs), len(vocab)), dtype=np.float64)
    for gi, f in enumerate(feats):
        for k, c in f.items():
            phi[gi, k] = c
    K = np.asarray((phi.tocsr() @ phi.tocsr().T).todense(), dtype=np.float64)
    if normalize:
        dg = np.sqrt(np.clip(np.diag(K), 1e-12, None))
        K = K / dg[:, None] / dg[None, :]
    return K


AttributedGraph = Tuple[np.ndarray, np.ndarray]  # (adjacency, node attrs [n,d])


def _lsh_labels(attrs: np.ndarray, bin_width: float, sigma: float,
                rng: np.random.Generator) -> np.ndarray:
    """Locally-sensitive hash of continuous node attributes into discrete
    labels: random Gaussian projection, offset, bin by ``bin_width``, then
    encode each binned row as one integer (reference:
    graphkernel/hash_graph_kernel.py:44 `locally_sensitive_hashing`)."""
    d = attrs.shape[1]
    W = rng.normal(0.0, sigma, size=(d, d))
    b = rng.uniform(0.0, bin_width, size=(d,))
    bins = np.floor((attrs @ W + b) / bin_width).astype(np.int64)
    _, labels = np.unique(bins, axis=0, return_inverse=True)
    return labels


def hash_graph_kernel(graphs: Sequence[AttributedGraph], iterations: int = 20,
                      wl_iterations: int = 2, lsh_bin_width: float = 1.0,
                      sigma: float = 1.0, normalize: bool = True,
                      scale_attributes: bool = True, seed: int = 0) -> np.ndarray:
    """Hash graph kernel for continuous node attributes (Morris et al.;
    reference: graphkernel/hash_graph_kernel.py:13-72).  Each iteration
    LSH-hashes the attributes into discrete labels and runs the WL-subtree
    base kernel on them; feature vectors are stacked across iterations and
    scaled by sqrt(1/iterations) before the gram product."""
    rng = np.random.default_rng(seed)
    all_attrs = np.concatenate([np.asarray(a, np.float64) for _, a in graphs])
    if scale_attributes and all_attrs.shape[1] > 0:
        mu = all_attrs.mean(axis=0)
        sd = all_attrs.std(axis=0)
        sd[sd == 0] = 1.0
    else:
        mu, sd = 0.0, 1.0

    sizes = [len(a) for _, a in graphs]
    offsets = np.cumsum([0] + sizes)
    blocks = []
    for _ in range(iterations):
        hashed = _lsh_labels((all_attrs - mu) / sd, lsh_bin_width, sigma, rng)
        labeled = [
            (adj, hashed[offsets[i]:offsets[i + 1]])
            for i, (adj, _) in enumerate(graphs)
        ]
        blocks.append(wl_subtree_features(labeled, iterations=wl_iterations))
    phi = sp.hstack(blocks).tocsr() * np.sqrt(1.0 / iterations)
    K = np.asarray((phi @ phi.T).todense(), dtype=np.float64)
    if normalize:
        dg = np.sqrt(np.clip(np.diag(K), 1e-12, None))
        K = K / dg[:, None] / dg[None, :]
    return K


def kernel_svm_cv(K: np.ndarray, y: np.ndarray, folds: int = 5,
                  C: float = 1.0, seed: int = 0):
    """Gram-matrix SVM cross-validation over stratified shuffled folds
    (reference: graph_kernel/gk.py) → (mean accuracy, its std)."""
    from kgcn_tpu_torch.data.dataset import kfold_indices
    from kgcn_tpu_torch.tools.estimators import SVC

    y = np.asarray(y)
    accs = []
    for tr, te in kfold_indices(len(y), folds, seed=seed, stratify=y):
        clf = SVC(kernel="precomputed", C=C)
        clf.fit(K[np.ix_(tr, tr)], y[tr])
        accs.append(clf.score(K[np.ix_(te, tr)], y[te]))
    return float(np.mean(accs)), float(np.std(accs))


def kernel_ridge_cv(K: np.ndarray, y: np.ndarray, folds: int = 5,
                    alpha: float = 1.0, seed: int = 0):
    """Gram-matrix kernel-ridge regression CV over shuffled folds — the
    reference's regression criterion (graph_kernel/gk.py:10,35).  Returns
    (mse_mean, mse_std, r2_mean)."""
    from kgcn_tpu_torch.data.dataset import kfold_indices
    from kgcn_tpu_torch.runtime.metrics import mean_squared_error, r2_score
    from kgcn_tpu_torch.tools.estimators import KernelRidge

    y = np.asarray(y, np.float64)
    mses, r2s = [], []
    for tr, te in kfold_indices(len(y), folds, seed=seed):
        reg = KernelRidge(kernel="precomputed", alpha=alpha)
        reg.fit(K[np.ix_(tr, tr)], y[tr])
        pred = reg.predict(K[np.ix_(te, tr)])
        mses.append(mean_squared_error(y[te], pred))
        r2s.append(r2_score(y[te], pred))
    return float(np.mean(mses)), float(np.std(mses)), float(np.mean(r2s))


def dataset_to_kernel_graphs(ds) -> List[Graph]:
    """Convert our Dataset (COO channels + features) into kernel graphs —
    node labels are argmax of the feature one-hots."""
    graphs = []
    for g in range(ds.num):
        n = (
            int(ds.enabled_node_nums[g])
            if ds.enabled_node_nums is not None
            else ds.max_node_num
        )
        dense = np.zeros((n, n), np.float64)
        for (r, c, v) in ds.adjs[g]:
            keep = (r < n) & (c < n)
            dense[r[keep], c[keep]] = v[keep]
        lab = (
            np.argmax(ds.features[g][:n], axis=1)
            if ds.features is not None
            else np.zeros(n, np.int64)
        )
        graphs.append((dense, lab))
    return graphs


def dataset_to_attributed_graphs(ds) -> List[AttributedGraph]:
    """Like :func:`dataset_to_kernel_graphs` but keeps the continuous node
    feature rows (for the hash kernel)."""
    out = []
    for dense, _ in dataset_to_kernel_graphs(ds):
        out.append(dense)
    graphs = []
    for g, dense in enumerate(out):
        n = len(dense)
        attrs = (
            np.asarray(ds.features[g][:n], np.float64)
            if ds.features is not None
            else np.zeros((n, 1), np.float64)
        )
        graphs.append((dense, attrs))
    return graphs
