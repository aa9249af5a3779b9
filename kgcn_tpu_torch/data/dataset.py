"""Dataset loading — reads the reference's ``.jbl`` dict format.

The counterpart of ``kgcn_tpu/data/dataset.py:30-362``, host-side NumPy
throughout.  Covered: ``feature``, the adjacency keys ``adj`` (per-graph COO
tuples), ``dense_adj`` and ``multi_dense_adj``, the transform flags
``order`` / ``split_adj_flag`` / ``normalize_adj_flag``, ``label`` /
``mask_label`` (and their ``*_sparse`` forms), ``node_label`` /
``mask_node_label``, ``class_weight``, ``mol_info``, ``max_node_num``, and
the node-embedding mode of KG datasets (``node`` / ``node_num`` with
``with_node_embedding``, ``label_list`` / ``test_label_list``).

Not read yet, because no ported model uses them (ROADMAP.md queue A):
``sequence*``, the vector modals and ``graph_index_list``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np

from kgcn_tpu_torch.data import jbl
from kgcn_tpu_torch.graph import transforms
from kgcn_tpu_torch.graph.batch import pad_edge_budget


@dataclasses.dataclass
class DatasetInfo:
    """Static dataset metadata (the reference's ``info`` dotdict,
    kgcn/data_util.py:484-592); fields as in ``kgcn_tpu``."""

    feature_dim: int = 0
    graph_node_num: int = 0
    graph_num: int = 0
    label_dim: Optional[int] = None
    adj_channel_num: int = 1
    all_node_num: Optional[int] = None
    feature_enabled: bool = True
    pos_weight: Optional[np.ndarray] = None
    class_weight: Optional[np.ndarray] = None
    edge_budget_per_graph: int = 0
    mol_info: Optional[Any] = None


@dataclasses.dataclass
class Dataset:
    """Host-side dataset: per-graph COO adjacency channels + aligned arrays."""

    # adjs[g] = list of (row, col, val) numpy triples, one per channel
    adjs: Optional[List[List[tuple]]] = None
    features: Optional[np.ndarray] = None  # [G, N, F]
    nodes: Optional[np.ndarray] = None  # [G, N] int vocab ids (embedding mode)
    labels: Optional[np.ndarray] = None
    mask_label: Optional[np.ndarray] = None
    node_label: Optional[np.ndarray] = None
    mask_node_label: Optional[np.ndarray] = None
    label_list: Optional[Any] = None  # KG triple lists
    enabled_node_nums: Optional[np.ndarray] = None
    num: int = 0
    max_node_num: int = 0

    def subset(self, idx) -> "Dataset":
        """The examples ``idx`` (``kgcn_tpu``'s ``Dataset.subset``)."""
        idx = np.asarray(idx)

        def take(x):
            if x is None:
                return None
            if isinstance(x, np.ndarray):
                return x[idx]
            return [x[i] for i in idx]

        return Dataset(
            adjs=take(self.adjs),
            features=take(self.features),
            nodes=take(self.nodes),
            labels=take(self.labels),
            mask_label=take(self.mask_label),
            node_label=take(self.node_label),
            mask_node_label=take(self.mask_node_label),
            label_list=self.label_list,
            enabled_node_nums=take(self.enabled_node_nums),
            num=len(idx),
            max_node_num=self.max_node_num,
        )


def split_dataset(ds: Dataset, valid_rate: float, seed: int = 0,
                  shuffle: bool = True):
    """Random train/valid split with ``kgcn_tpu``'s seeded permutation
    (``kgcn_tpu/data/dataset.py:364``; reference kgcn/data_util.py:595-644):
    (train, valid, train_idx, valid_idx)."""
    idx = np.arange(ds.num)
    if shuffle:
        np.random.RandomState(seed).shuffle(idx)
    n_valid = int(ds.num * valid_rate)
    valid_idx, train_idx = idx[:n_valid], idx[n_valid:]
    return ds.subset(train_idx), ds.subset(valid_idx), train_idx, valid_idx


def _dense_to_coo(dense: np.ndarray):
    dense = np.asarray(dense)
    row, col = np.nonzero(dense)
    return (
        row.astype(np.int32),
        col.astype(np.int32),
        dense[row, col].astype(np.float32),
    )


def _tuple_to_coo(t):
    indices, values, _shape = t
    indices = np.asarray(indices).reshape(-1, 2)
    return (
        indices[:, 0].astype(np.int32),
        indices[:, 1].astype(np.int32),
        np.asarray(values, dtype=np.float32).reshape(-1),
    )


def _is_coo_tuple(x) -> bool:
    # matches reference check_adj (kgcn/data_util.py:49-56): a single-channel
    # (indices, values, shape) triple rather than a per-channel list
    try:
        return len(x) == 3 and len(x[2]) == 2 and np.isscalar(np.asarray(x[2][0]).item())
    except (TypeError, ValueError, IndexError):
        return False


def _last_active_row(m) -> int:
    """Enabled node count of a dense adjacency: the LAST active row + 1.
    The node mask is a prefix, so counting active rows would cut off a real
    trailing node whenever an earlier real node is isolated."""
    nz = np.nonzero(np.abs(np.asarray(m)).sum(axis=1) > 0)[0]
    return int(nz[-1]) + 1 if len(nz) else 1


def _adjacency(data: Dict[str, Any]):
    """(per-graph COO channels, enabled node counts, max_node_num)."""
    max_node_num = int(data.get("max_node_num", 0) or 0)
    if "multi_dense_adj" in data:
        raw = data["multi_dense_adj"]
        # union of the channels' active rows
        enabled = np.array(
            [_last_active_row(sum(np.abs(np.asarray(m)) for m in lm)) for lm in raw],
            np.int32,
        )
        adjs = [[_dense_to_coo(m) for m in lm] for lm in raw]
        if not max_node_num:
            max_node_num = int(max(np.asarray(m).shape[0] for lm in raw for m in lm))
        return adjs, enabled, max_node_num
    if "adj" in data:
        # the KNIME preprocessing chain stores adj as an object NDARRAY
        # rather than a list — normalise, and drop None placeholders
        raw = list(data["adj"])
        if any(a is None for a in raw):
            keep = [i for i, a in enumerate(raw) if a is not None]
            raw = [raw[i] for i in keep]
            for key in ("label", "mask_label", "feature"):
                if key in data and data[key] is not None:
                    arr = data[key]
                    data[key] = (
                        np.asarray([arr[i] for i in keep])
                        if not isinstance(arr, list)
                        else [arr[i] for i in keep]
                    )
        if len(raw) and _is_coo_tuple(raw[0]):
            enabled = np.array([int(t[2][0]) for t in raw], np.int32)
            adjs = [[_tuple_to_coo(t)] for t in raw]
        else:
            enabled = np.array([int(gs[0][2][0]) for gs in raw], np.int32)
            adjs = [[_tuple_to_coo(t) for t in gs] for gs in raw]
        return adjs, enabled, max_node_num
    if "dense_adj" in data:
        raw = np.asarray(data["dense_adj"])
        enabled = np.array([_last_active_row(m) for m in raw], np.int32)
        adjs = [[_dense_to_coo(m)] for m in raw]
        return adjs, enabled, max_node_num or raw.shape[1]
    return None, None, max_node_num


def build_dataset(data: Dict[str, Any], config: Optional[Dict[str, Any]] = None,
                  test_mode: bool = False, verbose: bool = False):
    """Assemble (Dataset, DatasetInfo) from a raw jbl dict, as
    ``kgcn_tpu.data.build_dataset`` does (reference: kgcn/data_util.py:374-592),
    for the keys listed in the module docstring.  ``test_mode`` selects the
    KG test triples (``test_label_list``) instead of the training ones."""
    config = config or {}
    order = int(config.get("order", 1) or 1)
    split_flag = bool(config.get("split_adj_flag", False))
    normalize_flag = bool(config.get("normalize_adj_flag", False))

    features = data.get("feature") if config.get("with_feature", True) else None
    if features is not None and len(features) == 0:
        features = None
    if features is not None:
        features = np.asarray(features, dtype=np.float32)
    nodes = None
    if config.get("with_node_embedding", False) and "node" in data:
        nodes = np.array(data["node"], np.int32)

    adjs, enabled, max_node_num = _adjacency(data)
    if adjs is not None:
        if not max_node_num:
            max_node_num = int(enabled.max())
        if order > 1:
            # powers A^1..A^order become EXTRA channels (kgcn/data_util.py:407)
            adjs = [
                [
                    transforms.high_order_adj(r, c, v, max_node_num, o)
                    for (r, c, v) in gs
                    for o in range(1, order + 1)
                ]
                for gs in adjs
            ]
        if split_flag:
            adjs = [
                [
                    ch
                    for (r, c, v) in gs
                    for ch in transforms.split_adj(r, c, v, max_node_num)
                ]
                for gs in adjs
            ]
        if normalize_flag:
            adjs = [
                [transforms.normalize_adj(r, c, v, max_node_num) for (r, c, v) in gs]
                for gs in adjs
            ]

    labels = data.get("label")
    mask_label = data.get("mask_label")
    if "label_sparse" in data:
        labels = np.array(data["label_sparse"].todense())
    if "mask_label_sparse" in data:
        mask_label = np.array(data["mask_label_sparse"].todense())
    if labels is not None:
        labels = np.asarray(labels)
    if mask_label is not None:
        mask_label = np.asarray(mask_label)
    node_label = data.get("node_label")
    mask_node_label = data.get("mask_node_label")
    label_list = None
    if "label_list" in data:
        label_list = data["test_label_list"] if test_mode else data["label_list"]

    num = len(adjs) if adjs is not None else (len(labels) if labels is not None else 0)
    ds = Dataset(
        adjs=adjs,
        features=features,
        nodes=nodes,
        labels=labels,
        mask_label=mask_label,
        node_label=np.asarray(node_label) if node_label is not None else None,
        mask_node_label=(
            np.asarray(mask_node_label) if mask_node_label is not None else None
        ),
        label_list=label_list,
        enabled_node_nums=enabled,
        num=num,
        max_node_num=max_node_num,
    )

    info = DatasetInfo()
    info.graph_num = len(adjs) if adjs is not None else 0
    info.adj_channel_num = len(adjs[0]) if adjs else 1
    if features is not None:
        info.feature_dim = features.shape[2]
        info.graph_node_num = features.shape[1]
        info.feature_enabled = True
    elif nodes is not None:
        info.feature_dim = 0
        info.graph_node_num = nodes.shape[1]
        info.all_node_num = int(data["node_num"])
        info.feature_enabled = False
    if max_node_num:
        info.graph_node_num = max(info.graph_node_num, max_node_num)
    if labels is not None:
        info.label_dim = int(data.get("label_dim", labels.shape[1] if labels.ndim >= 2 else 1))
    elif node_label is not None:
        info.label_dim = np.asarray(node_label).shape[2]
    elif "label_dim" in data:
        info.label_dim = int(data["label_dim"])

    # pos/class weights (kgcn/data_util.py:563-576)
    eps = 0.01
    if mask_label is not None and labels is not None:
        sum_all = np.nansum(mask_label, axis=0)
        sum_pos = np.nansum(labels, axis=0)
        info.pos_weight = (sum_all - sum_pos + eps) / (sum_pos + eps)
    if "class_weight" in data:
        info.class_weight = np.asarray(data["class_weight"])
    elif labels is not None:
        sum_pos = np.nansum(labels, axis=0)
        info.class_weight = (np.nansum(labels) + eps) / (sum_pos + eps)
    if "mol_info" in data:
        info.mol_info = data["mol_info"]

    # static edge budget per graph, so every batch shares one shape
    if adjs is not None:
        per_graph = [max((len(ch[0]) for ch in gs), default=1) for gs in adjs]
        info.edge_budget_per_graph = pad_edge_budget(max(per_graph), multiple=1)

    if verbose:
        print(
            f"graphs={info.graph_num} feature_dim={info.feature_dim} "
            f"max_nodes={info.graph_node_num} label_dim={info.label_dim} "
            f"adj_channels={info.adj_channel_num}"
        )
    return ds, info


def load_jbl(path: str, config: Optional[Dict[str, Any]] = None, test_mode: bool = False):
    """Read a ``.jbl`` file with the port's own reader and build it."""
    return build_dataset(jbl.load(path), config, test_mode=test_mode)
