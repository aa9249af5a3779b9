"""Python helpers behind the KNIME GCN-K nodes — the port's own copy of
``kgcn_tpu/knime/helpers.py``.

Each function is the counterpart of one script in the reference plugin's
``py/`` directory (reference: KNIME/GCN-K/py/*.py — flags, intermediate
``.jbl`` schemas, and output layouts match), on the port's RDKit-free
molecule protocol (``data/molparse`` + ``data/featurizer``); with RDKit
installed the same code paths accept RDKit molecules unchanged.  The
intermediate files are plain pickles (protocol 4) read back with
``data/jbl.py`` (``kgcn_tpu`` writes them with joblib, whose loader reads
these too).  The score viewer draws with the port's ``tools/plots.py``
(NumPy metric copies, matplotlib imported only when drawing).

Pipeline (node wiring in KNIME):

    SDFReader            → prep_mol_info : SDF → {mol_info, atom_num_limit}
    GraphExtractor       → prep_adj      : + adj (per-graph COO tuples)
    AtomFeatureExtractor → prep_feat     : + feature [G, N, 81]
    CSVLabelExtractor    → prep_label    : {label, mask_label} (NaN → mask)
    GCNDatasetBuilder    → prep_dataset  : merge the three → dataset.jbl
    GCNDatasetSplitter   → split_dataset : ratio split (order-preserving)
    AddModality          → add_modality  : merge modality dict into dataset
    AdditionalModalityPreprocessor → preprocess_modality
    GCNLearner/Predictor/Visualizer → clean_dataset + cli.main
    GCNScore             → gcn_score     : prediction jbl → CSV
    GCNScoreViewer       → gcn_score_viewer : AUC plots per task
    GCNGraphViewer       → graph_viewer  : IG atom-coloring images
"""
from __future__ import annotations

import argparse
import os
import pickle
from typing import List, Optional

import numpy as np

from kgcn_tpu_torch.data import jbl

KEYS = ["label", "feature", "mask_label", "adj",
        "vector_modal", "profeat", "dragon", "chemical_fp", "mol_info"]


def _dump(obj, path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=4)


def _load_mols(sdf: str) -> List:
    from kgcn_tpu_torch.data.featurizer import parse_molecules

    return parse_molecules(sdf_path=sdf)


def prep_mol_info(sdf: str, atom_num_limit: int, output: str) -> dict:
    """SDF → mol_info jbl (reference: py/prep_mol_info.py).  Oversize
    molecules stay as None placeholders so CSV label rows keep aligning."""
    mols = _load_mols(sdf)
    names = []
    for i, mol in enumerate(mols):
        if mol is None:
            names.append("")
            continue
        if atom_num_limit is not None and mol.GetNumAtoms() > atom_num_limit:
            mols[i] = None
            names.append("")
            continue
        try:
            names.append(mol.GetProp("_Name"))
        except Exception:
            names.append(getattr(mol, "name", "") or "")
    obj = {
        "mol_info": {"obj_list": mols, "name_list": names},
        "atom_num_limit": atom_num_limit,
    }
    print("[SAVE] " + output)
    _dump(obj, output)
    return obj


def _dense_to_sparse(dense):
    row, col = np.nonzero(dense)
    return (
        np.stack([row, col], axis=1),
        np.asarray(dense[row, col], np.float32),
        np.asarray(dense.shape),
    )


def prep_adj(mol_info: str, output: str) -> dict:
    """mol_info jbl → + per-graph adjacency COO tuples with self loops
    (reference: py/prep_adj.py)."""
    from kgcn_tpu_torch.data.featurizer import adjacency_matrix

    obj = jbl.load(mol_info)
    adj_list = []
    for mol in obj["mol_info"]["obj_list"]:
        if mol is None:
            adj_list.append(None)
            continue
        adj_list.append(_dense_to_sparse(adjacency_matrix(mol)))
    obj["adj"] = np.asarray(adj_list, dtype=object)
    print("[SAVE] " + output)
    _dump(obj, output)
    return obj


def prep_feat(mol_info: str, output: str) -> dict:
    """mol_info jbl → + padded [G, N, 81] atom features
    (reference: py/prep_feat.py — same 81-dim schema)."""
    from kgcn_tpu_torch.data.featurizer import atom_features

    obj = jbl.load(mol_info)
    limit = int(obj["atom_num_limit"])
    feats = []
    for mol in obj["mol_info"]["obj_list"]:
        if mol is None:
            feats.append(None)
            continue
        f = np.stack([atom_features(a) for a in mol.GetAtoms()]).astype(
            np.float32
        )
        padded = np.zeros((limit, f.shape[1]), np.float32)
        padded[: len(f)] = f
        feats.append(padded)
    obj["feature"] = np.asarray(feats, dtype=object)
    print("[SAVE] " + output)
    _dump(obj, output)
    return obj


def prep_label(label: str, output: str) -> dict:
    """Headerless CSV → {label, mask_label}; NaN entries become mask zeros
    (reference: py/prep_label.py)."""
    rows = []
    with open(label) as f:
        for line in f:
            if not line.strip():
                continue
            rows.append([
                float(x) if x.strip() != "" else np.nan
                for x in line.rstrip("\n").split(",")
            ])
    arr = np.asarray(rows, np.float64)
    mask = np.zeros_like(arr, np.float32)
    mask[~np.isnan(arr)] = 1
    arr = np.where(np.isnan(arr), 0.0, arr)
    obj = {"label": arr, "mask_label": mask}
    print("[SAVE] " + output)
    _dump(obj, output)
    return obj


def prep_dataset(label: str, adjacent: str, atom_feature: str,
                 output: str) -> dict:
    """Merge the three intermediate jbls into one dataset
    (reference: py/prep_dataset.py)."""
    obj = jbl.load(label)
    obj.update(jbl.load(adjacent))
    obj.update(jbl.load(atom_feature))
    obj["max_node_num"] = obj["atom_num_limit"]
    print("[SAVE] " + output)
    _dump(obj, output)
    return obj


def clean_dataset(dataset: str, output: str) -> dict:
    """Drop records whose adjacency is None (oversize/unparseable molecules)
    from every aligned key (reference: py/clean_dataset.py)."""
    obj = jbl.load(dataset)
    adjs = obj["adj"]
    for key in KEYS:
        if key == "mol_info" and key in obj:
            for mk in obj[key]:
                obj[key][mk] = np.asarray(
                    [v for a, v in zip(adjs, obj[key][mk]) if a is not None],
                    dtype=object,
                )
        elif key not in obj:
            continue
        else:
            vals = [v for a, v in zip(adjs, obj[key]) if a is not None]
            try:
                obj[key] = np.asarray(vals)
            except ValueError:  # ragged
                obj[key] = np.asarray(vals, dtype=object)
    print("[SAVE] " + output)
    _dump(obj, output)
    return obj


def split_dataset(dataset: str, ratio: float, output1: str,
                  output2: str) -> tuple:
    """Order-preserving ratio split counting only valid (non-None-adj)
    records, like the reference (py/split_dataset.py)."""
    obj = jbl.load(dataset)
    adjs = obj["adj"]
    nmol = len([a for a in adjs if a is not None])
    nmol1 = int(nmol * ratio)
    cut = 0
    if nmol1 > 0:
        remaining = nmol1
        for i, a in enumerate(adjs):
            if a is not None:
                remaining -= 1
            if remaining == 0:
                cut = i + 1
                break
    obj1, obj2 = dict(obj), dict(obj)
    for key in KEYS:
        if key == "mol_info" and key in obj:
            obj1[key] = {mk: v[:cut] for mk, v in obj[key].items()}
            obj2[key] = {mk: v[cut:] for mk, v in obj[key].items()}
        elif key in obj:
            obj1[key] = obj[key][:cut]
            obj2[key] = obj[key][cut:]
    print("[SAVE] " + output1)
    _dump(obj1, output1)
    print("[SAVE] " + output2)
    _dump(obj2, output2)
    return obj1, obj2


def add_modality(dataset: str, modality: str, output: str) -> dict:
    """Merge a modality jbl (profeat/sequence/vector_modal keys) into the
    dataset (reference: py/add_modality.py)."""
    obj = jbl.load(dataset)
    obj.update(jbl.load(modality))
    print("[SAVE] " + output)
    _dump(obj, output)
    return obj


def preprocess_modality(output: str, profeat: Optional[str] = None,
                        sequence: Optional[str] = None) -> dict:
    """CSV modality files → modality jbl (reference:
    py/preprocess_modality.py): profeat rows as float vectors; sequences as
    zero-padded int matrices + lengths + symbol count."""
    obj = {}
    if profeat and os.path.exists(profeat):
        print("[LOAD] " + profeat)
        obj["profeat"] = np.asarray(
            [[float(x) for x in line.strip().split(",")]
             for line in open(profeat) if line.strip()]
        )
    if sequence and os.path.exists(sequence):
        print("[LOAD] " + sequence)
        seqs = [
            [int(float(x)) for x in line.strip().split(",")]
            for line in open(sequence) if line.strip()
        ]
        max_len = max(map(len, seqs))
        mat = np.zeros((len(seqs), max_len), np.int32)
        for i, s in enumerate(seqs):
            mat[i, : len(s)] = s
        obj["sequence"] = mat
        obj["sequence_length"] = np.asarray([len(s) for s in seqs], np.int32)
        obj["sequence_symbol_num"] = int(mat.max()) + 1
    print("[SAVE] " + output)
    _dump(obj, output)
    return obj


def gcn_score(prediction_data: str, output: str) -> None:
    """Prediction jbl → CSV rows (graph-centric [G, D] or node-centric
    [G, N, D] with blank lines between graphs; reference: py/gcn_score.py)."""
    obj = jbl.load(prediction_data)
    pred = np.asarray(obj["prediction_data"])
    print("[SAVE] " + output)
    with open(output, "w") as fp:
        if pred.ndim == 2:
            for dist in pred:
                fp.write(",".join(map(str, dist)) + "\n")
        elif pred.ndim == 3:
            for node_pred in pred:
                for dist in node_pred:
                    fp.write(",".join(map(str, dist)) + "\n")
                fp.write("\n")
        else:
            print("[ERROR] unknown prediction format")


def gcn_score_viewer(prediction_data: str, output: str,
                     plot_multitask: bool = False) -> list:
    """AUC plot(s) from a prediction jbl carrying true labels
    (reference: py/gcn_score_viewer.py) → <output>/auc[_task].png paths."""
    from kgcn_tpu_torch.tools.plots import plot_auc

    obj = jbl.load(prediction_data)
    pred = np.asarray(obj["prediction_data"])
    labels = np.asarray(obj["true_label"])
    if labels.ndim == 1:
        labels = np.stack([1 - labels, labels], axis=1)
    cfg = {"plot_path": output + "/"}
    paths = []
    if plot_multitask and pred.ndim == 3:
        for t in range(pred.shape[1]):
            paths.append(plot_auc(cfg, labels[:, t], pred[:, t],
                                  name=f"task{t}_"))
    else:
        paths.append(plot_auc(cfg, labels, pred))
    return paths


def graph_viewer(ig_dir: str, output: str) -> list:
    """Render every visualization/mol_*.jbl IG dump to an image
    (reference: py/graph_viewer.py → gcnv rendering)."""
    import glob as _glob

    from kgcn_tpu_torch.cli.gcnv import render

    os.makedirs(output, exist_ok=True)
    dumps = sorted(_glob.glob(os.path.join(ig_dir, "mol_*.jbl")))
    for path in dumps:
        render(path, output)
    outs = sorted(_glob.glob(os.path.join(output, "*.png"))) + sorted(
        _glob.glob(os.path.join(output, "*.svg"))
    )
    return outs


# --------------------------------------------------------------------------
# argparse entry points (one per reference script; flags match exactly)


def _ap(**flags):
    p = argparse.ArgumentParser()
    for name, kw in flags.items():
        p.add_argument(name, **kw)
    return p


def main_prep_mol_info(argv=None):
    a = _ap(**{"--sdf": dict(type=str), "--atom_num_limit": dict(
        type=int, required=True), "--output": dict(type=str, default="dataset.jbl")}
    ).parse_args(argv)
    prep_mol_info(a.sdf, a.atom_num_limit, a.output)


def main_prep_adj(argv=None):
    a = _ap(**{"--mol_info": dict(type=str, required=True),
               "--output": dict(type=str, required=True)}).parse_args(argv)
    prep_adj(a.mol_info, a.output)


def main_prep_feat(argv=None):
    a = _ap(**{"--mol_info": dict(type=str, required=True),
               "--output": dict(type=str, required=True)}).parse_args(argv)
    prep_feat(a.mol_info, a.output)


def main_prep_label(argv=None):
    a = _ap(**{"--label": dict(type=str, required=True),
               "--output": dict(type=str, required=True)}).parse_args(argv)
    prep_label(a.label, a.output)


def main_prep_dataset(argv=None):
    a = _ap(**{"--label": dict(type=str, required=True),
               "--adjacent": dict(type=str, required=True),
               "--atom_feature": dict(type=str, required=True),
               "--output": dict(type=str, required=True)}).parse_args(argv)
    prep_dataset(a.label, a.adjacent, a.atom_feature, a.output)


def main_clean_dataset(argv=None):
    a = _ap(**{"--dataset": dict(type=str, required=True),
               "--output": dict(type=str, required=True)}).parse_args(argv)
    clean_dataset(a.dataset, a.output)


def main_split_dataset(argv=None):
    a = _ap(**{"--dataset": dict(type=str, required=True),
               "--ratio": dict(type=float, required=True),
               "--output1": dict(type=str, required=True),
               "--output2": dict(type=str, required=True)}).parse_args(argv)
    split_dataset(a.dataset, a.ratio, a.output1, a.output2)


def main_add_modality(argv=None):
    a = _ap(**{"--dataset": dict(type=str, required=True),
               "--modality": dict(type=str, required=True),
               "--output": dict(type=str, required=True)}).parse_args(argv)
    add_modality(a.dataset, a.modality, a.output)


def main_preprocess_modality(argv=None):
    a = _ap(**{"--profeat": dict(type=str), "--sequence": dict(type=str),
               "--output": dict(type=str, required=True)}).parse_args(argv)
    preprocess_modality(a.output, profeat=a.profeat, sequence=a.sequence)


def main_gcn_score(argv=None):
    a = _ap(**{"--prediction_data": dict(type=str, required=True),
               "--output": dict(type=str, required=True)}).parse_args(argv)
    gcn_score(a.prediction_data, a.output)


def main_gcn_score_viewer(argv=None):
    p = _ap(**{"--prediction_data": dict(type=str, required=True),
               "--output": dict(type=str, required=True)})
    p.add_argument("--plot_multitask", action="store_true", default=False)
    a = p.parse_args(argv)
    gcn_score_viewer(a.prediction_data, a.output, a.plot_multitask)


def main_graph_viewer(argv=None):
    a = _ap(**{"--ig_dir": dict(type=str, required=True),
               "--output": dict(type=str, required=True)}).parse_args(argv)
    graph_viewer(a.ig_dir, a.output)
