"""Split one ``.jbl`` dataset into per-fold files — the port's own copy of
``kgcn_tpu/cli/cv_splitter.py`` (reference: ``kgcn-cv-splitter``,
script_cv/cv_splitter.py:31-148, kgcn/data_util.py:187-352 split_jbl_obj).

    python -m kgcn_tpu_torch.cli.cv_splitter --input data.jbl \\
        [--output-dir DIR] [--fold 5] [--seed 0] [--stratified]

Writes ``<name>.fold<k>.train.jbl`` and ``.test.jbl`` per fold, with the
folds of the port's ``kfold_indices`` (equal to ``kgcn_tpu``'s), so folds
can run as independent processes.  Reads with ``data/jbl.py``; writes plain
pickles (protocol 4), which ``joblib.load`` reads too.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

SPLITTABLE_ARRAYS = [
    "feature", "dense_adj", "label", "mask_label", "node_label",
    "mask_node_label", "sequence", "vector_modal", "profeat", "dragon",
    "chemical_fp", "node",
]
SPLITTABLE_LISTS = ["adj", "multi_dense_adj", "sequence_length"]
# scipy CSR label matrices (dataset.py label_sparse schema) — row-sliceable
SPLITTABLE_SPARSE = ["label_sparse", "mask_label_sparse"]


def data_num(obj) -> int:
    for key in ("adj", "dense_adj", "multi_dense_adj", "feature", "label"):
        if key in obj:
            return len(obj[key])
    raise ValueError("cannot determine dataset size")


def split_jbl_obj(obj, idx):
    """Subset a jbl dict by example indices (kgcn/data_util.py:187-352)."""
    idx = np.asarray(idx)
    out = {}
    for k, v in obj.items():
        if k in SPLITTABLE_ARRAYS and v is not None and hasattr(v, "__len__") \
                and len(v) == data_num(obj):
            out[k] = np.asarray(v)[idx] if isinstance(v, np.ndarray) else [
                v[i] for i in idx
            ]
        elif k in SPLITTABLE_LISTS and v is not None and len(v) == data_num(obj):
            out[k] = [v[i] for i in idx]
        elif k in SPLITTABLE_SPARSE and v is not None:
            # leaving the FULL sparse matrix in every fold would silently
            # misalign labels with the subset examples
            out[k] = v[idx]
        elif k == "mol_info" and isinstance(v, dict) and "obj_list" in v:
            out[k] = {
                "obj_list": [v["obj_list"][i] for i in idx],
                "index_list": list(range(len(idx))),
            }
        else:
            out[k] = v
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="kgcn-tpu-cv-splitter", description=__doc__)
    p.add_argument("--input", required=True)
    p.add_argument("--output-dir", default=".")
    p.add_argument("--fold", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--stratified", action="store_true")
    args = p.parse_args(argv)

    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.dataset import kfold_indices

    obj = jbl.load(args.input)
    n = data_num(obj)
    stratify = None
    if args.stratified and "label" in obj:
        stratify = np.argmax(np.asarray(obj["label"]), axis=1)
    folds = kfold_indices(n, args.fold, seed=args.seed, stratify=stratify)
    os.makedirs(args.output_dir, exist_ok=True)
    base = os.path.splitext(os.path.basename(args.input))[0]
    for k, (train_idx, test_idx) in enumerate(folds):
        for tag, idx in (("train", train_idx), ("test", test_idx)):
            path = os.path.join(args.output_dir, f"{base}.fold{k}.{tag}.jbl")
            with open(path, "wb") as f:
                pickle.dump(split_jbl_obj(obj, idx), f, protocol=4)
            print(f"[SAVE] {path} ({len(idx)} examples)")


if __name__ == "__main__":
    main()
