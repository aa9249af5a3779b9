"""Concatenate ``.jbl`` datasets / attach modal columns — the port's own
copy of ``kgcn_tpu/cli/data_join.py`` (reference: ``kgcn-join``,
kgcn/data_join.py:11-66, join_jbl_obj in kgcn/data_util.py).

    python -m kgcn_tpu_torch.cli.data_join --input a.jbl b.jbl \\
        --output joined.jbl [--modal-csv m.csv --modal-name profeat]

Merges ``.jbl`` files example-wise (same schema; per-node arrays re-padded
to the common ``max_node_num``) or attaches a CSV matrix as an extra
modality.  Reads with ``data/jbl.py``; writes a plain pickle (protocol 4).
"""
from __future__ import annotations

import argparse
import pickle

import numpy as np

from kgcn_tpu_torch.cli.cv_splitter import SPLITTABLE_ARRAYS, SPLITTABLE_LISTS, data_num


def join_jbl_objs(objs):
    out = {}
    keys = set().union(*(o.keys() for o in objs))
    for k in keys:
        vals = [o.get(k) for o in objs]
        if all(v is None for v in vals):
            continue
        sample = next(v for v in vals if v is not None)
        if k in SPLITTABLE_ARRAYS and isinstance(sample, np.ndarray):
            arrs = [np.asarray(v) for v in vals if v is not None]
            # per-node arrays padded to each file's own max_node_num must be
            # re-padded to the common max before concatenation
            if k in ("feature", "dense_adj", "node_label",
                     "mask_node_label") and len(
                         {a.shape[1] for a in arrs if a.ndim >= 2}) > 1:
                n_max = max(a.shape[1] for a in arrs)
                padded = []
                for a in arrs:
                    widths = [(0, 0)] * a.ndim
                    widths[1] = (0, n_max - a.shape[1])
                    if k == "dense_adj" and a.ndim >= 3:
                        widths[2] = (0, n_max - a.shape[2])
                    padded.append(np.pad(a, widths))
                arrs = padded
            out[k] = np.concatenate(arrs)
        elif k in SPLITTABLE_LISTS or (k in SPLITTABLE_ARRAYS and isinstance(sample, list)):
            joined = []
            for v in vals:
                if v is not None:
                    joined.extend(v)
            out[k] = joined
        elif k == "max_node_num":
            out[k] = np.int64(max(int(v) for v in vals if v is not None))
        elif k == "mol_info":
            objl = []
            for v in vals:
                if v:
                    objl.extend(v.get("obj_list", []))
            out[k] = {"obj_list": objl, "index_list": list(range(len(objl)))}
        else:
            out[k] = sample
    return out


def main(argv=None):
    p = argparse.ArgumentParser(prog="kgcn-tpu-join", description=__doc__)
    p.add_argument("--input", nargs="+", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--modal-csv", default=None,
                   help="attach a CSV matrix as vector_modal (row-aligned)")
    p.add_argument("--modal-name", default="vector_modal",
                   choices=["vector_modal", "profeat", "dragon", "chemical_fp"])
    args = p.parse_args(argv)

    from kgcn_tpu_torch.data import jbl

    objs = [jbl.load(path) for path in args.input]
    out = join_jbl_objs(objs) if len(objs) > 1 else dict(objs[0])
    if args.modal_csv:
        mat = np.loadtxt(args.modal_csv, delimiter=",", dtype=np.float32)
        assert len(mat) == data_num(out), "modal rows != dataset size"
        out[args.modal_name] = mat
    with open(args.output, "wb") as f:
        pickle.dump(out, f, protocol=4)
    print(f"[SAVE] {args.output} ({data_num(out)} examples)")


if __name__ == "__main__":
    main()
