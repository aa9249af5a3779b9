"""Molecular preprocessing — the port's own copy of ``kgcn_tpu/cli/chem.py``
(reference: ``kgcn-chem``, kgcn/preprocessing/chem.py:552-770).

    python -m kgcn_tpu_torch.cli.chem --smiles mols.smi --label labels.txt \\
        [--atom-num-limit 50] [--morgan-fingerprint] -o dataset.jbl

SMILES / SDF / multitask assay CSV → ``.jbl`` (or ``.tfrecords``) with the
81-dim atom featuriser, atom-count filter, NaN→mask multitask label
matrices, optional Morgan fingerprints and protein-sequence modality; the
same flags, messages and dataset dict as ``kgcn_tpu``'s.  Uses RDKit when
importable, otherwise the dependency-free :mod:`kgcn_tpu_torch.data.molparse`
SDF/SMILES backend (SMARTS and Gasteiger charges still need RDKit).

Host-only preprocessing: it touches no device and has no ``--cpu`` flag.
The ``.jbl`` is a plain pickle (protocol 4), not a joblib stream: the port
does without joblib, and ``joblib.load`` and the port's ``data/jbl.load``
both read it.  ``mol_info`` holds the port's ``Molecule`` objects.
``--tfrecords`` writes through the port's ``data/tfrecord.py``.
"""
from __future__ import annotations

import argparse
import csv
import os
import pickle

import numpy as np


def read_label_csv(path: str):
    """CSV: first column SMILES, remaining columns task labels (blank/NaN →
    masked) — the assay-matrix format (chem.py:436-490)."""
    smiles, rows = [], []
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        for row in reader:
            if not row:
                continue
            smiles.append(row[0])
            vals = [
                float(v) if v not in ("", "NA", "nan", None) else np.nan
                for v in row[1:]
            ]
            rows.append(vals)
    return smiles, np.asarray(rows, np.float64), header[1:]


def main(argv=None):
    p = argparse.ArgumentParser(prog="kgcn-tpu-chem", description=__doc__)
    p.add_argument("--smiles", default=None, help="text file, one SMILES/line")
    p.add_argument("--sdf", default=None)
    p.add_argument("--assay-csv", default=None,
                   help="CSV: smiles,task1,task2,... (blank = masked)")
    p.add_argument("--label", default=None,
                   help="label text file aligned with --smiles (one row/line)")
    p.add_argument("-o", "--output", default="dataset.jbl")
    p.add_argument("--atom-num-limit", type=int, default=50)
    p.add_argument("--deepchem-compat", action="store_true",
                   help="75-dim deepchem featuriser mode")
    p.add_argument("--use-electronegativity", action="store_true",
                   help="append Pauling electronegativity to atom features")
    p.add_argument("--use-sybyl", action="store_true",
                   help="SYBYL atom-type one-hot instead of element symbols "
                        "(reference --use_sybyl, kgcn/preprocessing/chem.py:135)")
    p.add_argument("--use-gasteiger", action="store_true",
                   help="append Gasteiger partial charge to atom features")
    p.add_argument("--use-gaff", action="store_true",
                   help="GAFF atom-type one-hot as the ONLY atom features "
                        "(reference --use_gaff, kgcn/preprocessing/chem.py:"
                        "139-140; openbabel-free graph-context typer)")
    p.add_argument("--pseudo-negative", action="store_true",
                   help="balance assay labels by unmasking random cells as "
                        "negatives (CPI; reference chem.py:193-226)")
    p.add_argument("--morgan-fingerprint", action="store_true")
    p.add_argument("--sequence", default=None,
                   help="protein sequence file (CPI multimodal), one/line")
    p.add_argument("--max-len-seq", type=int, default=750)
    p.add_argument("--tfrecords", action="store_true",
                   help="write sharded tfrecords instead of jbl")
    p.add_argument("--no-mol-info", action="store_true")
    args = p.parse_args(argv)

    from kgcn_tpu_torch.data import featurizer as fz

    labels = None
    if args.assay_csv:
        smiles, labels, task_names = read_label_csv(args.assay_csv)
        print(f"[INFO] {len(smiles)} molecules, tasks: {task_names}")
        mols = fz.parse_molecules(smiles=smiles)
    elif args.smiles:
        with open(args.smiles) as f:
            smiles = [line.strip() for line in f if line.strip()]
        mols = fz.parse_molecules(smiles=smiles)
    elif args.sdf:
        mols = fz.parse_molecules(sdf_path=args.sdf)
    else:
        p.error("one of --smiles / --sdf / --assay-csv required")

    if args.label:
        with open(args.label) as f:
            labels = np.asarray(
                [[float(x) for x in line.split(",")] for line in f if line.strip()]
            )

    sequences = None
    symbol_num = None
    if args.sequence:
        with open(args.sequence) as f:
            seqs = [line.strip() for line in f if line.strip()]
        sequences = np.stack(
            [fz.encode_protein_sequence(s, args.max_len_seq) for s in seqs]
        )
        symbol_num = len(fz.AMINO_ACIDS) + 2

    if args.use_gaff and (args.use_sybyl or args.use_electronegativity
                          or args.use_gasteiger or args.deepchem_compat):
        # the reference documents GAFF as exclusive of every other feature
        # mode (chem.py:139-140) — the one-hot IS the whole vector
        p.error("--use-gaff cannot be combined with other feature flags "
                "(reference chem.py:139-140)")
    if args.deepchem_compat and (args.use_sybyl or args.use_electronegativity
                                 or args.use_gasteiger):
        # the reference forces use_sybyl/EN/gasteiger off in deepchem mode
        # (reference chem.py:554-558); match it rather than emit hybrid
        # feature vectors the reference cannot produce
        print("[WARN] --deepchem-compat ignores --use-sybyl/"
              "--use-electronegativity/--use-gasteiger (reference "
              "chem.py:554-558)")
        args.use_sybyl = args.use_electronegativity = args.use_gasteiger = False

    data = fz.build_chem_dataset(
        mols,
        labels=labels,
        atom_num_limit=args.atom_num_limit,
        deepchem_compat=args.deepchem_compat,
        use_electronegativity=args.use_electronegativity,
        use_gasteiger=args.use_gasteiger,
        use_sybyl=args.use_sybyl,
        use_gaff=args.use_gaff,
        with_fingerprint=args.morgan_fingerprint,
        sequences=sequences,
        sequence_symbol_num=symbol_num,
        generate_mol_info=not args.no_mol_info,
    )
    if args.pseudo_negative and "label" in data:
        lab, msk, n_added = fz.generate_pseudo_negatives(
            data["label"], data["mask_label"]
        )
        data["label"], data["mask_label"] = lab, msk
        print(f"[INFO] pseudo negative count: {n_added}")

    if args.tfrecords:
        from kgcn_tpu_torch.data.tfrecord import example_from_graph, write_tfrecord

        dropped = [k for k in ("sequence", "chemical_fp", "vector_modal",
                               "mol_info") if k in data]
        if dropped:
            print(f"[WARN] --tfrecords keeps only adjacency/feature/label "
                  f"(the reference's record schema) — dropping {dropped}; "
                  "use the jbl output to keep them")
        d = os.path.dirname(args.output)
        if d:
            os.makedirs(d, exist_ok=True)
        recs = []
        n = len(data["adj"])
        for i in range(n):
            indices, values, shape = data["adj"][i]
            dense = np.zeros(shape, np.float32)
            dense[indices[:, 0], indices[:, 1]] = values
            lab = data.get("label")
            mask = data.get("mask_label")
            recs.append(
                example_from_graph(
                    # slice to the TRUE atom count so the record's `size`
                    # (read back as enabled_node_nums) is not the pad limit
                    dense, data["feature"][i][: shape[0]],
                    label=lab[i] if lab is not None else None,
                    mask_label=mask[i] if mask is not None else None,
                )
            )
        write_tfrecord(args.output, recs)
        print(f"[SAVE] {args.output} ({len(recs)} records)")
    else:
        d = os.path.dirname(args.output)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(args.output, "wb") as f:
            pickle.dump(data, f, protocol=4)
        print(f"[SAVE] {args.output} ({len(data['adj'])} molecules)")


if __name__ == "__main__":
    main()
