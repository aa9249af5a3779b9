"""Dataset summary statistics — the port's own copy of
``kgcn_tpu/cli/chem_summary.py`` (reference:
``kgcn/preprocessing/chem_summary.py:28-122``, ChemSummary).

    python -m kgcn_tpu_torch.cli.chem_summary -p FILE [-f smiles|smarts|sdf|jbl] [-b 20]

Loads a molecule file (smiles / smarts / sdf), prints dataset size,
min/max atom number, min/max molecular weight, and ASCII histograms of
both (``print_histgram``, chem_summary.py:84-107), with the same headers
and numbers as ``kgcn_tpu``'s.

This version additionally summarises prepared ``.jbl`` datasets (graph /
node / edge / label statistics, read with ``data/jbl.py`` and the port's
``build_dataset``) so the tool works on the framework's own artifacts, and
degrades gracefully without RDKit: SMILES atom counts and molecular weights
come from a lightweight element tokenizer, SDF from the V2000 counts line.
With RDKit installed the reference's exact loaders are used.
"""
from __future__ import annotations

import argparse
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

# Standard atomic weights (CIAAW 2021, abridged) for the no-RDKit fallback.
ATOMIC_WEIGHTS = {
    "H": 1.008, "He": 4.003, "Li": 6.94, "Be": 9.012, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998, "Ne": 20.180,
    "Na": 22.990, "Mg": 24.305, "Al": 26.982, "Si": 28.085, "P": 30.974,
    "S": 32.06, "Cl": 35.45, "Ar": 39.95, "K": 39.098, "Ca": 40.078,
    "Ti": 47.867, "V": 50.942, "Cr": 51.996, "Mn": 54.938, "Fe": 55.845,
    "Co": 58.933, "Ni": 58.693, "Cu": 63.546, "Zn": 65.38, "Ga": 69.723,
    "Ge": 72.630, "As": 74.922, "Se": 78.971, "Br": 79.904, "Kr": 83.798,
    "Zr": 91.224, "Mo": 95.95, "Pd": 106.42, "Ag": 107.868, "Cd": 112.414,
    "In": 114.818, "Sn": 118.710, "Sb": 121.760, "Te": 127.60, "I": 126.904,
    "Ba": 137.327, "Yb": 173.045, "Pt": 195.084, "Au": 196.967,
    "Hg": 200.592, "Tl": 204.38, "Pb": 207.2, "Bi": 208.980,
}

# Two-letter symbols first so "Cl" never tokenizes as C+l.
_ELEMENT_RE = re.compile(
    "|".join(sorted(ATOMIC_WEIGHTS, key=len, reverse=True))
)
# Outside brackets only the SMILES organic subset may appear — matching the
# full element table there misreads "In1cccc1" as indium and "Sn1..." as tin
# (those spellings can only mean I+n / S+n unbracketed).
_ORGANIC_RE = re.compile(r"Cl|Br|[BCNOPSFI]")
# Organic-subset aromatic atoms appear lowercase outside brackets.
_AROMATIC = {"b": "B", "c": "C", "n": "N", "o": "O", "p": "P", "s": "S"}


def smiles_atoms(smiles: str) -> List[str]:
    """Tokenize heavy atoms from a SMILES string without RDKit.

    Handles bracket atoms ([nH+], [Fe+2], isotopes), the aromatic organic
    subset, and skips ring-bond digits / branch / bond symbols.  Implicit
    hydrogens are NOT counted (matching ``GetNumAtoms()`` default).
    """
    atoms: List[str] = []
    i, n = 0, len(smiles)
    while i < n:
        ch = smiles[i]
        if ch == "[":
            j = smiles.index("]", i)
            body = smiles[i + 1:j]
            body = re.sub(r"^\d+", "", body)  # isotope prefix
            m = _ELEMENT_RE.match(body) or re.match(r"[a-z]", body)
            if m:
                sym = m.group(0)
                sym = _AROMATIC.get(sym, sym)
                # explicit [H] counts as an atom node (GetNumAtoms does too)
                atoms.append(sym)
            i = j + 1
            continue
        m = _ORGANIC_RE.match(smiles, i)
        if m and ch.isupper():
            sym = m.group(0)
            atoms.append(sym)
            i += len(sym)
            continue
        if ch in _AROMATIC:
            atoms.append(_AROMATIC[ch])
        i += 1
    return atoms


def _load_plain(path: str, fmt: str) -> Tuple[List[int], List[float]]:
    """No-RDKit loaders: (atom_counts, mol_weights).

    Weights are heavy-atom-only (implicit hydrogens need bond-order
    perception); with RDKit installed the exact ``Descriptors.MolWt`` is
    used instead.
    """
    counts, weights = [], []
    if fmt in ("smiles", "smarts"):
        with open(path) as f:
            for line in f:
                token = line.split()[0] if line.split() else ""
                if not token:
                    continue
                atoms = smiles_atoms(token)
                if not atoms:
                    continue
                counts.append(len(atoms))
                weights.append(sum(ATOMIC_WEIGHTS.get(a, 0.0) for a in atoms))
    elif fmt == "sdf":
        with open(path) as f:
            lines = f.read().splitlines()
        i = 0
        while i < len(lines):
            # V2000 counts line is the 4th line of each record
            if i + 3 < len(lines) and lines[i + 3][34:39].strip() == "V2000":
                natoms = int(lines[i + 3][:3])
                counts.append(natoms)
                w = 0.0
                for k in range(natoms):
                    sym = lines[i + 4 + k][31:34].strip()
                    w += ATOMIC_WEIGHTS.get(sym, 0.0)
                weights.append(w)
            # advance to end of record
            while i < len(lines) and lines[i].strip() != "$$$$":
                i += 1
            i += 1
    else:
        raise TypeError(
            "Not Supported format. Supported format type is [smiles, smarts, sdf]"
        )
    return counts, weights


def _load_rdkit(path: str, fmt: str) -> Tuple[List[int], List[float]]:
    from rdkit import Chem
    from rdkit.Chem import Descriptors

    if fmt == "smiles":
        suppl = Chem.SmilesMolSupplier(
            path, sanitize=False, titleLine=False, nameColumn=0
        )
        mols = [m for m in suppl if m is not None]
    elif fmt == "sdf":
        suppl = Chem.SDMolSupplier(path, sanitize=False)
        mols = [m for m in suppl if m is not None]
    elif fmt == "smarts":
        with open(path) as f:
            mols = [Chem.MolFromSmarts(line) for line in f]
        mols = [m for m in mols if m is not None]
    else:
        raise TypeError(
            "Not Supported format. Supported format type is [smiles, smarts, sdf]"
        )
    for m in mols:
        Chem.SanitizeMol(m, sanitizeOps=Chem.rdmolops.SANITIZE_ADJUSTHS)
    return (
        [m.GetNumAtoms() for m in mols],
        [Descriptors.MolWt(m) for m in mols],
    )


def print_histogram(title: str, values: Sequence[float], bins: int) -> None:
    """ASCII histogram in the reference's format (chem_summary.py:84-107):
    one ``[ left, right ] ===`` line per bin, bar length = percent share."""
    arr = np.asarray(values, np.float64)
    counts, edges = np.histogram(arr, bins=bins)
    frac = counts / max(len(arr), 1)
    print(f"\n[Histgram ({title})]")
    for k in range(bins):
        bar = "=" * int(frac[k] * 100)
        print(f"[ {edges[k]:>4.1f}, {edges[k + 1]:>4.1f} ] {bar}")


def summarize_mols(path: str, fmt: str, bins: int = 20) -> dict:
    try:
        counts, weights = _load_rdkit(path, fmt)
    except ImportError:
        counts, weights = _load_plain(path, fmt)
    if not counts:
        raise ValueError(f"no molecules parsed from {path}")
    info = {
        "size": len(counts),
        "max_atom_num": int(max(counts)),
        "min_atom_num": int(min(counts)),
        "max_mol_wt": float(max(weights)),
        "min_mol_wt": float(min(weights)),
    }
    print(f"{'#' * 30} Summary {'#' * 30}\n"
          f"          File name: {path}\n"
          f"       Dataset size: {info['size']}\n"
          f"    Max atom number: {info['max_atom_num']}\n"
          f"Minimum atom number: {info['min_atom_num']}\n"
          f"     Max mol weight: {info['max_mol_wt']:.2f}\n"
          f" Minimum mol weight: {info['min_mol_wt']:.2f}")
    print_histogram("atom number", counts, bins)
    print_histogram("molecular weight", weights, bins)
    return info


def summarize_jbl(path: str, bins: int = 20) -> dict:
    """Summary of a prepared ``.jbl`` dataset (no reference analogue — the
    reference tool only reads raw molecule files)."""
    from kgcn_tpu_torch.data import jbl
    from kgcn_tpu_torch.data.dataset import build_dataset

    obj = jbl.load(path)
    ds, info = build_dataset(obj, {})
    n = ds.num
    if ds.enabled_node_nums is not None:
        node_counts = [int(v) for v in np.asarray(ds.enabled_node_nums)]
    else:
        node_counts = [ds.max_node_num] * n
    edge_counts = None
    if ds.adjs is not None:
        edge_counts = [sum(int(len(ch[0])) for ch in a) for a in ds.adjs]
    out = {
        "size": n,
        "max_node_num": int(info.graph_node_num),
        "feature_dim": int(info.feature_dim or 0),
        "label_dim": int(info.label_dim or 0),
        "adj_channel_num": int(info.adj_channel_num or 0),
    }
    print(f"{'#' * 30} Summary {'#' * 30}\n"
          f"          File name: {path}\n"
          f"       Dataset size: {n}\n"
          f"    Max node number: {out['max_node_num']}\n"
          f"        Feature dim: {out['feature_dim']}\n"
          f"          Label dim: {out['label_dim']}\n"
          f"       Adj channels: {out['adj_channel_num']}")
    if ds.labels is not None:
        lab = np.asarray(ds.labels)
        if lab.ndim == 2 and lab.shape[1] > 1:
            pos = lab.argmax(1) if ds.mask_label is None else None
            if pos is not None:
                uniq, cnt = np.unique(pos, return_counts=True)
                dist = {int(u): int(c) for u, c in zip(uniq, cnt)}
                print(f"        Class counts: {dist}")
    print_histogram("node number", node_counts, min(bins, max(2, len(set(node_counts)))))
    if edge_counts:
        print_histogram("edge number", edge_counts, min(bins, max(2, len(set(edge_counts)))))
    return out


def main(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser(
        prog="kgcn-tpu-chem-summary",
        description="Dataset summary (reference: kgcn/preprocessing/chem_summary.py)",
    )
    p.add_argument("-f", "--format", default=None,
                   help="smiles | smarts | sdf | jbl (inferred from extension)")
    p.add_argument("-p", "--file_path", required=True)
    p.add_argument("-b", "--bins", type=int, default=20)
    a = p.parse_args(argv)
    fmt = a.format
    if fmt is None:
        ext = a.file_path.rsplit(".", 1)[-1].lower()
        fmt = {"jbl": "jbl", "sdf": "sdf", "smi": "smiles"}.get(ext, "smiles")
    if fmt == "jbl":
        summarize_jbl(a.file_path, a.bins)
    else:
        summarize_mols(a.file_path, fmt, a.bins)


if __name__ == "__main__":
    main()
