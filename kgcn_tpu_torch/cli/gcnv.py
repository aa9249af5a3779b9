"""Render Integrated-Gradients dumps — the port's counterpart of
``kgcn_tpu/cli/gcnv.py`` (``gcnv-tpu``), the same files and lines:

    python -m kgcn_tpu_torch.cli.gcnv visualization/mol_00000_max.jbl [--outdir DIR]

Reference: the ``gcnv`` CLI (gcnvisualizer/gcnvisualizer/visualizer.py:28-318
+ command_line_interface.py): reads an IG ``.jbl``/``.pkl`` dump and renders
* molecule SVG with atom-IG coolwarm colouring (needs RDKit; skipped with a
  warning otherwise — visualizer.py:98-147),
* adjacency / adjacency-IG heatmaps (visualizer.py:215-238),
* feature / feature-IG heatmaps (visualizer.py:240-259),
* per-position modal profiles (e.g. amino-acid IG bioplot, :261-298),
and prints the completeness line ``IG completeness: F(1)-F(0)=... sum_IG=...``.
A ``.jbl`` dump is read with the port's own reader (``data/jbl.py``; the
dumps ``visualize`` writes are plain pickles), a ``.pkl`` with ``pickle``.
matplotlib is imported where the plots need it (``ImportError`` without
it); RDKit where the molecule needs it (a warning, and no SVG, without
it).
"""
from __future__ import annotations

import argparse
import os

import numpy as np


def _load(path: str):
    import pickle

    from kgcn_tpu_torch.data import jbl

    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            return pickle.load(f)
    return jbl.load(path)


def _heatmap(mat, title, out_path, symmetric=True):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mat = np.asarray(mat)
    fig, ax = plt.subplots(figsize=(6, 5))
    vmax = np.abs(mat).max() or 1.0
    kw = dict(cmap="coolwarm", vmin=-vmax, vmax=vmax) if symmetric else dict(
        cmap="viridis"
    )
    im = ax.imshow(mat, **kw)
    fig.colorbar(im, ax=ax)
    ax.set_title(title)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    print(f"[SAVE] {out_path}")


def _atom_svg(mol, atom_scores, out_path):
    """RDKit 2D depiction with coolwarm atom colouring
    (visualizer.py:98-147)."""
    from matplotlib import cm
    from rdkit.Chem.Draw import rdMolDraw2D

    scores = np.asarray(atom_scores, dtype=float)
    vmax = np.abs(scores).max() or 1.0
    norm = (scores / vmax + 1.0) / 2.0
    cmap = cm.get_cmap("coolwarm")
    colors = {i: tuple(cmap(float(v))[:3]) for i, v in enumerate(norm)}
    drawer = rdMolDraw2D.MolDraw2DSVG(500, 500)
    rdMolDraw2D.PrepareAndDrawMolecule(
        drawer, mol,
        highlightAtoms=list(colors),
        highlightAtomColors=colors,
        highlightBonds=[],
    )
    drawer.FinishDrawing()
    with open(out_path, "w") as f:
        f.write(drawer.GetDrawingText())
    print(f"[SAVE] {out_path}")


def render(path: str, outdir: str | None = None) -> None:
    """The heatmaps, profiles and molecule SVG of one dump, written to
    ``outdir`` (the dump's directory by default)."""
    data = _load(path)
    outdir = outdir or os.path.dirname(os.path.abspath(path))
    os.makedirs(outdir, exist_ok=True)
    base = os.path.splitext(os.path.basename(path))[0]

    def _2d(a):
        a = np.squeeze(np.asarray(a))
        # multi-channel dumps carry [C, N, N]; the heatmap shows the
        # channel sum (per-channel data stays in the jbl)
        return a.sum(axis=0) if a.ndim == 3 else a

    if "adjs" in data and data["adjs"] is not None:
        _heatmap(_2d(data["adjs"]), "adjacency",
                 os.path.join(outdir, f"{base}_adjs.png"), symmetric=False)
    if "adjs_IG" in data:
        _heatmap(_2d(data["adjs_IG"]), "adjacency IG",
                 os.path.join(outdir, f"{base}_adjs_IG.png"))
    if "features" in data and data["features"] is not None:
        _heatmap(np.squeeze(data["features"]), "features",
                 os.path.join(outdir, f"{base}_features.png"), symmetric=False)
    if "features_IG" in data:
        _heatmap(np.squeeze(data["features_IG"]), "features IG",
                 os.path.join(outdir, f"{base}_features_IG.png"))
    for key in data:
        if key.endswith("_IG") and key not in (
            "adjs_IG", "features_IG"
        ) and np.ndim(data[key]) >= 1:
            _profile_plot(data[key], key, os.path.join(outdir, f"{base}_{key}.png"))

    if "mol" in data and data.get("features_IG") is not None:
        try:
            atom_ig = np.squeeze(data["features_IG"]).sum(axis=-1)
            _atom_svg(data["mol"], atom_ig[: data["mol"].GetNumAtoms()],
                      os.path.join(outdir, f"{base}_mol.svg"))
        except ImportError:
            print("[WARN] RDKit unavailable — skipping molecule SVG")
        except Exception as e:  # malformed mol objects shouldn't kill the run
            print(f"[WARN] molecule rendering failed: {e}")

    if "check_score" in data:
        print(
            f"IG completeness: F(1)-F(0)={float(np.sum(data['check_score'])):.4f} "
            f"sum_IG={float(np.sum(data['sum_of_IG'])):.4f}"
        )


def _profile_plot(values, title, out_path):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    v = np.squeeze(np.asarray(values))
    if v.ndim > 1:
        v = v.sum(axis=-1)
    fig, ax = plt.subplots(figsize=(8, 3))
    ax.bar(np.arange(len(v)), v)
    ax.set_title(title)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    print(f"[SAVE] {out_path}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="gcnv-tpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("inputs", nargs="+", help="IG jbl/pkl dumps")
    p.add_argument("--outdir", default=None)
    args = p.parse_args(argv)
    for path in args.inputs:
        render(path, args.outdir)


if __name__ == "__main__":
    main()
