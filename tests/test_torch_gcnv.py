"""The port's IG-dump renderer (``kgcn_tpu_torch/cli/gcnv.py``) against
``kgcn_tpu.cli.gcnv`` on the CPU: the same files from the same dump and
the same completeness line; matplotlib missing raises ``ImportError`` as
there; RDKit missing gives the warning and no SVG."""
import os
import pickle
import sys

import numpy as np
import pytest


class FakeMol:
    """Stands in for an RDKit molecule in a dump (RDKit is not installed
    here): ``render`` asks it for its atom count only."""

    def GetNumAtoms(self):
        return 4


def _dump(path, with_mol=False):
    rng = np.random.RandomState(0)
    dump = {"features": rng.rand(6, 3), "features_IG": rng.randn(6, 3),
            "adjs": rng.rand(6, 6), "adjs_IG": rng.randn(6, 6),
            "embedded_layer": rng.randn(12, 10), "embedded_layer_IG": rng.randn(12, 10),
            "check_score": 0.5, "sum_of_IG": 0.48}
    if with_mol:
        dump["mol"] = FakeMol()
    with open(path, "wb") as f:
        pickle.dump(dump, f, protocol=4)
    return str(path)


@pytest.mark.parametrize("name", ["mol_00000_max.jbl", "mol_00001_max.pkl"])
def test_render_writes_the_jax_files(tmp_path, capsys, name):
    from kgcn_tpu.cli.gcnv import render as j_render
    from kgcn_tpu_torch.cli.gcnv import main as t_main

    path = _dump(tmp_path / name)
    j_render(path, str(tmp_path / "jax"))
    jout = capsys.readouterr().out
    t_main([path, "--outdir", str(tmp_path / "port")])
    tout = capsys.readouterr().out
    jfiles = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == jfiles and len(jfiles) == 5
    line = [ln for ln in jout.splitlines() if ln.startswith("IG completeness")]
    assert line == ["IG completeness: F(1)-F(0)=0.5000 sum_IG=0.4800"]
    assert [ln for ln in tout.splitlines() if ln.startswith("IG completeness")] == line
    assert jout.replace("/jax/", "/port/") == tout


def test_render_without_rdkit_warns_and_skips_the_svg(tmp_path, capsys):
    from kgcn_tpu_torch.cli.gcnv import render

    render(_dump(tmp_path / "mol.pkl", with_mol=True), str(tmp_path / "out"))
    out = capsys.readouterr().out
    assert "[WARN]" in out
    assert not any(f.endswith(".svg") for f in os.listdir(tmp_path / "out"))


def test_render_without_matplotlib_raises_import_error(tmp_path, monkeypatch):
    from kgcn_tpu_torch.cli.gcnv import render

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        render(_dump(tmp_path / "mol.pkl"), str(tmp_path / "out"))
