"""The port's molecule parser and featuriser (``kgcn_tpu_torch/data/
molparse.py``, ``data/featurizer.py``) against the JAX package's, on the
CPU: every SMILES literal of ``tests/test_molparse.py`` and
``tests/test_preprocessing.py`` (the invalid ones included: both give
``None``) and 512 seeded drug-like SMILES (``chip_smoke.make_smiles``).

* the parsed molecules are equal atom for atom: symbols, charges,
  radicals, aromatic flags, explicit and total hydrogens, implicit valence,
  degree, hybridisation, and the bond lists in order;
* the atom features are bitwise equal in every mode: the default 81,
  ``deepchem_compat`` (degree dims 11-16 and the charge and radical slots
  dropped), ``use_electronegativity``, ``use_sybyl``,
  ``use_gaff`` and ``use_gasteiger`` (Gasteiger charges given through an
  atom proxy, as ``tests/test_preprocessing.py``'s stub RDKit gives them;
  ``mol_to_graph`` refuses molparse molecules there in both packages);
* Morgan fingerprints are bitwise equal, also computed in a process with
  another ``PYTHONHASHSEED``;
* an SDF the test writes (charges, a radical, aromatic bonds, data fields)
  parses to the same molecules in both packages.
"""
import ast
import hashlib
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from kgcn_tpu.data import featurizer as j_fz
from kgcn_tpu.data import molparse as j_mp
from kgcn_tpu_torch.data import featurizer as t_fz
from kgcn_tpu_torch.data import molparse as t_mp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402

_TOKEN = re.compile(r"^[A-Za-z0-9@+\-\[\]\(\)=#%/\\.:*]+$")


def _literals():
    """Every string literal of the JAX package's chemistry tests, and each
    comma- or blank-separated token of them, that reads as SMILES text."""
    found = set()
    for name in ("test_molparse.py", "test_preprocessing.py"):
        with open(os.path.join(REPO, "tests", name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                for tok in [node.value] + re.split(r"[\s,]+", node.value):
                    if tok and _TOKEN.match(tok):
                        found.add(tok)
    return sorted(found)


LITERALS = _literals()
SEEDED = chip_smoke.make_smiles(512, seed=0)
SOURCES = {"test literals": LITERALS, "seeded": SEEDED}


def _atom_state(a):
    return (a.GetSymbol(), a.GetAtomicNum(), a.GetFormalCharge(),
            a.GetNumRadicalElectrons(), a.GetIsAromatic(), a.explicit_h, a.isotope,
            a.GetDegree(), a.GetTotalNumHs(), a.GetImplicitValence(),
            a.GetHybridization(), a.idx)


def _pairs(smiles):
    out = []
    for smi in smiles:
        j, t = j_mp.parse_smiles(smi), t_mp.parse_smiles(smi)
        assert (j is None) == (t is None), smi
        if j is not None:
            out.append((smi, j, t))
    return out


def test_the_literals_hold_valid_and_invalid_smiles():
    parsed = [t_mp.parse_smiles(s) for s in LITERALS]
    assert len(LITERALS) > 100
    assert sum(m is None for m in parsed) > 10
    assert sum(m is not None for m in parsed) > 60


def test_the_seeded_smiles_lie_in_the_subset_molparse_parses():
    """Every seeded SMILES parses (in both packages), within the heavy-atom
    range, with rings, aromatic atoms, charges, explicit hydrogens and salts
    among them; the same seed gives the same list."""
    mols = [t_mp.parse_smiles(s) for s in SEEDED]
    assert all(m is not None for m in mols)
    assert all(j_mp.parse_smiles(s) is not None for s in SEEDED)
    lo, hi = chip_smoke.CHEM_HEAVY
    assert all(lo <= m.GetNumAtoms() <= hi for m in mols)
    atoms = [a for m in mols for a in m.GetAtoms()]
    assert {"C", "N", "O", "S", "F", "Cl", "Br", "I"} <= {a.GetSymbol() for a in atoms}
    assert any(a.GetIsAromatic() for a in atoms)
    assert any(a.GetFormalCharge() for a in atoms)
    assert any(a.explicit_h for a in atoms)
    assert any(o == 3 for m in mols for _, _, o in m.bonds)
    assert sum("." in s for s in SEEDED) >= 5
    assert any("[nH]" in s for s in SEEDED) and any("c2" in s for s in SEEDED)
    assert chip_smoke.make_smiles(512, seed=0) == SEEDED
    assert chip_smoke.make_smiles(64, seed=1) != SEEDED[:64]


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_molecules_equal_atom_for_atom(source):
    pairs = _pairs(SOURCES[source])
    assert pairs
    for smi, j, t in pairs:
        assert j.bonds == t.bonds, smi
        assert j.name == t.name and j.GetNumAtoms() == t.GetNumAtoms(), smi
        assert [_atom_state(a) for a in j.GetAtoms()] == \
            [_atom_state(a) for a in t.GetAtoms()], smi
        assert j.__getstate__() == t.__getstate__(), smi
        np.testing.assert_array_equal(j.adjacency_matrix(), t.adjacency_matrix())


class _Gasteiger:
    """A molparse atom with a ``_GasteigerCharge`` property, as RDKit's
    ``ComputeGasteigerCharges`` leaves one (NaN on some atoms: the
    featuriser writes 0 there)."""

    def __init__(self, atom, charge):
        self._atom, self._charge = atom, charge

    def __getattr__(self, name):
        return getattr(self._atom, name)

    def GetDoubleProp(self, name):
        assert name == "_GasteigerCharge"
        return self._charge


def _gasteiger_charges(mol):
    rng = np.random.RandomState(mol.GetNumAtoms())
    q = rng.uniform(-0.5, 0.5, mol.GetNumAtoms())
    q[::7] = np.nan
    return q


MODES = {
    "default 81": lambda fz, m: np.stack([fz.atom_features(a) for a in m.GetAtoms()]),
    "use_electronegativity": lambda fz, m: np.stack(
        [fz.atom_features(a, use_electronegativity=True) for a in m.GetAtoms()]),
    "use_sybyl": lambda fz, m: np.stack(
        [fz.atom_features(a, use_sybyl=True) for a in m.GetAtoms()]),
    "use_gasteiger": lambda fz, m: np.stack(
        [fz.atom_features(_Gasteiger(a, q), use_gasteiger=True, use_electronegativity=True)
         for a, q in zip(m.GetAtoms(), _gasteiger_charges(m))]),
    "deepchem_compat": lambda fz, m: fz.mol_to_graph(m, 64, deepchem_compat=True)[0],
    "use_gaff": lambda fz, m: fz.mol_to_graph(m, 64, use_gaff=True)[0],
    "mol_to_graph sybyl EN": lambda fz, m: fz.mol_to_graph(
        m, 64, use_sybyl=True, use_electronegativity=True)[0],
}


@pytest.mark.parametrize("source", sorted(SOURCES))
@pytest.mark.parametrize("mode", sorted(MODES))
def test_atom_features_are_bitwise_equal(mode, source):
    pairs = [p for p in _pairs(SOURCES[source]) if p[1].GetNumAtoms() <= 64]
    for smi, j, t in pairs:
        want, got = MODES[mode](j_fz, j), MODES[mode](t_fz, t)
        assert got.dtype == want.dtype and got.shape == want.shape, smi
        assert got.tobytes() == want.tobytes(), (mode, smi)


def test_gasteiger_on_molparse_molecules_raises_in_both():
    mol_j, mol_t = j_mp.parse_smiles("CCO"), t_mp.parse_smiles("CCO")
    for fz, mol in ((j_fz, mol_j), (t_fz, mol_t)):
        with pytest.raises(ValueError, match="use-gasteiger requires RDKit"):
            fz.mol_to_graph(mol, 10, use_gasteiger=True)


@pytest.mark.parametrize("source", sorted(SOURCES))
def test_morgan_fingerprints_are_bitwise_equal(source):
    for smi, j, t in _pairs(SOURCES[source]):
        for radius, bits in ((2, 2048), (3, 1024)):
            want = j_fz.morgan_fingerprint(j, radius=radius, bits=bits)
            got = t_fz.morgan_fingerprint(t, radius=radius, bits=bits)
            assert got.tobytes() == want.tobytes(), smi
        assert t_mp.morgan_fingerprint(t).tobytes() == j_mp.morgan_fingerprint(j).tobytes()


def _fingerprint_digest(mols, fp):
    h = hashlib.sha256()
    for m in mols:
        h.update(fp(m).tobytes())
    return h.hexdigest()


def test_morgan_fingerprints_do_not_depend_on_the_hash_seed():
    """The port's fingerprints of every parsed molecule, computed in a
    process with PYTHONHASHSEED 12345, equal the JAX package's here."""
    smiles = [s for s in LITERALS + SEEDED if j_mp.parse_smiles(s) is not None]
    want = _fingerprint_digest([j_mp.parse_smiles(s) for s in smiles], j_fz.morgan_fingerprint)
    code = ("import hashlib, json, sys\n"
            "from kgcn_tpu_torch.data import featurizer, molparse\n"
            "smiles = json.load(sys.stdin)\n"
            "h = hashlib.sha256()\n"
            "for s in smiles:\n"
            "    h.update(featurizer.morgan_fingerprint(molparse.parse_smiles(s)).tobytes())\n"
            "print(h.hexdigest())\n")
    import json

    r = subprocess.run([sys.executable, "-c", code], input=json.dumps(smiles), cwd=REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONHASHSEED="12345"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want


SDF_RECORDS = """methyl radical, ammonium, acetate
  test

  7  5  0  0  0  0  0  0  0  0999 V2000
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0
    0.0000    0.0000    0.0000 N   0  3  0  0  0  0
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0
    0.0000    0.0000    0.0000 O   0  0  0  0  0  0
    0.0000    0.0000    0.0000 O   0  0  0  0  0  0
    0.0000    0.0000    0.0000 C   0  0  0  0  0  0
  3  4  1  0
  4  5  2  0
  4  6  1  0
  2  7  1  0
  1  7  1  0
M  CHG  1   6  -1
M  RAD  1   1   2
M  END
> <SOL>
-1.25

> <name>
mixture

$$$$
"""


def test_an_sdf_parses_to_the_same_molecules(tmp_path):
    """A handwritten record (an old-style charge code, ``M  CHG``,
    ``M  RAD``, data fields) and the seeded molecules written by
    ``chip_smoke.write_sdf`` (aromatic bonds as type 4), in both packages;
    the seeded ones also equal their SMILES molecules."""
    path = tmp_path / "mols.sdf"
    mols = [t_mp.parse_smiles(s) for s in SEEDED[:64]]
    chip_smoke.write_sdf(str(path), mols)
    path.write_text(SDF_RECORDS + path.read_text())
    j, t = j_mp.parse_sdf(str(path)), t_mp.parse_sdf(str(path))
    assert len(j) == len(t) == 65 and None not in t
    for a, b in zip(j, t):
        assert a.__getstate__() == b.__getstate__()
        assert [_atom_state(x) for x in a.GetAtoms()] == [_atom_state(x) for x in b.GetAtoms()]
    assert t[0].props == {"SOL": "-1.25", "name": "mixture"}
    assert t[0].atoms[0].GetNumRadicalElectrons() == 1
    assert [a.GetFormalCharge() for a in t[0].atoms] == [0, 1, 0, 0, 0, -1, 0]
    for m, s in zip(t[1:], mols):
        assert m.bonds == s.bonds
        assert [a.GetIsAromatic() for a in m.atoms] == [a.GetIsAromatic() for a in s.atoms]
    np.testing.assert_array_equal(
        t_fz.build_chem_dataset(t, atom_num_limit=64)["feature"],
        j_fz.build_chem_dataset(j, atom_num_limit=64)["feature"])


def test_parse_molecules_and_the_dataset_dict_equal_the_jax_packages():
    """``parse_molecules`` (molparse, RDKit absent) and
    ``build_chem_dataset`` with labels, NaN labels (the mask), sequences
    and fingerprints: the same dict, arrays with their dtypes."""
    smiles = SEEDED[:40] + ["C1CC", "Xx"]
    rng = np.random.RandomState(0)
    labels = rng.randint(0, 2, (len(smiles), 3)).astype(np.float64)
    labels[rng.rand(*labels.shape) < 0.3] = np.nan
    seqs = np.stack([t_fz.encode_protein_sequence("MKVL" * (i % 5 + 1) + "X", 30)
                     for i in range(len(smiles))])
    assert np.array_equal(seqs, np.stack([j_fz.encode_protein_sequence(
        "MKVL" * (i % 5 + 1) + "X", 30) for i in range(len(smiles))]))
    out = []
    for fz in (j_fz, t_fz):
        mols = fz.parse_molecules(smiles=smiles, backend="molparse")
        out.append(fz.build_chem_dataset(mols, labels=labels, atom_num_limit=45,
                                         with_fingerprint=True, sequences=seqs))
    want, got = out
    assert sorted(want) == sorted(got)
    assert isinstance(got["max_node_num"], np.int64) and got["mask_label"].dtype == np.int64
    for key in ("feature", "label", "mask_label", "sequence", "chemical_fp"):
        assert got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]), key
    assert got["sequence_length"] == want["sequence_length"]
    assert got["sequence_symbol_num"] == want["sequence_symbol_num"]
    for a, b in zip(got["adj"], want["adj"]):
        assert a[0].dtype == np.int32 and a[1].dtype == np.float32
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) and a[2] == b[2]
    assert got["mol_info"]["index_list"] == want["mol_info"]["index_list"]
    assert [m.__getstate__() for m in got["mol_info"]["obj_list"]] == \
        [m.__getstate__() for m in want["mol_info"]["obj_list"]]
    assert all(type(m) is t_mp.Molecule for m in got["mol_info"]["obj_list"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pseudo_negatives_draw_as_the_jax_package_does(seed):
    rng = np.random.RandomState(10 + seed)
    labels = (rng.rand(200, 5) < 0.6).astype(np.float64)
    mask = (rng.rand(200, 5) < 0.7).astype(np.int64)
    want = j_fz.generate_pseudo_negatives(labels, mask, seed=seed)
    got = t_fz.generate_pseudo_negatives(labels, mask, seed=seed)
    assert got[2] == want[2] > 0
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    # every free cell unmasked when the imbalance exceeds them
    mask = np.ones((4, 2), np.int64)
    mask[0, 0] = mask[1, 1] = 0
    full = t_fz.generate_pseudo_negatives(np.ones((4, 2)), mask)
    assert full[2] == 2 and full[1].all() and not full[0][mask == 0].any()
