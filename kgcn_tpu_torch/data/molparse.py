"""Dependency-free molecular parsing: SDF (V2000 molblock) + a SMILES subset.

The port's copy of ``kgcn_tpu/data/molparse.py``, which it keeps
behaviour for behaviour (atoms, bonds, aromatic flags, hybridisation,
hydrogen counts and fingerprint bits are equal; ``tests/test_torch_chem.py``
holds them to the JAX package's).  Its :class:`Molecule` pickles to the same
state (``__getstate__``), so ``mol_info`` lists written by either package
read in the other (``data/jbl.py`` maps the JAX package's class names onto
these).

RDKit is not available in every deployment image, but the chemistry surface
assumes molecules can be turned into graphs + 81-dim atom features
(kgcn/preprocessing/utils.py:20-56).  This module provides a pure-Python
molecule exposing exactly the atom API the featuriser consumes
(``GetSymbol/GetDegree/GetImplicitValence/GetFormalCharge/
GetNumRadicalElectrons/GetHybridization/GetIsAromatic/GetTotalNumHs/
GetAtomicNum``) so :mod:`kgcn_tpu_torch.data.featurizer` works identically
with RDKit mols or these.

Chemistry perception is deliberately lightweight but principled:

* implicit hydrogens from standard organic valences (B 3, C 4, N 3, O 2,
  P 3/5, S 2/4/6, halogens 1) with charge adjustment;
* aromaticity by Hückel-lite ring perception (cycle basis of 5–7 rings,
  4n+2 π electrons counting endocyclic double bonds as 2, lone-pair
  heteroatoms as 2, exocyclic-double-bond atoms as 0), iterated to a
  fixpoint for fused systems — this recovers the aromatic flags an
  RDKit-kekulized SDF has dropped;
* hybridisation heuristics: triple/allene ⇒ SP, double bond or aromatic ⇒
  SP2, degree 5/6 ⇒ SP3D/SP3D2, else SP3.

The cycle basis and the aromaticity fixpoint depend on iteration order, so
they walk lists in the order the JAX package does; ``_stable_hash`` hashes
``repr`` of plain Python ints and strings (a NumPy scalar's ``repr`` differs
under NumPy 2 and would change every fingerprint bit).
"""
from __future__ import annotations

import hashlib
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

ATOMIC_NUM = {
    "H": 1, "He": 2, "Li": 3, "Be": 4, "B": 5, "C": 6, "N": 7, "O": 8,
    "F": 9, "Ne": 10, "Na": 11, "Mg": 12, "Al": 13, "Si": 14, "P": 15,
    "S": 16, "Cl": 17, "Ar": 18, "K": 19, "Ca": 20, "Sc": 21, "Ti": 22,
    "V": 23, "Cr": 24, "Mn": 25, "Fe": 26, "Co": 27, "Ni": 28, "Cu": 29,
    "Zn": 30, "Ga": 31, "Ge": 32, "As": 33, "Se": 34, "Br": 35, "Kr": 36,
    "Rb": 37, "Sr": 38, "Y": 39, "Zr": 40, "Nb": 41, "Mo": 42, "Tc": 43,
    "Ru": 44, "Rh": 45, "Pd": 46, "Ag": 47, "Cd": 48, "In": 49, "Sn": 50,
    "Sb": 51, "Te": 52, "I": 53, "Xe": 54, "Cs": 55, "Ba": 56, "La": 57,
    "Pt": 78, "Au": 79, "Hg": 80, "Tl": 81, "Pb": 82, "Bi": 83, "Yb": 70,
    "W": 74,
}

# default valences for implicit-H completion (RDKit's organic-subset model)
DEFAULT_VALENCE = {
    "B": (3,), "C": (4,), "N": (3,), "O": (2,), "P": (3, 5),
    "S": (2, 4, 6), "F": (1,), "Cl": (1,), "Br": (1,), "I": (1,),
}


class Atom:
    """Pure-Python atom with the RDKit getter API the featuriser needs."""

    __slots__ = ("symbol", "charge", "radical", "aromatic", "explicit_h",
                 "_mol", "idx", "isotope")

    def __init__(self, symbol: str, charge: int = 0, radical: int = 0,
                 aromatic: bool = False, explicit_h: Optional[int] = None,
                 isotope: int = 0):
        self.symbol = symbol
        self.charge = charge
        self.radical = radical
        self.aromatic = aromatic
        self.explicit_h = explicit_h  # from [nH] brackets; None = implicit
        self.isotope = isotope
        self._mol: Optional["Molecule"] = None
        self.idx = -1

    # -- RDKit-compatible API -------------------------------------------------
    def GetSymbol(self) -> str:
        return self.symbol

    def GetAtomicNum(self) -> int:
        return ATOMIC_NUM.get(self.symbol, 0)

    def GetFormalCharge(self) -> int:
        return self.charge

    def GetNumRadicalElectrons(self) -> int:
        return self.radical

    def GetIsAromatic(self) -> bool:
        return self.aromatic

    def GetDegree(self) -> int:
        return len(self._mol._nbrs[self.idx])

    def _bond_order_sum(self) -> float:
        tot = 0.0
        n_arom = 0
        for j, order in self._mol._nbrs[self.idx]:
            if order == 12:  # aromatic bond sentinel
                n_arom += 1
            else:
                tot += order
        if n_arom:
            # aromatic contribution: n bonds share (n+1) valence units —
            # benzene C (2 arom) → 3, fusion C (3 arom) → 4, pyridine N → 3
            tot += n_arom + 1
        return tot

    def GetTotalNumHs(self) -> int:
        if self.explicit_h is not None:
            return self.explicit_h + self._explicit_h_neighbors()
        dv = DEFAULT_VALENCE.get(self.symbol)
        if dv is None:
            return self._explicit_h_neighbors()
        used = self._bond_order_sum() + abs(self.radical)
        eff = [v + self._charge_valence_shift(v) for v in dv]
        for v in eff:
            if used <= v:
                return int(round(v - used)) + self._explicit_h_neighbors()
        return self._explicit_h_neighbors()

    def _charge_valence_shift(self, base: int) -> int:
        # N+/P+/O+/S+ gain a bond; N-/O-/C- lose one; C+ also loses one
        if self.charge > 0:
            return self.charge if self.symbol in ("N", "P", "O", "S") \
                else -self.charge
        return self.charge  # negative charge always reduces H count

    def _explicit_h_neighbors(self) -> int:
        return sum(
            1 for j, _ in self._mol._nbrs[self.idx]
            if self._mol.atoms[j].symbol == "H"
        )

    def GetImplicitValence(self) -> int:
        # RDKit: implicit valence == number of implicit hydrogens.  Bracket
        # H counts ([nH] → explicit_h=1) are EXPLICIT in RDKit's model, so
        # they contribute 0 here — keeps the valence one-hot slot of the
        # 81-dim feature vector identical between the molparse and RDKit
        # backends (kgcn/preprocessing/utils.py:20-56 schema).
        if self.explicit_h is not None:
            return 0
        return self.GetTotalNumHs() - self._explicit_h_neighbors()

    def GetHybridization(self) -> str:
        n_double = n_triple = 0
        for j, order in self._mol._nbrs[self.idx]:
            if order == 2:
                n_double += 1
            elif order == 3:
                n_triple += 1
        deg = self.GetDegree() + self.GetImplicitValence()
        if deg >= 6:
            return "SP3D2"
        if deg == 5:
            return "SP3D"
        # two cumulated double bonds only mean SP on a LINEAR centre
        # (allene/CO2); tetrahedral hypervalent centres (sulfone S, sulfonate,
        # phosphate — degree > 2 with two X=O) are SP3 in RDKit's model
        if n_triple or (n_double >= 2 and self.GetDegree() <= 2):
            return "SP"
        if n_double >= 2:
            return "SP3"  # tetrahedral hypervalent: 4 sigma bonds, no lone pair
        if n_double or self.aromatic:
            return "SP2"
        if self.symbol in DEFAULT_VALENCE or self.symbol == "H":
            return "SP3"
        return "UNSPECIFIED"


@dataclass
class Molecule:
    """Molecular graph with RDKit-shaped accessors; picklable (mol_info)."""

    atoms: List[Atom] = field(default_factory=list)
    bonds: List[Tuple[int, int, int]] = field(default_factory=list)
    props: Dict[str, str] = field(default_factory=dict)
    name: str = ""

    def __post_init__(self):
        self._rebuild()

    def _rebuild(self):
        self._nbrs: List[List[Tuple[int, int]]] = [[] for _ in self.atoms]
        for a, b, order in self.bonds:
            self._nbrs[a].append((b, order))
            self._nbrs[b].append((a, order))
        for i, at in enumerate(self.atoms):
            at._mol = self
            at.idx = i

    # pickle support: atoms hold a back-reference; rebuild it on load
    def __getstate__(self):
        return {"atoms": [
            (a.symbol, a.charge, a.radical, a.aromatic, a.explicit_h,
             a.isotope) for a in self.atoms
        ], "bonds": self.bonds, "props": self.props, "name": self.name}

    def __setstate__(self, st):
        self.atoms = [Atom(*t) for t in st["atoms"]]
        self.bonds = st["bonds"]
        self.props = st["props"]
        self.name = st["name"]
        self._rebuild()

    # -- RDKit-compatible API -------------------------------------------------
    def GetNumAtoms(self) -> int:
        return len(self.atoms)

    def GetAtoms(self) -> List[Atom]:
        return self.atoms

    def GetAtomWithIdx(self, i: int) -> Atom:
        return self.atoms[i]

    def GetProp(self, key: str) -> str:
        return self.props[key]

    def HasProp(self, key: str) -> bool:
        return key in self.props

    def GetNumBonds(self) -> int:
        return len(self.bonds)

    def adjacency_matrix(self) -> np.ndarray:
        n = len(self.atoms)
        adj = np.zeros((n, n), np.int8)
        for a, b, _ in self.bonds:
            adj[a, b] = adj[b, a] = 1
        return adj

    # -- perception ------------------------------------------------------------
    def perceive_aromaticity(self) -> None:
        """Hückel-lite: flag 5–7 rings with 4n+2 π electrons as aromatic and
        rewrite their ring bonds to the aromatic sentinel (order 12).

        π counting per ring atom: endocyclic double bond → 1 (so a C=C pair
        contributes 2), exocyclic double bond (quinone C=O) → 0, saturated
        N/O/S (lone pair) → 2, saturated C/B⁻-like → ring not aromatic.
        Iterated so fused systems (naphthalene) resolve.
        """
        rings = _cycle_basis(len(self.atoms), [(a, b) for a, b, _ in self.bonds])
        rings = [r for r in rings if 5 <= len(r) <= 7]
        bond_order = {}
        for a, b, o in self.bonds:
            bond_order[(a, b)] = bond_order[(b, a)] = o
        changed = True
        aromatic_atoms = set(i for i, a in enumerate(self.atoms) if a.aromatic)
        while changed:
            changed = False
            for ring in rings:
                if all(i in aromatic_atoms for i in ring):
                    continue
                pi = 0
                ok = True
                rs = set(ring)
                for i in ring:
                    at = self.atoms[i]
                    if at.symbol not in ("C", "N", "O", "S", "B", "P"):
                        ok = False
                        break
                    orders = self._nbrs[i]
                    endo_double = any(
                        o == 2 and j in rs for j, o in orders
                    )
                    exo_double = any(
                        o == 2 and j not in rs for j, o in orders
                    )
                    if endo_double or i in aromatic_atoms:
                        pi += 1
                    elif exo_double:
                        pi += 0
                    elif at.symbol in ("N", "O", "S") or at.charge < 0:
                        pi += 2
                    else:
                        ok = False
                        break
                if ok and pi >= 2 and (pi - 2) % 4 == 0:
                    for i in ring:
                        if i not in aromatic_atoms:
                            aromatic_atoms.add(i)
                            self.atoms[i].aromatic = True
                            changed = True
        # rewrite ring bonds between aromatic atoms
        new_bonds = []
        ring_pairs = set()
        for ring in rings:
            if all(i in aromatic_atoms for i in ring):
                for k in range(len(ring)):
                    a, b = ring[k], ring[(k + 1) % len(ring)]
                    ring_pairs.add((a, b))
                    ring_pairs.add((b, a))
        for a, b, o in self.bonds:
            if (a, b) in ring_pairs:
                o = 12
            new_bonds.append((a, b, o))
        self.bonds = new_bonds
        self._rebuild()


def _cycle_basis(n: int, edges: List[Tuple[int, int]]) -> List[List[int]]:
    """Fundamental cycles from a spanning forest (paths joined at ring-closure
    edges) — enough to find all SSSR-sized rings in molecules ≤ ~200 atoms."""
    nbrs: List[List[int]] = [[] for _ in range(n)]
    for a, b in edges:
        nbrs[a].append(b)
        nbrs[b].append(a)
    parent = [-1] * n
    depth = [0] * n
    seen = [False] * n
    tree_edges = set()
    cycles = []
    for root in range(n):
        if seen[root]:
            continue
        stack = [root]
        seen[root] = True
        while stack:
            u = stack.pop()
            for v in nbrs[u]:
                if not seen[v]:
                    seen[v] = True
                    parent[v] = u
                    depth[v] = depth[u] + 1
                    tree_edges.add((u, v))
                    tree_edges.add((v, u))
                    stack.append(v)
    done = set()
    for a, b in edges:
        if (a, b) in tree_edges or (a, b) in done or (b, a) in done:
            continue
        done.add((a, b))
        # path a→b through the tree = the fundamental cycle
        pa, pb = a, b
        path_a, path_b = [pa], [pb]
        while depth[pa] > depth[pb]:
            pa = parent[pa]
            path_a.append(pa)
        while depth[pb] > depth[pa]:
            pb = parent[pb]
            path_b.append(pb)
        while pa != pb:
            pa, pb = parent[pa], parent[pb]
            path_a.append(pa)
            path_b.append(pb)
        cycles.append(path_a + path_b[:-1][::-1])
    return cycles


# ---------------------------------------------------------------------------
# SDF / V2000 molblock parsing


_OLD_CHARGE = {1: 3, 2: 2, 3: 1, 5: -1, 6: -2, 7: -3}


def parse_molblock(block: str) -> Optional[Molecule]:
    """One V2000 molblock (up to ``M  END``) → Molecule, or None on error."""
    lines = block.splitlines()
    if len(lines) < 4:
        return None
    name = lines[0].strip()
    counts = lines[3]
    try:
        n_atoms = int(counts[0:3])
        n_bonds = int(counts[3:6])
    except ValueError:
        return None
    atoms: List[Atom] = []
    for i in range(n_atoms):
        ln = lines[4 + i]
        sym = ln[31:34].strip()
        chg = 0
        try:
            chg = _OLD_CHARGE.get(int(ln[36:39]), 0)
        except (ValueError, IndexError):
            pass
        atoms.append(Atom(sym, charge=chg))
    bonds: List[Tuple[int, int, int]] = []
    for i in range(n_bonds):
        ln = lines[4 + n_atoms + i]
        a = int(ln[0:3]) - 1
        b = int(ln[3:6]) - 1
        t = int(ln[6:9])
        order = 12 if t == 4 else min(t, 3)
        bonds.append((a, b, order))
    radicals: Dict[int, int] = {}
    for ln in lines[4 + n_atoms + n_bonds:]:
        if ln.startswith("M  CHG"):
            parts = ln.split()
            k = int(parts[2])
            for j in range(k):
                atoms[int(parts[3 + 2 * j]) - 1].charge = int(parts[4 + 2 * j])
        elif ln.startswith("M  RAD"):
            parts = ln.split()
            k = int(parts[2])
            for j in range(k):
                radicals[int(parts[3 + 2 * j]) - 1] = int(parts[4 + 2 * j])
        elif ln.startswith("M  END"):
            break
    for idx, rad in radicals.items():
        atoms[idx].radical = 1 if rad in (2,) else (2 if rad == 3 else 0)
    # aromatic flags from explicit aromatic bonds, then Hückel perception
    for a, b, o in bonds:
        if o == 12:
            atoms[a].aromatic = atoms[b].aromatic = True
    mol = Molecule(atoms=atoms, bonds=bonds, name=name)
    mol.perceive_aromaticity()
    return mol


def parse_sdf(path: str) -> List[Optional[Molecule]]:
    """SDF file → list of Molecule (None for records that fail to parse),
    with ``> <tag>`` data fields captured into ``mol.props``."""
    with open(path, errors="replace") as f:
        text = f.read()
    mols: List[Optional[Molecule]] = []
    for record in text.split("$$$$"):
        if not record.strip():
            continue
        record = record.lstrip("\n")
        head, _, tail = record.partition("M  END")
        try:
            mol = parse_molblock(head + "M  END")
        except Exception:
            mol = None
        if mol is not None:
            for m in re.finditer(
                r">\s*<([^>]+)>[^\n]*\n((?:[^\n]+\n)*)", tail
            ):
                mol.props[m.group(1)] = m.group(2).strip()
        mols.append(mol)
    return mols


# ---------------------------------------------------------------------------
# SMILES parsing (organic + bracket subset)

_ORGANIC = ["Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I"]
_AROMATIC_ORG = ["b", "c", "n", "o", "p", "s"]
_BRACKET_RE = re.compile(
    r"\[(\d*)([A-Za-z][a-z]?|\*)(@{0,2}|@TH\d|@AL\d|@SP\d)"
    r"(H\d*)?([+-]\d*|[+]+|[-]+)?(?::\d+)?\]"
)
_BOND_ORDER = {"-": 1, "=": 2, "#": 3, ":": 12, "/": 1, "\\": 1}


def parse_smiles(s: str) -> Optional[Molecule]:
    """SMILES → Molecule.  Supports the organic subset, bracket atoms with
    H-count/charge/isotope, branches, ring closures (incl. %nn and bond
    symbols on closures), aromatic lowercase atoms, and '.' fragments.
    Stereo markers are accepted and ignored.  Returns None on any syntax
    error (mirrors ``Chem.MolFromSmiles`` returning None)."""
    try:
        return _parse_smiles_inner(s)
    except Exception:
        return None


def _parse_smiles_inner(s: str) -> Optional[Molecule]:
    atoms: List[Atom] = []
    bonds: List[Tuple[int, int, int]] = []
    prev: List[Optional[int]] = [None]  # branch stack of attachment points
    pending_bond: Optional[int] = None
    ring: Dict[str, Tuple[int, Optional[int]]] = {}
    i = 0
    n = len(s)

    def add_atom(at: Atom) -> None:
        nonlocal pending_bond
        atoms.append(at)
        idx = len(atoms) - 1
        if prev[-1] is not None:
            order = pending_bond
            if order is None:
                order = 12 if (at.aromatic and atoms[prev[-1]].aromatic) else 1
            bonds.append((prev[-1], idx, order))
        pending_bond = None
        prev[-1] = idx

    while i < n:
        ch = s[i]
        if ch == "[":
            j = s.index("]", i) + 1
            m = _BRACKET_RE.match(s[i:j])
            if not m:
                return None
            iso, sym, hcnt, chg = m.group(1, 2, 4, 5)
            aromatic = sym[0].islower() and sym != "*"
            symbol = sym.capitalize() if aromatic else sym
            if symbol == "*":
                symbol = "Unknown"
            h = 0
            if hcnt:
                h = int(hcnt[1:]) if len(hcnt) > 1 else 1
            charge = 0
            if chg:
                if chg in ("+", "-"):
                    charge = 1 if chg == "+" else -1
                elif set(chg) <= {"+"}:
                    charge = len(chg)
                elif set(chg) <= {"-"}:
                    charge = -len(chg)
                else:
                    charge = int(chg)
            add_atom(Atom(symbol, charge=charge, aromatic=aromatic,
                          explicit_h=h, isotope=int(iso) if iso else 0))
            i = j
        elif ch.isalpha():
            matched = None
            for sym in _ORGANIC:
                if s.startswith(sym, i):
                    matched = sym
                    break
            if matched:
                add_atom(Atom(matched))
                i += len(matched)
            elif ch in _AROMATIC_ORG:
                add_atom(Atom(ch.upper(), aromatic=True))
                i += 1
            else:
                return None
        elif ch in _BOND_ORDER:
            pending_bond = _BOND_ORDER[ch]
            i += 1
        elif ch == "(":
            prev.append(prev[-1])
            i += 1
        elif ch == ")":
            if len(prev) == 1:
                return None
            prev.pop()
            pending_bond = None
            i += 1
        elif ch == ".":
            prev[-1] = None
            pending_bond = None
            i += 1
        elif ch.isdigit() or ch == "%":
            if ch == "%":
                key = s[i + 1:i + 3]
                i += 3
            else:
                key = ch
                i += 1
            if key in ring:
                j0, order0 = ring.pop(key)
                order = pending_bond if pending_bond is not None else order0
                if order is None:
                    order = 12 if (atoms[j0].aromatic
                                   and atoms[prev[-1]].aromatic) else 1
                bonds.append((j0, prev[-1], order))
                pending_bond = None
            else:
                ring[key] = (prev[-1], pending_bond)
                pending_bond = None
        elif ch in "@/\\":
            i += 1
        else:
            return None
    if ring:
        return None  # unclosed ring bond
    if len(prev) != 1:
        return None  # unclosed branch
    if not atoms:
        return None
    mol = Molecule(atoms=atoms, bonds=bonds, name=s)
    mol.perceive_aromaticity()
    return mol


# ---------------------------------------------------------------------------
# Morgan-style hashed fingerprint (pure-Python ECFP fallback)


def morgan_fingerprint(mol: Molecule, radius: int = 2,
                       bits: int = 2048) -> np.ndarray:
    """Hashed circular fingerprint: iterative WL-style neighbourhood hashing
    of (symbol, charge, degree, numH, aromatic) invariants, each iteration's
    identifiers folded into a ``bits``-wide bit vector.  Not bit-compatible
    with RDKit's Morgan, but the same invariant family (used only when RDKit
    is absent; reference semantics: kgcn/preprocessing/chem.py:720-727)."""
    inv = [
        _stable_hash((a.GetSymbol(), a.GetFormalCharge(), a.GetDegree(),
                      a.GetTotalNumHs(), int(a.GetIsAromatic())))
        for a in mol.GetAtoms()
    ]
    fp = np.zeros((bits,), np.float32)
    for v in inv:
        fp[v % bits] = 1.0
    for _ in range(radius):
        nxt = []
        for i, a in enumerate(mol.GetAtoms()):
            env = sorted(
                (order, inv[j]) for j, order in mol._nbrs[i]
            )
            h = _stable_hash((inv[i],) + tuple(env))
            nxt.append(h)
            fp[h % bits] = 1.0
        inv = nxt
    return fp


def _stable_hash(obj) -> int:
    """Process-independent hash of a nested tuple of ints/strings.

    Python's builtin ``hash()`` is randomised per process for strings
    (PYTHONHASHSEED), which would make fingerprint bit vectors saved to
    ``.jbl`` irreproducible across runs — blake2b over a canonical byte
    encoding is stable everywhere."""
    h = hashlib.blake2b(repr(obj).encode("utf-8"), digest_size=8)
    return int.from_bytes(h.digest(), "little", signed=False)
