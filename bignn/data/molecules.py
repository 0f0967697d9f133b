"""SMILES -> molecular graph featurization (SURVEY.md §2.1 R9).

The reference prepares DrugBank/BioSNAP molecule graphs offline with RDKit
(SMILES parse -> atom one-hot features -> networkx). RDKit is not available
in this image, so this module ships:

  * a small built-in SMILES parser covering the organic subset that drug
    SMILES overwhelmingly use: organic-subset atoms (incl. aromatic
    lowercase), bracket atoms, bonds ``- = # :``, branches, ring-closure
    digits (incl. ``%nn``), and charge/H-count inside brackets (parsed,
    ignored for topology);
  * atom featurization: one-hot element (top-N table) + degree + aromatic
    flag — the same feature family the reference uses;
  * ``smiles_to_graph`` producing a COOGraph directly, and
    ``build_dataset_from_smiles`` assembling a DDIDataset from
    (smiles list, interaction edge list).

If RDKit *is* importable, ``smiles_to_graph`` prefers it (kekulization,
sanitization); the built-in parser is the fallback and is tested against
known molecules.
"""

from __future__ import annotations

import re

import numpy as np

from bignn.data.schema import DDIDataset, random_split
from bignn.sparse.formats import COOGraph

# element vocabulary (one-hot rows; last slot = other)
ELEMENTS = ["C", "N", "O", "S", "F", "Cl", "Br", "I", "P", "B", "Si", "Se", "H"]
FEAT_DIM = len(ELEMENTS) + 1 + 6 + 1  # element + other + degree(0-5) + aromatic


_ORGANIC = ["Cl", "Br", "B", "C", "N", "O", "P", "S", "F", "I"]
_AROMATIC = ["b", "c", "n", "o", "p", "s"]
_BRACKET = re.compile(
    r"\[(?P<isotope>\d+)?(?P<symbol>[A-Z][a-z]?|[a-z])(?P<chiral>@{1,2})?"
    r"(?P<hcount>H\d*)?(?P<charge>[+-]\d*|\++|-+)?(?::\d+)?\]"
)


class SmilesError(ValueError):
    pass


def parse_smiles(smiles: str) -> tuple[list[dict], list[tuple[int, int, int]]]:
    """Parse SMILES into (atoms, bonds).

    atoms: [{symbol, aromatic}], bonds: [(i, j, order)] with order 1/2/3
    (aromatic bonds recorded as order 1 + both-atom aromatic flags).
    """
    atoms: list[dict] = []
    bonds: list[tuple[int, int, int]] = []
    stack: list[int] = []
    prev: int | None = None
    pending_order = 1
    rings: dict[str, tuple[int, int]] = {}
    i = 0
    s = smiles.strip()

    def add_atom(symbol: str, aromatic: bool):
        nonlocal prev, pending_order
        atoms.append({"symbol": symbol, "aromatic": aromatic})
        idx = len(atoms) - 1
        if prev is not None:
            bonds.append((prev, idx, pending_order))
        prev = idx
        pending_order = 1

    def ring_bond(label: str):
        nonlocal pending_order
        if label in rings:
            j, order = rings.pop(label)
            bonds.append((prev, j, max(order, pending_order)))
        else:
            rings[label] = (prev, pending_order)
        pending_order = 1

    while i < len(s):
        ch = s[i]
        if ch == "[":
            m = _BRACKET.match(s, i)
            if not m:
                raise SmilesError(f"bad bracket atom at {i} in {smiles!r}")
            sym = m.group("symbol")
            add_atom(sym.capitalize(), sym.islower())
            i = m.end()
        elif ch in "-=#:":
            pending_order = {"-": 1, "=": 2, "#": 3, ":": 1}[ch]
            i += 1
        elif ch == "(":
            if prev is None:
                raise SmilesError(f"branch with no prior atom in {smiles!r}")
            stack.append(prev)
            i += 1
        elif ch == ")":
            if not stack:
                raise SmilesError(f"unbalanced ')' in {smiles!r}")
            prev = stack.pop()
            i += 1
        elif ch == "%":
            if i + 2 >= len(s) or not s[i + 1 : i + 3].isdigit():
                raise SmilesError(f"bad ring label at {i} in {smiles!r}")
            ring_bond(s[i + 1 : i + 3])
            i += 3
        elif ch.isdigit():
            ring_bond(ch)
            i += 1
        elif ch == ".":
            prev = None  # disconnected component
            i += 1
        elif ch in "/\\":
            i += 1  # stereo bonds: treat as single
        else:
            two = s[i : i + 2]
            if two in _ORGANIC:
                add_atom(two, False)
                i += 2
            elif ch in _ORGANIC:
                add_atom(ch, False)
                i += 1
            elif ch in _AROMATIC:
                add_atom(ch.upper(), True)
                i += 1
            else:
                raise SmilesError(f"unexpected {ch!r} at {i} in {smiles!r}")
    if rings:
        raise SmilesError(f"unclosed ring bond(s) {sorted(rings)} in {smiles!r}")
    if not atoms:
        raise SmilesError(f"no atoms in {smiles!r}")
    return atoms, bonds


def featurize_atoms(atoms: list[dict], bonds) -> np.ndarray:
    deg = np.zeros(len(atoms), np.int64)
    for a, b, _ in bonds:
        deg[a] += 1
        deg[b] += 1
    feat = np.zeros((len(atoms), FEAT_DIM), np.float32)
    for i, at in enumerate(atoms):
        try:
            feat[i, ELEMENTS.index(at["symbol"])] = 1.0
        except ValueError:
            feat[i, len(ELEMENTS)] = 1.0  # other
        feat[i, len(ELEMENTS) + 1 + min(int(deg[i]), 5)] = 1.0
        feat[i, -1] = float(at["aromatic"])
    return feat


def smiles_to_graph(smiles: str) -> COOGraph:
    """SMILES -> COOGraph (both bond directions). Prefers RDKit if present."""
    try:  # pragma: no cover - rdkit absent in this image
        from rdkit import Chem  # type: ignore

        mol = Chem.MolFromSmiles(smiles)
        if mol is None:
            raise SmilesError(f"rdkit rejected {smiles!r}")
        atoms = [
            {"symbol": a.GetSymbol(), "aromatic": a.GetIsAromatic()}
            for a in mol.GetAtoms()
        ]
        bonds = [
            (b.GetBeginAtomIdx(), b.GetEndAtomIdx(),
             max(1, int(b.GetBondTypeAsDouble())))
            for b in mol.GetBonds()
        ]
    except ImportError:
        atoms, bonds = parse_smiles(smiles)
    feat = featurize_atoms(atoms, bonds)
    src = np.asarray([b[0] for b in bonds] + [b[1] for b in bonds], np.int64)
    dst = np.asarray([b[1] for b in bonds] + [b[0] for b in bonds], np.int64)
    return COOGraph(node_feat=feat, src=src, dst=dst)


def build_dataset_from_smiles(
    smiles_list: list[str],
    edges: np.ndarray,  # [E, 2] drug-index pairs
    name: str = "smiles",
    val_frac: float = 0.1,
    test_frac: float = 0.1,
    seed: int = 0,
) -> DDIDataset:
    """Assemble a DDIDataset from SMILES strings + interaction pairs —
    the offline prep path the reference ships as notebooks (R9)."""
    molecules = [smiles_to_graph(s) for s in smiles_list]
    edges = np.asarray(edges, np.int64)
    tr, va, te = random_split(edges.shape[0], val_frac, test_frac, seed)
    return DDIDataset(
        name=name, molecules=molecules, edges=edges,
        train_idx=tr, val_idx=va, test_idx=te,
    )
