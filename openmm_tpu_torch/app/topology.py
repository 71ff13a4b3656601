"""Topology: chains, residues, atoms and bonds, with the standard-bond
table that infers bonds in PDB files (createStandardBonds) and disulfide
detection.

The port's copy of openmm_tpu/app/topology.py (after OpenMM's
wrappers/python/openmm/app/topology.py:70-490). createStandardBonds reads
the port's own data/residue_bonds.json and data/residues.xml.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as etree
from collections import namedtuple

import numpy as np

from .. import unit as u
from ..vec3 import Vec3


class Chain(object):
    def __init__(self, index, topology, id):  # noqa: A002
        self.index = index
        self.topology = topology
        self.id = id
        self._residues = []

    def residues(self):
        return iter(self._residues)

    def atoms(self):
        for res in self._residues:
            for atom in res._atoms:
                yield atom

    def __len__(self):
        return len(self._residues)

    def __repr__(self):
        return "<Chain %d>" % self.index


class Residue(object):
    def __init__(self, name, index, chain, id, insertionCode=""):  # noqa: A002
        self.name = name
        self.index = index
        self.chain = chain
        self.id = id
        self.insertionCode = insertionCode
        self._atoms = []

    def atoms(self):
        return iter(self._atoms)

    def bonds(self):
        return (b for b in self.chain.topology.bonds()
                if b[0].residue is self or b[1].residue is self)

    def internal_bonds(self):
        return (b for b in self.chain.topology.bonds()
                if b[0].residue is self and b[1].residue is self)

    def external_bonds(self):
        return (b for b in self.chain.topology.bonds()
                if (b[0].residue is self) != (b[1].residue is self))

    def __len__(self):
        return len(self._atoms)

    def __repr__(self):
        return "<Residue %d (%s) of chain %d>" % (self.index, self.name,
                                                  self.chain.index)


class Atom(object):
    __slots__ = ("name", "element", "index", "residue", "id", "formalCharge")

    def __init__(self, name, element, index, residue, id, formalCharge=None):  # noqa: A002
        self.name = name
        self.element = element
        self.index = index
        self.residue = residue
        self.id = id
        self.formalCharge = formalCharge

    def __repr__(self):
        return "<Atom %d (%s) of chain %d residue %d (%s)>" % (
            self.index, self.name, self.residue.chain.index,
            self.residue.index, self.residue.name)


class Bond(namedtuple("Bond", ["atom1", "atom2"])):
    def __new__(cls, atom1, atom2, type=None, order=None):  # noqa: A002
        bond = super().__new__(cls, atom1, atom2)
        bond.type = type
        bond.order = order
        return bond

    def __getnewargs__(self):
        return self[0], self[1], self.type, self.order

    def __repr__(self):
        s = "Bond(%s, %s" % (self[0], self[1])
        if self.type is not None:
            s += ", type=%s" % self.type
        if self.order is not None:
            s += ", order=%d" % self.order
        return s + ")"


class Topology(object):
    _standardBonds = None

    def __init__(self):
        self._chains = []
        self._numResidues = 0
        self._numAtoms = 0
        self._bonds = []
        self._periodicBoxVectors = None

    def __repr__(self):
        return "<Topology; %d chains, %d residues, %d atoms, %d bonds>" % (
            len(self._chains), self._numResidues, self._numAtoms,
            len(self._bonds))

    def getNumAtoms(self):
        return self._numAtoms

    def getNumResidues(self):
        return self._numResidues

    def getNumChains(self):
        return len(self._chains)

    def getNumBonds(self):
        return len(self._bonds)

    def addChain(self, id=None):  # noqa: A002
        if id is None:
            id = str(len(self._chains) + 1)
        chain = Chain(len(self._chains), self, id)
        self._chains.append(chain)
        return chain

    def addResidue(self, name, chain, id=None, insertionCode=""):  # noqa: A002
        if len(chain._residues) > 0 \
                and self._numResidues != chain._residues[-1].index + 1:
            raise ValueError("All residues within a chain must be contiguous")
        if id is None:
            id = str(self._numResidues + 1)
        residue = Residue(name, self._numResidues, chain, id, insertionCode)
        self._numResidues += 1
        chain._residues.append(residue)
        return residue

    def addAtom(self, name, element, residue, id=None, formalCharge=None):  # noqa: A002
        if len(residue._atoms) > 0 \
                and self._numAtoms != residue._atoms[-1].index + 1:
            raise ValueError("All atoms within a residue must be contiguous")
        if id is None:
            id = str(self._numAtoms + 1)
        atom = Atom(name, element, self._numAtoms, residue, id, formalCharge)
        self._numAtoms += 1
        residue._atoms.append(atom)
        return atom

    def addBond(self, atom1, atom2, type=None, order=None):  # noqa: A002
        self._bonds.append(Bond(atom1, atom2, type, order))

    def chains(self):
        return iter(self._chains)

    def residues(self):
        for chain in self._chains:
            for residue in chain._residues:
                yield residue

    def atoms(self):
        for chain in self._chains:
            for residue in chain._residues:
                for atom in residue._atoms:
                    yield atom

    def bonds(self):
        return iter(self._bonds)

    def getPeriodicBoxVectors(self):
        return self._periodicBoxVectors

    def setPeriodicBoxVectors(self, vectors):
        if vectors is None:
            self._periodicBoxVectors = None
            return
        v = u.strip(vectors, u.nanometer)
        self._periodicBoxVectors = u.Quantity(
            (Vec3(*v[0]), Vec3(*v[1]), Vec3(*v[2])), u.nanometer)

    def getUnitCellDimensions(self):
        if self._periodicBoxVectors is None:
            return None
        v = self._periodicBoxVectors.value_in_unit(u.nanometer)
        return u.Quantity(Vec3(v[0][0], v[1][1], v[2][2]), u.nanometer)

    def setUnitCellDimensions(self, dimensions):
        if dimensions is None:
            self._periodicBoxVectors = None
            return
        d = u.strip(dimensions, u.nanometer)
        self.setPeriodicBoxVectors(((d[0], 0, 0), (0, d[1], 0), (0, 0, d[2])))

    # -- standard bonds (topology.py loadBondDefinitions/createStandardBonds) --
    @staticmethod
    def loadBondDefinitions(file):
        if Topology._standardBonds is None:
            Topology._standardBonds = {}
        if isinstance(file, str) and file.endswith(".json"):
            import json
            with open(file) as f:
                data = json.load(f)
            for name, bonds in data.items():
                Topology._standardBonds[name] = [tuple(b) for b in bonds]
            return
        tree = etree.parse(file)
        for residue in tree.getroot().findall("Residue"):
            bonds = []
            Topology._standardBonds[residue.attrib["name"]] = bonds
            for bond in residue.findall("Bond"):
                bonds.append((bond.attrib["from"], bond.attrib["to"]))

    def createStandardBonds(self):
        """Infer bonds from residue templates (data/residue_bonds.json,
        generated by the JAX package's tools/gen_residue_bonds.py, plus the
        data/residues.xml extras)."""
        if Topology._standardBonds is None:
            Topology._standardBonds = {}
            data_dir = os.path.join(os.path.dirname(__file__), "data")
            for fname in ("residue_bonds.json", "residues.xml"):
                Topology.loadBondDefinitions(os.path.join(data_dir, fname))
        for chain in self._chains:
            for i, res in enumerate(chain._residues):
                name = res.name
                if name not in Topology._standardBonds:
                    continue
                atom_maps = []
                for offset in (-1, 0):
                    index = i + offset
                    if 0 <= index < len(chain._residues):
                        atom_maps.append({a.name: a for a in
                                          chain._residues[index]._atoms})
                    else:
                        atom_maps.append({})
                for bond in Topology._standardBonds[name]:
                    names = []
                    maps = []
                    for bname in bond:
                        if bname.startswith("-"):
                            maps.append(atom_maps[0])
                            names.append(bname[1:])
                        elif bname.startswith("+"):
                            next_map = ({a.name: a for a in
                                         chain._residues[i + 1]._atoms}
                                        if i + 1 < len(chain._residues) else {})
                            maps.append(next_map)
                            names.append(bname[1:])
                        else:
                            maps.append(atom_maps[1])
                            names.append(bname)
                    if names[0] in maps[0] and names[1] in maps[1]:
                        self.addBond(maps[0][names[0]], maps[1][names[1]])

    def attachUnbondedHydrogens(self, positions):
        """Bond any hydrogen of a standard residue that createStandardBonds
        left unbonded to the nearest heavy atom in the same residue. PDB
        hydrogen naming varies (HB2/HB3 vs 1HB/2HB vs HB1/HB2...), so the
        bond-definition data intentionally omits hydrogens; geometry is
        unambiguous (a hydrogen sits ~0.1 nm from its parent)."""
        if not positions:
            return
        pos = u.strip(positions, u.nanometer)
        bonded = set()
        for b in self.bonds():
            bonded.add(b[0].index)
            bonded.add(b[1].index)
        std = Topology._standardBonds or {}
        for res in self.residues():
            if res.name not in std:
                continue
            heavies = [a for a in res.atoms()
                       if a.element is not None and a.element.symbol != "H"]
            if not heavies:
                continue
            for a in res.atoms():
                if (a.element is not None and a.element.symbol == "H"
                        and a.index not in bonded):
                    p = np.asarray(pos[a.index], dtype=float)
                    best, best_d2 = None, 0.04   # only within 0.2 nm
                    for h in heavies:
                        q = np.asarray(pos[h.index], dtype=float)
                        d2 = float(np.sum((p - q) ** 2))
                        if d2 < best_d2:
                            best, best_d2 = h, d2
                    if best is not None:
                        self.addBond(a, best)
                        bonded.add(a.index)

    def createDisulfideBonds(self, positions):
        """Add SG-SG bonds for cysteine pairs within 0.3 nm
        (topology.py createDisulfideBonds)."""
        def is_cyx(res):
            names = [a.name for a in res._atoms]
            return "SG" in names and "HG" not in names

        pos = u.strip(positions, u.nanometer)
        cyx_sg = []
        for res in self.residues():
            if res.name in ("CYS", "CYX") and is_cyx(res):
                sg = [a for a in res._atoms if a.name == "SG"][0]
                cyx_sg.append(sg)
        for i, sg1 in enumerate(cyx_sg):
            for sg2 in cyx_sg[:i]:
                p1 = np.asarray(pos[sg1.index], float)
                p2 = np.asarray(pos[sg2.index], float)
                if np.linalg.norm(p1 - p2) < 0.3:
                    self.addBond(sg1, sg2)
