"""PDB files: ATOM/HETATM/TER/MODEL/CRYST1/CONECT parsing with
standard-bond inference and several models, and the writeFile,
writeHeader, writeModel and writeFooter that PDBReporter uses.

The port's copy of openmm_tpu/app/pdbfile.py (after OpenMM's
wrappers/python/openmm/app/pdbfile.py and internal/pdbstructure.py).
Positions are unit-bearing: PDBFile.positions is a Quantity in nm, and the
writers take a Quantity or plain numbers in nm.
"""
from __future__ import annotations

import math
import sys

import numpy as np

from .. import unit as u
from ..vec3 import Vec3
from .element import Element
from .pdbnames import canonical_atom_name
from .topology import Topology
from . import unitcell

_STANDARD_RESIDUES = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "HOH", "WAT", "A", "G", "C", "U", "I", "DA", "DG", "DC", "DT", "DI",
    "HID", "HIE", "HIP", "CYX", "ASH", "GLH", "LYN",
}


def _guess_element(name, res_name):
    name = name.strip()
    if not name:
        return None
    # two-letter element symbols come first in columns for ions etc.
    upper = name.upper()
    if res_name.upper() in ("HOH", "WAT"):
        return Element.getBySymbol("H") if upper.startswith("H") \
            else Element.getBySymbol("O")
    for two in ("CL", "BR", "NA", "MG", "ZN", "CA", "FE", "MN", "CU", "NI",
                "CO", "SE", "RB", "CS", "LI", "KR", "XE"):
        if upper.startswith(two) and res_name.upper().strip() in (two, two + "+",
                                                                  two + "-",
                                                                  two + "2+"):
            return Element.getBySymbol(two[0] + two[1].lower())
    head = upper.lstrip("0123456789")
    if not head:
        return None
    try:
        return Element.getBySymbol(head[0])
    except KeyError:
        return None


class PDBFile(object):
    def __init__(self, file):
        own = False
        if isinstance(file, str):
            file = open(file)
            own = True
        try:
            self._parse(file)
        finally:
            if own:
                file.close()

    def _parse(self, f):
        top = Topology()
        self.topology = top
        self._positions = []   # list of models, each (N,3) nm
        coords = []
        chain = None
        residue = None
        last_chain_id = None
        last_res_key = None
        atom_by_serial = {}
        model_open = True
        n_model_atoms = None
        ter_flag = False
        conect = []
        box = None
        for line in f:
            rec = line[:6]
            if rec in ("ATOM  ", "HETATM"):
                if not model_open:
                    # new model started implicitly
                    model_open = True
                serial = line[6:11].strip()
                name = line[12:16].strip()
                alt_loc = line[16]
                res_name = line[17:20].strip() or line[17:21].strip()
                chain_id = line[21]
                res_seq = line[22:26].strip()
                i_code = line[26]
                x = float(line[30:38]) * 0.1
                y = float(line[38:46]) * 0.1
                z = float(line[46:54]) * 0.1
                elem_sym = line[76:78].strip() if len(line) >= 78 else ""
                if alt_loc not in (" ", "A", "1", ""):
                    continue
                if len(self._positions) == 0:
                    # first model: build topology
                    if chain is None or chain_id != last_chain_id or ter_flag:
                        chain = top.addChain(chain_id.strip() or None)
                        last_chain_id = chain_id
                        residue = None
                        last_res_key = None
                        ter_flag = False
                    res_key = (res_seq, res_name, i_code)
                    if residue is None or res_key != last_res_key:
                        residue = top.addResidue(res_name, chain,
                                                 res_seq or None, i_code.strip())
                        last_res_key = res_key
                    element = None
                    if elem_sym:
                        try:
                            element = Element.getBySymbol(elem_sym)
                        except KeyError:
                            element = None
                    if element is None:
                        element = _guess_element(name, res_name)
                    name = canonical_atom_name(res_name, name)
                    atom = top.addAtom(name, element, residue, serial or None)
                    atom_by_serial[serial] = atom
                coords.append(Vec3(x, y, z))
            elif rec == "TER   " or line.strip() == "TER":
                ter_flag = True
            elif rec == "MODEL ":
                model_open = True
            elif rec == "ENDMDL":
                if coords:
                    if n_model_atoms is None:
                        n_model_atoms = len(coords)
                    self._positions.append(coords)
                    coords = []
                model_open = False
            elif rec == "CRYST1":
                try:
                    a = float(line[6:15]) * 0.1
                    b = float(line[15:24]) * 0.1
                    c = float(line[24:33]) * 0.1
                    alpha = float(line[33:40]) * math.pi / 180.0
                    beta = float(line[40:47]) * math.pi / 180.0
                    gamma = float(line[47:54]) * math.pi / 180.0
                    if a > 0.11 or b > 0.11 or c > 0.11:  # skip dummy 1A cells
                        box = unitcell.computePeriodicBoxVectors(
                            a, b, c, alpha, beta, gamma)
                except ValueError:
                    pass
            elif rec == "CONECT":
                # fixed columns of 5: serials above 9999 run together
                fields = [line[k:k + 5].strip()
                          for k in range(6, min(len(line), 31), 5)]
                fields = [fld for fld in fields if fld]
                if len(fields) >= 2:
                    conect.append(fields)
        if coords:
            self._positions.append(coords)
        if box is not None:
            top.setPeriodicBoxVectors(box)
        top.createStandardBonds()
        top.attachUnbondedHydrogens(self._positions[0]
                                    if self._positions else [])
        top.createDisulfideBonds(self._positions[0] if self._positions else [])
        existing = {(min(b[0].index, b[1].index), max(b[0].index, b[1].index))
                    for b in top.bonds()}
        for fields in conect:
            if fields[0] in atom_by_serial:
                a1 = atom_by_serial[fields[0]]
                for serial2 in fields[1:]:
                    if serial2 in atom_by_serial:
                        a2 = atom_by_serial[serial2]
                        key = (min(a1.index, a2.index), max(a1.index, a2.index))
                        if key not in existing and a1 is not a2:
                            top.addBond(a1, a2)
                            existing.add(key)

    def getTopology(self):
        return self.topology

    def getNumFrames(self):
        return len(self._positions)

    def getPositions(self, asNumpy=False, frame=0):
        if asNumpy:
            return u.Quantity(
                np.asarray([[v.x, v.y, v.z] for v in self._positions[frame]]),
                u.nanometer)
        return u.Quantity(list(self._positions[frame]), u.nanometer)

    @property
    def positions(self):
        return self.getPositions()

    # ------------------------------------------------------------- writing
    @staticmethod
    def writeFile(topology, positions, file=sys.stdout, keepIds=False):
        own = False
        if isinstance(file, str):
            file = open(file, "w")
            own = True
        try:
            PDBFile.writeHeader(topology, file)
            PDBFile.writeModel(topology, positions, file, keepIds=keepIds)
            PDBFile.writeFooter(topology, file)
        finally:
            if own:
                file.close()

    @staticmethod
    def writeHeader(topology, file=sys.stdout):
        vectors = topology.getPeriodicBoxVectors()
        if vectors is not None:
            v = vectors.value_in_unit(u.nanometer)
            (a, b, c, alpha, beta, gamma) = \
                unitcell.computeLengthsAndAngles(v)
            print("CRYST1%9.3f%9.3f%9.3f%7.2f%7.2f%7.2f P 1           1 "
                  % (a * 10, b * 10, c * 10, alpha * 180 / math.pi,
                     beta * 180 / math.pi, gamma * 180 / math.pi), file=file)

    @staticmethod
    def writeModel(topology, positions, file=sys.stdout, modelIndex=None,
                   keepIds=False, extraParticleIdentifier="EP"):
        pos = u.strip(positions, u.nanometer)
        if modelIndex is not None:
            print("MODEL     %4d" % modelIndex, file=file)
        index = 1
        for ci, chain in enumerate(topology.chains()):
            chain_id = chain.id if keepIds else chr(ord("A") + ci % 26)
            res_list = list(chain.residues())
            for ri, res in enumerate(res_list):
                res_id = res.id if keepIds else str((ri + 1) % 10000)
                res_name = res.name[:3]
                for atom in res.atoms():
                    sym = (atom.element.symbol if atom.element is not None
                           else extraParticleIdentifier)
                    name = atom.name
                    if len(name) < 4 and len(sym) == 1:
                        name = " " + name
                    p = pos[atom.index]
                    print("%s%5d %-4s %3s %s%4s    %8.3f%8.3f%8.3f  1.00  0.00          %2s"
                          % ("ATOM  " if res.name in _STANDARD_RESIDUES
                             else "HETATM", index % 100000, name[:4], res_name,
                             chain_id, res_id,
                             p[0] * 10, p[1] * 10, p[2] * 10, sym[:2]),
                          file=file)
                    index += 1
            print("TER   %5d      %3s %s%4s" % (index % 100000,
                                                res_list[-1].name[:3],
                                                chain_id,
                                                res_list[-1].id if keepIds
                                                else str(len(res_list) % 10000)),
                  file=file)
            index += 1
        if modelIndex is not None:
            print("ENDMDL", file=file)

    @staticmethod
    def writeFooter(topology, file=sys.stdout):
        """CONECT records for the bonds that the reader's standard-bond
        table does not give back (those with an atom outside the standard
        residues, and disulfides), then END (OpenMM's pdbfile.py
        writeFooter). The JAX package's writer writes no CONECT records,
        so its files lose those bonds."""
        PDBFile._writeConect(topology, file)
        print("END", file=file)

    @staticmethod
    def _writeConect(topology, file):
        serial = {}
        index = 1
        for chain in topology.chains():
            for atom in chain.atoms():
                serial[atom] = index
                index += 1
            index += 1      # the chain's TER record
        partners = {}
        for a1, a2 in topology.bonds():
            standard = (a1.residue.name in _STANDARD_RESIDUES
                        and a2.residue.name in _STANDARD_RESIDUES)
            disulfide = (a1.name == "SG" and a2.name == "SG"
                         and a1.residue.name in ("CYS", "CYX")
                         and a2.residue.name in ("CYS", "CYX"))
            if standard and not disulfide:
                continue
            i, j = serial[a1], serial[a2]
            if max(i, j) > 99999:
                continue    # the serial column holds five digits
            partners.setdefault(i, []).append(j)
            partners.setdefault(j, []).append(i)
        for i in sorted(partners):
            bonded = partners[i]
            for k in range(0, len(bonded), 4):
                print("CONECT%5d" % i + "".join(
                    "%5d" % j for j in bonded[k:k + 4]), file=file)
