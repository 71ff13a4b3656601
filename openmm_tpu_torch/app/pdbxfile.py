"""PDBx/mmCIF reader and writer: the port's copy of
openmm_tpu/app/pdbxfile.py (the reader opens a chain or a residue
whenever its key changes from the row before, where the JAX reader looks
the key up: a reused chain id or residue number there raises or merges
residues) (after
wrappers/python/openmm/app/pdbxfile.py + internal/pdbx): parses the
atom_site category and cell parameters, writes standard mmCIF."""
from __future__ import annotations

import math
import sys

import numpy as np

from .. import unit as u
from ..vec3 import Vec3
from .element import Element
from .pdbfile import _guess_element
from .pdbnames import canonical_atom_name
from .topology import Topology
from . import unitcell


def _cif_tokens(line):
    """Tokenize one CIF line honoring quotes."""
    tokens = []
    i = 0
    n = len(line)
    while i < n:
        while i < n and line[i] in " \t":
            i += 1
        if i >= n or line[i] == "#":
            break
        if line[i] in "'\"":
            quote = line[i]
            j = line.find(quote, i + 1)
            while j != -1 and j + 1 < n and line[j + 1] not in " \t":
                j = line.find(quote, j + 1)
            if j == -1:
                j = n
            tokens.append(line[i + 1:j])
            i = j + 1
        else:
            j = i
            while j < n and line[j] not in " \t":
                j += 1
            tokens.append(line[i:j])
            i = j
    return tokens


class PDBxFile(object):
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
        self._positions = []
        cell = {}
        atom_rows = []
        atom_cols = None

        lines = f.read().splitlines()
        i = 0
        while i < len(lines):
            line = lines[i].strip()
            if line.startswith("_cell."):
                tokens = _cif_tokens(lines[i])
                if len(tokens) >= 2:
                    cell[tokens[0]] = tokens[1]
                i += 1
            elif line == "loop_":
                # gather the column headers
                cols = []
                i += 1
                while i < len(lines) and lines[i].strip().startswith("_"):
                    cols.append(lines[i].strip().split()[0])
                    i += 1
                if cols and cols[0].startswith("_atom_site."):
                    atom_cols = cols
                    while i < len(lines):
                        row = lines[i].strip()
                        if (not row or row.startswith("_")
                                or row.startswith("loop_")
                                or row.startswith("#")
                                or row.startswith("data_")):
                            break
                        tokens = _cif_tokens(lines[i])
                        if len(tokens) == len(cols):
                            atom_rows.append(tokens)
                        i += 1
                else:
                    # skip other loops
                    while i < len(lines):
                        row = lines[i].strip()
                        if (not row or row.startswith("_")
                                or row.startswith("loop_")
                                or row.startswith("#")
                                or row.startswith("data_")):
                            break
                        i += 1
            else:
                i += 1

        if atom_cols is None:
            raise ValueError("no atom_site records found")
        col = {name.split(".")[1]: k for k, name in enumerate(atom_cols)}

        def get(row, *names, default=None):
            for name in names:
                if name in col:
                    v = row[col[name]]
                    if v not in (".", "?"):
                        return v
            return default

        chains = {}
        residues = {}
        models_seen = set()
        frames = {}
        atoms_first_model = []
        last_chain = last_res = None
        for row in atom_rows:
            model = get(row, "pdbx_PDB_model_num", default="1")
            models_seen.add(model)
            x = float(get(row, "Cartn_x")) * 0.1
            y = float(get(row, "Cartn_y")) * 0.1
            z = float(get(row, "Cartn_z")) * 0.1
            frames.setdefault(model, []).append(Vec3(x, y, z))
            if len(models_seen) > 1:
                continue
            chain_id = get(row, "auth_asym_id", "label_asym_id", default="A")
            res_name = get(row, "auth_comp_id", "label_comp_id", default="UNK")
            res_id = get(row, "auth_seq_id", "label_seq_id", default="1")
            name = get(row, "auth_atom_id", "label_atom_id", default="X")
            sym = get(row, "type_symbol", default="")
            # a chain, or a residue, runs while its key repeats row after
            # row: a file may reuse a chain id (a Modeller's ions after its
            # waters) or a residue number (tiled membrane patches)
            if chain_id != last_chain:
                chains[chain_id] = top.addChain(chain_id)
                last_chain, last_res = chain_id, None
            rkey = (chain_id, res_id, res_name)
            if rkey != last_res:
                residues[rkey] = top.addResidue(res_name, chains[chain_id],
                                                res_id)
                last_res = rkey
            element = None
            if sym:
                try:
                    element = Element.getBySymbol(sym)
                except KeyError:
                    pass
            if element is None:
                element = _guess_element(name, res_name)
            name = canonical_atom_name(res_name, name)
            atoms_first_model.append(top.addAtom(name, element,
                                                 residues[rkey]))
        self._positions = [frames[m] for m in sorted(frames)]
        if "_cell.length_a" in cell:
            a = float(cell["_cell.length_a"]) * 0.1
            b = float(cell["_cell.length_b"]) * 0.1
            c = float(cell["_cell.length_c"]) * 0.1
            alpha = math.radians(float(cell.get("_cell.angle_alpha", 90)))
            beta = math.radians(float(cell.get("_cell.angle_beta", 90)))
            gamma = math.radians(float(cell.get("_cell.angle_gamma", 90)))
            if a > 0.11:
                top.setPeriodicBoxVectors(unitcell.computePeriodicBoxVectors(
                    a, b, c, alpha, beta, gamma))
        top.createStandardBonds()
        top.attachUnbondedHydrogens(
            self._positions[0] if self._positions else [])

    def getTopology(self):
        return self.topology

    def getNumFrames(self):
        return len(self._positions)

    def getPositions(self, asNumpy=False, frame=0):
        if asNumpy:
            return u.Quantity(np.asarray(
                [[v.x, v.y, v.z] for v in self._positions[frame]]),
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
            PDBxFile.writeHeader(topology, file)
            PDBxFile.writeModel(topology, positions, file)
        finally:
            if own:
                file.close()

    @staticmethod
    def writeHeader(topology, file=sys.stdout):
        print("data_openmm_tpu", file=file)
        box = topology.getPeriodicBoxVectors()
        if box is not None:
            (a, b, c, alpha, beta, gamma) = \
                unitcell.computeLengthsAndAngles(box)
            print("_cell.length_a     %.4f" % (a * 10), file=file)
            print("_cell.length_b     %.4f" % (b * 10), file=file)
            print("_cell.length_c     %.4f" % (c * 10), file=file)
            print("_cell.angle_alpha  %.4f" % math.degrees(alpha), file=file)
            print("_cell.angle_beta   %.4f" % math.degrees(beta), file=file)
            print("_cell.angle_gamma  %.4f" % math.degrees(gamma), file=file)
        print("loop_", file=file)
        for colname in ("group_PDB", "id", "type_symbol", "label_atom_id",
                        "label_comp_id", "label_asym_id", "label_seq_id",
                        "Cartn_x", "Cartn_y", "Cartn_z",
                        "pdbx_PDB_model_num"):
            print("_atom_site.%s" % colname, file=file)

    @staticmethod
    def writeModel(topology, positions, file=sys.stdout, modelIndex=1):
        pos = u.strip(positions, u.nanometer)
        index = 1
        for chain in topology.chains():
            for res in chain.residues():
                for atom in res.atoms():
                    p = pos[atom.index]
                    sym = atom.element.symbol if atom.element else "X"
                    print("ATOM %d %s %s %s %s %s %.4f %.4f %.4f %d"
                          % (index, sym, atom.name or "X", res.name or "UNK",
                             chain.id or "A", res.id or "1",
                             p[0] * 10, p[1] * 10, p[2] * 10, modelIndex),
                          file=file)
                    index += 1
