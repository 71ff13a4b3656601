"""Desmond DMS file reader: the port's copy of
openmm_tpu/app/desmonddmsfile.py (after
wrappers/python/openmm/app/desmonddmsfile.py, 958 LoC; createSystem at :303):
a sqlite database with particle/bond/term tables. Functional subset:
particles/topology/box, stretch_harm, angle_harm, dihedral_trig,
improper_harm, nonbonded (vdw_12_6), exclusions and scaled pairs.
"""
from __future__ import annotations

import math
import sqlite3

import numpy as np

from .. import forces as mmforces
from .. import unit as u
from ..exceptions import OpenMMException
from ..system import System
from ..vec3 import Vec3
from .element import Element
from .forcefield import NoCutoff, _METHOD_MAP
from .topology import Topology

A2NM = 0.1
KCAL = 4.184


class DesmondDMSFile(object):
    def __init__(self, file):
        self._conn = sqlite3.connect(file)
        self._file = file
        c = self._conn.cursor()
        tables = {row[0] for row in c.execute(
            "SELECT name FROM sqlite_master WHERE type='table'")}
        self._tables = tables
        if "particle" not in tables:
            raise OpenMMException("%s is not a valid DMS file" % file)

        rows = list(c.execute(
            "SELECT id, anum, name, resname, resid, chain, mass, charge,"
            " x, y, z FROM particle ORDER BY id"))
        top = Topology()
        self.topology = top
        positions = []
        self._charges = []
        self._masses = []
        atoms = []
        last_rkey = None
        last_chain_name = None
        chain = None
        residue = None
        for (pid, anum, name, resname, resid, chain_name, mass, charge,
             x, y, z) in rows:
            # particles are ordered by id; open a new chain whenever the
            # chain name changes (Topology requires contiguity)
            if chain is None or chain_name != last_chain_name:
                chain = top.addChain(chain_name)
                last_chain_name = chain_name
                last_rkey = None
            rkey = (resid, resname)
            if rkey != last_rkey:
                residue = top.addResidue(resname, chain, str(resid))
                last_rkey = rkey
            el = (Element.getByAtomicNumber(anum) if anum and anum > 0
                  else None)
            atoms.append(top.addAtom(name, el, residue))
            positions.append(Vec3(x * A2NM, y * A2NM, z * A2NM))
            self._charges.append(charge)
            self._masses.append(mass)
        self._atoms = atoms
        self.positions = u.Quantity(positions, u.nanometer)
        if "bond" in tables:
            for (p0, p1) in c.execute("SELECT p0, p1 FROM bond"):
                top.addBond(atoms[p0], atoms[p1])
        if "global_cell" in tables:
            cell = list(c.execute("SELECT x, y, z FROM global_cell"))
            if len(cell) >= 3:
                box = tuple(Vec3(*[v * A2NM for v in row]) for row in cell[:3])
                if box[0][0] > 0.11:
                    top.setPeriodicBoxVectors(u.Quantity(box, u.nanometer))

    def getPositions(self, asNumpy=False):
        if asNumpy:
            return u.Quantity(np.asarray(
                [[v.x, v.y, v.z] for v in self.positions._value]), u.nanometer)
        return self.positions

    def getTopology(self):
        return self.topology

    def _term_rows(self, term, param, columns):
        c = self._conn.cursor()
        if term not in self._tables or param not in self._tables:
            return []
        return list(c.execute(
            "SELECT %s FROM %s INNER JOIN %s ON %s.param=%s.id"
            % (columns, term, param, term, param)))

    def createSystem(self, nonbondedMethod=NoCutoff, nonbondedCutoff=1.0,
                     ewaldErrorTolerance=5e-4, removeCMMotion=True,
                     hydrogenMass=None, **kwargs):
        system = System()
        for m in self._masses:
            system.addParticle(m)
        box = self.topology.getPeriodicBoxVectors()
        if box is not None:
            system.setDefaultPeriodicBoxVectors(
                *box.value_in_unit(u.nanometer))

        bonds = self._term_rows("stretch_harm_term", "stretch_harm_param",
                                "p0, p1, r0, fc, constrained")
        if bonds:
            f = mmforces.HarmonicBondForce()
            for (p0, p1, r0, fc, constrained) in bonds:
                if constrained:
                    system.addConstraint(p0, p1, r0 * A2NM)
                else:
                    f.addBond(p0, p1, r0 * A2NM,
                              2.0 * fc * KCAL / (A2NM * A2NM))
            if f.getNumBonds():
                system.addForce(f)
        angles = self._term_rows("angle_harm_term", "angle_harm_param",
                                 "p0, p1, p2, theta0, fc, constrained")
        if angles:
            f = mmforces.HarmonicAngleForce()
            for (p0, p1, p2, theta0, fc, constrained) in angles:
                if constrained:
                    continue
                f.addAngle(p0, p1, p2, math.radians(theta0), 2.0 * fc * KCAL)
            if f.getNumAngles():
                system.addForce(f)
        dihedrals = self._term_rows(
            "dihedral_trig_term", "dihedral_trig_param",
            "p0, p1, p2, p3, phi0, fc0, fc1, fc2, fc3, fc4, fc5, fc6")
        if dihedrals:
            f = mmforces.PeriodicTorsionForce()
            for row in dihedrals:
                p0, p1, p2, p3, phi0 = row[0], row[1], row[2], row[3], row[4]
                fcs = row[5:12]
                # fc0 is a constant offset; fc_n multiplies cos(n phi - phi0)
                for n in range(1, 7):
                    if fcs[n] != 0:
                        f.addTorsion(p0, p1, p2, p3, n,
                                     math.radians(phi0), fcs[n] * KCAL)
            if f.getNumTorsions():
                system.addForce(f)
        impropers = self._term_rows("improper_harm_term",
                                    "improper_harm_param",
                                    "p0, p1, p2, p3, phi0, fc")
        if impropers:
            f = mmforces.CustomTorsionForce("k*(theta-theta0)^2")
            f.addPerTorsionParameter("k")
            f.addPerTorsionParameter("theta0")
            for (p0, p1, p2, p3, phi0, fc) in impropers:
                f.addTorsion(p0, p1, p2, p3,
                             [fc * KCAL, math.radians(phi0)])
            if f.getNumTorsions():
                system.addForce(f)

        # nonbonded
        nb = mmforces.NonbondedForce()
        method = _METHOD_MAP.get(nonbondedMethod, nonbondedMethod)
        nb.setNonbondedMethod(method)
        nb.setCutoffDistance(u.strip(nonbondedCutoff, u.nanometer))
        nb.setEwaldErrorTolerance(ewaldErrorTolerance)
        c = self._conn.cursor()
        if "nonbonded_param" in self._tables:
            params = {row[0]: (row[1], row[2]) for row in c.execute(
                "SELECT id, sigma, epsilon FROM nonbonded_param")}
            nbtype = [row[0] for row in c.execute(
                "SELECT nbtype FROM particle ORDER BY id")]
            for i, q in enumerate(self._charges):
                sigma, eps = params.get(nbtype[i], (1.0, 0.0))
                nb.addParticle(q, sigma * A2NM, eps * KCAL)
        else:
            for q in self._charges:
                nb.addParticle(q, 1.0, 0.0)
        if "exclusion" in self._tables:
            for (p0, p1) in c.execute("SELECT p0, p1 FROM exclusion"):
                nb.addException(p0, p1, 0.0, 1.0, 0.0, True)
        pair_rows = self._term_rows("pair_12_6_es_term", "pair_12_6_es_param",
                                    "p0, p1, aij, bij, qij")
        for (p0, p1, aij, bij, qij) in pair_rows:
            if bij != 0:
                sigma6 = aij / bij
                sigma = sigma6 ** (1.0 / 6.0) * A2NM
                eps = bij * bij / (4.0 * aij) * KCAL
            else:
                sigma, eps = 1.0, 0.0
            nb.addException(p0, p1, qij, sigma, eps, True)
        system.addForce(nb)
        if removeCMMotion:
            system.addForce(mmforces.CMMotionRemover())
        return system

    def close(self):
        self._conn.close()
