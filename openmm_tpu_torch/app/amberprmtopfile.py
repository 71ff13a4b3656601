"""Amber prmtop (parm7) reader: the port's copy of
openmm_tpu/app/amberprmtopfile.py (after
wrappers/python/openmm/app/amberprmtopfile.py + internal/amber_file_parser.py):
parses %FLAG sections and builds Topology + System.

Amber unit conventions handled here: charges scaled by 18.2223 (kcal-based
electrostatic constant), lengths in Angstrom, energies kcal/mol, harmonic
constants as E = k (r-r0)^2 (factor 2 versus the 0.5 k convention).
"""
from __future__ import annotations

import math
import re

import numpy as np

from .. import forces as mmforces
from .. import unit as u
from ..exceptions import OpenMMException
from ..system import System
from ..vec3 import Vec3
from .element import Element
from .forcefield import (NoCutoff, CutoffNonPeriodic, CutoffPeriodic, Ewald,
                         PME, LJPME, HBonds, AllBonds, HAngles, _METHOD_MAP)
from .topology import Topology

CHARGE_SCALE = 18.2223
KCAL = 4.184
A2NM = 0.1


def _parse_prmtop(path):
    """%FLAG -> list of typed values."""
    sections = {}
    current = None
    fmt = None
    with open(path) as f:
        for line in f:
            if line.startswith("%FLAG"):
                current = line.split()[1]
                sections[current] = []
                fmt = None
            elif line.startswith("%FORMAT"):
                fmt = line[line.index("(") + 1:line.rindex(")")]
            elif line.startswith("%"):
                continue
            elif current is not None:
                if fmt and ("a" in fmt or "A" in fmt):
                    m = re.match(r"(\d+)[aA](\d+)", fmt)
                    width = int(m.group(2)) if m else 4
                    row = [line[i:i + width].strip()
                           for i in range(0, len(line.rstrip("\n")), width)]
                    sections[current].extend(x for x in row)
                else:
                    sections[current].extend(line.split())
    return sections


class AmberPrmtopFile(object):
    def __init__(self, file, periodicBoxVectors=None,
                 unitCellDimensions=None):
        sections = _parse_prmtop(file)
        self._sections = sections
        pointers = [int(x) for x in sections["POINTERS"]]
        self._n_atoms = pointers[0]
        n_res = pointers[11]
        self.elements = []

        def floats(name):
            return np.asarray([float(x) for x in sections.get(name, [])])

        def ints(name):
            return np.asarray([int(x) for x in sections.get(name, [])],
                              np.int64)

        self._charges = floats("CHARGE") / CHARGE_SCALE
        self._masses = floats("MASS")
        atom_names = sections["ATOM_NAME"][:self._n_atoms]
        res_labels = sections["RESIDUE_LABEL"][:n_res]
        res_ptr = ints("RESIDUE_POINTER")[:n_res]
        atomic_numbers = (ints("ATOMIC_NUMBER")[:self._n_atoms]
                          if "ATOMIC_NUMBER" in sections else None)

        # topology
        top = Topology()
        self.topology = top
        chain = top.addChain()
        atoms = []
        res_of = np.zeros(self._n_atoms, np.int64)
        for r in range(n_res):
            start = res_ptr[r] - 1
            end = res_ptr[r + 1] - 1 if r + 1 < n_res else self._n_atoms
            res = top.addResidue(res_labels[r], chain)
            for i in range(start, end):
                res_of[i] = r
                if atomic_numbers is not None and atomic_numbers[i] > 0:
                    el = Element.getByAtomicNumber(int(atomic_numbers[i]))
                elif self._masses[i] < 0.1:
                    el = None
                else:
                    el = Element.getByMass(self._masses[i])
                a = top.addAtom(atom_names[i], el, res)
                atoms.append(a)
                self.elements.append(el)
        bonds_h = ints("BONDS_INC_HYDROGEN").reshape(-1, 3)
        bonds_noh = ints("BONDS_WITHOUT_HYDROGEN").reshape(-1, 3)
        self._bonds = []
        for table in (bonds_h, bonds_noh):
            for row in table:
                i, j = row[0] // 3, row[1] // 3
                top.addBond(atoms[i], atoms[j])
                self._bonds.append((int(i), int(j), int(row[2]) - 1))
        self._bonds_h_count = len(bonds_h)

        # box
        if periodicBoxVectors is not None:
            box = u.strip(periodicBoxVectors, u.nanometer)
            top.setPeriodicBoxVectors(box)
        elif unitCellDimensions is not None:
            top.setUnitCellDimensions(unitCellDimensions)
        elif "BOX_DIMENSIONS" in sections:
            bd = floats("BOX_DIMENSIONS")
            top.setUnitCellDimensions(Vec3(bd[1] * A2NM, bd[2] * A2NM,
                                           bd[3] * A2NM))

    def createSystem(self, nonbondedMethod=NoCutoff, nonbondedCutoff=1.0,
                     constraints=None, rigidWater=True, implicitSolvent=None,
                     implicitSolventSaltConc=0.0, implicitSolventKappa=None,
                     temperature=298.15, soluteDielectric=1.0,
                     solventDielectric=78.5, gbsaModel="ACE",
                     ewaldErrorTolerance=5e-4, removeCMMotion=True,
                     hydrogenMass=None, switchDistance=None, **kwargs):
        sections = self._sections
        n = self._n_atoms

        def floats(name):
            return np.asarray([float(x) for x in sections.get(name, [])])

        def ints(name):
            return np.asarray([int(x) for x in sections.get(name, [])],
                              np.int64)

        system = System()
        for m in self._masses:
            system.addParticle(float(m))
        box = self.topology.getPeriodicBoxVectors()
        if box is not None:
            system.setDefaultPeriodicBoxVectors(
                *box.value_in_unit(u.nanometer))

        atoms = list(self.topology.atoms())

        def is_h(i):
            el = atoms[i].element
            return el is not None and el.atomic_number == 1

        is_water = [a.residue.name in ("HOH", "WAT") for a in atoms]

        # ---- bonds ----------------------------------------------------------
        bond_k = floats("BOND_FORCE_CONSTANT") * 2.0 * KCAL / (A2NM * A2NM)
        bond_r0 = floats("BOND_EQUIL_VALUE") * A2NM
        bond_force = mmforces.HarmonicBondForce()
        for (i, j, t) in self._bonds:
            r0, k = bond_r0[t], bond_k[t]
            constrain = (constraints in (AllBonds, HAngles)
                         or (constraints is HBonds and (is_h(i) or is_h(j)))
                         or (rigidWater and is_water[i] and is_water[j]))
            if constrain:
                system.addConstraint(i, j, r0)
            else:
                bond_force.addBond(i, j, r0, k)
        if bond_force.getNumBonds():
            system.addForce(bond_force)

        # ---- angles ---------------------------------------------------------
        angle_k = floats("ANGLE_FORCE_CONSTANT") * 2.0 * KCAL
        angle_t0 = floats("ANGLE_EQUIL_VALUE")
        angle_force = mmforces.HarmonicAngleForce()
        angles_all = np.concatenate([
            ints("ANGLES_INC_HYDROGEN").reshape(-1, 4),
            ints("ANGLES_WITHOUT_HYDROGEN").reshape(-1, 4)]) \
            if sections.get("ANGLES_INC_HYDROGEN") is not None else \
            ints("ANGLES_WITHOUT_HYDROGEN").reshape(-1, 4)
        bond_dist = {}
        for (i, j, t) in self._bonds:
            bond_dist[(min(i, j), max(i, j))] = bond_r0[t]
        for row in angles_all:
            i, j, k_atom = row[0] // 3, row[1] // 3, row[2] // 3
            t = row[3] - 1
            constrain = (constraints is HAngles and is_h(i) and is_h(k_atom)) \
                or (rigidWater and is_water[i] and is_water[j]
                    and is_water[k_atom])
            if constrain:
                k1 = bond_dist.get((min(i, j), max(i, j)))
                k2 = bond_dist.get((min(j, k_atom), max(j, k_atom)))
                if k1 and k2:
                    d13 = math.sqrt(k1 * k1 + k2 * k2
                                    - 2 * k1 * k2 * math.cos(angle_t0[t]))
                    system.addConstraint(i, k_atom, d13)
                continue
            angle_force.addAngle(i, j, k_atom, angle_t0[t], angle_k[t])
        if angle_force.getNumAngles():
            system.addForce(angle_force)

        # ---- dihedrals ---------------------------------------------------------
        dih_k = floats("DIHEDRAL_FORCE_CONSTANT") * KCAL
        dih_per = floats("DIHEDRAL_PERIODICITY")
        dih_phase = floats("DIHEDRAL_PHASE")
        torsion_force = mmforces.PeriodicTorsionForce()
        dihedrals_all = []
        for name in ("DIHEDRALS_INC_HYDROGEN", "DIHEDRALS_WITHOUT_HYDROGEN"):
            if sections.get(name):
                dihedrals_all.append(ints(name).reshape(-1, 5))
        pairs14 = []
        for table in dihedrals_all:
            for row in table:
                i = row[0] // 3
                j = row[1] // 3
                k_atom = abs(row[2]) // 3
                l_atom = abs(row[3]) // 3
                t = row[4] - 1
                if dih_k[t] != 0:
                    torsion_force.addTorsion(i, j, k_atom, l_atom,
                                             int(round(dih_per[t])),
                                             dih_phase[t], dih_k[t])
                # negative 3rd index: skip 1-4 terms (already counted);
                # negative 4th: improper (no 1-4 either)
                if row[2] >= 0 and row[3] >= 0:
                    pairs14.append((i, l_atom, t))
        if torsion_force.getNumTorsions():
            system.addForce(torsion_force)

        # ---- nonbonded ------------------------------------------------------------
        ntypes = int(sections["POINTERS"][1])
        atom_type = ints("ATOM_TYPE_INDEX") - 1
        nb_parm = ints("NONBONDED_PARM_INDEX")
        acoef = floats("LENNARD_JONES_ACOEF")
        bcoef = floats("LENNARD_JONES_BCOEF")

        def lj_params(t):
            idx = nb_parm[ntypes * t + t] - 1
            a, bcf = acoef[idx], bcoef[idx]
            if a == 0 or bcf == 0:
                return 1.0, 0.0
            sigma6 = a / bcf
            sigma = sigma6 ** (1.0 / 6.0) * A2NM
            eps = bcf * bcf / (4.0 * a) * KCAL
            return sigma, eps

        nb = mmforces.NonbondedForce()
        method = _METHOD_MAP.get(nonbondedMethod, nonbondedMethod)
        nb.setNonbondedMethod(method)
        nb.setCutoffDistance(u.strip(nonbondedCutoff, u.nanometer))
        nb.setEwaldErrorTolerance(ewaldErrorTolerance)
        if switchDistance is not None:
            nb.setUseSwitchingFunction(True)
            nb.setSwitchingDistance(u.strip(switchDistance, u.nanometer))
        type_sigma = {}
        type_eps = {}
        for t in range(ntypes):
            type_sigma[t], type_eps[t] = lj_params(t)
        for i in range(n):
            t = int(atom_type[i])
            nb.addParticle(self._charges[i], type_sigma[t], type_eps[t])
        # 1-2/1-3 exclusions + scaled 1-4 from SCEE/SCNB
        scee = floats("SCEE_SCALE_FACTOR")
        scnb = floats("SCNB_SCALE_FACTOR")
        bonds = [(b[0], b[1]) for b in self._bonds]
        bonded = {}
        for (i, j) in bonds:
            bonded.setdefault(i, set()).add(j)
            bonded.setdefault(j, set()).add(i)
        excl = set()
        for i in bonded:
            for j in bonded[i]:
                excl.add((min(i, j), max(i, j)))
                for k_atom in bonded[j]:
                    if k_atom != i:
                        excl.add((min(i, k_atom), max(i, k_atom)))
        seen14 = set()
        for (i, l_atom, t) in pairs14:
            key = (min(i, l_atom), max(i, l_atom))
            if key in excl or key in seen14:
                continue
            seen14.add(key)
        for (a, b) in sorted(excl):
            nb.addException(a, b, 0.0, 1.0, 0.0, True)
        for (i, l_atom, t) in pairs14:
            key = (min(i, l_atom), max(i, l_atom))
            if key not in seen14:
                continue
            seen14.discard(key)
            f14_q = 1.0 / (scee[t] if len(scee) > t and scee[t] != 0 else 1.2)
            f14_lj = 1.0 / (scnb[t] if len(scnb) > t and scnb[t] != 0 else 2.0)
            t1 = int(atom_type[i])
            t2 = int(atom_type[l_atom])
            sig = 0.5 * (type_sigma[t1] + type_sigma[t2])
            eps = math.sqrt(type_eps[t1] * type_eps[t2])
            nb.addException(i, l_atom,
                            f14_q * self._charges[i] * self._charges[l_atom],
                            sig, f14_lj * eps, True)
        system.addForce(nb)

        # ---- implicit solvent (amber_file_parser.py:1054-1135 behavior) ----
        if implicitSolvent is not None:
            from . import forcefield as ffmod
            from .gbforces import add_implicit_solvent, compute_kappa
            model = {ffmod.HCT: "HCT", ffmod.OBC1: "OBC1",
                     ffmod.OBC2: "OBC2", ffmod.GBn: "GBn",
                     ffmod.GBn2: "GBn2"}.get(implicitSolvent, "OBC2")
            if implicitSolventKappa is None:
                kappa = compute_kappa(implicitSolventSaltConc,
                                      solventDielectric, temperature)
            else:
                kappa = float(u.strip(implicitSolventKappa,
                                      u.nanometer ** -1))
            cutoff_gb = None
            if method != mmforces.NonbondedForce.NoCutoff:
                cutoff_gb = float(u.strip(nonbondedCutoff, u.nanometer))
            radii = floats("RADII") * A2NM
            screen = floats("SCREEN")
            add_implicit_solvent(
                system, self.topology, model, list(self._charges),
                radii=radii, screens=screen,
                solventDielectric=solventDielectric,
                soluteDielectric=soluteDielectric,
                SA=gbsaModel, cutoff=cutoff_gb, kappa=kappa)
            nb.setReactionFieldDielectric(1.0)

        if hydrogenMass is not None:
            h_mass = float(u.strip(hydrogenMass, u.dalton))
            for (i, j, t) in self._bonds:
                hi, hj = is_h(i), is_h(j)
                if hi == hj:
                    continue
                h, heavy = (i, j) if hi else (j, i)
                transfer = h_mass - system.getParticleMass(h)._value
                if system.getParticleMass(heavy)._value > h_mass and transfer:
                    system.setParticleMass(
                        heavy, system.getParticleMass(heavy)._value - transfer)
                    system.setParticleMass(h, h_mass)

        if removeCMMotion:
            system.addForce(mmforces.CMMotionRemover())
        return system
