"""GROMACS .top topology reader: the port's copy of
openmm_tpu/app/gromacstopfile.py (after
wrappers/python/openmm/app/gromacstopfile.py, 1237 LoC; createSystem at :594).

Supports the cpp-style preprocessor (#include/#define/#ifdef/#else/#endif),
parameter sections ([defaults], [atomtypes], [bondtypes], [angletypes],
[dihedraltypes], [pairtypes]) and per-molecule sections ([atoms], [bonds],
[pairs], [angles], [dihedrals], [settles], [exclusions], [constraints]),
with molecule replication from [molecules]. Combination rule 2
(Lorentz-Berthelot) maps onto NonbondedForce; rules 1/3 (geometric) convert
c6/c12 to sigma/epsilon per type.
"""
from __future__ import annotations

import math
import os

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


class _MoleculeType(object):
    def __init__(self, name, nrexcl):
        self.name = name
        self.nrexcl = nrexcl
        self.atoms = []        # (type, resnr, resname, atomname, charge, mass)
        self.bonds = []        # (i, j, funct, params)
        self.pairs = []        # (i, j, funct, params)
        self.angles = []       # (i, j, k, funct, params)
        self.dihedrals = []    # (i, j, k, l, funct, params)
        self.exclusions = []   # (i, [j...])
        self.constraints = []  # (i, j, funct, dist)
        self.settles = []      # (ow, dOH, dHH)


class GromacsTopFile(object):
    def __init__(self, file, periodicBoxVectors=None, unitCellDimensions=None,
                 includeDir=None, defines=None):
        if includeDir is None:
            includeDir = "/usr/local/gromacs/share/gromacs/top"
        self._includeDirs = [os.path.dirname(os.path.abspath(file)),
                             includeDir]
        self._defines = dict(defines or {})
        self._defaults = {"nbfunc": 1, "comb-rule": 2, "gen-pairs": "no",
                          "fudgeLJ": 1.0, "fudgeQQ": 1.0}
        self._atomtypes = {}      # name -> (mass, charge, sigma, epsilon)
        self._bondtypes = {}
        self._angletypes = {}
        self._dihedraltypes = {}
        self._pairtypes = {}
        self._moltypes = {}
        self._mol_order = []      # [(name, count)]
        self._current = None
        self._section = None
        self._if_stack = []
        self._process_file(file)
        self._build_topology(periodicBoxVectors, unitCellDimensions)

    # ------------------------------------------------------------ parsing
    def _resolve(self, name):
        for d in self._includeDirs:
            path = os.path.join(d, name)
            if os.path.exists(path):
                return path
        raise OpenMMException("Could not locate #include file: " + name)

    def _process_file(self, path):
        with open(path) as fh:
            for raw in fh:
                line = raw.split(";")[0].strip()
                if not line:
                    continue
                while line.endswith("\\"):
                    line = line[:-1] + next(fh).split(";")[0].strip()
                if line.startswith("#"):
                    self._directive(line, path)
                    continue
                if self._if_stack and not all(self._if_stack):
                    continue
                if line.startswith("["):
                    self._section = line.strip("[] \t").lower()
                    if self._section == "moleculetype":
                        self._current = None
                    continue
                self._line(line)

    def _directive(self, line, path):
        fields = line.split()
        cmd = fields[0]
        if cmd == "#ifdef":
            self._if_stack.append(fields[1] in self._defines)
        elif cmd == "#ifndef":
            self._if_stack.append(fields[1] not in self._defines)
        elif cmd == "#else":
            self._if_stack[-1] = not self._if_stack[-1]
        elif cmd == "#endif":
            self._if_stack.pop()
        elif self._if_stack and not all(self._if_stack):
            return
        elif cmd == "#include":
            name = fields[1].strip('"<>')
            inc = self._resolve(name)
            self._includeDirs.insert(0, os.path.dirname(inc))
            self._process_file(inc)
            self._includeDirs.pop(0)
        elif cmd == "#define":
            value = " ".join(fields[2:]) if len(fields) > 2 else "1"
            self._defines[fields[1]] = value
        elif cmd == "#undef":
            self._defines.pop(fields[1], None)

    def _line(self, line):
        for name, value in self._defines.items():
            if name in line.split():
                line = " ".join(value if f == name else f
                                for f in line.split())
        fields = line.split()
        s = self._section
        if s == "defaults":
            self._defaults["nbfunc"] = int(fields[0])
            self._defaults["comb-rule"] = int(fields[1])
            if len(fields) > 2:
                self._defaults["gen-pairs"] = fields[2].lower()
            if len(fields) > 3:
                self._defaults["fudgeLJ"] = float(fields[3])
            if len(fields) > 4:
                self._defaults["fudgeQQ"] = float(fields[4])
        elif s == "atomtypes":
            self._atomtype_line(fields)
        elif s == "bondtypes":
            key = tuple(sorted(fields[:2]))
            self._bondtypes[key] = [float(x) for x in fields[3:5]]
        elif s == "angletypes":
            t = fields[:3]
            if t[0] > t[2]:
                t = t[::-1]
            self._angletypes[tuple(t)] = [int(fields[3])] \
                + [float(x) for x in fields[4:8]]
        elif s == "dihedraltypes":
            if len(fields) >= 5 and fields[4].lstrip("-").isdigit() \
                    and not fields[2].lstrip("-").replace(".", "").isdigit():
                t = tuple(fields[:4])
                funct = int(fields[4])
                params = [float(x) for x in fields[5:11]]
            else:  # two-type form
                t = ("X", fields[0], fields[1], "X")
                funct = int(fields[2])
                params = [float(x) for x in fields[3:9]]
            self._dihedraltypes.setdefault((t, funct), []).append(params)
        elif s == "pairtypes":
            key = tuple(sorted(fields[:2]))
            self._pairtypes[key] = [float(x) for x in fields[3:5]]
        elif s == "moleculetype":
            self._current = _MoleculeType(fields[0], int(fields[1]))
            self._moltypes[fields[0]] = self._current
        elif s == "system":
            pass
        elif s == "molecules":
            self._mol_order.append((fields[0], int(fields[1])))
        elif self._current is not None:
            m = self._current
            if s == "atoms":
                type_name = fields[1]
                charge = (float(fields[6]) if len(fields) > 6
                          else self._atomtypes[type_name][1])
                mass = (float(fields[7]) if len(fields) > 7
                        else self._atomtypes[type_name][0])
                m.atoms.append((type_name, fields[2], fields[3], fields[4],
                                charge, mass))
            elif s == "bonds":
                m.bonds.append((int(fields[0]) - 1, int(fields[1]) - 1,
                                int(fields[2]),
                                [float(x) for x in fields[3:5]]))
            elif s == "pairs":
                m.pairs.append((int(fields[0]) - 1, int(fields[1]) - 1,
                                int(fields[2]),
                                [float(x) for x in fields[3:5]]))
            elif s == "angles":
                m.angles.append((int(fields[0]) - 1, int(fields[1]) - 1,
                                 int(fields[2]) - 1, int(fields[3]),
                                 [float(x) for x in fields[4:8]]))
            elif s == "dihedrals":
                m.dihedrals.append((int(fields[0]) - 1, int(fields[1]) - 1,
                                    int(fields[2]) - 1, int(fields[3]) - 1,
                                    int(fields[4]),
                                    [float(x) for x in fields[5:11]]))
            elif s == "exclusions":
                m.exclusions.append((int(fields[0]) - 1,
                                     [int(x) - 1 for x in fields[1:]]))
            elif s == "constraints":
                m.constraints.append((int(fields[0]) - 1, int(fields[1]) - 1,
                                      int(fields[2]), float(fields[3])))
            elif s == "settles":
                m.settles.append((int(fields[0]) - 1, float(fields[2]),
                                  float(fields[3])))

    def _atomtype_line(self, fields):
        # flexible column layouts: name [btype] [at.num] mass charge ptype V W
        name = fields[0]
        # find the ptype column (single letter A/S/V/D)
        pt = None
        for i, f in enumerate(fields):
            if f.upper() in ("A", "S", "V", "D") and i >= 3:
                pt = i
                break
        if pt is None or len(fields) < pt + 3:
            return
        mass = float(fields[pt - 2])
        charge = float(fields[pt - 1])
        v = float(fields[pt + 1])
        w = float(fields[pt + 2])
        if self._defaults["comb-rule"] == 1:
            # c6/c12 -> sigma/eps
            if v > 0 and w > 0:
                sigma = (w / v) ** (1.0 / 6.0)
                eps = v * v / (4.0 * w)
            else:
                sigma, eps = 1.0, 0.0
        else:
            sigma, eps = v, w
        self._atomtypes[name] = (mass, charge, sigma, eps)

    # -------------------------------------------------------------- topology
    def _build_topology(self, periodicBoxVectors, unitCellDimensions):
        top = Topology()
        self.topology = top
        self.elements = []
        for (mol_name, count) in self._mol_order:
            if mol_name not in self._moltypes:
                raise OpenMMException("unknown molecule type " + mol_name)
            mt = self._moltypes[mol_name]
            for _ in range(count):
                chain = top.addChain()
                residues = {}
                atoms = []
                for (type_name, resnr, resname, atomname, charge, mass) \
                        in mt.atoms:
                    if resnr not in residues:
                        residues[resnr] = top.addResidue(resname, chain, resnr)
                    try:
                        el = Element.getByMass(mass) if mass > 0.2 else None
                    except Exception:
                        el = None
                    atoms.append(top.addAtom(atomname, el, residues[resnr]))
                    self.elements.append(el)
                for (i, j, funct, params) in mt.bonds:
                    top.addBond(atoms[i], atoms[j])
        if periodicBoxVectors is not None:
            top.setPeriodicBoxVectors(periodicBoxVectors)
        elif unitCellDimensions is not None:
            top.setUnitCellDimensions(unitCellDimensions)

    # ------------------------------------------------------------- createSystem
    def createSystem(self, nonbondedMethod=NoCutoff, nonbondedCutoff=1.0,
                     constraints=None, rigidWater=True, removeCMMotion=True,
                     hydrogenMass=None, ewaldErrorTolerance=5e-4,
                     switchDistance=None, **kwargs):
        system = System()
        box = self.topology.getPeriodicBoxVectors()
        if box is not None:
            system.setDefaultPeriodicBoxVectors(
                *box.value_in_unit(u.nanometer))
        bond_force = mmforces.HarmonicBondForce()
        angle_force = mmforces.HarmonicAngleForce()
        ub_force = mmforces.HarmonicBondForce()
        ub_force.setName("UreyBradleyForce")
        torsion_force = mmforces.PeriodicTorsionForce()
        rb_force = mmforces.RBTorsionForce()
        imp_force = mmforces.CustomTorsionForce(
            "0.5*k*(theta-theta0)^2")
        imp_force.addPerTorsionParameter("k")
        imp_force.addPerTorsionParameter("theta0")
        nb = mmforces.NonbondedForce()
        method = _METHOD_MAP.get(nonbondedMethod, nonbondedMethod)
        nb.setNonbondedMethod(method)
        nb.setCutoffDistance(u.strip(nonbondedCutoff, u.nanometer))
        nb.setEwaldErrorTolerance(ewaldErrorTolerance)
        if switchDistance is not None:
            nb.setUseSwitchingFunction(True)
            nb.setSwitchingDistance(u.strip(switchDistance, u.nanometer))
        fudge_qq = self._defaults["fudgeQQ"]
        fudge_lj = self._defaults["fudgeLJ"]
        all_bonds = []
        offset = 0
        atoms_flat = []

        for (mol_name, count) in self._mol_order:
            mt = self._moltypes[mol_name]
            n_mol = len(mt.atoms)
            for rep in range(count):
                types = [a[0] for a in mt.atoms]
                charges = [a[4] for a in mt.atoms]
                for (type_name, resnr, resname, atomname, charge, mass) \
                        in mt.atoms:
                    system.addParticle(mass)
                    tinfo = self._atomtypes.get(type_name)
                    if tinfo is None:
                        raise OpenMMException("unknown atom type " + type_name)
                    nb.addParticle(charge, tinfo[2] if tinfo[2] > 0 else 1.0,
                                   tinfo[3])
                    atoms_flat.append(type_name)
                mol_bonds = []
                for (i, j, funct, params) in mt.bonds:
                    if len(params) < 2:
                        bt = self._bondtypes.get(
                            tuple(sorted([types[i], types[j]])))
                        if bt is None:
                            raise OpenMMException(
                                "missing bond type %s-%s" % (types[i], types[j]))
                        params = bt
                    b0, kb = params[0], params[1]
                    mol_bonds.append((i + offset, j + offset))
                    constrain = (constraints in (AllBonds, HAngles)
                                 or (constraints is HBonds
                                     and (mt.atoms[i][5] < 2 or mt.atoms[j][5] < 2))
                                 or (rigidWater and mt.atoms[i][2] in
                                     ("SOL", "HOH", "WAT")))
                    if funct == 1:
                        if constrain:
                            system.addConstraint(i + offset, j + offset, b0)
                        else:
                            bond_force.addBond(i + offset, j + offset, b0, kb)
                for (ow, d_oh, d_hh) in mt.settles:
                    system.addConstraint(ow + offset, ow + 1 + offset, d_oh)
                    system.addConstraint(ow + offset, ow + 2 + offset, d_oh)
                    system.addConstraint(ow + 1 + offset, ow + 2 + offset, d_hh)
                    mol_bonds.append((ow + offset, ow + 1 + offset))
                    mol_bonds.append((ow + offset, ow + 2 + offset))
                for (i, j, funct, dist) in mt.constraints:
                    system.addConstraint(i + offset, j + offset, dist)
                    if funct == 1:
                        mol_bonds.append((i + offset, j + offset))
                for (i, j, k, funct, params) in mt.angles:
                    if len(params) < 2:
                        t = [types[i], types[j], types[k]]
                        if t[0] > t[2]:
                            t = t[::-1]
                        at = self._angletypes.get(tuple(t))
                        if at is None:
                            raise OpenMMException("missing angle type")
                        funct2, params = at[0], at[1:]
                    theta0, k_ang = params[0], params[1]
                    angle_force.addAngle(i + offset, j + offset, k + offset,
                                         math.radians(theta0), k_ang)
                    if funct == 5 and len(params) >= 4 and params[3] != 0:
                        ub_force.addBond(i + offset, k + offset, params[2],
                                         params[3])
                for (i, j, k, l, funct, params) in mt.dihedrals:
                    t = (types[i], types[j], types[k], types[l])
                    if len(params) < 2:
                        params_list = self._lookup_dihedral(t, funct)
                    else:
                        params_list = [params]
                    if params_list is None:
                        continue
                    for params in params_list:
                        if funct in (1, 4, 9):
                            phase, kd, per = params[0], params[1], int(params[2])
                            if kd != 0:
                                torsion_force.addTorsion(
                                    i + offset, j + offset, k + offset,
                                    l + offset, per, math.radians(phase), kd)
                        elif funct == 2:
                            xi0, kx = params[0], params[1]
                            imp_force.addTorsion(i + offset, j + offset,
                                                 k + offset, l + offset,
                                                 [kx, math.radians(xi0)])
                        elif funct == 3:
                            rb_force.addTorsion(i + offset, j + offset,
                                                k + offset, l + offset,
                                                *params[:6])
                all_bonds.extend(mol_bonds)
                # 1-4 pairs
                for (i, j, funct, params) in mt.pairs:
                    t1 = self._atomtypes[types[i]]
                    t2 = self._atomtypes[types[j]]
                    if len(params) >= 2:
                        sig14, eps14 = params[0], params[1]
                    else:
                        pt = self._pairtypes.get(
                            tuple(sorted([types[i], types[j]])))
                        if pt is not None:
                            sig14, eps14 = pt
                        else:
                            sig14 = 0.5 * (t1[2] + t2[2])
                            eps14 = fudge_lj * math.sqrt(t1[3] * t2[3])
                    nb.addException(i + offset, j + offset,
                                    fudge_qq * charges[i] * charges[j],
                                    sig14 if sig14 > 0 else 1.0, eps14, True)
                offset += n_mol

        # exclusions from nrexcl over the bond graph (+ explicit)
        bonded = {}
        for (i, j) in all_bonds:
            bonded.setdefault(i, set()).add(j)
            bonded.setdefault(j, set()).add(i)
        excl = set()
        offset = 0
        for (mol_name, count) in self._mol_order:
            mt = self._moltypes[mol_name]
            for rep in range(count):
                for start in range(len(mt.atoms)):
                    cur = {start + offset}
                    for _ in range(mt.nrexcl):
                        nxt = set()
                        for a in cur:
                            nxt |= bonded.get(a, set())
                        cur = cur | nxt
                        for b in nxt:
                            if b != start + offset:
                                excl.add((min(start + offset, b),
                                          max(start + offset, b)))
                for (i, js) in mt.exclusions:
                    for j in js:
                        excl.add((min(i, j) + offset, max(i, j) + offset))
                offset += len(mt.atoms)
        existing = {(min(e[0], e[1]), max(e[0], e[1]))
                    for e in nb._exceptions}
        for (a, b) in sorted(excl):
            if (a, b) not in existing:
                nb.addException(a, b, 0.0, 1.0, 0.0, True)

        for f in (bond_force, angle_force, ub_force, torsion_force, rb_force):
            if (getattr(f, "getNumBonds", lambda: 0)() or
                    getattr(f, "getNumAngles", lambda: 0)() or
                    getattr(f, "getNumTorsions", lambda: 0)()):
                system.addForce(f)
        if imp_force.getNumTorsions():
            system.addForce(imp_force)
        system.addForce(nb)
        if removeCMMotion:
            system.addForce(mmforces.CMMotionRemover())
        return system

    def _lookup_dihedral(self, t, funct):
        store = self._dihedraltypes
        for key in ((t, funct), (t[::-1], funct),
                    ((("X",) + t[1:3] + ("X",)), funct),
                    ((("X",) + (t[2], t[1]) + ("X",)), funct)):
            if key in store:
                return store[key]
        return None
