"""CHARMM PSF + parameter/topology file readers: the port's copy of
openmm_tpu/app/charmmfiles.py (counterparts of
wrappers/python/openmm/app/charmmpsffile.py (1852 LoC, createSystem at :793)
and charmmparameterset.py (705 LoC) at reduced but functional scope:
X-PLOR/CHARMM PSF parsing, RTF/PAR/str parameter files with wildcards,
createSystem building Harmonic bonds/angles + Urey-Bradley, periodic and
improper-harmonic dihedrals, CMAP, and the CHARMM LJ convention (Rmin/2,
-epsilon, separate 1-4 parameters)."""
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

KCAL = 4.184
A2NM = 0.1
# CHARMM LJ: Emin(kcal), Rmin/2 (A); sigma = 2*Rmin/2 * 2^(-1/6)
RMIN2_TO_SIGMA = 2.0 * A2NM / (2.0 ** (1.0 / 6.0))


class CharmmParameterSet(object):
    """Parses CHARMM parameter (.prm/.par), topology (.rtf/.top) and stream
    (.str) files."""

    def __init__(self, *files):
        self.atom_masses = {}       # type -> mass
        self.bond_types = {}        # (t1,t2) sorted -> (k kcal/A^2, r0 A)
        self.angle_types = {}       # (t1,t2,t3) -> (k, theta0 deg, kub, rub)
        self.dihedral_types = {}    # (t1..t4) -> [(k, n, phase deg)]
        self.improper_types = {}    # (t1..t4) -> (k, psi0 deg)
        self.cmap_types = {}        # 8-tuple -> (size, values)
        self.nb_types = {}          # type -> (eps kcal, rmin2 A, eps14, rmin2_14)
        self.atom_types_by_id = {}  # numeric CHARMM type id -> type name
        self.nbfix_types = {}       # (t1,t2) sorted -> (emin, rmin, e14, r14)
        for f in files:
            self.readFile(f)

    def readFile(self, filename):
        section = None
        continuation = ""
        pending_cmap = None
        with open(filename) as fh:
            for raw in fh:
                line = raw.split("!")[0].rstrip()
                if continuation:
                    line = continuation + " " + line.strip()
                    continuation = ""
                if line.endswith("-"):
                    continuation = line[:-1]
                    continue
                stripped = line.strip()
                if not stripped or stripped.startswith("*"):
                    continue
                fields = stripped.split()
                upper = fields[0].upper()
                if upper in ("BONDS", "ANGLES", "DIHEDRALS", "IMPROPER",
                             "IMPROPERS", "CMAP", "NONBONDED", "NBFIX",
                             "HBOND", "END", "RETURN"):
                    section = upper
                    continue
                if upper == "MASS":
                    try:
                        self.atom_masses[fields[2].upper()] = float(fields[3])
                        self.atom_types_by_id[int(fields[1])] = \
                            fields[2].upper()
                    except (IndexError, ValueError):
                        pass
                    continue
                if upper in ("ATOM", "ATOMS") and section != "NONBONDED":
                    section = "ATOMS"
                    continue
                if upper in ("RESI", "PRES", "GROUP", "BOND", "DOUBLE",
                             "ANGLE", "DIHE", "IMPR", "DONOR", "ACCEPTOR",
                             "IC", "PATCH", "AUTO", "AUTOGENERATE", "DEFA",
                             "DECL", "DELETE"):
                    # topology-file records (templates handled by PSF input)
                    continue
                if section == "BONDS" and len(fields) >= 4:
                    key = tuple(sorted([fields[0].upper(), fields[1].upper()]))
                    self.bond_types[key] = (float(fields[2]), float(fields[3]))
                elif section == "ANGLES" and len(fields) >= 5:
                    t = [f.upper() for f in fields[:3]]
                    if t[0] > t[2]:
                        t = [t[2], t[1], t[0]]
                    kub, rub = 0.0, 0.0
                    if len(fields) >= 7:
                        try:
                            kub, rub = float(fields[5]), float(fields[6])
                        except ValueError:
                            pass
                    self.angle_types[tuple(t)] = (float(fields[3]),
                                                  float(fields[4]), kub, rub)
                elif section == "DIHEDRALS" and len(fields) >= 7:
                    t = tuple(f.upper() for f in fields[:4])
                    if t[::-1] < t:
                        t = t[::-1]
                    entry = (float(fields[4]), int(float(fields[5])),
                             float(fields[6]))
                    self.dihedral_types.setdefault(t, [])
                    # replace duplicate periodicity, else append
                    terms = [x for x in self.dihedral_types[t]
                             if x[1] != entry[1]]
                    terms.append(entry)
                    self.dihedral_types[t] = terms
                elif section in ("IMPROPER", "IMPROPERS") and len(fields) >= 7:
                    t = tuple(f.upper() for f in fields[:4])
                    self.improper_types[t] = (float(fields[4]),
                                              float(fields[6]))
                elif section == "CMAP":
                    if re.match(r"^[A-Za-z]", fields[0]) and len(fields) >= 9:
                        if pending_cmap is not None:
                            self._finish_cmap(*pending_cmap)
                        pending_cmap = (tuple(f.upper() for f in fields[:8]),
                                        int(fields[8]), [])
                    elif pending_cmap is not None:
                        pending_cmap[2].extend(float(x) for x in fields)
                elif section == "NONBONDED" and len(fields) >= 4:
                    if upper in ("CUTNB", "CTOFNB", "CTONNB", "EPS", "E14FAC",
                                 "WMIN"):
                        continue
                    try:
                        eps = float(fields[2])
                        rmin2 = float(fields[3])
                    except ValueError:
                        continue
                    eps14, rmin2_14 = eps, rmin2
                    if len(fields) >= 7:
                        try:
                            eps14 = float(fields[5])
                            rmin2_14 = float(fields[6])
                        except ValueError:
                            pass
                    self.nb_types[fields[0].upper()] = (eps, rmin2, eps14,
                                                        rmin2_14)
                elif section == "NBFIX" and len(fields) >= 4:
                    # type1 type2 emin rmin [emin14 rmin14]; emin negative
                    try:
                        emin = float(fields[2])
                        rmin = float(fields[3])
                    except ValueError:
                        continue
                    emin14, rmin14 = emin, rmin
                    if len(fields) >= 6:
                        try:
                            emin14 = float(fields[4])
                            rmin14 = float(fields[5])
                        except ValueError:
                            pass
                    key = tuple(sorted([fields[0].upper(),
                                        fields[1].upper()]))
                    self.nbfix_types[key] = (emin, rmin, emin14, rmin14)
        if pending_cmap is not None:
            self._finish_cmap(*pending_cmap)

    def _finish_cmap(self, types, size, values):
        if len(values) == size * size:
            self.cmap_types[types] = (size, values)

    # -- lookups with CHARMM X wildcards ---------------------------------------
    def bond(self, t1, t2):
        return self.bond_types.get(tuple(sorted([t1, t2])))

    def angle(self, t1, t2, t3):
        key = (t1, t2, t3) if t1 <= t3 else (t3, t2, t1)
        return self.angle_types.get(key)

    def dihedral(self, t1, t2, t3, t4):
        for key in ((t1, t2, t3, t4), (t4, t3, t2, t1)):
            if key in self.dihedral_types:
                return self.dihedral_types[key]
        for key in (("X", t2, t3, "X"), ("X", t3, t2, "X")):
            if key in self.dihedral_types:
                return self.dihedral_types[key]
        return None

    def improper(self, t1, t2, t3, t4):
        for key in ((t1, t2, t3, t4), (t4, t3, t2, t1)):
            if key in self.improper_types:
                return self.improper_types[key]
        for key in ((t1, "X", "X", t4), (t4, "X", "X", t1)):
            if key in self.improper_types:
                return self.improper_types[key]
        return None


class CharmmPsfFile(object):
    """X-PLOR / CHARMM PSF structure file."""

    def __init__(self, file):
        with open(file) as fh:
            content = fh.read().split("\n")
        if "PSF" not in content[0]:
            raise OpenMMException("not a PSF file")
        idx = 0

        def next_section(tag):
            nonlocal idx
            while idx < len(content):
                if tag in content[idx]:
                    fields = content[idx].split()
                    count = int(fields[0])
                    idx += 1
                    return count
                idx += 1
            return 0

        n_atoms = next_section("!NATOM")
        self.atom_list = []     # (segid, resid, resname, name, type, charge, mass)
        for i in range(n_atoms):
            fields = content[idx].split()
            idx += 1
            segid, resid, resname, name, atype = fields[1:6]
            charge = float(fields[6])
            mass = float(fields[7])
            self.atom_list.append((segid, resid, resname, name,
                                   atype.upper(), charge, mass))

        def read_indices(tag, per_entry):
            nonlocal idx
            count = next_section(tag)
            vals = []
            while len(vals) < count * per_entry and idx < len(content):
                vals.extend(int(x) for x in content[idx].split())
                idx += 1
            return [tuple(v - 1 for v in vals[i:i + per_entry])
                    for i in range(0, count * per_entry, per_entry)]

        self.bonds = read_indices("!NBOND", 2)
        self.angles = read_indices("!NTHETA", 3)
        self.dihedrals = read_indices("!NPHI", 4)
        self.impropers = read_indices("!NIMPHI", 4)
        _donors = read_indices("!NDON", 2)
        _acceptors = read_indices("!NACC", 2)
        _nnb = next_section("!NNB")
        # skip to cross terms if present
        self.cmaps = []
        for j, line in enumerate(content):
            if "!NCRTERM" in line:
                count = int(line.split()[0])
                vals = []
                jj = j + 1
                while len(vals) < count * 8 and jj < len(content):
                    vals.extend(int(x) for x in content[jj].split())
                    jj += 1
                self.cmaps = [tuple(v - 1 for v in vals[i:i + 8])
                              for i in range(0, count * 8, 8)]
                break

        # topology
        top = Topology()
        self.topology = top
        chains = {}
        residues = {}
        atoms = []
        for (segid, resid, resname, name, atype, charge, mass) in self.atom_list:
            if segid not in chains:
                chains[segid] = top.addChain(segid)
            rkey = (segid, resid)
            if rkey not in residues:
                residues[rkey] = top.addResidue(resname, chains[segid], resid)
            el = Element.getByMass(mass) if mass > 0.2 else None
            atoms.append(top.addAtom(name, el, residues[rkey]))
        for (i, j) in self.bonds:
            top.addBond(atoms[i], atoms[j])

    def setBox(self, a, b, c, alpha=math.pi / 2, beta=math.pi / 2,
               gamma=math.pi / 2):
        from . import unitcell
        self.topology.setPeriodicBoxVectors(
            unitcell.computePeriodicBoxVectors(
                u.strip(a, u.nanometer), u.strip(b, u.nanometer),
                u.strip(c, u.nanometer), u.strip(alpha, u.radian),
                u.strip(beta, u.radian), u.strip(gamma, u.radian)))

    def createSystem(self, params, nonbondedMethod=NoCutoff,
                     nonbondedCutoff=1.0, constraints=None, rigidWater=True,
                     implicitSolvent=None, implicitSolventSaltConc=0.0,
                     implicitSolventKappa=None, temperature=298.15,
                     soluteDielectric=1.0, solventDielectric=78.5,
                     gbsaModel=None, removeCMMotion=True, hydrogenMass=None,
                     ewaldErrorTolerance=5e-4, switchDistance=None, **kwargs):
        system = System()
        n = len(self.atom_list)
        types = [a[4] for a in self.atom_list]
        # CHARMM-format PSFs carry numeric type ids; map via RTF MASS records
        types = [params.atom_types_by_id.get(int(t), t) if t.isdigit() else t
                 for t in types]
        charges = [a[5] for a in self.atom_list]
        for a in self.atom_list:
            system.addParticle(a[6])
        box = self.topology.getPeriodicBoxVectors()
        if box is not None:
            system.setDefaultPeriodicBoxVectors(
                *box.value_in_unit(u.nanometer))
        atoms = list(self.topology.atoms())

        def is_h(i):
            el = atoms[i].element
            return el is not None and el.atomic_number == 1

        is_water = [a[2] in ("TIP3", "HOH", "WAT", "SPC", "TIP4") for a in
                    self.atom_list]

        # ---- bonds ------------------------------------------------------------
        bond_force = mmforces.HarmonicBondForce()
        bond_dist = {}
        for (i, j) in self.bonds:
            bp = params.bond(types[i], types[j])
            if bp is None:
                raise OpenMMException("missing bond type %s-%s"
                                      % (types[i], types[j]))
            k_char, r0 = bp
            r0_nm = r0 * A2NM
            k_mm = 2.0 * k_char * KCAL / (A2NM * A2NM)
            bond_dist[(min(i, j), max(i, j))] = r0_nm
            constrain = (constraints in (AllBonds, HAngles)
                         or (constraints is HBonds and (is_h(i) or is_h(j)))
                         or (rigidWater and is_water[i] and is_water[j]))
            if constrain:
                system.addConstraint(i, j, r0_nm)
            else:
                bond_force.addBond(i, j, r0_nm, k_mm)
        if bond_force.getNumBonds():
            system.addForce(bond_force)

        # ---- angles + Urey-Bradley --------------------------------------------
        angle_force = mmforces.HarmonicAngleForce()
        ub_force = mmforces.HarmonicBondForce()
        ub_force.setName("UreyBradleyForce")
        for (i, j, k_atom) in self.angles:
            ap = params.angle(types[i], types[j], types[k_atom])
            if ap is None:
                raise OpenMMException("missing angle type %s-%s-%s"
                                      % (types[i], types[j], types[k_atom]))
            k_char, theta0, kub, rub = ap
            water_angle = (rigidWater and is_water[i] and is_water[j]
                           and is_water[k_atom])
            if water_angle or (constraints is HAngles and is_h(i)
                               and is_h(k_atom)):
                d1 = bond_dist.get((min(i, j), max(i, j)))
                d2 = bond_dist.get((min(j, k_atom), max(j, k_atom)))
                if d1 and d2:
                    t0 = math.radians(theta0)
                    d13 = math.sqrt(d1 * d1 + d2 * d2
                                    - 2 * d1 * d2 * math.cos(t0))
                    system.addConstraint(i, k_atom, d13)
            else:
                angle_force.addAngle(i, j, k_atom, math.radians(theta0),
                                     2.0 * k_char * KCAL)
            if kub:
                ub_force.addBond(i, k_atom, rub * A2NM,
                                 2.0 * kub * KCAL / (A2NM * A2NM))
        if angle_force.getNumAngles():
            system.addForce(angle_force)
        if ub_force.getNumBonds():
            system.addForce(ub_force)

        # ---- dihedrals ----------------------------------------------------------
        torsion_force = mmforces.PeriodicTorsionForce()
        for (i, j, k_atom, l_atom) in self.dihedrals:
            terms = params.dihedral(types[i], types[j], types[k_atom],
                                    types[l_atom])
            if terms is None:
                continue
            for (k_char, per, phase) in terms:
                if k_char != 0:
                    torsion_force.addTorsion(i, j, k_atom, l_atom, per,
                                             math.radians(phase),
                                             k_char * KCAL)
        if torsion_force.getNumTorsions():
            system.addForce(torsion_force)

        # ---- impropers (harmonic) --------------------------------------------------
        if self.impropers:
            imp = mmforces.CustomTorsionForce("k*(theta-theta0)^2")
            imp.addPerTorsionParameter("k")
            imp.addPerTorsionParameter("theta0")
            for (i, j, k_atom, l_atom) in self.impropers:
                ip = params.improper(types[i], types[j], types[k_atom],
                                     types[l_atom])
                if ip is None:
                    continue
                k_char, psi0 = ip
                imp.addTorsion(i, j, k_atom, l_atom,
                               [k_char * KCAL, math.radians(psi0)])
            if imp.getNumTorsions():
                system.addForce(imp)

        # ---- CMAP ---------------------------------------------------------------------
        if self.cmaps and params.cmap_types:
            cmap_force = mmforces.CMAPTorsionForce()
            map_index = {}
            for (key, (size, values)) in params.cmap_types.items():
                # CHARMM grids: rows over phi, columns over psi, both starting
                # at -180 deg. The MM layout is energy[i+size*j] with angle_i
                # starting at 0: roll both axes by half a period and flatten
                # with phi fastest. Validated against CHARMM's own energy for
                # ala_ala_ala (39.13169 kcal/mol, TestCharmmFiles.py:419).
                g = np.asarray(values).reshape(size, size) * KCAL
                g = np.roll(g, -(size // 2), axis=0)
                g = np.roll(g, -(size // 2), axis=1)
                map_index[key] = cmap_force.addMap(
                    size, list(g.flatten(order="F")))
            for term in self.cmaps:
                t = tuple(types[x] for x in term)
                if t in params.cmap_types:
                    cmap_force.addTorsion(map_index[t], *term)
            if cmap_force.getNumTorsions():
                system.addForce(cmap_force)

        # ---- nonbonded -------------------------------------------------------------------
        nb = mmforces.NonbondedForce()
        method = _METHOD_MAP.get(nonbondedMethod, nonbondedMethod)
        nb.setNonbondedMethod(method)
        nb.setCutoffDistance(u.strip(nonbondedCutoff, u.nanometer))
        nb.setEwaldErrorTolerance(ewaldErrorTolerance)
        if switchDistance is not None:
            nb.setUseSwitchingFunction(True)
            nb.setSwitchingDistance(u.strip(switchDistance, u.nanometer))
        has_14 = any(t in params.nb_types
                     and (params.nb_types[t][2] != params.nb_types[t][0]
                          or params.nb_types[t][3] != params.nb_types[t][1])
                     for t in set(types))
        for i in range(n):
            t = types[i]
            if t not in params.nb_types:
                raise OpenMMException("missing nonbonded type " + t)
            eps, rmin2 = params.nb_types[t][:2]
            nb.addParticle(charges[i], rmin2 * RMIN2_TO_SIGMA,
                           abs(eps) * KCAL)
        nb.createExceptionsFromBonds(self.bonds, 1.0, 1.0)
        # CHARMM 1-4: full electrostatics, special LJ parameters
        if has_14:
            for idx_exc in range(nb.getNumExceptions()):
                p1, p2, cp, sig, eps = nb.getExceptionParameters(idx_exc)
                if abs(eps._value) > 1e-10 or abs(cp._value) > 1e-10:
                    e1, r1 = params.nb_types[types[p1]][2:4]
                    e2, r2 = params.nb_types[types[p2]][2:4]
                    sig14 = (r1 + r2) * A2NM / (2.0 ** (1.0 / 6.0))
                    eps14 = math.sqrt(abs(e1) * abs(e2)) * KCAL
                    nb.setExceptionParameters(idx_exc, p1, p2,
                                              charges[p1] * charges[p2],
                                              sig14, eps14)
        system.addForce(nb)

        # ---- NBFIX: per-type-pair LJ overrides (charmmpsffile.py:1224-1306:
        # zero the built-in LJ and evaluate LJ via a CustomNonbondedForce
        # with Discrete2DFunction A/B coefficient tables) -------------------
        present = sorted(set(types))
        has_nbfix = any(tuple(sorted((t1, t2))) in params.nbfix_types
                        for i, t1 in enumerate(present)
                        for t2 in present[i:])
        if has_nbfix:
            type_index = {t: k for k, t in enumerate(present)}
            m = len(present)
            acoef = np.zeros((m, m))
            bcoef = np.zeros((m, m))
            for t1, k1 in type_index.items():
                for t2, k2 in type_index.items():
                    fix = params.nbfix_types.get(tuple(sorted((t1, t2))))
                    if fix is not None:
                        emin, rmin = abs(fix[0]) * KCAL, fix[1] * A2NM
                    else:
                        e1, r1 = params.nb_types[t1][:2]
                        e2, r2 = params.nb_types[t2][:2]
                        emin = math.sqrt(abs(e1) * abs(e2)) * KCAL
                        rmin = (r1 + r2) * A2NM
                    acoef[k1, k2] = math.sqrt(emin) * rmin ** 6
                    bcoef[k1, k2] = 2.0 * emin * rmin ** 6
            from ..tabulated import Discrete2DFunction
            cforce = mmforces.CustomNonbondedForce(
                "(a/r6)^2-b/r6; r6=r^6;"
                "a=acoef(type1, type2); b=bcoef(type1, type2)")
            cforce.addTabulatedFunction(
                "acoef", Discrete2DFunction(m, m, acoef.T.ravel().tolist()))
            cforce.addTabulatedFunction(
                "bcoef", Discrete2DFunction(m, m, bcoef.T.ravel().tolist()))
            cforce.addPerParticleParameter("type")
            if method in (mmforces.NonbondedForce.PME,
                          mmforces.NonbondedForce.LJPME,
                          mmforces.NonbondedForce.Ewald,
                          mmforces.NonbondedForce.CutoffPeriodic):
                cforce.setNonbondedMethod(
                    mmforces.CustomNonbondedForce.CutoffPeriodic)
                cforce.setCutoffDistance(u.strip(nonbondedCutoff,
                                                 u.nanometer))
            elif method == mmforces.NonbondedForce.CutoffNonPeriodic:
                cforce.setNonbondedMethod(
                    mmforces.CustomNonbondedForce.CutoffNonPeriodic)
                cforce.setCutoffDistance(u.strip(nonbondedCutoff,
                                                 u.nanometer))
            if switchDistance is not None:
                cforce.setUseSwitchingFunction(True)
                cforce.setSwitchingDistance(u.strip(switchDistance,
                                                    u.nanometer))
            for i in range(n):
                cforce.addParticle([type_index[types[i]]])
            for idx_exc in range(nb.getNumExceptions()):
                p1, p2 = nb.getExceptionParameters(idx_exc)[:2]
                cforce.addExclusion(p1, p2)
            # the built-in force keeps charge (and 1-4 LJ exceptions); its
            # per-particle LJ is zeroed out
            for i in range(n):
                nb.setParticleParameters(i, charges[i], 1.0, 0.0)
            system.addForce(cforce)

        if hydrogenMass is not None:
            h_mass = float(u.strip(hydrogenMass, u.dalton))
            for (i, j) in self.bonds:
                hi, hj = is_h(i), is_h(j)
                if hi == hj:
                    continue
                h, heavy = (i, j) if hi else (j, i)
                transfer = h_mass - system.getParticleMass(h)._value
                if system.getParticleMass(heavy)._value > h_mass and transfer:
                    system.setParticleMass(
                        heavy, system.getParticleMass(heavy)._value - transfer)
                    system.setParticleMass(h, h_mass)
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
            if nonbondedMethod != NoCutoff:
                cutoff_gb = float(u.strip(nonbondedCutoff, u.nanometer))
            add_implicit_solvent(
                system, self.topology, model, list(charges),
                solventDielectric=solventDielectric,
                soluteDielectric=soluteDielectric,
                SA=gbsaModel, cutoff=cutoff_gb, kappa=kappa)
            for f in system.getForces():
                if isinstance(f, mmforces.NonbondedForce):
                    f.setReactionFieldDielectric(1.0)
        if removeCMMotion:
            system.addForce(mmforces.CMMotionRemover())
        return system


class CharmmCrdFile(object):
    """CHARMM coordinate (.crd card) file reader (counterpart of
    app/internal/charmm/_charmmfile.py usage): atomno resno resname atomname
    x y z segid resid weight, coordinates in Angstrom."""

    def __init__(self, file):
        positions = []
        self.atomNames = []
        self.resNames = []
        with open(file) as fh:
            lines = [ln for ln in fh if not ln.startswith("*")]
        n = int(lines[0].split()[0])
        extended = "EXT" in lines[0].upper() or n > 99999
        for line in lines[1:1 + n]:
            fields = line.split()
            self.resNames.append(fields[2])
            self.atomNames.append(fields[3])
            x, y, z = (float(fields[4]), float(fields[5]), float(fields[6]))
            positions.append(Vec3(x * A2NM, y * A2NM, z * A2NM))
        self.positions = u.Quantity(positions, u.nanometer)
        self.natom = n

    def getPositions(self, asNumpy=False):
        if asNumpy:
            return u.Quantity(np.asarray(
                [[v.x, v.y, v.z] for v in self.positions._value]), u.nanometer)
        return self.positions
