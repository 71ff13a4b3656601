"""XML generator sections for ForceField beyond the core bonded and
nonbonded set.

The port's copy of openmm_tpu/app/ffgenerators.py (after the generator
classes of OpenMM's wrappers/python/openmm/app/forcefield.py, parsers[...]
at forcefield.py:2013-5889). Each generator parses one section into
parameter tables and later adds Forces to the System being built.

Registered here: CMAPTorsionForce (forcefield.py:2399), LennardJonesForce
with NBFIX (forcefield.py:2672), CustomBond/Angle/Torsion/Nonbonded
(forcefield.py:2773-2964), CustomGB/Hbond/ManyParticle
(forcefield.py:3024-3294), DrudeForce (forcefield.py:5798); the AMOEBA
family (Urey-Bradley, which the CHARMM waters use too, among them) in
ffgenerators_amoeba.py.
"""
from __future__ import annotations

import math
from collections import defaultdict

from .. import forces as mmforces
from .. import unit as u
from .. import tabulated
from ..exceptions import OpenMMException

PARSERS = {}


def parse_section(element, ff):
    """Hand a force-field section to its generator's parser (the AMOEBA
    sections' in ffgenerators_amoeba.py). A tag no generator knows is
    left alone, as in the JAX package."""
    tag = element.tag
    if tag in PARSERS:
        PARSERS[tag](element, ff)


def _f(x):
    return float(x)


def parse_functions(element):
    """<Function> children -> list of (name, type, values, params)
    (forcefield.py:73 _parseFunctions)."""
    functions = []
    for fn in element.findall("Function"):
        values = [float(x) for x in fn.text.split()]
        ftype = fn.attrib.get("type", "Continuous1D")
        params = {}
        for key, val in fn.attrib.items():
            if key.endswith("size"):
                params[key] = int(val)
            elif key.endswith("min") or key.endswith("max"):
                params[key] = float(val)
        if ftype.startswith("Continuous"):
            params["periodic"] = fn.attrib.get(
                "periodic", "false").lower() in ("true", "yes", "1")
        functions.append((fn.attrib["name"], ftype, values, params))
    return functions


def create_functions(force, functions):
    """Attach parsed tabulated functions (forcefield.py:97)."""
    for (name, ftype, values, params) in functions:
        if ftype == "Continuous1D":
            force.addTabulatedFunction(name, tabulated.Continuous1DFunction(
                values, params["min"], params["max"], params["periodic"]))
        elif ftype == "Continuous2D":
            force.addTabulatedFunction(name, tabulated.Continuous2DFunction(
                params["xsize"], params["ysize"], values,
                params["xmin"], params["xmax"], params["ymin"],
                params["ymax"], params["periodic"]))
        elif ftype == "Continuous3D":
            force.addTabulatedFunction(name, tabulated.Continuous3DFunction(
                params["xsize"], params["ysize"], params["zsize"], values,
                params["xmin"], params["xmax"], params["ymin"],
                params["ymax"], params["zmin"], params["zmax"],
                params["periodic"]))
        elif ftype == "Discrete1D":
            force.addTabulatedFunction(
                name, tabulated.Discrete1DFunction(values))
        elif ftype == "Discrete2D":
            force.addTabulatedFunction(name, tabulated.Discrete2DFunction(
                params["xsize"], params["ysize"], values))
        elif ftype == "Discrete3D":
            force.addTabulatedFunction(name, tabulated.Discrete3DFunction(
                params["xsize"], params["ysize"], params["zsize"], values))
        else:
            raise OpenMMException("unknown tabulated function type " + ftype)


def bonds_with_children(bond_idx, exclude_with) -> list:
    """The bonds that exclusions are built from, with each child particle
    (a Drude particle: exclude_with maps a parent atom to its children)
    given its parent's bonds and a bond to its parent, so that it shares
    the parent's 1-2, 1-3 and 1-4 pairs and is excluded from the parent
    (OpenMM forcefield.py _findBondsForExclusions; the JAX package never
    reads the children). Without children the bonds are returned as they
    are."""
    bonds = [(int(a), int(b)) for a, b in bond_idx]
    if not any(exclude_with.values()):
        return bonds
    k = 0
    while k < len(bonds):
        atom1, atom2 = bonds[k]
        for child1 in exclude_with.get(atom1, ()):
            bonds.append((child1, atom2))
            for child2 in exclude_with.get(atom2, ()):
                bonds.append((child1, child2))
        for child2 in exclude_with.get(atom2, ()):
            bonds.append((atom1, child2))
        k += 1
    for parent, children in sorted(exclude_with.items()):
        bonds += [(child, parent) for child in children]
    return list(dict.fromkeys(bonds))


def find_bonds_for_exclusions(data, sys):
    """Bond index pairs for exclusion building, with each virtual site
    bonded to its exclusion parent (forcefield.py:1428) and each child
    particle given its parent's bonds (bonds_with_children)."""
    bond_idx = [(b.atom1, b.atom2) for b in data.bonds]
    for i in range(sys.getNumParticles()):
        if sys.isVirtualSite(i):
            vs = sys.getVirtualSite(i)
            bond_idx.append((i, vs.getParticle(0)))
    return bonds_with_children(bond_idx, data.excludeAtomWith)


class AtomTypeParameters(object):
    """Per-atom-type parameter table for a force section's <Atom> entries,
    honoring type/class keys and UseAttributeFromResidue
    (forcefield.py _AtomTypeParameters)."""

    def __init__(self, ff, forceName, atomTag, paramNames):
        self.ff = ff
        self.forceName = forceName
        self.atomTag = atomTag
        self.paramNames = list(paramNames)
        self.paramsForType = {}
        self.extraParamsForType = {}
        self.residueAttrs = set()

    def registerAtom(self, attrib, expectedParams=None):
        types = self.ff._findAtomTypes(attrib, 1)
        if None in types:
            return
        names = expectedParams or self.paramNames
        values = {}
        extra = {}
        for key, val in attrib.items():
            if key in ("type", "class", "type1", "class1"):
                continue
            if key in names:
                values[key] = float(val)
            else:
                extra[key] = val
        for t in types[0]:
            self.paramsForType[t] = values
            self.extraParamsForType[t] = extra

    def parseDefinitions(self, element):
        for use in element.findall("UseAttributeFromResidue"):
            name = use.attrib["name"]
            if name not in self.paramNames:
                raise OpenMMException(
                    "%s: <UseAttributeFromResidue> specified an invalid "
                    "attribute: %s" % (self.forceName, name))
            self.residueAttrs.add(name)
        for atom in element.findall(self.atomTag):
            self.registerAtom(atom.attrib)

    def getAtomParameters(self, atom, data):
        t = data.atomType[atom]
        values = self.paramsForType.get(t)
        if values is None:
            raise OpenMMException(
                "%s: No parameters defined for atom type %s"
                % (self.forceName, t))
        out = []
        res_params = data.atomParameters.get(atom, {})
        for name in self.paramNames:
            if name in self.residueAttrs:
                out.append(float(res_params.get(name, 0.0)))
            else:
                out.append(values.get(name, 0.0))
        return out

    def getExtraParameters(self, atom, data):
        return self.extraParamsForType.get(data.atomType[atom], {})


# ---------------------------------------------------------------- CMAP
class CMAPTorsionGenerator(object):
    """<CMAPTorsionForce> -> CMAPTorsionForce (forcefield.py:2320)."""

    def __init__(self, ff):
        self.ff = ff
        self.torsions = []     # (type-sets x5, map index)
        self.maps = []

    @staticmethod
    def parseElement(element, ff):
        existing = [g for g in ff._forces
                    if isinstance(g, CMAPTorsionGenerator)]
        gen = existing[0] if existing else CMAPTorsionGenerator(ff)
        if not existing:
            ff.registerGenerator(gen)
        map_offset = len(gen.maps)
        for m in element.findall("Map"):
            values = [float(x) for x in m.text.split()]
            size = int(round(math.sqrt(len(values))))
            if size * size != len(values):
                raise OpenMMException("CMAP maps must be square")
            gen.maps.append(values)
        for t in element.findall("Torsion"):
            types = ff._findAtomTypes(t.attrib, 5)
            if None not in types:
                gen.torsions.append((types,
                                     map_offset + int(t.attrib["map"])))

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        existing = [f for f in sys.getForces()
                    if type(f) is mmforces.CMAPTorsionForce]
        force = existing[0] if existing else mmforces.CMAPTorsionForce()
        if not existing:
            sys.addForce(force)
        for m in self.maps:
            force.addMap(int(round(math.sqrt(len(m)))), m)

        # all unique 5-atom chains from the proper-torsion list
        # (forcefield.py:2357)
        unique = set()
        for tor in data.propers:
            for nb in data.bondedToAtom[tor[0]]:
                if nb != tor[1]:
                    unique.add((nb,) + tuple(tor))
            for nb in data.bondedToAtom[tor[3]]:
                if nb != tor[2]:
                    unique.add(tuple(tor) + (nb,))
        wildcard = self.ff._wildcard
        for chain in sorted(unique):
            ts = [data.atomType[data.atoms[i]] for i in chain]
            match = None
            for (slots, map_i) in self.torsions:
                fwd = all(t in s for t, s in zip(ts, slots))
                rev = all(t in s for t, s in zip(ts[::-1], slots))
                if fwd or rev:
                    has_wild = any(s is wildcard for s in slots)
                    if match is None or not has_wild:
                        match = map_i
                    if not has_wild:
                        break
            if match is not None:
                a1, a2, a3, a4, a5 = chain
                force.addTorsion(match, a1, a2, a3, a4, a2, a3, a4, a5)


PARSERS["CMAPTorsionForce"] = CMAPTorsionGenerator.parseElement


# ------------------------------------------------------- LennardJones/NBFIX
class LennardJonesGenerator(object):
    """<LennardJonesForce> with NBFixPair entries -> CustomNonbondedForce
    over a type-pair lookup table, plus a CustomBondForce for scaled 1-4
    (forcefield.py:2495)."""

    SCALETOL = 1e-5

    def __init__(self, ff, lj14scale, useDispersionCorrection):
        self.ff = ff
        self.lj14scale = lj14scale
        self.useDispersionCorrection = useDispersionCorrection
        self.nbfixTypes = {}
        self.ljTypes = AtomTypeParameters(ff, "LennardJonesForce", "Atom",
                                          ("sigma", "epsilon"))

    @staticmethod
    def parseElement(element, ff):
        existing = [g for g in ff._forces
                    if isinstance(g, LennardJonesGenerator)]
        udc = None
        if "useDispersionCorrection" in element.attrib:
            udc = element.attrib["useDispersionCorrection"].lower() in (
                "true", "1", "yes")
        if existing:
            gen = existing[0]
            if abs(gen.lj14scale
                   - float(element.attrib["lj14scale"])) > \
                    LennardJonesGenerator.SCALETOL:
                raise OpenMMException(
                    "multiple LennardJonesForce sections with different "
                    "lj14scale values")
        else:
            gen = LennardJonesGenerator(
                ff, float(element.attrib["lj14scale"]), udc)
            ff.registerGenerator(gen)
        for atom in element.findall("Atom"):
            gen.ljTypes.registerAtom(atom.attrib)
        for fix in element.findall("NBFixPair"):
            types = ff._findAtomTypes(fix.attrib, 2)
            if None not in types:
                sig = float(fix.attrib["sigma"])
                eps = float(fix.attrib["epsilon"])
                for t1 in types[0]:
                    for t2 in types[1]:
                        gen.nbfixTypes[(t1, t2)] = (sig, eps)
                        gen.nbfixTypes[(t2, t1)] = (sig, eps)

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        from . import forcefield as ffmod
        # merge types with identical parameters (NBFIX members stay
        # unmerged) -> square A/B coefficient tables (forcefield.py:2548)
        nbfix_members = set()
        for (t1, t2) in self.nbfixTypes:
            nbfix_members.add(t1)
            nbfix_members.add(t2)
        all_types = set(data.atomType[a] for a in data.atoms)
        merged, merged_params = [], []
        by_params, type_to_merged = {}, {}
        for t in sorted(all_types):
            tp = self.ljTypes.paramsForType.get(t)
            if tp is None:
                raise OpenMMException(
                    "LennardJonesForce: no parameters for type " + t)
            params = (tp.get("sigma", 1.0), tp.get("epsilon", 0.0))
            if t in nbfix_members:
                type_to_merged[t] = len(merged)
                merged.append(t)
                merged_params.append(params)
            elif params in by_params:
                type_to_merged[t] = by_params[params]
            else:
                type_to_merged[t] = by_params[params] = len(merged)
                merged.append(t)
                merged_params.append(params)
        ntypes = len(merged)
        acoef = [0.0] * (ntypes * ntypes)
        bcoef = [0.0] * (ntypes * ntypes)
        for m in range(ntypes):
            for nn in range(ntypes):
                pair = (merged[m], merged[nn])
                if pair in self.nbfixTypes:
                    sig, eps = self.nbfixTypes[pair]
                else:
                    sig = 0.5 * (merged_params[m][0] + merged_params[nn][0])
                    eps = math.sqrt(
                        merged_params[m][1] * merged_params[nn][1])
                s6 = sig ** 6
                acoef[m + ntypes * nn] = 4.0 * eps * s6 * s6
                bcoef[m + ntypes * nn] = 4.0 * eps * s6
        force = mmforces.CustomNonbondedForce(
            "acoef(type1, type2)/r^12 - bcoef(type1, type2)/r^6;")
        force.addTabulatedFunction(
            "acoef", tabulated.Discrete2DFunction(ntypes, ntypes, acoef))
        force.addTabulatedFunction(
            "bcoef", tabulated.Discrete2DFunction(ntypes, ntypes, bcoef))
        force.addPerParticleParameter("type")
        force.setName("LennardJones")
        if nonbondedMethod in (ffmod.CutoffPeriodic, ffmod.Ewald,
                               ffmod.PME, ffmod.LJPME):
            force.setNonbondedMethod(
                mmforces.CustomNonbondedForce.CutoffPeriodic)
        elif nonbondedMethod is ffmod.NoCutoff:
            force.setNonbondedMethod(mmforces.CustomNonbondedForce.NoCutoff)
        else:
            force.setNonbondedMethod(
                mmforces.CustomNonbondedForce.CutoffNonPeriodic)
        if args.get("switchDistance") is not None:
            force.setUseSwitchingFunction(True)
            force.setSwitchingDistance(args["switchDistance"])
        udc = args.get("useDispersionCorrection")
        if udc is None:
            udc = self.useDispersionCorrection
        force.setUseLongRangeCorrection(bool(udc)
                                        if udc is not None else True)
        for a in data.atoms:
            force.addParticle((type_to_merged[data.atomType[a]],))
        force.setCutoffDistance(nonbondedCutoff)
        sys.addForce(force)
        self.force = force
        self.type_to_merged = type_to_merged

    def postprocessSystem(self, sys, data, args):
        # 1-2/1-3 exclusions; 1-4 pairs become a CustomBondForce at
        # lj14scale using sigma14/epsilon14 overrides (forcefield.py:2637)
        bond_idx = find_bonds_for_exclusions(data, sys)
        self.force.createExclusionsFromBonds(bond_idx, 3)
        # recompute the 2-bond exclusion set to identify the 1-4 shell
        probe = mmforces.CustomNonbondedForce("r")
        probe.addPerParticleParameter("type")
        for a in data.atoms:
            probe.addParticle((0,))
        probe.createExclusionsFromBonds(bond_idx, 2)
        skip = set()
        for i in range(probe.getNumExclusions()):
            p1, p2 = probe.getExclusionParticles(i)
            skip.add((min(p1, p2), max(p1, p2)))
        if self.lj14scale == 0:
            return
        bonded = None
        for i in range(self.force.getNumExclusions()):
            p1, p2 = self.force.getExclusionParticles(i)
            if (min(p1, p2), max(p1, p2)) in skip:
                continue
            if bonded is None:
                bonded = mmforces.CustomBondForce(
                    "%.17g*epsilon*((sigma/r)^12-(sigma/r)^6)"
                    % (4.0 * self.lj14scale))
                bonded.addPerBondParameter("sigma")
                bonded.addPerBondParameter("epsilon")
                bonded.setName("LennardJones14")
                sys.addForce(bonded)
            a1, a2 = data.atoms[p1], data.atoms[p2]
            t1, t2 = data.atomType[a1], data.atomType[a2]
            if (t1, t2) in self.nbfixTypes:
                sig, eps = self.nbfixTypes[(t1, t2)]
            else:
                v1 = self.ljTypes.paramsForType[t1]
                v2 = self.ljTypes.paramsForType[t2]
                e1 = self.ljTypes.extraParamsForType.get(t1, {})
                e2 = self.ljTypes.extraParamsForType.get(t2, {})
                s1 = float(e1.get("sigma14", v1.get("sigma", 1.0)))
                s2 = float(e2.get("sigma14", v2.get("sigma", 1.0)))
                eps1 = float(e1.get("epsilon14", v1.get("epsilon", 0.0)))
                eps2 = float(e2.get("epsilon14", v2.get("epsilon", 0.0)))
                sig = 0.5 * (s1 + s2)
                eps = math.sqrt(eps1 * eps2)
            bonded.addBond(p1, p2, (sig, eps))


PARSERS["LennardJonesForce"] = LennardJonesGenerator.parseElement


# ---------------------------------------------------------------- Drude
class DrudeGenerator(object):
    """<DrudeForce> -> DrudeForce; Drude particle per matched atom, screened
    pairs for excluded Drude pairs, mass repartitioning to drudeMass
    (forcefield.py:5798). Each Drude particle is recorded as its parent's
    child (data.excludeAtomWith), which the NonbondedForce's exceptions
    read (bonds_with_children)."""

    def __init__(self, ff):
        self.ff = ff
        self.typeMap = {}

    @staticmethod
    def parseElement(element, ff):
        existing = [g for g in ff._forces if isinstance(g, DrudeGenerator)]
        gen = existing[0] if existing else DrudeGenerator(ff)
        if not existing:
            ff.registerGenerator(gen)
        for p in element.findall("Particle"):
            types = ff._findAtomTypes(p.attrib, 5)
            if None not in types[:2]:
                values = (types[1], types[2], types[3], types[4],
                          float(p.attrib["charge"]),
                          float(p.attrib["polarizability"]),
                          float(p.attrib.get("aniso12", 0.0)),
                          float(p.attrib.get("aniso34", 0.0)),
                          float(p.attrib["thole"]))
                for t in types[0]:
                    gen.typeMap[t] = values

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        force = mmforces.DrudeForce()
        if not any(isinstance(f, mmforces.NonbondedForce)
                   for f in sys.getForces()):
            raise OpenMMException(
                "<DrudeForce> requires a NonbondedForce")
        for a in data.atoms:
            t = data.atomType[a]
            if t not in self.typeMap:
                continue
            p = [-1, -1, -1, -1]
            values = self.typeMap[t]
            for a2 in a.residue.atoms():
                t2 = data.atomType[a2]
                if t2 in values[0]:
                    p[0] = a2.index
                elif values[1] is not None and t2 in values[1]:
                    p[1] = a2.index
                elif values[2] is not None and t2 in values[2]:
                    p[2] = a2.index
                elif values[3] is not None and t2 in values[3]:
                    p[3] = a2.index
            force.addParticle(a.index, p[0], p[1], p[2], p[3],
                              values[4], values[5], values[6], values[7])
            data.excludeAtomWith[p[0]].append(a.index)
        sys.addForce(force)

    def postprocessSystem(self, sys, data, args):
        drude = [f for f in sys.getForces()
                 if isinstance(f, mmforces.DrudeForce)][0]
        nonbonded = [f for f in sys.getForces()
                     if isinstance(f, mmforces.NonbondedForce)][0]
        particle_map = {}
        for i in range(drude.getNumParticles()):
            particle_map[drude.getParticleParameters(i)[0]] = i
        # the exceptions' term list, plain numbers: the getters' Quantities
        # cost ~1 s a thousand exceptions to strip
        for p1, p2, qq, sig, eps in nonbonded._exceptions:
            if qq == 0 and eps == 0 \
                    and p1 in particle_map and p2 in particle_map:
                t1 = data.atomType[data.atoms[p1]]
                t2 = data.atomType[data.atoms[p2]]
                drude.addScreenedPair(
                    particle_map[p1], particle_map[p2],
                    self.typeMap[t1][8] + self.typeMap[t2][8])
        drude_mass = u.strip(args.get("drudeMass", 0.4), u.dalton)
        for i in range(drude.getNumParticles()):
            particle, parent = drude.getParticleParameters(i)[:2]
            transfer = drude_mass - sys._masses[particle]
            sys.setParticleMass(particle, drude_mass)
            sys.setParticleMass(parent, sys._masses[parent] - transfer)


PARSERS["DrudeForce"] = DrudeGenerator.parseElement


# -------------------------------------------------------------- Custom*
class CustomBondGenerator(object):
    """<CustomBondForce> -> CustomBondForce (forcefield.py:2731)."""

    def __init__(self, ff):
        self.ff = ff
        self.types = []
        self.globalParams = {}
        self.perBondParams = []
        self.paramValues = []
        self.energy = ""

    @staticmethod
    def parseElement(element, ff):
        gen = CustomBondGenerator(ff)
        ff.registerGenerator(gen)
        gen.energy = element.attrib["energy"]
        for p in element.findall("GlobalParameter"):
            gen.globalParams[p.attrib["name"]] = float(
                p.attrib["defaultValue"])
        for p in element.findall("PerBondParameter"):
            gen.perBondParams.append(p.attrib["name"])
        for b in element.findall("Bond"):
            types = ff._findAtomTypes(b.attrib, 2)
            if None not in types:
                gen.types.append(types)
                gen.paramValues.append(
                    [float(b.attrib[p]) for p in gen.perBondParams])

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        force = mmforces.CustomBondForce(self.energy)
        sys.addForce(force)
        for p, v in self.globalParams.items():
            force.addGlobalParameter(p, v)
        for p in self.perBondParams:
            force.addPerBondParameter(p)
        for bond in data.bonds:
            t1 = data.atomType[data.atoms[bond.atom1]]
            t2 = data.atomType[data.atoms[bond.atom2]]
            for i, (s1, s2) in enumerate(self.types):
                if (t1 in s1 and t2 in s2) or (t1 in s2 and t2 in s1):
                    force.addBond(bond.atom1, bond.atom2,
                                  self.paramValues[i])
                    break


PARSERS["CustomBondForce"] = CustomBondGenerator.parseElement


class CustomAngleGenerator(object):
    """<CustomAngleForce> -> CustomAngleForce (forcefield.py:2777)."""

    def __init__(self, ff):
        self.ff = ff
        self.types = []
        self.globalParams = {}
        self.perAngleParams = []
        self.paramValues = []
        self.energy = ""

    @staticmethod
    def parseElement(element, ff):
        gen = CustomAngleGenerator(ff)
        ff.registerGenerator(gen)
        gen.energy = element.attrib["energy"]
        for p in element.findall("GlobalParameter"):
            gen.globalParams[p.attrib["name"]] = float(
                p.attrib["defaultValue"])
        for p in element.findall("PerAngleParameter"):
            gen.perAngleParams.append(p.attrib["name"])
        for a in element.findall("Angle"):
            types = ff._findAtomTypes(a.attrib, 3)
            if None not in types:
                gen.types.append(types)
                gen.paramValues.append(
                    [float(a.attrib[p]) for p in gen.perAngleParams])

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        force = mmforces.CustomAngleForce(self.energy)
        sys.addForce(force)
        for p, v in self.globalParams.items():
            force.addGlobalParameter(p, v)
        for p in self.perAngleParams:
            force.addPerAngleParameter(p)
        for (i, j, k) in data.angles:
            t1 = data.atomType[data.atoms[i]]
            t2 = data.atomType[data.atoms[j]]
            t3 = data.atomType[data.atoms[k]]
            for idx, (s1, s2, s3) in enumerate(self.types):
                if (t1 in s1 and t2 in s2 and t3 in s3) or \
                        (t1 in s3 and t2 in s2 and t3 in s1):
                    force.addAngle(i, j, k, self.paramValues[idx])
                    break


PARSERS["CustomAngleForce"] = CustomAngleGenerator.parseElement


class CustomTorsionGenerator(object):
    """<CustomTorsionForce> -> CustomTorsionForce (forcefield.py:2838;
    Proper and Improper entries, wildcard-aware ordering like
    PeriodicTorsion)."""

    def __init__(self, ff):
        self.ff = ff
        self.proper = []
        self.improper = []
        self.globalParams = {}
        self.perTorsionParams = []
        self.energy = ""

    @staticmethod
    def parseElement(element, ff):
        gen = CustomTorsionGenerator(ff)
        ff.registerGenerator(gen)
        gen.energy = element.attrib["energy"]
        for p in element.findall("GlobalParameter"):
            gen.globalParams[p.attrib["name"]] = float(
                p.attrib["defaultValue"])
        for p in element.findall("PerTorsionParameter"):
            gen.perTorsionParams.append(p.attrib["name"])
        for t in element.findall("Proper"):
            types = ff._findAtomTypes(t.attrib, 4)
            if None not in types:
                gen.proper.append(
                    (types,
                     [float(t.attrib[p]) for p in gen.perTorsionParams]))
        for t in element.findall("Improper"):
            types = ff._findAtomTypes(t.attrib, 4)
            if None not in types:
                gen.improper.append(
                    (types,
                     [float(t.attrib[p]) for p in gen.perTorsionParams]))

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        import itertools
        force = mmforces.CustomTorsionForce(self.energy)
        sys.addForce(force)
        for p, v in self.globalParams.items():
            force.addGlobalParameter(p, v)
        for p in self.perTorsionParams:
            force.addPerTorsionParameter(p)
        for quad in data.propers:
            ts = tuple(data.atomType[data.atoms[x]] for x in quad)
            for (slots, values) in self.proper:
                fwd = all(t in s for t, s in zip(ts, slots))
                rev = all(t in s for t, s in zip(ts[::-1], slots))
                if fwd or rev:
                    force.addTorsion(*quad, values)
                    break
        for j in sorted(data.bondedToAtom):
            nb = sorted(data.bondedToAtom[j])
            if len(nb) < 3:
                continue
            tj = data.atomType[data.atoms[j]]
            for (slots, values) in self.improper:
                if tj not in slots[0]:
                    continue
                matched = None
                for perm in itertools.permutations(nb, 3):
                    tp = tuple(data.atomType[data.atoms[x]] for x in perm)
                    if all(t in s for t, s in zip(tp, slots[1:])):
                        matched = perm
                        break
                if matched:
                    force.addTorsion(matched[0], matched[1], j,
                                     matched[2], values)
                    break


PARSERS["CustomTorsionForce"] = CustomTorsionGenerator.parseElement


class CustomNonbondedGenerator(object):
    """<CustomNonbondedForce> -> CustomNonbondedForce (forcefield.py:2912)."""

    def __init__(self, ff, energy, bondCutoff):
        self.ff = ff
        self.energy = energy
        self.bondCutoff = bondCutoff
        self.globalParams = {}
        self.perParticleParams = []
        self.functions = []
        self.params = None

    @staticmethod
    def parseElement(element, ff):
        gen = CustomNonbondedGenerator(
            ff, element.attrib["energy"],
            int(element.attrib.get("bondCutoff", 3)))
        ff.registerGenerator(gen)
        for p in element.findall("GlobalParameter"):
            gen.globalParams[p.attrib["name"]] = float(
                p.attrib["defaultValue"])
        for p in element.findall("PerParticleParameter"):
            gen.perParticleParams.append(p.attrib["name"])
        gen.params = AtomTypeParameters(ff, "CustomNonbondedForce", "Atom",
                                        gen.perParticleParams)
        gen.params.parseDefinitions(element)
        gen.functions += parse_functions(element)

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        from . import forcefield as ffmod
        force = mmforces.CustomNonbondedForce(self.energy)
        for p, v in self.globalParams.items():
            force.addGlobalParameter(p, v)
        for p in self.perParticleParams:
            force.addPerParticleParameter(p)
        create_functions(force, self.functions)
        for a in data.atoms:
            force.addParticle(self.params.getAtomParameters(a, data))
        if nonbondedMethod in (ffmod.CutoffPeriodic, ffmod.Ewald,
                               ffmod.PME, ffmod.LJPME):
            force.setNonbondedMethod(
                mmforces.CustomNonbondedForce.CutoffPeriodic)
        elif nonbondedMethod is ffmod.NoCutoff:
            force.setNonbondedMethod(mmforces.CustomNonbondedForce.NoCutoff)
        else:
            force.setNonbondedMethod(
                mmforces.CustomNonbondedForce.CutoffNonPeriodic)
        force.setCutoffDistance(nonbondedCutoff)
        sys.addForce(force)
        self.force = force

    def postprocessSystem(self, sys, data, args):
        bond_idx = find_bonds_for_exclusions(data, sys)
        self.force.createExclusionsFromBonds(bond_idx, self.bondCutoff)


PARSERS["CustomNonbondedForce"] = CustomNonbondedGenerator.parseElement


class CustomGBGenerator(object):
    """<CustomGBForce> -> CustomGBForce (forcefield.py:2968)."""

    def __init__(self, ff):
        self.ff = ff
        self.globalParams = {}
        self.perParticleParams = []
        self.computedValues = []
        self.energyTerms = []
        self.functions = []
        self.params = None

    @staticmethod
    def parseElement(element, ff):
        gen = CustomGBGenerator(ff)
        ff.registerGenerator(gen)
        for p in element.findall("GlobalParameter"):
            gen.globalParams[p.attrib["name"]] = float(
                p.attrib["defaultValue"])
        for p in element.findall("PerParticleParameter"):
            gen.perParticleParams.append(p.attrib["name"])
        gen.params = AtomTypeParameters(ff, "CustomGBForce", "Atom",
                                        gen.perParticleParams)
        gen.params.parseDefinitions(element)
        comp = {"SingleParticle": mmforces.CustomGBForce.SingleParticle,
                "ParticlePair": mmforces.CustomGBForce.ParticlePair,
                "ParticlePairNoExclusions":
                    mmforces.CustomGBForce.ParticlePairNoExclusions}
        for v in element.findall("ComputedValue"):
            gen.computedValues.append(
                (v.attrib["name"], v.text, comp[v.attrib["type"]]))
        for t in element.findall("EnergyTerm"):
            gen.energyTerms.append((t.text, comp[t.attrib["type"]]))
        gen.functions += parse_functions(element)

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        from . import forcefield as ffmod
        force = mmforces.CustomGBForce()
        for p, v in self.globalParams.items():
            force.addGlobalParameter(p, v)
        for p in self.perParticleParams:
            force.addPerParticleParameter(p)
        for (name, expr, ctype) in self.computedValues:
            force.addComputedValue(name, expr, ctype)
        for (expr, ctype) in self.energyTerms:
            force.addEnergyTerm(expr, ctype)
        create_functions(force, self.functions)
        for a in data.atoms:
            force.addParticle(self.params.getAtomParameters(a, data))
        if nonbondedMethod is ffmod.NoCutoff:
            force.setNonbondedMethod(mmforces.CustomGBForce.NoCutoff)
        elif nonbondedMethod is ffmod.CutoffNonPeriodic:
            force.setNonbondedMethod(
                mmforces.CustomGBForce.CutoffNonPeriodic)
        else:
            force.setNonbondedMethod(mmforces.CustomGBForce.CutoffPeriodic)
        force.setCutoffDistance(nonbondedCutoff)
        sys.addForce(force)


PARSERS["CustomGBForce"] = CustomGBGenerator.parseElement


class CustomHbondGenerator(object):
    """<CustomHbondForce> -> CustomHbondForce (forcefield.py:3100)."""

    def __init__(self, ff):
        self.ff = ff
        self.globalParams = {}
        self.perDonorParams = []
        self.perAcceptorParams = []
        self.donorTypes = []
        self.donorValues = []
        self.acceptorTypes = []
        self.acceptorValues = []
        self.functions = []
        self.energy = ""
        self.bondCutoff = 3
        self.particlesPerDonor = 1
        self.particlesPerAcceptor = 1

    @staticmethod
    def parseElement(element, ff):
        gen = CustomHbondGenerator(ff)
        ff.registerGenerator(gen)
        gen.energy = element.attrib["energy"]
        gen.bondCutoff = int(element.attrib.get("bondCutoff", 3))
        gen.particlesPerDonor = int(
            element.attrib.get("particlesPerDonor", 1))
        gen.particlesPerAcceptor = int(
            element.attrib.get("particlesPerAcceptor", 1))
        for p in element.findall("GlobalParameter"):
            gen.globalParams[p.attrib["name"]] = float(
                p.attrib["defaultValue"])
        for p in element.findall("PerDonorParameter"):
            gen.perDonorParams.append(p.attrib["name"])
        for p in element.findall("PerAcceptorParameter"):
            gen.perAcceptorParams.append(p.attrib["name"])
        for d in element.findall("Donor"):
            types = ff._findAtomTypes(d.attrib, gen.particlesPerDonor)
            if None not in types:
                gen.donorTypes.append(types)
                gen.donorValues.append(
                    [float(d.attrib[p]) for p in gen.perDonorParams])
        for a in element.findall("Acceptor"):
            types = ff._findAtomTypes(a.attrib, gen.particlesPerAcceptor)
            if None not in types:
                gen.acceptorTypes.append(types)
                gen.acceptorValues.append(
                    [float(a.attrib[p]) for p in gen.perAcceptorParams])
        gen.functions += parse_functions(element)

    def _match_groups(self, data, type_sets, n_particles):
        """Enumerate bonded groups of n_particles atoms matching any of
        the type-set rows; group = (a1[, a2[, a3]]) with a2 bonded to a1
        and a3 bonded to a1 (reference semantics for donor groups)."""
        groups = []
        for a in data.atoms:
            t1 = data.atomType[a]
            if n_particles == 1:
                for sets in type_sets:
                    if t1 in sets[0]:
                        groups.append((a.index,))
                        break
            else:
                for b1 in data.bondedToAtom[a.index]:
                    t2 = data.atomType[data.atoms[b1]]
                    if n_particles == 2:
                        for sets in type_sets:
                            if t1 in sets[0] and t2 in sets[1]:
                                groups.append((a.index, b1))
                                break
                    else:
                        for b2 in data.bondedToAtom[a.index]:
                            if b2 == b1:
                                continue
                            t3 = data.atomType[data.atoms[b2]]
                            for sets in type_sets:
                                if t1 in sets[0] and t2 in sets[1] \
                                        and t3 in sets[2]:
                                    groups.append((a.index, b1, b2))
                                    break
        return groups

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        from . import forcefield as ffmod
        force = mmforces.CustomHbondForce(self.energy)
        for p, v in self.globalParams.items():
            force.addGlobalParameter(p, v)
        for p in self.perDonorParams:
            force.addPerDonorParameter(p)
        for p in self.perAcceptorParams:
            force.addPerAcceptorParameter(p)
        create_functions(force, self.functions)
        for idx, types in enumerate(self.donorTypes):
            for g in self._match_groups(data, [types],
                                        self.particlesPerDonor):
                padded = list(g) + [-1] * (3 - len(g))
                force.addDonor(padded[0], padded[1], padded[2],
                               self.donorValues[idx])
        for idx, types in enumerate(self.acceptorTypes):
            for g in self._match_groups(data, [types],
                                        self.particlesPerAcceptor):
                padded = list(g) + [-1] * (3 - len(g))
                force.addAcceptor(padded[0], padded[1], padded[2],
                                  self.acceptorValues[idx])
        if nonbondedMethod is ffmod.NoCutoff:
            force.setNonbondedMethod(mmforces.CustomHbondForce.NoCutoff)
        elif nonbondedMethod is ffmod.CutoffNonPeriodic:
            force.setNonbondedMethod(
                mmforces.CustomHbondForce.CutoffNonPeriodic)
        else:
            force.setNonbondedMethod(
                mmforces.CustomHbondForce.CutoffPeriodic)
        force.setCutoffDistance(nonbondedCutoff)
        sys.addForce(force)


PARSERS["CustomHbondForce"] = CustomHbondGenerator.parseElement


class CustomManyParticleGenerator(object):
    """<CustomManyParticleForce> -> CustomManyParticleForce
    (forcefield.py:3209)."""

    def __init__(self, ff, particlesPerSet, energy, permutationMode,
                 bondCutoff):
        self.ff = ff
        self.particlesPerSet = particlesPerSet
        self.energy = energy
        self.permutationMode = permutationMode
        self.bondCutoff = bondCutoff
        self.globalParams = {}
        self.perParticleParams = []
        self.functions = []
        self.typeFilters = []
        self.params = None

    @staticmethod
    def parseElement(element, ff):
        mode = {"SinglePermutation":
                mmforces.CustomManyParticleForce.SinglePermutation,
                "UniqueCentralParticle":
                mmforces.CustomManyParticleForce.UniqueCentralParticle}[
                    element.attrib["permutationMode"]]
        gen = CustomManyParticleGenerator(
            ff, int(element.attrib["particlesPerSet"]),
            element.attrib["energy"], mode,
            int(element.attrib.get("bondCutoff", 3)))
        ff.registerGenerator(gen)
        for p in element.findall("GlobalParameter"):
            gen.globalParams[p.attrib["name"]] = float(
                p.attrib["defaultValue"])
        for p in element.findall("PerParticleParameter"):
            gen.perParticleParams.append(p.attrib["name"])
        gen.params = AtomTypeParameters(ff, "CustomManyParticleForce",
                                        "Atom", gen.perParticleParams)
        gen.params.parseDefinitions(element)
        for f in element.findall("TypeFilter"):
            gen.typeFilters.append(
                (int(f.attrib["index"]),
                 [int(x) for x in f.attrib["types"].split(",")]))
        gen.functions += parse_functions(element)

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        from . import forcefield as ffmod
        force = mmforces.CustomManyParticleForce(self.particlesPerSet,
                                                 self.energy)
        force.setPermutationMode(self.permutationMode)
        for p, v in self.globalParams.items():
            force.addGlobalParameter(p, v)
        for p in self.perParticleParams:
            force.addPerParticleParameter(p)
        create_functions(force, self.functions)
        for (index, types) in self.typeFilters:
            force.setTypeFilter(index, types)
        for a in data.atoms:
            values = self.params.getAtomParameters(a, data)
            extra = self.params.getExtraParameters(a, data)
            ptype = int(extra.get("filterType", 0))
            force.addParticle(values, ptype)
        if nonbondedMethod is ffmod.NoCutoff:
            force.setNonbondedMethod(
                mmforces.CustomManyParticleForce.NoCutoff)
        else:
            force.setNonbondedMethod(
                mmforces.CustomManyParticleForce.CutoffPeriodic)
        force.setCutoffDistance(nonbondedCutoff)
        sys.addForce(force)
        self.force = force

    def postprocessSystem(self, sys, data, args):
        bond_idx = find_bonds_for_exclusions(data, sys)
        self.force.createExclusionsFromBonds(bond_idx, self.bondCutoff)


PARSERS["CustomManyParticleForce"] = CustomManyParticleGenerator.parseElement


from . import ffgenerators_amoeba  # noqa: E402,F401  (registers its parsers)
