"""AMOEBA force-field XML generator sections.

Counterpart of openmm_tpu/app/ffgenerators_amoeba.py (the Amoeba*Generator
classes of wrappers/python/openmm/app/forcefield.py:3324-5690). The bonded
AMOEBA terms map onto Custom*Force objects exactly as the reference does
(e.g. AmoebaBondForce -> CustomBondForce with quartic terms,
forcefield.py:3367); Urey-Bradley onto HarmonicBondForce; Vdw, Multipole,
TorsionTorsion, WcaDispersion and GeneralizedKirkwood onto the port's
forces of openmm_tpu_torch.forces.amoeba. createSystem hands each
generator its keyword arguments (polarization, mutualInducedTargetEpsilon,
vdwCutoff, the GK file's solventDielectric and soluteDielectric, ...).
"""
from __future__ import annotations

import math
from collections import defaultdict

from .. import forces as mmforces
from ..exceptions import OpenMMException
from .ffgenerators import (PARSERS, AtomTypeParameters,
                           find_bonds_for_exclusions)

_RAD = math.pi / 180.0


def _bonded12_sets(data, sys):
    """Per-atom set of 1-2 partners incl. virtual-site parents
    (forcefield.py:4560 getBondedParticleSets)."""
    sets = [set() for _ in data.atoms]
    for (a1, a2) in find_bonds_for_exclusions(data, sys):
        sets[a1].add(a2)
        sets[a2].add(a1)
    return sets


def _shell_sets(b12):
    """1-3/1-4/1-5 shells from the 1-2 sets (forcefield.py:5017-5076)."""
    n = len(b12)
    b13, b14, b15 = [], [], []
    for i in range(n):
        s13 = set()
        for j in b12[i]:
            s13 |= b12[j]
        s13 -= b12[i]
        s13.discard(i)
        b13.append(s13)
    for i in range(n):
        s14 = set()
        for j in b13[i]:
            s14 |= b12[j]
        s14 -= b12[i]
        s14 -= b13[i]
        s14.discard(i)
        b14.append(s14)
    for i in range(n):
        s15 = set()
        for j in b14[i]:
            s15 |= b12[j]
        s15 -= b12[i]
        s15 -= b13[i]
        s15 -= b14[i]
        s15.discard(i)
        b15.append(s15)
    return b13, b14, b15


def _neighbors(data, i):
    """Atoms bonded to atom i (via the data.bonds records)."""
    out = []
    for b in data.atomBonds[i]:
        bond = data.bonds[b]
        out.append(bond.atom2 if bond.atom1 == i else bond.atom1)
    return out


def _add_13_constraint(sys, data, angle, theta0):
    """Constrain the 1-3 distance of an angle whose bond lengths are known
    (forcefield.py:3397 addAngleConstraint)."""
    l1 = l2 = None
    for b in data.atomBonds[angle[1]]:
        bond = data.bonds[b]
        other = bond.atom2 if bond.atom1 == angle[1] else bond.atom1
        if other == angle[0]:
            l1 = bond.length
        elif other == angle[2]:
            l2 = bond.length
    if l1 and l2:
        d = math.sqrt(l1 * l1 + l2 * l2 - 2 * l1 * l2 * math.cos(theta0))
        sys.addConstraint(angle[0], angle[2], d)


# ------------------------------------------------------------------ bond
class AmoebaBondGenerator(object):
    """<AmoebaBondForce> -> CustomBondForce with cubic/quartic terms
    (forcefield.py:3324)."""

    def __init__(self, cubic, quartic):
        self.cubic = cubic
        self.quartic = quartic
        self.entries = []       # (types1, types2, length, k)

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaBondGenerator(element.attrib["bond-cubic"],
                                  element.attrib["bond-quartic"])
        ff.registerGenerator(gen)
        for bond in element.findall("Bond"):
            types = ff._findAtomTypes(bond.attrib, 2)
            if None in types:
                raise OpenMMException(
                    "AmoebaBondGenerator: unknown class in " +
                    str(bond.attrib))
            gen.entries.append((types[0], types[1],
                                float(bond.attrib["length"]),
                                float(bond.attrib["k"])))

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        energy = "k*(d^2 + %s*d^3 + %s*d^4); d=r-r0" % (self.cubic,
                                                        self.quartic)
        existing = [f for f in sys.getForces()
                    if isinstance(f, mmforces.CustomBondForce)
                    and f.getEnergyFunction() == energy]
        if existing:
            force = existing[0]
        else:
            force = mmforces.CustomBondForce(energy)
            force.addPerBondParameter("r0")
            force.addPerBondParameter("k")
            force.setName("AmoebaBond")
            sys.addForce(force)
        for bond in data.bonds:
            t1 = data.atomType[data.atoms[bond.atom1]]
            t2 = data.atomType[data.atoms[bond.atom2]]
            for (s1, s2, length, k) in self.entries:
                if (t1 in s1 and t2 in s2) or (t1 in s2 and t2 in s1):
                    bond.length = length
                    key = (min(bond.atom1, bond.atom2),
                           max(bond.atom1, bond.atom2))
                    done = getattr(data, "constrainedPairs", set())
                    if bond.isConstrained and key not in done:
                        sys.addConstraint(bond.atom1, bond.atom2, length)
                        done.add(key)
                    if k != 0 and (not bond.isConstrained
                                   or args.get("flexibleConstraints")):
                        force.addBond(bond.atom1, bond.atom2, [length, k])
                    break


PARSERS["AmoebaBondForce"] = AmoebaBondGenerator.parseElement


# ----------------------------------------------------------------- angle
class AmoebaAngleGenerator(object):
    """<AmoebaAngleForce> -> CustomAngleForce (+ in-plane variant via
    CustomCompoundBondForce) with sextic expansion; angle assignment is
    driven by AmoebaOutOfPlaneBendGenerator, which partitions angles
    (forcefield.py:3425)."""

    def __init__(self, ff, cubic, quartic, pentic, sextic):
        self.ff = ff
        self.cubic = cubic
        self.quartic = quartic
        self.pentic = pentic
        self.sextic = sextic
        self.entries = []       # (t1, t2, t3, [angles], k)

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaAngleGenerator(ff, element.attrib["angle-cubic"],
                                   element.attrib["angle-quartic"],
                                   element.attrib["angle-pentic"],
                                   element.attrib["angle-sextic"])
        ff.registerGenerator(gen)
        for angle in element.findall("Angle"):
            types = ff._findAtomTypes(angle.attrib, 3)
            if None in types:
                raise OpenMMException(
                    "AmoebaAngleGenerator: unknown class in " +
                    str(angle.attrib))
            angles = [float(angle.attrib["angle1"])]
            for key in ("angle2", "angle3"):
                if key in angle.attrib:
                    angles.append(float(angle.attrib[key]))
            gen.entries.append((types[0], types[1], types[2], angles,
                                float(angle.attrib["k"])))

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        # deferred to AmoebaOutOfPlaneBendGenerator (angle partitioning)
        pass

    def createForcePostOpBendAngle(self, sys, data, nonbondedMethod,
                                   nonbondedCutoff, angleList, args):
        energy = ("k*(d^2 + %s*d^3 + %s*d^4 + %s*d^5 + %s*d^6); "
                  "d=%.15g*theta-theta0"
                  % (self.cubic, self.quartic, self.pentic, self.sextic,
                     180 / math.pi))
        existing = [f for f in sys.getForces()
                    if isinstance(f, mmforces.CustomAngleForce)
                    and f.getEnergyFunction() == energy]
        if existing:
            force = existing[0]
        else:
            force = mmforces.CustomAngleForce(energy)
            force.addPerAngleParameter("theta0")
            force.addPerAngleParameter("k")
            force.setName("AmoebaAngle")
            sys.addForce(force)
        for rec in angleList:
            angle = rec["angle"]
            constrained = rec["isConstrained"]
            ts = [data.atomType[data.atoms[angle[j]]] for j in range(3)]
            for (s1, s2, s3, angles, k) in self.entries:
                if ts[1] in s2 and ((ts[0] in s1 and ts[2] in s3)
                                    or (ts[0] in s3 and ts[2] in s1)):
                    if constrained and k != 0.0:
                        rec["idealAngle"] = angles[0]
                        _add_13_constraint(sys, data, angle,
                                           angles[0] * _RAD)
                    if k != 0 and (not constrained
                                   or args.get("flexibleConstraints")):
                        if len(angles) > 1:
                            # k-index = number of non-angle hydrogens on
                            # the central atom (TINKER kangle.f rule)
                            n_h = 0
                            for other in _neighbors(data, angle[1]):
                                if other in (angle[0], angle[2]):
                                    continue
                                from .. import unit as u
                                m = u.strip(sys.getParticleMass(other),
                                            u.dalton)
                                if m < 1.90:
                                    n_h += 1
                            if n_h >= len(angles):
                                raise OpenMMException(
                                    "AmoebaAngleGenerator: angle index "
                                    "out of range")
                            val = angles[n_h]
                        else:
                            val = angles[0]
                        rec["idealAngle"] = val
                        force.addAngle(angle[0], angle[1], angle[2],
                                       [val, k])
                    break

    def createForcePostOpBendInPlaneAngle(self, sys, data, nonbondedMethod,
                                          nonbondedCutoff, angleList, args):
        energy = ("k*(d^2 + %s*d^3 + %s*d^4 + %s*d^5 + %s*d^6); "
                  "d=theta-theta0;\n"
                  "theta = %.15g*pointangle(x1, y1, z1, projx, projy, "
                  "projz, x3, y3, z3);\n"
                  "projx = x2-nx*dot; projy = y2-ny*dot; projz = z2-nz*dot;"
                  "\ndot = nx*(x2-x3) + ny*(y2-y3) + nz*(z2-z3);\n"
                  "nx = px/norm; ny = py/norm; nz = pz/norm;\n"
                  "norm = sqrt(px*px + py*py + pz*pz);\n"
                  "px = (d1y*d2z-d1z*d2y); py = (d1z*d2x-d1x*d2z); "
                  "pz = (d1x*d2y-d1y*d2x);\n"
                  "d1x = x1-x4; d1y = y1-y4; d1z = z1-z4;\n"
                  "d2x = x3-x4; d2y = y3-y4; d2z = z3-z4"
                  % (self.cubic, self.quartic, self.pentic, self.sextic,
                     180 / math.pi))
        existing = [f for f in sys.getForces()
                    if isinstance(f, mmforces.CustomCompoundBondForce)
                    and f.getEnergyFunction() == energy]
        if existing:
            force = existing[0]
        else:
            force = mmforces.CustomCompoundBondForce(4, energy)
            force.addPerBondParameter("theta0")
            force.addPerBondParameter("k")
            force.setName("AmoebaInPlaneAngle")
            sys.addForce(force)
        for rec in angleList:
            angle = rec["angle"]
            constrained = rec["isConstrained"]
            ts = [data.atomType[data.atoms[angle[j]]] for j in range(3)]
            for (s1, s2, s3, angles, k) in self.entries:
                if ts[1] in s2 and ((ts[0] in s1 and ts[2] in s3)
                                    or (ts[0] in s3 and ts[2] in s1)):
                    rec["idealAngle"] = angles[0]
                    if constrained and k != 0.0:
                        _add_13_constraint(sys, data, angle,
                                           angles[0] * _RAD)
                    if k != 0 and (not constrained
                                   or args.get("flexibleConstraints")):
                        force.addBond((angle[0], angle[1], angle[2],
                                       angle[3]), (angles[0], k))
                    break


PARSERS["AmoebaAngleForce"] = AmoebaAngleGenerator.parseElement


# ------------------------------------------------------- out-of-plane bend
class AmoebaOutOfPlaneBendGenerator(object):
    """<AmoebaOutOfPlaneBendForce> -> CustomCompoundBondForce; also
    partitions angles into in-plane/generic and drives the angle and
    stretch-bend generators (forcefield.py:3616)."""

    def __init__(self, ff, typeName, cubic, quartic, pentic, sextic):
        self.ff = ff
        self.typeName = typeName
        self.cubic = cubic
        self.quartic = quartic
        self.pentic = pentic
        self.sextic = sextic
        self.entries = []       # (types1, types2, k)

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaOutOfPlaneBendGenerator(
            ff, element.attrib.get("type", "ALLINGER"),
            float(element.attrib["opbend-cubic"]),
            float(element.attrib["opbend-quartic"]),
            float(element.attrib["opbend-pentic"]),
            float(element.attrib["opbend-sextic"]))
        ff.registerGenerator(gen)
        for angle in element.findall("Angle"):
            # class3/class4 of "0" mean unmatched slots -> empty sets
            # (reference's local findAtomTypes at forcefield.py:3645)
            def slot(idx):
                cls = angle.attrib.get("class%d" % idx, "0")
                matched = frozenset(ff._class_types(cls))
                return matched
            gen.entries.append((slot(1), slot(2),
                                float(angle.attrib["k"])))

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        energy = ("k*(theta^2 + %s*theta^3 + %s*theta^4 + %s*theta^5 + "
                  "%s*theta^6);\n"
                  "theta = %.15g*pointangle(x2, y2, z2, x4, y4, z4, projx, "
                  "projy, projz);\n"
                  "projx = x2-nx*dot; projy = y2-ny*dot; projz = z2-nz*dot;"
                  "\ndot = nx*(x2-x3) + ny*(y2-y3) + nz*(z2-z3);\n"
                  "nx = px/norm; ny = py/norm; nz = pz/norm;\n"
                  "norm = sqrt(px*px + py*py + pz*pz);\n"
                  "px = (d1y*d2z-d1z*d2y); py = (d1z*d2x-d1x*d2z); "
                  "pz = (d1x*d2y-d1y*d2x);\n"
                  "d1x = x1-x4; d1y = y1-y4; d1z = z1-z4;\n"
                  "d2x = x3-x4; d2y = y3-y4; d2z = z3-z4"
                  % (self.cubic, self.quartic, self.pentic, self.sextic,
                     180 / math.pi))
        force = mmforces.CustomCompoundBondForce(4, energy)
        force.addPerBondParameter("k")
        force.setName("AmoebaOutOfPlaneBend")
        sys.addForce(force)

        skip_atoms = {}
        in_plane, generic = [], []
        for (angle, constrained) in zip(data.angles,
                                        data.isAngleConstrained):
            middle = angle[1]
            covalency = len(data.atomBonds[middle])
            mid_type = data.atomType[data.atoms[middle]]
            if covalency == 3 and middle not in skip_atoms:
                partners, partner_k = [], []
                for other in _neighbors(data, middle):
                    ptype = data.atomType[data.atoms[other]]
                    for (s1, s2, k) in self.entries:
                        if mid_type in s2 and ptype in s1:
                            partners.append(other)
                            partner_k.append(k)
                            break
                if len(partners) == 3:
                    force.addBond([partners[0], middle, partners[1],
                                   partners[2]], [partner_k[2]])
                    force.addBond([partners[0], middle, partners[2],
                                   partners[1]], [partner_k[1]])
                    force.addBond([partners[1], middle, partners[2],
                                   partners[0]], [partner_k[0]])
                    skip_atoms[middle] = set(partners)
                    angle_list = list(angle)
                    for p in partners:
                        if p not in angle_list:
                            angle_list.append(p)
                    in_plane.append({"angle": angle_list,
                                     "isConstrained": 0})
                else:
                    generic.append({"angle": list(angle),
                                    "isConstrained": constrained})
            elif covalency == 3 and middle in skip_atoms:
                angle_list = list(angle)
                for p in skip_atoms[middle]:
                    if p not in angle_list:
                        angle_list.append(p)
                in_plane.append({"angle": angle_list,
                                 "isConstrained": constrained})
            else:
                generic.append({"angle": list(angle),
                                "isConstrained": constrained})

        for gen in self.ff._forces:
            if isinstance(gen, AmoebaAngleGenerator):
                gen.createForcePostOpBendAngle(
                    sys, data, nonbondedMethod, nonbondedCutoff, generic,
                    args)
                gen.createForcePostOpBendInPlaneAngle(
                    sys, data, nonbondedMethod, nonbondedCutoff, in_plane,
                    args)
        for gen in self.ff._forces:
            if isinstance(gen, AmoebaStretchBendGenerator):
                gen.createForcePostAmoebaBondForce(
                    sys, data, nonbondedMethod, nonbondedCutoff,
                    generic + in_plane, args)


PARSERS["AmoebaOutOfPlaneBendForce"] = \
    AmoebaOutOfPlaneBendGenerator.parseElement


# --------------------------------------------------------------- torsion
class AmoebaTorsionGenerator(object):
    """<AmoebaTorsionForce> -> PeriodicTorsionForce with three terms
    (forcefield.py:3890)."""

    def __init__(self, torsionUnit):
        self.torsionUnit = torsionUnit
        self.entries = []       # (slots x4, [(amp, angle) x3])

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaTorsionGenerator(
            float(element.attrib.get("torsionUnit", 1.0)))
        ff.registerGenerator(gen)
        for t in element.findall("Torsion"):
            types = ff._findAtomTypes(t.attrib, 4)
            if None in types:
                raise OpenMMException(
                    "AmoebaTorsionGenerator: unknown class in "
                    + str(t.attrib))
            terms = [(float(t.attrib["amp%d" % i]),
                      float(t.attrib["angle%d" % i])) for i in (1, 2, 3)]
            gen.entries.append((types, terms))

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        existing = [f for f in sys.getForces()
                    if type(f) is mmforces.PeriodicTorsionForce]
        force = existing[0] if existing \
            else mmforces.PeriodicTorsionForce()
        if not existing:
            sys.addForce(force)
        for quad in data.propers:
            ts = tuple(data.atomType[data.atoms[x]] for x in quad)
            for (slots, terms) in self.entries:
                fwd = all(t in s for t, s in zip(ts, slots))
                rev = all(t in s for t, s in zip(ts[::-1], slots))
                if fwd or rev:
                    for per, (amp, ang) in enumerate(terms, start=1):
                        if amp != 0:
                            force.addTorsion(*quad, per, ang, amp)
                    break


PARSERS["AmoebaTorsionForce"] = AmoebaTorsionGenerator.parseElement


# ------------------------------------------------------------ pi-torsion
class AmoebaPiTorsionGenerator(object):
    """<AmoebaPiTorsionForce> -> 6-particle CustomCompoundBondForce
    (forcefield.py:3998)."""

    def __init__(self, piTorsionUnit):
        self.piTorsionUnit = piTorsionUnit
        self.entries = []       # (types1, types2, k)

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaPiTorsionGenerator(
            float(element.attrib.get("piTorsionUnit", 1.0)))
        ff.registerGenerator(gen)
        for t in element.findall("PiTorsion"):
            types = ff._findAtomTypes(t.attrib, 2)
            if None in types:
                raise OpenMMException(
                    "AmoebaPiTorsionGenerator: unknown class in "
                    + str(t.attrib))
            gen.entries.append((types[0], types[1],
                                float(t.attrib["k"])))

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        energy = ("2*k*sin(phi)^2;\n"
                  "phi = pointdihedral(x3+c1x, y3+c1y, z3+c1z, x3, y3, z3, "
                  "x4, y4, z4, x4+c2x, y4+c2y, z4+c2z);\n"
                  "c1x = (d14y*d24z-d14z*d24y); "
                  "c1y = (d14z*d24x-d14x*d24z); "
                  "c1z = (d14x*d24y-d14y*d24x);\n"
                  "c2x = (d53y*d63z-d53z*d63y); "
                  "c2y = (d53z*d63x-d53x*d63z); "
                  "c2z = (d53x*d63y-d53y*d63x);\n"
                  "d14x = x1-x4; d14y = y1-y4; d14z = z1-z4;\n"
                  "d24x = x2-x4; d24y = y2-y4; d24z = z2-z4;\n"
                  "d53x = x5-x3; d53y = y5-y3; d53z = z5-z3;\n"
                  "d63x = x6-x3; d63y = y6-y3; d63z = z6-z3")
        force = mmforces.CustomCompoundBondForce(6, energy)
        force.addPerBondParameter("k")
        force.setName("AmoebaPiTorsion")
        sys.addForce(force)
        for bond in data.bonds:
            a1, a2 = bond.atom1, bond.atom2
            if len(data.atomBonds[a1]) != 3 or len(data.atomBonds[a2]) != 3:
                continue
            t1 = data.atomType[data.atoms[a1]]
            t2 = data.atomType[data.atoms[a2]]
            for (s1, s2, k) in self.entries:
                if (t1 in s1 and t2 in s2) or (t1 in s2 and t2 in s1):
                    p12 = [x for x in _neighbors(data, a1) if x != a2]
                    p56 = [x for x in _neighbors(data, a2) if x != a1]
                    force.addBond([p12[0], p12[1], a1, a2, p56[0],
                                   p56[1]], [k])
                    break


PARSERS["AmoebaPiTorsionForce"] = AmoebaPiTorsionGenerator.parseElement


# -------------------------------------------------------- stretch-bend
class AmoebaStretchBendGenerator(object):
    """<AmoebaStretchBendForce> -> 3-particle CustomCompoundBondForce;
    invoked by AmoebaOutOfPlaneBendGenerator after angles get their ideal
    values (forcefield.py:4362)."""

    def __init__(self):
        self.entries = []       # (t1, t2, t3, k1, k2)

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaStretchBendGenerator()
        ff.registerGenerator(gen)
        for sb in element.findall("StretchBend"):
            types = ff._findAtomTypes(sb.attrib, 3)
            if None in types:
                raise OpenMMException(
                    "AmoebaStretchBendGenerator: unknown class in "
                    + str(sb.attrib))
            gen.entries.append((types[0], types[1], types[2],
                                float(sb.attrib["k1"]),
                                float(sb.attrib["k2"])))

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        pass

    def createForcePostAmoebaBondForce(self, sys, data, nonbondedMethod,
                                       nonbondedCutoff, angleList, args):
        energy = ("(k1*(distance(p1,p2)-r12) + k2*(distance(p2,p3)-r23))"
                  "*(%.15g*(angle(p1,p2,p3)-theta0))" % (180 / math.pi))
        existing = [f for f in sys.getForces()
                    if isinstance(f, mmforces.CustomCompoundBondForce)
                    and f.getEnergyFunction() == energy]
        if existing:
            force = existing[0]
        else:
            force = mmforces.CustomCompoundBondForce(3, energy)
            for p in ("r12", "r23", "theta0", "k1", "k2"):
                force.addPerBondParameter(p)
            force.setName("AmoebaStretchBend")
            sys.addForce(force)
        for rec in angleList:
            angle = rec["angle"]
            ts = [data.atomType[data.atoms[angle[j]]] for j in range(3)]
            for (s1, s2, s3, k1, k2) in self.entries:
                if ts[1] in s2 and ((ts[0] in s1 and ts[2] in s3)
                                    or (ts[2] in s1 and ts[0] in s3)):
                    bond_ab = bond_cb = -1.0
                    for b in data.atomBonds[angle[1]]:
                        bond = data.bonds[b]
                        if angle[0] in (bond.atom1, bond.atom2):
                            bond_ab = bond.length
                        if angle[2] in (bond.atom1, bond.atom2):
                            bond_cb = bond.length
                    if "idealAngle" not in rec:
                        raise OpenMMException(
                            "AmoebaStretchBendGenerator: ideal angle "
                            "not set for angle %s" % (angle,))
                    if bond_ab < 0 or bond_cb < 0:
                        raise OpenMMException(
                            "AmoebaStretchBendGenerator: bond lengths "
                            "not set for angle %s" % (angle,))
                    force.addBond((angle[0], angle[1], angle[2]),
                                  (bond_ab, bond_cb,
                                   rec["idealAngle"] * _RAD, k1, k2))
                    break


PARSERS["AmoebaStretchBendForce"] = AmoebaStretchBendGenerator.parseElement


# ------------------------------------------------------- Urey-Bradley
class AmoebaUreyBradleyGenerator(object):
    """<AmoebaUreyBradleyForce> -> HarmonicBondForce on the 1-3 atoms of
    matching angles (forcefield.py:5622)."""

    def __init__(self):
        self.entries = []
        self.by_center = defaultdict(list)

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaUreyBradleyGenerator()
        ff.registerGenerator(gen)
        for ub in element.findall("UreyBradley"):
            types = ff._findAtomTypes(ub.attrib, 3)
            if None in types:
                continue
            idx = len(gen.entries)
            gen.entries.append((types[0], types[1], types[2],
                                float(ub.attrib["d"]),
                                float(ub.attrib["k"])))
            for t in types[1]:
                gen.by_center[t].append(idx)

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        existing = [f for f in sys.getForces()
                    if type(f) is mmforces.HarmonicBondForce]
        force = existing[0] if existing else mmforces.HarmonicBondForce()
        if not existing:
            sys.addForce(force)
        for (angle, constrained) in zip(data.angles,
                                        data.isAngleConstrained):
            if constrained and not args.get("flexibleConstraints"):
                continue
            ts = [data.atomType[data.atoms[angle[j]]] for j in range(3)]
            for i in self.by_center.get(ts[1], ()):
                (s1, s2, s3, d, k) = self.entries[i]
                if (ts[0] in s1 and ts[1] in s2 and ts[2] in s3) or \
                        (ts[2] in s1 and ts[1] in s2 and ts[0] in s3):
                    force.addBond(angle[0], angle[2], d, 2 * k)
                    break


PARSERS["AmoebaUreyBradleyForce"] = AmoebaUreyBradleyGenerator.parseElement


# ---------------------------------------------------- torsion-torsion
class AmoebaTorsionTorsionGenerator(object):
    """<AmoebaTorsionTorsionForce> -> AmoebaTorsionTorsionForce
    (forcefield.py:4121); bitorsion search follows TINKER bitors()."""

    def __init__(self):
        self.entries = []       # (slots x5, grid index)
        self.grids = []

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaTorsionTorsionGenerator()
        ff.registerGenerator(gen)
        for tt in element.findall("TorsionTorsion"):
            types = ff._findAtomTypes(tt.attrib, 5)
            if None in types:
                raise OpenMMException(
                    "AmoebaTorsionTorsionGenerator: unknown class in "
                    + str(tt.attrib))
            gen.entries.append((types, int(tt.attrib["grid"])))
        for gnode in element.findall("TorsionTorsionGrid"):
            gidx = int(gnode.attrib["grid"])
            nx = int(gnode.attrib["nx"])
            grid, col = [], []
            for e in gnode.findall("Grid"):
                row = [float(e.attrib["angle1"]),
                       float(e.attrib["angle2"]), float(e.attrib["f"])]
                if "fx" in e.attrib:
                    row += [float(e.attrib["fx"]), float(e.attrib["fy"]),
                            float(e.attrib["fxy"])]
                col.append(row)
                if len(col) == nx:
                    grid.append(col)
                    col = []
            while len(gen.grids) <= gidx:
                gen.grids.append([])
            gen.grids[gidx] = grid

    @staticmethod
    def _chiral_atom(data, sys, atom_b, atom_c, atom_d):
        """Chirality-check atom for the central bitorsion atom
        (forcefield.py:4235)."""
        if len(data.atomBonds[atom_c]) != 4:
            return -1
        others = [x for x in _neighbors(data, atom_c)
                  if x not in (atom_b, atom_d)]
        if len(others) != 2:
            return -1
        e, f = others
        te = data.atomType[data.atoms[e]]
        tf = data.atomType[data.atoms[f]]
        if te != tf:
            try:
                return e if int(te) > int(tf) else f
            except ValueError:
                return e if te > tf else f
        from .. import unit as u
        me = u.strip(sys.getParticleMass(e), u.dalton)
        mf = u.strip(sys.getParticleMass(f), u.dalton)
        if me != mf:
            return e if me > mf else f
        return -1

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        existing = [f for f in sys.getForces()
                    if type(f) is mmforces.AmoebaTorsionTorsionForce]
        force = existing[0] if existing \
            else mmforces.AmoebaTorsionTorsionForce()
        if not existing:
            sys.addForce(force)
        for angle in data.angles:
            ib, ic, idx = angle
            for ia in _neighbors(data, ib):
                if ia in (ic, idx):
                    continue
                for ie in _neighbors(data, idx):
                    if ie in (ic, ib, ia):
                        continue
                    ts = [data.atomType[data.atoms[x]]
                          for x in (ia, ib, ic, idx, ie)]
                    for (slots, gidx) in self.entries:
                        fwd = all(t in s for t, s in zip(ts, slots))
                        rev = all(t in s
                                  for t, s in zip(ts[::-1], slots))
                        if fwd:
                            chiral = self._chiral_atom(data, sys, ib, ic,
                                                       idx)
                            force.addTorsionTorsion(ia, ib, ic, idx, ie,
                                                    chiral, gidx)
                            break
                        elif rev:
                            chiral = self._chiral_atom(data, sys, idx, ic,
                                                       ib)
                            force.addTorsionTorsion(ie, idx, ic, ib, ia,
                                                    chiral, gidx)
                            break
        for (i, grid) in enumerate(self.grids):
            force.setTorsionTorsionGrid(i, grid)


PARSERS["AmoebaTorsionTorsionForce"] = \
    AmoebaTorsionTorsionGenerator.parseElement


# ------------------------------------------------------------------ vdW
class AmoebaVdwGenerator(object):
    """<AmoebaVdwForce> -> AmoebaVdwForce with hydrogen reduction and
    1-2/1-3 exclusions (forcefield.py:4508)."""

    SCALETOL = 1e-5

    def __init__(self, ff, typeName, radiusrule, radiustype, radiussize,
                 epsilonrule, vdw13, vdw14, vdw15):
        self.ff = ff
        self.typeName = typeName
        self.radiusrule = radiusrule
        self.radiustype = radiustype
        self.radiussize = radiussize
        self.epsilonrule = epsilonrule
        self.vdw13Scale = vdw13
        self.vdw14Scale = vdw14
        self.vdw15Scale = vdw15
        self.params = AtomTypeParameters(ff, "AmoebaVdwForce", "Vdw",
                                         ("sigma", "epsilon", "reduction"))

    @staticmethod
    def parseElement(element, ff):
        existing = [g for g in ff._forces
                    if isinstance(g, AmoebaVdwGenerator)]
        if existing:
            gen = existing[0]
        else:
            gen = AmoebaVdwGenerator(
                ff, element.attrib["type"], element.attrib["radiusrule"],
                element.attrib["radiustype"], element.attrib["radiussize"],
                element.attrib["epsilonrule"],
                float(element.attrib["vdw-13-scale"]),
                float(element.attrib["vdw-14-scale"]),
                float(element.attrib["vdw-15-scale"]))
            ff.registerGenerator(gen)
        gen.params.parseDefinitions(element)

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        from . import forcefield as ffmod
        force = mmforces.AmoebaVdwForce()
        sys.addForce(force)
        if self.typeName.upper() != "BUFFERED-14-7":
            raise OpenMMException(
                "AmoebaVdwForce: only BUFFERED-14-7 supported, got "
                + self.typeName)
        force.setSigmaCombiningRule(
            args.get("sigmaCombiningRule", self.radiusrule).upper())
        force.setEpsilonCombiningRule(
            args.get("epsilonCombiningRule", self.epsilonrule).upper())
        force.setCutoffDistance(args.get("vdwCutoff", nonbondedCutoff))
        if "useDispersionCorrection" in args:
            force.setUseDispersionCorrection(
                bool(args["useDispersionCorrection"]))
        if nonbondedMethod is ffmod.PME:
            force.setNonbondedMethod(mmforces.AmoebaVdwForce.CutoffPeriodic)
        sigma_scale = 1.0
        if self.radiustype == "SIGMA":
            sigma_scale = 1.122462048309372
        if self.radiussize == "DIAMETER":
            sigma_scale = 0.5
        from .element import Element
        hydrogen = Element.getBySymbol("H")
        for (i, atom) in enumerate(data.atoms):
            values = self.params.getAtomParameters(atom, data)
            iv = i
            if atom.element is hydrogen and len(data.atomBonds[i]) == 1:
                iv = _neighbors(data, i)[0]
            force.addParticle(iv, values[0] * sigma_scale, values[1],
                              values[2])
        b12 = _bonded12_sets(data, sys)
        for (i, atom) in enumerate(data.atoms):
            excl = set(b12[i])
            if self.vdw13Scale == 0.0:
                for j in b12[i]:
                    excl |= b12[j]
            excl.add(i)
            force.setParticleExclusions(i, sorted(excl))


PARSERS["AmoebaVdwForce"] = AmoebaVdwGenerator.parseElement


# ------------------------------------------------------------ multipole
class AmoebaMultipoleGenerator(object):
    """<AmoebaMultipoleForce> -> AmoebaMultipoleForce: local-frame axis
    assignment (ZThenX/Bisector/... via kz/kx/ky sign conventions),
    covalent maps, polarization groups (forcefield.py:4674)."""

    def __init__(self, ff):
        self.ff = ff
        self.typeMap = {}

    @staticmethod
    def setAxisType(k_indices):
        """Map kz/kx/ky signs to the axis type and strip signs
        (forcefield.py:4691)."""
        while len(k_indices) < 4:
            k_indices.append(0)
        kz, kx, ky = k_indices[1], k_indices[2], k_indices[3]
        F = mmforces.AmoebaMultipoleForce
        axis = F.ZThenX
        if kz == 0:
            axis = F.NoAxisType
        if kz != 0 and kx == 0:
            axis = F.ZOnly
        if kz < 0 or kx < 0:
            axis = F.Bisector
        if kx < 0 and ky < 0:
            axis = F.ZBisect
        if kz < 0 and kx < 0 and ky < 0:
            axis = F.ThreeFold
        k_indices[1] = abs(kz)
        k_indices[2] = abs(kx)
        k_indices[3] = abs(ky)
        return axis

    @staticmethod
    def parseElement(element, ff):
        existing = [g for g in ff._forces
                    if isinstance(g, AmoebaMultipoleGenerator)]
        gen = existing[0] if existing else AmoebaMultipoleGenerator(ff)
        if not existing:
            ff.registerGenerator(gen)
        for atom in element.findall("Multipole"):
            types = ff._findAtomTypes(atom.attrib, 1)
            if None in types:
                raise OpenMMException(
                    "AmoebaMultipoleGenerator: unknown type "
                    + str(atom.attrib))
            k_indices = [int(atom.attrib["type"])]
            for key in ("kz", "kx", "ky"):
                if atom.attrib.get(key):
                    k_indices.append(int(atom.attrib[key]))
            axis = AmoebaMultipoleGenerator.setAxisType(k_indices)
            q = atom.attrib
            quad = [float(q["q11"]), float(q["q21"]), float(q["q31"]),
                    float(q["q21"]), float(q["q22"]), float(q["q32"]),
                    float(q["q31"]), float(q["q32"]), float(q["q33"])]
            rec = {"classIndex": atom.attrib["type"],
                   "kIndices": k_indices,
                   "charge": float(q["c0"]),
                   "dipole": [float(q["d1"]), float(q["d2"]),
                              float(q["d3"])],
                   "quadrupole": quad,
                   "axisType": axis}
            for t in types[0]:
                gen.typeMap.setdefault(t, []).append(rec)
        for atom in element.findall("Polarize"):
            types = ff._findAtomTypes(atom.attrib, 1)
            if None in types:
                raise OpenMMException(
                    "AmoebaMultipoleGenerator: unknown polarize type "
                    + str(atom.attrib))
            class_index = atom.attrib["type"]
            pol = float(atom.attrib["polarizability"])
            thole = float(atom.attrib["thole"])
            pdamp = 0 if thole == 0 else pol ** (1.0 / 6.0)
            pgrp = set()
            for i in range(1, 7):
                key = "pgrp%d" % i
                if key in atom.attrib:
                    pgrp.add(int(atom.attrib[key]))
            for t in types[0]:
                hit = False
                for rec in gen.typeMap.get(t, []):
                    if rec["classIndex"] == class_index:
                        rec["polarizability"] = pol
                        rec["thole"] = thole
                        rec["pdamp"] = pdamp
                        rec["pgrp"] = pgrp
                        hit = True
                if not hit:
                    raise OpenMMException(
                        "AmoebaMultipoleGenerator: Polarize type %s has "
                        "no Multipole entry" % class_index)

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        from . import forcefield as ffmod
        F = mmforces.AmoebaMultipoleForce
        force = F()
        sys.addForce(force)
        if nonbondedMethod is ffmod.PME:
            force.setNonbondedMethod(F.PME)
        elif nonbondedMethod is not ffmod.NoCutoff:
            raise OpenMMException(
                "AmoebaMultipoleForce: method must be NoCutoff or PME")
        force.setCutoffDistance(nonbondedCutoff)
        if "ewaldErrorTolerance" in args:
            force.setEwaldErrorTolerance(float(args["ewaldErrorTolerance"]))
        pol = str(args.get("polarization", "mutual")).lower()
        force.setPolarizationType(
            {"direct": F.Direct, "extrapolated": F.Extrapolated}.get(
                pol, F.Mutual))
        if "aEwald" in args:
            force.setAEwald(float(args["aEwald"]))
        if "pmeGridDimensions" in args:
            force.setPmeGridDimensions(args["pmeGridDimensions"])
        if "mutualInducedMaxIterations" in args:
            force.setMutualInducedMaxIterations(
                int(args["mutualInducedMaxIterations"]))
        if "mutualInducedTargetEpsilon" in args:
            force.setMutualInducedTargetEpsilon(
                float(args["mutualInducedTargetEpsilon"]))

        b12 = _bonded12_sets(data, sys)
        b13, b14, b15 = _shell_sets(b12)

        multipole_rec = [None] * len(data.atoms)
        for (i, atom) in enumerate(data.atoms):
            t = data.atomType[atom]
            if t not in self.typeMap:
                raise OpenMMException(
                    "AmoebaMultipoleGenerator: no multipole type for atom "
                    "%s %s" % (atom.name, atom.residue.name))
            rec, axes = self._assign_frame(data, i, b12[i], b13[i])
            if rec is None:
                raise OpenMMException(
                    "AmoebaMultipoleGenerator: atom %s %s not assigned"
                    % (atom.name, atom.residue.name))
            zaxis, xaxis, yaxis = axes
            multipole_rec[i] = rec
            new_index = force.addMultipole(
                rec["charge"], rec["dipole"], rec["quadrupole"],
                rec["axisType"], zaxis, xaxis, yaxis, rec["thole"],
                rec["pdamp"], rec["polarizability"])
            assert new_index == i
            force.setCovalentMap(i, F.Covalent12, sorted(b12[i]))
            force.setCovalentMap(i, F.Covalent13, sorted(b13[i]))
            force.setCovalentMap(i, F.Covalent14, sorted(b14[i]))
            force.setCovalentMap(i, F.Covalent15, sorted(b15[i]))

        self._set_polar_groups(data, b12, multipole_rec, force)

    def _assign_frame(self, data, i, b12, b13):
        """Four-stage frame assignment: 1-2 partners, then 1-2 + 1-3,
        then z-only, then no axis (forcefield.py:4862)."""
        t = data.atomType[data.atoms[i]]
        recs = self.typeMap[t]

        def typ(j):
            return int(data.atomType[data.atoms[j]])

        # stage 1: z and x (and y) among 1-2 partners
        for rec in recs:
            kz, kx, ky = rec["kIndices"][1:4]
            if kz == 0:
                continue
            for z in sorted(b12):
                if typ(z) != kz:
                    continue
                if kx == 0:
                    continue
                for x in sorted(b12):
                    if x == z or typ(x) != kx:
                        continue
                    if ky == 0:
                        zaxis, xaxis = z, x
                        if typ(x) == typ(z) and xaxis < zaxis:
                            zaxis, xaxis = xaxis, zaxis
                        else:
                            for x2 in sorted(b12):
                                if typ(x2) == kx and x2 != z and x2 < xaxis:
                                    xaxis = x2
                        return rec, (zaxis, xaxis, -1)
                    for y in sorted(b12):
                        if y in (z, x) or typ(y) != ky:
                            continue
                        return rec, (z, x, y)
        # stage 2: z among 1-2, x (and y) among 1-3 bonded to z
        b12_of = self._b12_cache(data)
        for rec in recs:
            kz, kx, ky = rec["kIndices"][1:4]
            if kz == 0:
                continue
            for z in sorted(b12):
                if typ(z) != kz:
                    continue
                for x in sorted(b13):
                    if x == z or typ(x) != kx or z not in b12_of[x]:
                        continue
                    if ky == 0:
                        xaxis = x
                        for x2 in sorted(b13):
                            if typ(x2) == kx and x2 != z \
                                    and z in b12_of[x2] and x2 < xaxis:
                                xaxis = x2
                        return rec, (z, xaxis, -1)
                    for y in sorted(b13):
                        if y in (z, x) or typ(y) != ky \
                                or z not in b12_of[y]:
                            continue
                        return rec, (z, x, y)
        # stage 3: z-only
        for rec in recs:
            kz, kx = rec["kIndices"][1:3]
            if kx != 0 or kz == 0:
                continue
            for z in sorted(b12):
                if typ(z) == kz:
                    return rec, (z, -1, -1)
        # stage 4: no axis
        for rec in recs:
            if rec["kIndices"][1] == 0:
                return rec, (-1, -1, -1)
        return None, (-1, -1, -1)

    def _b12_cache(self, data):
        if not hasattr(data, "_b12_atom_sets"):
            sets = [set() for _ in data.atoms]
            for b in data.bonds:
                sets[b.atom1].add(b.atom2)
                sets[b.atom2].add(b.atom1)
            data._b12_atom_sets = sets
        return data._b12_atom_sets

    def _set_polar_groups(self, data, b12, multipole_rec, force):
        """Flood-fill polarization groups, then build the 11/12/13/14
        shells (forcefield.py:4846 setPolarGroups)."""
        F = mmforces.AmoebaMultipoleForce
        n = len(data.atoms)
        direct = [set([i]) for i in range(n)]
        for i in range(n):
            pgrp = multipole_rec[i].get("pgrp", set())
            for j in b12[i]:
                if int(data.atomType[data.atoms[j]]) in pgrp:
                    direct[i].add(j)
                    direct[j].add(i)
        group_of = [None] * n
        for i in range(n):
            if group_of[i] is not None:
                continue
            group = set()
            frontier = {i}
            while frontier:
                a = frontier.pop()
                if a in group:
                    continue
                group.add(a)
                frontier |= direct[a] - group
            for a in group:
                group_of[a] = group
        g11 = group_of
        g12, g13, g14 = [None] * n, [None] * n, [None] * n
        for i in range(n):
            if g12[i] is not None:
                continue
            s12 = set()
            for a in g11[i]:
                for j in b12[a]:
                    s12 |= g11[j]
            s12 -= g11[i]
            for a in g11[i]:
                g12[a] = s12
        for i in range(n):
            if g13[i] is not None:
                continue
            s13 = set()
            for a in g12[i]:
                for j in b12[a]:
                    s13 |= g11[j]
            s13 -= g12[i]
            s13 -= g11[i]
            for a in g11[i]:
                g13[a] = s13
        for i in range(n):
            if g14[i] is not None:
                continue
            s14 = set()
            for a in g13[i]:
                for j in b12[a]:
                    s14 |= g11[j]
            s14 -= g13[i]
            s14 -= g12[i]
            s14 -= g11[i]
            for a in g11[i]:
                g14[a] = s14
        for i in range(n):
            force.setCovalentMap(i, F.PolarizationCovalent11,
                                 sorted(g11[i]))
            force.setCovalentMap(i, F.PolarizationCovalent12,
                                 sorted(g12[i]))
            force.setCovalentMap(i, F.PolarizationCovalent13,
                                 sorted(g13[i]))
            force.setCovalentMap(i, F.PolarizationCovalent14,
                                 sorted(g14[i]))


PARSERS["AmoebaMultipoleForce"] = AmoebaMultipoleGenerator.parseElement


# -------------------------------------------------------- WCA dispersion
class AmoebaWcaDispersionGenerator(object):
    """<AmoebaWcaDispersionForce> -> AmoebaWcaDispersionForce
    (forcefield.py:5287)."""

    def __init__(self, ff, attrs):
        self.ff = ff
        self.attrs = attrs
        self.params = AtomTypeParameters(ff, "AmoebaWcaDispersionForce",
                                         "WcaDispersion",
                                         ("radius", "epsilon"))

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaWcaDispersionGenerator(
            ff, {k: float(element.attrib[k])
                 for k in ("epso", "epsh", "rmino", "rminh", "awater",
                           "slevy", "dispoff", "shctd")})
        ff.registerGenerator(gen)
        gen.params.parseDefinitions(element)

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff, args):
        existing = [f for f in sys.getForces()
                    if type(f) is mmforces.AmoebaWcaDispersionForce]
        force = existing[0] if existing \
            else mmforces.AmoebaWcaDispersionForce()
        if not existing:
            sys.addForce(force)
        a = self.attrs
        force.setEpso(a["epso"])
        force.setEpsh(a["epsh"])
        force.setRmino(a["rmino"])
        force.setRminh(a["rminh"])
        force.setDispoff(a["dispoff"])
        force.setSlevy(a["slevy"])
        force.setAwater(a["awater"])
        force.setShctd(a["shctd"])
        for atom in data.atoms:
            values = self.params.getAtomParameters(atom, data)
            force.addParticle(values[0], values[1])


PARSERS["AmoebaWcaDispersionForce"] = \
    AmoebaWcaDispersionGenerator.parseElement


# ---------------------------------------------- generalized Kirkwood (GK)
_BONDI_RADII = {0: 0.0, 1: 0.12, 2: 0.14, 5: 0.18, 6: 0.170, 7: 0.155,
                8: 0.152, 9: 0.147, 10: 0.154, 14: 0.210, 15: 0.180,
                16: 0.180, 17: 0.175, 18: 0.188, 34: 0.190, 35: 0.185,
                36: 0.202, 53: 0.198, 54: 0.216}
_BONDI_SCALE = 1.03


class AmoebaGeneralizedKirkwoodGenerator(object):
    """<AmoebaGeneralizedKirkwoodForce> -> AmoebaGeneralizedKirkwoodForce
    (reference forcefield.py:5359-5617: Bondi radii scaled by 1.03, overlap
    scale factor 0.69, charges taken from the multipole force)."""

    def __init__(self, ff, attrs):
        self.ff = ff
        self.attrs = attrs

    @staticmethod
    def parseElement(element, ff):
        gen = AmoebaGeneralizedKirkwoodGenerator(
            ff, {k: float(element.attrib[k])
                 for k in ("solventDielectric", "soluteDielectric",
                           "includeCavityTerm", "probeRadius",
                           "surfaceAreaFactor")})
        ff.registerGenerator(gen)

    def createForce(self, sys, data, nonbondedMethod, nonbondedCutoff,
                    args):
        from . import forcefield as ffmod
        if nonbondedMethod != ffmod.NoCutoff:
            raise ValueError(
                "Only the nonbondedMethod=NoCutoff option is available "
                "for implicit solvent simulations.")
        multipoles = [f for f in sys.getForces()
                      if type(f) is mmforces.AmoebaMultipoleForce]
        if not multipoles:
            raise ValueError(
                "AmoebaGeneralizedKirkwoodForce requires the "
                "AmoebaMultipoleForce section")
        mp = multipoles[0]
        existing = [f for f in sys.getForces()
                    if type(f) is mmforces.AmoebaGeneralizedKirkwoodForce]
        force = existing[0] if existing \
            else mmforces.AmoebaGeneralizedKirkwoodForce()
        if not existing:
            sys.addForce(force)
            force.setSolventDielectric(float(
                args.get("solventDielectric",
                         self.attrs["solventDielectric"])))
            force.setSoluteDielectric(float(
                args.get("soluteDielectric",
                         self.attrs["soluteDielectric"])))
            force.setIncludeCavityTerm(int(
                args.get("includeCavityTerm",
                         self.attrs["includeCavityTerm"])))
        force.setProbeRadius(self.attrs["probeRadius"])
        force.setSurfaceAreaFactor(self.attrs["surfaceAreaFactor"])
        for i, atom in enumerate(data.atoms):
            num = atom.element.atomic_number if atom.element else 0
            if num not in _BONDI_RADII:
                raise ValueError("no Bondi radius for atom %s" % atom)
            charge = mp.getMultipoleParameters(i)[0]
            force.addParticle(charge, _BONDI_RADII[num] * _BONDI_SCALE,
                              0.69)


PARSERS["AmoebaGeneralizedKirkwoodForce"] = \
    AmoebaGeneralizedKirkwoodGenerator.parseElement
