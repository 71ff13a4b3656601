"""XmlSerializer: XML (de)serialization of a System, a Force, an
Integrator or a State.

The port's counterpart of openmm_tpu/serialization.py, with its schema
(after OpenMM's serialization proxies: SystemProxy's tag layout,
NonbondedForceProxy's attributes, StateProxy's fields): for the same
object the two packages write XML that parses to equal element trees, so
each reads what the other wrote. A float is written as repr(float), which
a float64 survives bit for bit.

The tree is built with ElementTree and indented with ET.indent (no
re-parse of the text). The forces whose terms the port keeps as lists of
plain tuples (the System's particles and constraints, NonbondedForce,
the harmonic and torsion forces, GBSAOBCForce) are written from those
lists, not through one Quantity-returning getter a term, and read back
into them. The integrators the JAX package writes but does not read
(AMD, AMDForceGroup, DualAMD, Compound, DrudeNoseHoover, MTS and
MTSLangevin) raise OpenMMException on reading here too.
"""
from __future__ import annotations

import xml.etree.ElementTree as ET

import numpy as np

from . import forces as F
from . import integrators as I
from . import unit as u
from .exceptions import OpenMMException
from .state import State
from .system import (LocalCoordinatesSite, OutOfPlaneSite, System,
                     ThreeParticleAverageSite, TwoParticleAverageSite)
from .tabulated import (Continuous1DFunction, Continuous2DFunction,
                        Continuous3DFunction, Discrete1DFunction,
                        Discrete2DFunction, Discrete3DFunction)
from .vec3 import Vec3
from .version import short_version

_r = repr


def _fmt(x):
    return repr(float(x))


def _bool(x) -> str:
    return str(int(bool(x)))


def _rows(parent, tag, names, rows) -> None:
    """A child `tag` of `parent` for each row of strings, its attributes
    `names`."""
    sub = ET.SubElement
    for row in rows:
        sub(parent, tag, dict(zip(names, row)))


def _attrs(el, tag=None) -> list:
    """The attribute dicts of the children of `el` (or of its child
    `tag`, empty when it has none)."""
    if tag is not None:
        el = el.find(tag)
        if el is None:
            return []
    return [child.attrib for child in el]


def _floats(text) -> list:
    return [float(x) for x in text.split()] if text else []


class XmlSerializer(object):
    @staticmethod
    def serialize(obj) -> str:
        el = _serialize_object(obj)
        el.set("version", el.get("version", "1"))
        el.set("openmmVersion", short_version)
        ET.indent(el, space="\t")
        return '<?xml version="1.0" ?>\n' + ET.tostring(
            el, encoding="unicode") + "\n"

    @staticmethod
    def deserialize(xml):
        return _deserialize_object(ET.fromstring(xml))

    # the reference C++ template API's names
    serializeSystem = serialize
    deserializeSystem = deserialize


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
def _serialize_object(obj):
    if isinstance(obj, System):
        return _ser_system(obj)
    if isinstance(obj, State):
        return _ser_state(obj)
    if isinstance(obj, I.Integrator):
        return _ser_integrator(obj)
    if isinstance(obj, F.Force):
        el = ET.Element("Force")
        _ser_force_into(el, obj)
        return el
    raise OpenMMException("cannot serialize %r" % (obj,))


def _deserialize_object(root):
    tag = root.tag
    if tag == "System":
        return _de_system(root)
    if tag == "State":
        return _de_state(root)
    if tag == "Integrator":
        return _de_integrator(root)
    if tag == "Force":
        return _de_force(root)
    raise OpenMMException("cannot deserialize <%s>" % tag)


# ---------------------------------------------------------------------------
# System (SystemProxy.cpp:47-104)
# ---------------------------------------------------------------------------
def _ser_vsite(p, site) -> None:
    if isinstance(site, TwoParticleAverageSite):
        ET.SubElement(p, "TwoParticleAverageSite",
                      p1=str(site.getParticle(0)), p2=str(site.getParticle(1)),
                      w1=_fmt(site.getWeight(0)), w2=_fmt(site.getWeight(1)))
    elif isinstance(site, ThreeParticleAverageSite):
        ET.SubElement(p, "ThreeParticleAverageSite",
                      p1=str(site.getParticle(0)), p2=str(site.getParticle(1)),
                      p3=str(site.getParticle(2)), w1=_fmt(site.getWeight(0)),
                      w2=_fmt(site.getWeight(1)), w3=_fmt(site.getWeight(2)))
    elif isinstance(site, OutOfPlaneSite):
        ET.SubElement(p, "OutOfPlaneSite",
                      p1=str(site.getParticle(0)), p2=str(site.getParticle(1)),
                      p3=str(site.getParticle(2)),
                      w12=_fmt(site.getWeight12()),
                      w13=_fmt(site.getWeight13()),
                      wc=_fmt(site.getWeightCross()))
    elif isinstance(site, LocalCoordinatesSite):
        lp = site.getLocalPosition()
        sn = ET.SubElement(p, "LocalCoordinatesSite", pos1=_fmt(lp[0]),
                           pos2=_fmt(lp[1]), pos3=_fmt(lp[2]))
        wo, wx, wy = (site.getOriginWeights(), site.getXWeights(),
                      site.getYWeights())
        for j in range(site.getNumParticles()):
            idx = str(j + 1)
            sn.set("p" + idx, str(site.getParticle(j)))
            sn.set("wo" + idx, _fmt(wo[j]))
            sn.set("wx" + idx, _fmt(wx[j]))
            sn.set("wy" + idx, _fmt(wy[j]))


def _ser_system(system):
    el = ET.Element("System")
    el.set("type", "System")
    el.set("version", "1")
    box = ET.SubElement(el, "PeriodicBoxVectors")
    for name, v in zip("ABC", system._box.tolist()):
        ET.SubElement(box, name, x=_fmt(v[0]), y=_fmt(v[1]), z=_fmt(v[2]))
    particles = ET.SubElement(el, "Particles")
    _rows(particles, "Particle", ("mass",), ((_r(m),) for m in
                                              system._masses))
    for i, site in system._vsites.items():
        _ser_vsite(particles[i], site)
    constraints = ET.SubElement(el, "Constraints")
    _rows(constraints, "Constraint", ("p1", "p2", "d"),
          ((str(a), str(b), _r(d)) for a, b, d in system._constraints))
    forces = ET.SubElement(el, "Forces")
    for force in system.getForces():
        _ser_force_into(ET.SubElement(forces, "Force"), force)
    return el


def _de_vsite(child):
    t, g = child.tag, child.get
    if t == "TwoParticleAverageSite":
        return TwoParticleAverageSite(int(g("p1")), int(g("p2")),
                                      float(g("w1")), float(g("w2")))
    if t == "ThreeParticleAverageSite":
        return ThreeParticleAverageSite(
            int(g("p1")), int(g("p2")), int(g("p3")),
            float(g("w1")), float(g("w2")), float(g("w3")))
    if t == "OutOfPlaneSite":
        return OutOfPlaneSite(int(g("p1")), int(g("p2")), int(g("p3")),
                              float(g("w12")), float(g("w13")),
                              float(g("wc")))
    if t == "LocalCoordinatesSite":
        particles, wo, wx, wy = [], [], [], []
        j = 1
        while g("p%d" % j) is not None:
            particles.append(int(g("p%d" % j)))
            wo.append(float(g("wo%d" % j)))
            wx.append(float(g("wx%d" % j)))
            wy.append(float(g("wy%d" % j)))
            j += 1
        return LocalCoordinatesSite(particles, wo, wx, wy, Vec3(
            float(g("pos1")), float(g("pos2")), float(g("pos3"))))
    return None


def _de_system(root):
    system = System()
    box = root.find("PeriodicBoxVectors")
    if box is not None:
        system.setDefaultPeriodicBoxVectors(*(
            Vec3(*(float(box.find(n).get(c)) for c in "xyz"))
            for n in "ABC"))
    particles = root.find("Particles")
    system._masses = [float(p.get("mass")) for p in particles]
    for i, p in enumerate(particles):
        for child in p:
            site = _de_vsite(child)
            if site is not None:
                system.setVirtualSite(i, site)
    system._constraints = [(int(a["p1"]), int(a["p2"]), float(a["d"]))
                           for a in _attrs(root, "Constraints")]
    forces = root.find("Forces")
    if forces is not None:
        for fel in forces:
            system.addForce(_de_force(fel))
    return system


# ---------------------------------------------------------------------------
# Forces
# ---------------------------------------------------------------------------
def _ser_globals(el, force):
    gp = ET.SubElement(el, "GlobalParameters")
    for i in range(force.getNumGlobalParameters()):
        ET.SubElement(gp, "Parameter", name=force.getGlobalParameterName(i),
                      default=_fmt(force.getGlobalParameterDefaultValue(i)))
    dv = ET.SubElement(el, "EnergyParameterDerivatives")
    for i in range(force.getNumEnergyParameterDerivatives()):
        ET.SubElement(dv, "Parameter",
                      name=force.getEnergyParameterDerivativeName(i))


def _de_globals(el, force):
    for a in _attrs(el, "GlobalParameters"):
        force.addGlobalParameter(a["name"], float(a["default"]))
    for a in _attrs(el, "EnergyParameterDerivatives"):
        force.addEnergyParameterDerivative(a["name"])


def _ser_functions(el, force):
    fns = ET.SubElement(el, "Functions")
    for i in range(force.getNumTabulatedFunctions()):
        _ser_tabulated_into(ET.SubElement(
            fns, "Function", name=force.getTabulatedFunctionName(i)),
            force.getTabulatedFunction(i))


def _de_functions(el, force):
    fns = el.find("Functions")
    if fns is not None:
        for fel in fns:
            force.addTabulatedFunction(fel.get("name"), _de_tabulated(fel))


def _values_into(el, values) -> None:
    _rows(ET.SubElement(el, "Values"), "Value", ("v",),
          ((_fmt(v),) for v in values))


def _ser_tabulated_into(el, fn):
    if isinstance(fn, Continuous1DFunction):
        values, mn, mx = fn.getFunctionParameters()
        el.set("type", "Continuous1D")
        el.set("min", _fmt(mn))
        el.set("max", _fmt(mx))
        el.set("periodic", _bool(fn.getPeriodic()))
    elif isinstance(fn, Continuous2DFunction):
        (xs, ys, values, xmin, xmax, ymin, ymax) = fn.getFunctionParameters()
        el.set("type", "Continuous2D")
        for k, v in (("xsize", xs), ("ysize", ys)):
            el.set(k, str(v))
        for k, v in (("xmin", xmin), ("xmax", xmax), ("ymin", ymin),
                     ("ymax", ymax)):
            el.set(k, _fmt(v))
        el.set("periodic", _bool(fn.getPeriodic()))
    elif isinstance(fn, Continuous3DFunction):
        (xs, ys, zs, values, xmin, xmax, ymin, ymax, zmin, zmax) = \
            fn.getFunctionParameters()
        el.set("type", "Continuous3D")
        for k, v in (("xsize", xs), ("ysize", ys), ("zsize", zs)):
            el.set(k, str(v))
        for k, v in (("xmin", xmin), ("xmax", xmax), ("ymin", ymin),
                     ("ymax", ymax), ("zmin", zmin), ("zmax", zmax)):
            el.set(k, _fmt(v))
        el.set("periodic", _bool(fn.getPeriodic()))
    elif isinstance(fn, Discrete1DFunction):
        el.set("type", "Discrete1D")
        values = fn.getFunctionParameters()
    elif isinstance(fn, Discrete2DFunction):
        xs, ys, values = fn.getFunctionParameters()
        el.set("type", "Discrete2D")
        el.set("xsize", str(xs))
        el.set("ysize", str(ys))
    elif isinstance(fn, Discrete3DFunction):
        xs, ys, zs, values = fn.getFunctionParameters()
        el.set("type", "Discrete3D")
        el.set("xsize", str(xs))
        el.set("ysize", str(ys))
        el.set("zsize", str(zs))
    else:
        raise OpenMMException("cannot serialize function %r" % fn)
    _values_into(el, values)


def _de_tabulated(el):
    t, g = el.get("type"), el.get
    values = [float(a["v"]) for a in _attrs(el, "Values")]
    periodic = bool(int(g("periodic", "0")))
    if t == "Continuous1D":
        return Continuous1DFunction(values, float(g("min")), float(g("max")),
                                    periodic)
    if t == "Continuous2D":
        return Continuous2DFunction(
            int(g("xsize")), int(g("ysize")), values, float(g("xmin")),
            float(g("xmax")), float(g("ymin")), float(g("ymax")), periodic)
    if t == "Continuous3D":
        return Continuous3DFunction(
            int(g("xsize")), int(g("ysize")), int(g("zsize")), values,
            float(g("xmin")), float(g("xmax")), float(g("ymin")),
            float(g("ymax")), float(g("zmin")), float(g("zmax")), periodic)
    if t == "Discrete1D":
        return Discrete1DFunction(values)
    if t == "Discrete2D":
        return Discrete2DFunction(int(g("xsize")), int(g("ysize")), values)
    if t == "Discrete3D":
        return Discrete3DFunction(int(g("xsize")), int(g("ysize")),
                                  int(g("zsize")), values)
    raise OpenMMException("unknown function type %s" % t)


def _ser_force_into(el, force):
    name = type(force).__name__
    el.set("type", name)
    el.set("version", "1")
    el.set("forceGroup", str(force.getForceGroup()))
    el.set("name", force.getName())
    fn = _FORCE_SERIALIZERS.get(name)
    if fn is None:
        raise OpenMMException("cannot serialize force type %s" % name)
    fn(el, force)


def _de_force(el):
    name = el.get("type")
    fn = _FORCE_DESERIALIZERS.get(name)
    if fn is None:
        raise OpenMMException("cannot deserialize force type %s" % name)
    force = fn(el)
    force.setForceGroup(int(el.get("forceGroup", "0")))
    if el.get("name"):
        force.setName(el.get("name"))
    return force


def _uses_periodic(el, force) -> None:
    el.set("usesPeriodic", _bool(force.usesPeriodicBoundaryConditions()))


def _read_periodic(el, force, key="usesPeriodic"):
    force.setUsesPeriodicBoundaryConditions(bool(int(el.get(key, "0"))))
    return force


# --- standard bonded: written from and read into the term lists -------------
def _ser_harmonic_bond(el, force):
    _uses_periodic(el, force)
    _rows(ET.SubElement(el, "Bonds"), "Bond", ("p1", "p2", "d", "k"),
          ((str(a), str(b), _r(d), _r(k)) for a, b, d, k in force._bonds))


def _de_harmonic_bond(el):
    force = _read_periodic(el, F.HarmonicBondForce())
    force._bonds = [(int(a["p1"]), int(a["p2"]), float(a["d"]),
                     float(a["k"])) for a in _attrs(el, "Bonds")]
    return force


def _ser_harmonic_angle(el, force):
    _uses_periodic(el, force)
    _rows(ET.SubElement(el, "Angles"), "Angle", ("p1", "p2", "p3", "a", "k"),
          ((str(p1), str(p2), str(p3), _r(a), _r(k))
           for p1, p2, p3, a, k in force._angles))


def _de_harmonic_angle(el):
    force = _read_periodic(el, F.HarmonicAngleForce())
    force._angles = [(int(a["p1"]), int(a["p2"]), int(a["p3"]),
                      float(a["a"]), float(a["k"]))
                     for a in _attrs(el, "Angles")]
    return force


def _ser_periodic_torsion(el, force):
    _uses_periodic(el, force)
    _rows(ET.SubElement(el, "Torsions"), "Torsion",
          ("p1", "p2", "p3", "p4", "periodicity", "phase", "k"),
          ((str(t[0]), str(t[1]), str(t[2]), str(t[3]), str(t[4]), _r(t[5]),
            _r(t[6])) for t in force._torsions))


def _de_periodic_torsion(el):
    force = _read_periodic(el, F.PeriodicTorsionForce())
    force._torsions = [(int(a["p1"]), int(a["p2"]), int(a["p3"]),
                        int(a["p4"]), int(a["periodicity"]),
                        float(a["phase"]), float(a["k"]))
                       for a in _attrs(el, "Torsions")]
    return force


_RB = ("p1", "p2", "p3", "p4", "c0", "c1", "c2", "c3", "c4", "c5")


def _ser_rb_torsion(el, force):
    _uses_periodic(el, force)
    _rows(ET.SubElement(el, "Torsions"), "Torsion", _RB,
          ([str(x) for x in t[:4]] + [_r(x) for x in t[4:]]
           for t in force._torsions))


def _de_rb_torsion(el):
    force = _read_periodic(el, F.RBTorsionForce())
    force._torsions = [tuple(int(a[k]) for k in _RB[:4])
                       + tuple(float(a[k]) for k in _RB[4:])
                       for a in _attrs(el, "Torsions")]
    return force


_CMAP = ("a1", "a2", "a3", "a4", "b1", "b2", "b3", "b4")


def _ser_cmap(el, force):
    _uses_periodic(el, force)
    maps = ET.SubElement(el, "Maps")
    for size, energy in force._maps:
        ET.SubElement(maps, "Map", size=str(size)).text = " ".join(
            _fmt(e) for e in energy)
    _rows(ET.SubElement(el, "Torsions"), "Torsion", ("map",) + _CMAP,
          ([str(x) for x in t] for t in force._torsions))


def _de_cmap(el):
    force = _read_periodic(el, F.CMAPTorsionForce())
    for m in el.find("Maps"):
        force.addMap(int(m.get("size")), _floats(m.text))
    for a in _attrs(el, "Torsions"):
        force.addTorsion(int(a["map"]), *(int(a[k]) for k in _CMAP))
    return force


# --- nonbonded (NonbondedForceProxy.cpp:45-96 schema) -----------------------
def _ser_nonbonded(el, force):
    el.set("method", str(force.getNonbondedMethod()))
    el.set("cutoff", _fmt(force._cutoff))
    el.set("useSwitchingFunction", _bool(force.getUseSwitchingFunction()))
    el.set("switchingDistance", _fmt(force._switch_dist))
    el.set("ewaldTolerance", _fmt(force.getEwaldErrorTolerance()))
    el.set("rfDielectric", _fmt(force.getReactionFieldDielectric()))
    el.set("dispersionCorrection", _bool(force.getUseDispersionCorrection()))
    el.set("exceptionsUsePeriodic",
           _bool(force.getExceptionsUsePeriodicBoundaryConditions()))
    el.set("includeDirectSpace", _bool(force.getIncludeDirectSpace()))
    for prefix, (alpha, grid) in (("", (force._alpha, force._grid)),
                                  ("lj", (force._lj_alpha, force._lj_grid))):
        el.set("ljAlpha" if prefix else "alpha", _fmt(alpha))
        for axis, n in zip("xyz", grid):
            el.set(prefix + "n" + axis, str(n))
    el.set("recipForceGroup", str(force.getReciprocalSpaceForceGroup()))
    _rows(ET.SubElement(el, "GlobalParameters"), "Parameter",
          ("name", "default"),
          ((name, _fmt(v)) for name, v in force._global_params))
    _rows(ET.SubElement(el, "ParticleOffsets"), "Offset",
          ("parameter", "particle", "q", "sig", "eps"),
          ((o[0], str(o[1]), _fmt(o[2]), _fmt(o[3]), _fmt(o[4]))
           for o in force._particle_offsets))
    _rows(ET.SubElement(el, "ExceptionOffsets"), "Offset",
          ("parameter", "exception", "q", "sig", "eps"),
          ((o[0], str(o[1]), _fmt(o[2]), _fmt(o[3]), _fmt(o[4]))
           for o in force._exception_offsets))
    _rows(ET.SubElement(el, "Particles"), "Particle", ("q", "sig", "eps"),
          ((_r(q), _r(s), _r(e)) for q, s, e in force._particles))
    _rows(ET.SubElement(el, "Exceptions"), "Exception",
          ("p1", "p2", "q", "sig", "eps"),
          ((str(a), str(b), _r(q), _r(s), _r(e))
           for a, b, q, s, e in force._exceptions))


def _de_nonbonded(el):
    force = F.NonbondedForce()
    g = el.get
    force.setNonbondedMethod(int(g("method")))
    force.setCutoffDistance(float(g("cutoff")))
    force.setUseSwitchingFunction(bool(int(g("useSwitchingFunction", "0"))))
    force.setSwitchingDistance(float(g("switchingDistance", "-1")))
    force.setEwaldErrorTolerance(float(g("ewaldTolerance", "5e-4")))
    force.setReactionFieldDielectric(float(g("rfDielectric", "78.3")))
    force.setUseDispersionCorrection(bool(int(g("dispersionCorrection", "1"))))
    force.setExceptionsUsePeriodicBoundaryConditions(
        bool(int(g("exceptionsUsePeriodic", "0"))))
    force.setIncludeDirectSpace(bool(int(g("includeDirectSpace", "1"))))
    force.setPMEParameters(float(g("alpha", "0")), int(g("nx", "0")),
                           int(g("ny", "0")), int(g("nz", "0")))
    force.setLJPMEParameters(float(g("ljAlpha", "0")), int(g("ljnx", "0")),
                             int(g("ljny", "0")), int(g("ljnz", "0")))
    force.setReciprocalSpaceForceGroup(int(g("recipForceGroup", "-1")))
    for a in _attrs(el, "GlobalParameters"):
        force.addGlobalParameter(a["name"], float(a["default"]))
    force._particles = [(float(a["q"]), float(a["sig"]), float(a["eps"]))
                        for a in _attrs(el, "Particles")]
    for a in _attrs(el, "Exceptions"):
        force.addException(int(a["p1"]), int(a["p2"]), float(a["q"]),
                           float(a["sig"]), float(a["eps"]))
    for a in _attrs(el, "ParticleOffsets"):
        force.addParticleParameterOffset(
            a["parameter"], int(a["particle"]), float(a["q"]),
            float(a["sig"]), float(a["eps"]))
    for a in _attrs(el, "ExceptionOffsets"):
        force.addExceptionParameterOffset(
            a["parameter"], int(a["exception"]), float(a["q"]),
            float(a["sig"]), float(a["eps"]))
    return force


# --- GBSA, misc ---------------------------------------------------------------
def _ser_gbsa(el, force):
    el.set("method", str(force.getNonbondedMethod()))
    el.set("cutoff", _fmt(force._cutoff))
    el.set("soluteDielectric", _fmt(force.getSoluteDielectric()))
    el.set("solventDielectric", _fmt(force.getSolventDielectric()))
    el.set("surfaceAreaEnergy", _fmt(force._surface_energy))
    _rows(ET.SubElement(el, "Particles"), "Particle", ("q", "r", "scale"),
          ((_r(q), _r(r), _r(s)) for q, r, s in force._particles))


def _de_gbsa(el):
    force = F.GBSAOBCForce()
    g = el.get
    force.setNonbondedMethod(int(g("method", "0")))
    force.setCutoffDistance(float(g("cutoff", "1")))
    force.setSoluteDielectric(float(g("soluteDielectric", "1")))
    force.setSolventDielectric(float(g("solventDielectric", "78.3")))
    force.setSurfaceAreaEnergy(float(g("surfaceAreaEnergy", "2.25936")))
    force._particles = [(float(a["q"]), float(a["r"]), float(a["scale"]))
                        for a in _attrs(el, "Particles")]
    return force


def _ser_cmm(el, force):
    el.set("frequency", str(force.getFrequency()))


def _de_cmm(el):
    return F.CMMotionRemover(int(el.get("frequency", "1")))


def _ser_andersen(el, force):
    el.set("temperature", _fmt(u.plain(force.getDefaultTemperature())))
    el.set("frequency", _fmt(u.plain(force.getDefaultCollisionFrequency())))
    el.set("randomSeed", str(force.getRandomNumberSeed()))


def _de_andersen(el):
    force = F.AndersenThermostat(float(el.get("temperature")),
                                 float(el.get("frequency")))
    force.setRandomNumberSeed(int(el.get("randomSeed", "0")))
    return force


def _ser_mc_barostat(el, force):
    el.set("pressure", _fmt(u.plain(force.getDefaultPressure())))
    el.set("temperature", _fmt(u.plain(force.getDefaultTemperature())))
    el.set("frequency", str(force.getFrequency()))
    el.set("randomSeed", str(force.getRandomNumberSeed()))


def _de_mc_barostat(el):
    force = F.MonteCarloBarostat(float(el.get("pressure")),
                                 float(el.get("temperature")),
                                 int(el.get("frequency", "25")))
    force.setRandomNumberSeed(int(el.get("randomSeed", "0")))
    return force


def _ser_rmsd(el, force):
    _rows(ET.SubElement(el, "Particles"), "Particle", ("index",),
          ((str(p),) for p in force.getParticles()))
    _rows(ET.SubElement(el, "ReferencePositions"), "Position",
          ("x", "y", "z"), ((_fmt(r[0]), _fmt(r[1]), _fmt(r[2]))
                            for r in u.plain(force.getReferencePositions())))


def _de_rmsd(el):
    refs = [Vec3(float(a["x"]), float(a["y"]), float(a["z"]))
            for a in _attrs(el, "ReferencePositions")]
    return F.RMSDForce(refs, [int(a["index"]) for a in _attrs(el,
                                                              "Particles")])


# --- custom forces ------------------------------------------------------------
def _params_text(params) -> str:
    return " ".join(_fmt(x) for x in params)


def _ser_custom_bonded(el, force, per_names, terms):
    el.set("energy", force.getEnergyFunction())
    _uses_periodic(el, force)
    _ser_globals(el, force)
    _ser_functions(el, force)
    pp = ET.SubElement(el, "PerTermParameters")
    for name in per_names:
        ET.SubElement(pp, "Parameter", name=name)
    sub = ET.SubElement
    tel = ET.SubElement(el, "Terms")
    for atoms, params in terms:
        t = sub(tel, "Term")
        for j, a in enumerate(atoms):
            t.set("p%d" % (j + 1), str(a))
        t.set("params", _params_text(params))


def _de_custom_terms(el, force, add_per, add_term, n_atoms):
    _read_periodic(el, force)
    _de_globals(el, force)
    _de_functions(el, force)
    for a in _attrs(el, "PerTermParameters"):
        add_per(a["name"])
    for a in _attrs(el, "Terms"):
        add_term([int(a["p%d" % (k + 1)]) for k in range(n_atoms)],
                 _floats(a.get("params")))
    return force


def _ser_custom_bond(el, force):
    _ser_custom_bonded(el, force, force._per_term, force._terms)


def _de_custom_bond(el):
    force = F.CustomBondForce(el.get("energy"))
    return _de_custom_terms(el, force, force.addPerBondParameter,
                            lambda a, p: force.addBond(*a, p), 2)


def _ser_custom_angle(el, force):
    _ser_custom_bonded(el, force, force._per_term, force._terms)


def _de_custom_angle(el):
    force = F.CustomAngleForce(el.get("energy"))
    return _de_custom_terms(el, force, force.addPerAngleParameter,
                            lambda a, p: force.addAngle(*a, p), 3)


def _ser_custom_torsion(el, force):
    _ser_custom_bonded(el, force, force._per_term, force._terms)


def _de_custom_torsion(el):
    force = F.CustomTorsionForce(el.get("energy"))
    return _de_custom_terms(el, force, force.addPerTorsionParameter,
                            lambda a, p: force.addTorsion(*a, p), 4)


def _ser_custom_compound(el, force):
    el.set("particles", str(force.getNumParticlesPerBond()))
    _ser_custom_bonded(el, force, force._per_term, force._terms)


def _de_custom_compound(el):
    n = int(el.get("particles"))
    force = F.CustomCompoundBondForce(n, el.get("energy"))
    return _de_custom_terms(el, force, force.addPerBondParameter,
                            force.addBond, n)


def _ser_custom_external(el, force):
    el.set("energy", force.getEnergyFunction())
    _ser_globals(el, force)
    _ser_functions(el, force)
    pp = ET.SubElement(el, "PerTermParameters")
    for name in force._per_particle:
        ET.SubElement(pp, "Parameter", name=name)
    _rows(ET.SubElement(el, "Terms"), "Term", ("p1", "params"),
          ((str(p), _params_text(params)) for p, params in force._terms))


def _de_custom_external(el):
    force = F.CustomExternalForce(el.get("energy"))
    _de_globals(el, force)
    _de_functions(el, force)
    for a in _attrs(el, "PerTermParameters"):
        force.addPerParticleParameter(a["name"])
    for a in _attrs(el, "Terms"):
        force.addParticle(int(a["p1"]), _floats(a.get("params")))
    return force


def _ser_per_particle(el, force, tag="PerParticleParameters"):
    pp = ET.SubElement(el, tag)
    for name in force._per_particle:
        ET.SubElement(pp, "Parameter", name=name)


def _ser_exclusions(el, pairs, names=("p1", "p2")):
    _rows(ET.SubElement(el, "Exclusions"), "Exclusion", names,
          ((str(a), str(b)) for a, b in pairs))


def _ser_custom_nonbonded(el, force):
    el.set("energy", force.getEnergyFunction())
    el.set("method", str(force.getNonbondedMethod()))
    el.set("cutoff", _fmt(force._cutoff))
    el.set("useSwitchingFunction", _bool(force.getUseSwitchingFunction()))
    el.set("switchingDistance", _fmt(force._switch_dist))
    el.set("useLongRangeCorrection", _bool(force.getUseLongRangeCorrection()))
    _ser_globals(el, force)
    _ser_functions(el, force)
    _ser_per_particle(el, force)
    _rows(ET.SubElement(el, "Particles"), "Particle", ("params",),
          ((_params_text(p),) for p in force._particles))
    _ser_exclusions(el, force._exclusions)
    groups = ET.SubElement(el, "InteractionGroups")
    for set1, set2 in force._groups:
        g = ET.SubElement(groups, "InteractionGroup")
        ET.SubElement(g, "Set1", indices=" ".join(str(x) for x in set1))
        ET.SubElement(g, "Set2", indices=" ".join(str(x) for x in set2))


def _de_pair_method(el, force):
    force.setNonbondedMethod(int(el.get("method", "0")))
    force.setCutoffDistance(float(el.get("cutoff", "1")))


def _de_exclusions(el, force, names=("p1", "p2")):
    for a in _attrs(el, "Exclusions"):
        force.addExclusion(int(a[names[0]]), int(a[names[1]]))


def _de_custom_nonbonded(el):
    force = F.CustomNonbondedForce(el.get("energy"))
    _de_pair_method(el, force)
    force.setUseSwitchingFunction(
        bool(int(el.get("useSwitchingFunction", "0"))))
    force.setSwitchingDistance(float(el.get("switchingDistance", "-1")))
    force.setUseLongRangeCorrection(
        bool(int(el.get("useLongRangeCorrection", "0"))))
    _de_globals(el, force)
    _de_functions(el, force)
    for a in _attrs(el, "PerParticleParameters"):
        force.addPerParticleParameter(a["name"])
    for a in _attrs(el, "Particles"):
        force.addParticle(_floats(a.get("params")))
    _de_exclusions(el, force)
    groups = el.find("InteractionGroups")
    for g in (groups if groups is not None else ()):
        force.addInteractionGroup(
            [int(x) for x in g.find("Set1").get("indices").split()],
            [int(x) for x in g.find("Set2").get("indices").split()])
    return force


def _ser_custom_centroid(el, force):
    el.set("groupsPerBond", str(force.getNumGroupsPerBond()))
    el.set("energy", force.getEnergyFunction())
    _uses_periodic(el, force)
    _ser_globals(el, force)
    _ser_functions(el, force)
    pp = ET.SubElement(el, "PerTermParameters")
    for name in force._per_term:
        ET.SubElement(pp, "Parameter", name=name)
    groups = ET.SubElement(el, "Groups")
    for i in range(force.getNumGroups()):
        particles, weights = force.getGroupParameters(i)
        ET.SubElement(groups, "Group",
                      particles=" ".join(str(x) for x in particles),
                      weights=" ".join(_fmt(w) for w in weights))
    _rows(ET.SubElement(el, "Terms"), "Term", ("groups", "params"),
          ((" ".join(str(x) for x in g), _params_text(p))
           for g, p in force._terms))


def _de_custom_centroid(el):
    n = int(el.get("groupsPerBond"))
    force = F.CustomCentroidBondForce(n, el.get("energy"))
    _read_periodic(el, force)
    _de_globals(el, force)
    _de_functions(el, force)
    for a in _attrs(el, "PerTermParameters"):
        force.addPerBondParameter(a["name"])
    for a in _attrs(el, "Groups"):
        force.addGroup([int(x) for x in a["particles"].split()],
                       _floats(a.get("weights")) or None)
    for a in _attrs(el, "Terms"):
        force.addBond([int(x) for x in a["groups"].split()],
                      _floats(a.get("params")))
    return force


def _ser_custom_gb(el, force):
    el.set("method", str(force.getNonbondedMethod()))
    el.set("cutoff", _fmt(force._cutoff))
    _ser_globals(el, force)
    _ser_functions(el, force)
    _ser_per_particle(el, force)
    _rows(ET.SubElement(el, "ComputedValues"), "Value",
          ("name", "expression", "type"),
          ((name, expr, str(t)) for name, expr, t in force._values))
    _rows(ET.SubElement(el, "EnergyTerms"), "Term", ("expression", "type"),
          ((expr, str(t)) for expr, t in force._energy_terms))
    _rows(ET.SubElement(el, "Particles"), "Particle", ("params",),
          ((_params_text(p),) for p in force._particles))
    _ser_exclusions(el, force._exclusions)


def _de_custom_gb(el):
    force = F.CustomGBForce()
    _de_pair_method(el, force)
    _de_globals(el, force)
    _de_functions(el, force)
    for a in _attrs(el, "PerParticleParameters"):
        force.addPerParticleParameter(a["name"])
    for a in _attrs(el, "ComputedValues"):
        force.addComputedValue(a["name"], a["expression"], int(a["type"]))
    for a in _attrs(el, "EnergyTerms"):
        force.addEnergyTerm(a["expression"], int(a["type"]))
    for a in _attrs(el, "Particles"):
        force.addParticle(_floats(a.get("params")))
    _de_exclusions(el, force)
    return force


def _ser_gayberne(el, force):
    el.set("method", str(force.getNonbondedMethod()))
    el.set("cutoff", _fmt(force._cutoff))
    el.set("useSwitchingFunction", _bool(force.getUseSwitchingFunction()))
    el.set("switchingDistance", _fmt(force._switch_dist))
    _rows(ET.SubElement(el, "Particles"), "Particle",
          ("sigma", "epsilon", "xparticle", "yparticle", "sx", "sy", "sz",
           "ex", "ey", "ez"),
          ((_fmt(p[0]), _fmt(p[1]), str(p[2]), str(p[3]))
           + tuple(_fmt(x) for x in p[4:10])
           for p in (u.plain(force.getParticleParameters(i))
                     for i in range(force.getNumParticles()))))
    _rows(ET.SubElement(el, "Exceptions"), "Exception",
          ("p1", "p2", "sigma", "epsilon"),
          ((str(a), str(b), _fmt(s), _fmt(e))
           for a, b, s, e in force._exceptions))


def _de_gayberne(el):
    force = F.GayBerneForce()
    _de_pair_method(el, force)
    force.setUseSwitchingFunction(
        bool(int(el.get("useSwitchingFunction", "0"))))
    force.setSwitchingDistance(float(el.get("switchingDistance", "-1")))
    for a in _attrs(el, "Particles"):
        force.addParticle(float(a["sigma"]), float(a["epsilon"]),
                          int(a["xparticle"]), int(a["yparticle"]),
                          *(float(a[k]) for k in ("sx", "sy", "sz", "ex",
                                                  "ey", "ez")))
    for a in _attrs(el, "Exceptions"):
        force.addException(int(a["p1"]), int(a["p2"]), float(a["sigma"]),
                           float(a["epsilon"]))
    return force


def _ser_drude(el, force):
    _rows(ET.SubElement(el, "Particles"), "Particle",
          ("particle", "particle1", "particle2", "particle3", "particle4",
           "charge", "polarizability", "aniso12", "aniso34"),
          (tuple(str(x) for x in p[:5]) + tuple(_fmt(x) for x in p[5:9])
           for p in force._particles))
    _rows(ET.SubElement(el, "ScreenedPairs"), "Pair",
          ("particle1", "particle2", "thole"),
          ((str(a), str(b), _fmt(t)) for a, b, t in force._screened_pairs))


def _de_drude(el):
    force = F.DrudeForce()
    for a in _attrs(el, "Particles"):
        force.addParticle(*(int(a[k]) for k in (
            "particle", "particle1", "particle2", "particle3", "particle4")),
            *(float(a[k]) for k in ("charge", "polarizability", "aniso12",
                                    "aniso34")))
    for a in _attrs(el, "ScreenedPairs"):
        force.addScreenedPair(int(a["particle1"]), int(a["particle2"]),
                              float(a["thole"]))
    return force


def _ser_custom_hbond(el, force):
    el.set("energy", force.getEnergyFunction())
    el.set("method", str(force.getNonbondedMethod()))
    el.set("cutoff", _fmt(force._cutoff))
    _ser_globals(el, force)
    _ser_functions(el, force)
    for tag, names in (("PerDonorParameters", force._per_donor),
                       ("PerAcceptorParameters", force._per_acceptor)):
        pel = ET.SubElement(el, tag)
        for name in names:
            ET.SubElement(pel, "Parameter", name=name)
    for tag, child, prefix, items in (
            ("Donors", "Donor", "d", force._donors),
            ("Acceptors", "Acceptor", "a", force._acceptors)):
        _rows(ET.SubElement(el, tag), child,
              (prefix + "1", prefix + "2", prefix + "3", "params"),
              ((str(x[0]), str(x[1]), str(x[2]), _params_text(p))
               for x, p in items))
    _ser_exclusions(el, force._exclusions, ("donor", "acceptor"))


def _de_custom_hbond(el):
    force = F.CustomHbondForce(el.get("energy"))
    _de_pair_method(el, force)
    _de_globals(el, force)
    _de_functions(el, force)
    for a in _attrs(el, "PerDonorParameters"):
        force.addPerDonorParameter(a["name"])
    for a in _attrs(el, "PerAcceptorParameters"):
        force.addPerAcceptorParameter(a["name"])
    for a in _attrs(el, "Donors"):
        force.addDonor(int(a["d1"]), int(a["d2"]), int(a["d3"]),
                       _floats(a.get("params")))
    for a in _attrs(el, "Acceptors"):
        force.addAcceptor(int(a["a1"]), int(a["a2"]), int(a["a3"]),
                          _floats(a.get("params")))
    _de_exclusions(el, force, ("donor", "acceptor"))
    return force


def _ser_custom_manyparticle(el, force):
    el.set("energy", force.getEnergyFunction())
    el.set("particlesPerSet", str(force.getNumParticlesPerSet()))
    el.set("method", str(force.getNonbondedMethod()))
    el.set("permutationMode", str(force.getPermutationMode()))
    el.set("cutoff", _fmt(force._cutoff))
    _ser_globals(el, force)
    _ser_functions(el, force)
    _ser_per_particle(el, force)
    _rows(ET.SubElement(el, "Particles"), "Particle", ("type", "params"),
          ((str(t), _params_text(p)) for p, t in force._particles))
    _rows(ET.SubElement(el, "TypeFilters"), "Filter", ("index", "types"),
          ((str(i), " ".join(str(t) for t in force.getTypeFilter(i)))
           for i in range(force.getNumParticlesPerSet())))
    _ser_exclusions(el, force._exclusions)


def _de_custom_manyparticle(el):
    force = F.CustomManyParticleForce(int(el.get("particlesPerSet")),
                                      el.get("energy"))
    force.setPermutationMode(int(el.get("permutationMode", "0")))
    _de_pair_method(el, force)
    _de_globals(el, force)
    _de_functions(el, force)
    for a in _attrs(el, "PerParticleParameters"):
        force.addPerParticleParameter(a["name"])
    for a in _attrs(el, "Particles"):
        force.addParticle(_floats(a.get("params")), int(a.get("type", "0")))
    for a in _attrs(el, "TypeFilters"):
        types = [int(t) for t in a.get("types", "").split()]
        if types:
            force.setTypeFilter(int(a["index"]), types)
    _de_exclusions(el, force)
    return force


def _ser_custom_cv(el, force):
    el.set("energy", force.getEnergyFunction())
    _ser_globals(el, force)
    _ser_functions(el, force)
    cvs = ET.SubElement(el, "CollectiveVariables")
    for name, variable in force._cvs:
        cel = ET.SubElement(cvs, "Variable", name=name)
        _ser_force_into(ET.SubElement(cel, "Force"), variable)


def _de_custom_cv(el):
    force = F.CustomCVForce(el.get("energy"))
    _de_globals(el, force)
    _de_functions(el, force)
    cvs = el.find("CollectiveVariables")
    for cel in (cvs if cvs is not None else ()):
        force.addCollectiveVariable(cel.get("name"),
                                    _de_force(cel.find("Force")))
    return force


# --- anisotropic, membrane and RPMD barostats --------------------------------
def _ser_aniso_barostat(el, force):
    for axis, p in zip("XYZ", u.plain(force.getDefaultPressure())):
        el.set("pressure" + axis, _fmt(p))
    el.set("temperature", _fmt(u.plain(force.getDefaultTemperature())))
    el.set("scaleX", _bool(force.getScaleX()))
    el.set("scaleY", _bool(force.getScaleY()))
    el.set("scaleZ", _bool(force.getScaleZ()))
    el.set("frequency", str(force.getFrequency()))
    el.set("randomSeed", str(force.getRandomNumberSeed()))


def _de_aniso_barostat(el):
    g = el.get
    force = F.MonteCarloAnisotropicBarostat(
        [float(g("pressureX")), float(g("pressureY")), float(g("pressureZ"))],
        float(g("temperature")), bool(int(g("scaleX", "1"))),
        bool(int(g("scaleY", "1"))), bool(int(g("scaleZ", "1"))),
        int(g("frequency", "25")))
    force.setRandomNumberSeed(int(g("randomSeed", "0")))
    return force


def _ser_membrane_barostat(el, force):
    el.set("pressure", _fmt(u.plain(force.getDefaultPressure())))
    el.set("surfaceTension", _fmt(u.plain(force.getDefaultSurfaceTension())))
    el.set("temperature", _fmt(u.plain(force.getDefaultTemperature())))
    el.set("xymode", str(force.getXYMode()))
    el.set("zmode", str(force.getZMode()))
    el.set("frequency", str(force.getFrequency()))
    el.set("randomSeed", str(force.getRandomNumberSeed()))


def _de_membrane_barostat(el):
    g = el.get
    force = F.MonteCarloMembraneBarostat(
        float(g("pressure")), float(g("surfaceTension")),
        float(g("temperature")), int(g("xymode", "0")), int(g("zmode", "0")),
        int(g("frequency", "25")))
    force.setRandomNumberSeed(int(g("randomSeed", "0")))
    return force


def _ser_rpmd_barostat(el, force):
    el.set("pressure", _fmt(u.strip(force.getDefaultPressure(), u.bar)))
    el.set("frequency", str(force.getFrequency()))
    el.set("randomSeed", str(force.getRandomNumberSeed()))


def _de_rpmd_barostat(el):
    force = F.RPMDMonteCarloBarostat(float(el.get("pressure")),
                                     int(el.get("frequency", "25")))
    force.setRandomNumberSeed(int(el.get("randomSeed", "0")))
    return force


# --- AMOEBA plugin proxies --------------------------------------------------
def _ser_amoeba_vdw(el, force):
    el.set("method", str(force.getNonbondedMethod()))
    el.set("cutoff", _fmt(u.strip(force.getCutoffDistance())))
    el.set("sigmaCombiningRule", force.getSigmaCombiningRule())
    el.set("epsilonCombiningRule", force.getEpsilonCombiningRule())
    el.set("useDispersionCorrection",
           _bool(force.getUseDispersionCorrection()))
    particles = ET.SubElement(el, "Particles")
    for i in range(force.getNumParticles()):
        parent, sigma, eps, red = u.plain(force.getParticleParameters(i))
        ET.SubElement(particles, "Particle", parent=str(parent),
                      sigma=_fmt(sigma), epsilon=_fmt(eps),
                      reduction=_fmt(red)).set(
            "exclusions", " ".join(str(x)
                                   for x in force.getParticleExclusions(i)))


def _de_amoeba_vdw(el):
    force = F.AmoebaVdwForce()
    _de_pair_method(el, force)
    force.setSigmaCombiningRule(el.get("sigmaCombiningRule", "CUBIC-MEAN"))
    force.setEpsilonCombiningRule(el.get("epsilonCombiningRule", "HHG"))
    force.setUseDispersionCorrection(
        bool(int(el.get("useDispersionCorrection", "0"))))
    for i, a in enumerate(_attrs(el, "Particles")):
        force.addParticle(int(a["parent"]), float(a["sigma"]),
                          float(a["epsilon"]), float(a["reduction"]))
        if a.get("exclusions"):
            force.setParticleExclusions(
                i, [int(x) for x in a["exclusions"].split()])
    return force


def _ser_amoeba_multipole(el, force):
    el.set("method", str(force.getNonbondedMethod()))
    el.set("cutoff", _fmt(u.strip(force.getCutoffDistance())))
    el.set("polarizationType", str(force.getPolarizationType()))
    el.set("mutualInducedMaxIterations",
           str(force.getMutualInducedMaxIterations()))
    el.set("mutualInducedTargetEpsilon",
           _fmt(force.getMutualInducedTargetEpsilon()))
    el.set("extrapolationCoefficients", _params_text(
        force.getExtrapolationCoefficients()))
    particles = ET.SubElement(el, "Particles")
    for i in range(force.getNumMultipoles()):
        (q, dip, quad, axis, az, ax, ay, thole, damp,
         pol) = u.plain(force.getMultipoleParameters(i))
        pel = ET.SubElement(particles, "Particle", charge=_fmt(q),
                            dipole=_params_text(dip),
                            quadrupole=_params_text(quad),
                            axisType=str(axis), atomZ=str(az), atomX=str(ax),
                            atomY=str(ay), thole=_fmt(thole), damp=_fmt(damp),
                            polarity=_fmt(pol))
        for tid, atoms in sorted(force._covalent[i].items()):
            ET.SubElement(pel, "Covalent", type=str(tid),
                          atoms=" ".join(str(x) for x in atoms))


def _de_amoeba_multipole(el):
    force = F.AmoebaMultipoleForce()
    _de_pair_method(el, force)
    force.setPolarizationType(int(el.get("polarizationType", "0")))
    force.setMutualInducedMaxIterations(
        int(el.get("mutualInducedMaxIterations", "60")))
    force.setMutualInducedTargetEpsilon(
        float(el.get("mutualInducedTargetEpsilon", "1e-5")))
    if el.get("extrapolationCoefficients"):
        force.setExtrapolationCoefficients(
            _floats(el.get("extrapolationCoefficients")))
    for i, pel in enumerate(el.find("Particles")):
        a = pel.attrib
        force.addMultipole(
            float(a["charge"]), _floats(a["dipole"]),
            _floats(a["quadrupole"]), int(a["axisType"]), int(a["atomZ"]),
            int(a["atomX"]), int(a["atomY"]), float(a["thole"]),
            float(a["damp"]), float(a["polarity"]))
        for cel in pel:
            force.setCovalentMap(i, int(cel.get("type")),
                                 [int(x) for x in cel.get("atoms").split()])
    return force


def _ser_amoeba_torsiontorsion(el, force):
    el.set("periodic", _bool(force.usesPeriodicBoundaryConditions()))
    _rows(ET.SubElement(el, "TorsionTorsions"), "TorsionTorsion",
          ("p1", "p2", "p3", "p4", "p5", "chiral", "grid"),
          ([str(x) for x in force.getTorsionTorsionParameters(i)]
           for i in range(force.getNumTorsionTorsions())))
    grids = ET.SubElement(el, "Grids")
    for i in range(force.getNumTorsionTorsionGrids()):
        g = np.asarray(force.getTorsionTorsionGrid(i), np.float64)
        ET.SubElement(grids, "Grid", nx=str(g.shape[0]), ny=str(g.shape[1]),
                      nv=str(g.shape[2])).text = _params_text(g.ravel())


def _de_amoeba_torsiontorsion(el):
    force = _read_periodic(el, F.AmoebaTorsionTorsionForce(), "periodic")
    for a in _attrs(el, "TorsionTorsions"):
        force.addTorsionTorsion(*(int(a[k]) for k in (
            "p1", "p2", "p3", "p4", "p5", "chiral", "grid")))
    for i, gel in enumerate(el.find("Grids")):
        shape = (int(gel.get("nx")), int(gel.get("ny")), int(gel.get("nv")))
        force.setTorsionTorsionGrid(
            i, np.asarray(_floats(gel.text)).reshape(shape))
    return force


_WCA = (("epso", "Epso"), ("epsh", "Epsh"), ("rmino", "Rmino"),
        ("rminh", "Rminh"), ("awater", "Awater"), ("slevy", "Slevy"),
        ("shctd", "Shctd"), ("dispoff", "Dispoff"))


def _ser_amoeba_wca(el, force):
    for attr, name in _WCA:
        el.set(attr, _fmt(getattr(force, "get" + name)()))
    _rows(ET.SubElement(el, "Particles"), "Particle", ("radius", "epsilon"),
          ((_fmt(u.strip(r)), _fmt(u.strip(e))) for r, e in (
              force.getParticleParameters(i)
              for i in range(force.getNumParticles()))))


def _de_amoeba_wca(el):
    force = F.AmoebaWcaDispersionForce()
    for attr, name in _WCA:
        if el.get(attr) is not None:
            getattr(force, "set" + name)(float(el.get(attr)))
    for a in _attrs(el, "Particles"):
        force.addParticle(float(a["radius"]), float(a["epsilon"]))
    return force


def _ser_amoeba_gk(el, force):
    el.set("solventDielectric", _fmt(force.getSolventDielectric()))
    el.set("soluteDielectric", _fmt(force.getSoluteDielectric()))
    el.set("includeCavityTerm", str(force.getIncludeCavityTerm()))
    el.set("probeRadius", _fmt(u.strip(force.getProbeRadius())))
    el.set("surfaceAreaFactor", _fmt(force.getSurfaceAreaFactor()))
    _rows(ET.SubElement(el, "Particles"), "Particle",
          ("charge", "radius", "scaleFactor"),
          ((_fmt(u.strip(c)), _fmt(u.strip(r)), _fmt(sf)) for c, r, sf in (
              force.getParticleParameters(i)
              for i in range(force.getNumParticles()))))


def _de_amoeba_gk(el):
    force = F.AmoebaGeneralizedKirkwoodForce()
    g = el.get
    force.setSolventDielectric(float(g("solventDielectric", "78.3")))
    force.setSoluteDielectric(float(g("soluteDielectric", "1.0")))
    force.setIncludeCavityTerm(int(g("includeCavityTerm", "1")))
    force.setProbeRadius(float(g("probeRadius", "0.14")))
    force.setSurfaceAreaFactor(float(g("surfaceAreaFactor",
                                       "-170.351730667")))
    for a in _attrs(el, "Particles"):
        force.addParticle(float(a["charge"]), float(a["radius"]),
                          float(a["scaleFactor"]))
    return force


_HIPPO_SCALARS = ("coreCharge", "alpha", "epsilon", "damping", "c6",
                  "pauliK", "pauliQ", "pauliAlpha", "polarizability")
_HIPPO_FRAME = ("axisType", "atomZ", "atomX", "atomY")
_HIPPO_SCALES = ("multipoleMultipoleScale", "dipoleMultipoleScale",
                 "dipoleDipoleScale", "dispersionScale", "repulsionScale",
                 "chargeTransferScale")


def _ser_hippo(el, force):
    el.set("method", str(force.getNonbondedMethod()))
    el.set("cutoff", _fmt(u.strip(force.getCutoffDistance())))
    el.set("switchingDistance", _fmt(u.strip(force.getSwitchingDistance())))
    el.set("extrapolationCoefficients", _params_text(
        force.getExtrapolationCoefficients()))
    particles = ET.SubElement(el, "Particles")
    for i in range(force.getNumParticles()):
        p = u.plain(force.getParticleParameters(i))
        attrs = {"charge": _fmt(p[0]), "dipole": _params_text(p[1]),
                 "quadrupole": _params_text(p[2])}
        attrs.update(zip(_HIPPO_SCALARS, (_fmt(x) for x in p[3:12])))
        attrs.update(zip(_HIPPO_FRAME, (str(x) for x in p[12:16])))
        ET.SubElement(particles, "Particle", attrs)
    _rows(ET.SubElement(el, "Exceptions"), "Exception",
          ("p1", "p2") + _HIPPO_SCALES,
          ((str(e[0]), str(e[1])) + tuple(_fmt(x) for x in e[2:8])
           for e in (u.plain(force.getExceptionParameters(i))
                     for i in range(force.getNumExceptions()))))


def _de_hippo(el):
    force = F.HippoNonbondedForce()
    force.setNonbondedMethod(int(el.get("method", "0")))
    force.setCutoffDistance(float(el.get("cutoff", "1.0")))
    force.setSwitchingDistance(float(el.get("switchingDistance", "0.9")))
    if el.get("extrapolationCoefficients"):
        force.setExtrapolationCoefficients(
            _floats(el.get("extrapolationCoefficients")))
    for a in _attrs(el, "Particles"):
        force.addParticle(float(a["charge"]), _floats(a["dipole"]),
                          _floats(a["quadrupole"]),
                          *(float(a[k]) for k in _HIPPO_SCALARS),
                          *(int(a[k]) for k in _HIPPO_FRAME))
    for a in _attrs(el, "Exceptions"):
        force.addException(int(a["p1"]), int(a["p2"]),
                           *(float(a[k]) for k in _HIPPO_SCALES))
    return force


_FORCE_SERIALIZERS = {
    "HarmonicBondForce": _ser_harmonic_bond,
    "HarmonicAngleForce": _ser_harmonic_angle,
    "PeriodicTorsionForce": _ser_periodic_torsion,
    "RBTorsionForce": _ser_rb_torsion,
    "CMAPTorsionForce": _ser_cmap,
    "NonbondedForce": _ser_nonbonded,
    "GBSAOBCForce": _ser_gbsa,
    "CMMotionRemover": _ser_cmm,
    "AndersenThermostat": _ser_andersen,
    "MonteCarloBarostat": _ser_mc_barostat,
    "RMSDForce": _ser_rmsd,
    "CustomBondForce": _ser_custom_bond,
    "CustomExternalForce": _ser_custom_external,
    "CustomNonbondedForce": _ser_custom_nonbonded,
    "CustomAngleForce": _ser_custom_angle,
    "CustomTorsionForce": _ser_custom_torsion,
    "CustomCompoundBondForce": _ser_custom_compound,
    "CustomCentroidBondForce": _ser_custom_centroid,
    "CustomGBForce": _ser_custom_gb,
    "GayBerneForce": _ser_gayberne,
    "DrudeForce": _ser_drude,
    "CustomHbondForce": _ser_custom_hbond,
    "CustomManyParticleForce": _ser_custom_manyparticle,
    "CustomCVForce": _ser_custom_cv,
    "MonteCarloAnisotropicBarostat": _ser_aniso_barostat,
    "MonteCarloMembraneBarostat": _ser_membrane_barostat,
    "AmoebaVdwForce": _ser_amoeba_vdw,
    "AmoebaMultipoleForce": _ser_amoeba_multipole,
    "AmoebaTorsionTorsionForce": _ser_amoeba_torsiontorsion,
    "AmoebaWcaDispersionForce": _ser_amoeba_wca,
    "AmoebaGeneralizedKirkwoodForce": _ser_amoeba_gk,
    "HippoNonbondedForce": _ser_hippo,
    "RPMDMonteCarloBarostat": _ser_rpmd_barostat,
}
_FORCE_DESERIALIZERS = {
    "HarmonicBondForce": _de_harmonic_bond,
    "HarmonicAngleForce": _de_harmonic_angle,
    "PeriodicTorsionForce": _de_periodic_torsion,
    "RBTorsionForce": _de_rb_torsion,
    "CMAPTorsionForce": _de_cmap,
    "NonbondedForce": _de_nonbonded,
    "GBSAOBCForce": _de_gbsa,
    "CMMotionRemover": _de_cmm,
    "AndersenThermostat": _de_andersen,
    "MonteCarloBarostat": _de_mc_barostat,
    "RMSDForce": _de_rmsd,
    "CustomBondForce": _de_custom_bond,
    "CustomExternalForce": _de_custom_external,
    "CustomNonbondedForce": _de_custom_nonbonded,
    "CustomAngleForce": _de_custom_angle,
    "CustomTorsionForce": _de_custom_torsion,
    "CustomCompoundBondForce": _de_custom_compound,
    "CustomCentroidBondForce": _de_custom_centroid,
    "CustomGBForce": _de_custom_gb,
    "GayBerneForce": _de_gayberne,
    "DrudeForce": _de_drude,
    "CustomHbondForce": _de_custom_hbond,
    "CustomManyParticleForce": _de_custom_manyparticle,
    "CustomCVForce": _de_custom_cv,
    "MonteCarloAnisotropicBarostat": _de_aniso_barostat,
    "MonteCarloMembraneBarostat": _de_membrane_barostat,
    "AmoebaVdwForce": _de_amoeba_vdw,
    "AmoebaMultipoleForce": _de_amoeba_multipole,
    "AmoebaTorsionTorsionForce": _de_amoeba_torsiontorsion,
    "AmoebaWcaDispersionForce": _de_amoeba_wca,
    "AmoebaGeneralizedKirkwoodForce": _de_amoeba_gk,
    "HippoNonbondedForce": _de_hippo,
    "RPMDMonteCarloBarostat": _de_rpmd_barostat,
}


# ---------------------------------------------------------------------------
# Integrators
# ---------------------------------------------------------------------------
# (attribute, getter): written where the integrator has the getter
_INTEGRATOR_GETTERS = (
    ("temperature", "getTemperature"), ("friction", "getFriction"),
    ("errorTol", "getErrorTolerance"), ("maxStepSize", "getMaximumStepSize"),
    ("randomSeed", "getRandomNumberSeed"),
    ("drudeTemperature", "getDrudeTemperature"),
    ("drudeFriction", "getDrudeFriction"),
    ("maxDrudeDistance", "getMaxDrudeDistance"),
    ("minimizationErrorTolerance", "getMinimizationErrorTolerance"),
    ("numCopies", "getNumCopies"), ("applyThermostat", "getApplyThermostat"))
# the integrators that draw no random numbers: the JAX package's have no
# getRandomNumberSeed, so their XML has no randomSeed
_NO_SEED = (I.VerletIntegrator, I.VariableVerletIntegrator,
            I.NoseHooverIntegrator, I.CompoundIntegrator)


def _ser_integrator(integ):
    el = ET.Element("Integrator")
    name = type(integ).__name__
    el.set("type", name)
    el.set("version", "1")
    el.set("stepSize", _fmt(u.plain(integ.getStepSize())))
    el.set("constraintTolerance", _fmt(integ.getConstraintTolerance()))
    el.set("integrationForceGroups", str(integ.getIntegrationForceGroups()))
    for attr, getter in _INTEGRATOR_GETTERS:
        if not hasattr(integ, getter) or (attr == "randomSeed" and
                                          isinstance(integ, _NO_SEED)):
            continue
        val = getattr(integ, getter)()
        if isinstance(val, bool):
            el.set(attr, str(int(val)))
        elif isinstance(val, int):
            el.set(attr, str(val))
        else:
            el.set(attr, _fmt(u.strip(val)))
    if name == "NoseHooverIntegrator":
        th = integ._thermostats[0]
        el.set("collisionFrequency", _fmt(th["frequency"]))
        el.set("chainLength", str(th["chain_length"]))
        el.set("numMTS", str(th["n_mts"]))
        el.set("numYoshidaSuzuki", str(th["n_ys"]))
    if name == "CustomIntegrator":
        _ser_custom_integrator(el, integ)
    return el


def _ser_custom_integrator(el, integ) -> None:
    el.set("kineticEnergy", integ.getKineticEnergyExpression())
    gv = ET.SubElement(el, "GlobalVariables")
    for i in range(integ.getNumGlobalVariables()):
        ET.SubElement(gv, "Variable", name=integ.getGlobalVariableName(i),
                      value=_fmt(integ.getGlobalVariable(i)))
    pv = ET.SubElement(el, "PerDofVariables")
    for i, (name, initial) in enumerate(integ._perdof_vars):
        # the values exist once bound to a Context or set; else the
        # initial value alone (CustomIntegrator.h)
        try:
            values = _params_text(np.asarray(
                integ.getPerDofVariable(i)).ravel())
        except RuntimeError:
            values = ""
        ET.SubElement(pv, "Variable", name=name, initial=_fmt(initial),
                      values=values)
    _rows(ET.SubElement(el, "Computations"), "Computation",
          ("type", "variable", "expression"),
          ((str(t), var, expr) for t, var, expr in integ._steps))


def _de_integrator(el):
    t, g = el.get("type"), el.get
    step = float(g("stepSize", "0.001"))
    if t == "VerletIntegrator":
        integ = I.VerletIntegrator(step)
    elif t in ("LangevinIntegrator", "LangevinMiddleIntegrator",
               "BrownianIntegrator"):
        integ = getattr(I, t)(float(g("temperature")), float(g("friction")),
                              step)
    elif t == "VariableVerletIntegrator":
        integ = I.VariableVerletIntegrator(float(g("errorTol")))
    elif t == "VariableLangevinIntegrator":
        integ = I.VariableLangevinIntegrator(
            float(g("temperature")), float(g("friction")),
            float(g("errorTol")))
    elif t == "NoseHooverIntegrator":
        integ = I.NoseHooverIntegrator(
            float(g("temperature", "298")),
            float(g("collisionFrequency", "50")), step,
            int(g("chainLength", "3")), int(g("numMTS", "3")),
            int(g("numYoshidaSuzuki", "7")))
    elif t == "DrudeLangevinIntegrator":
        integ = I.DrudeLangevinIntegrator(
            float(g("temperature")), float(g("friction")),
            float(g("drudeTemperature")), float(g("drudeFriction")), step)
        integ.setMaxDrudeDistance(float(g("maxDrudeDistance", "0")))
    elif t == "DrudeSCFIntegrator":
        integ = I.DrudeSCFIntegrator(step)
        integ.setMinimizationErrorTolerance(
            float(g("minimizationErrorTolerance", "1")))
    elif t == "RPMDIntegrator":
        integ = I.RPMDIntegrator(int(g("numCopies")), float(g("temperature")),
                                 float(g("friction")), step)
        integ.setApplyThermostat(bool(int(g("applyThermostat", "1"))))
    elif t == "CustomIntegrator":
        integ = _de_custom_integrator(el, step)
    else:
        raise OpenMMException("cannot deserialize integrator type %s" % t)
    if g("maxStepSize") is not None:
        # the JAX package's reader leaves it at its default
        integ.setMaximumStepSize(float(g("maxStepSize")))
    integ.setConstraintTolerance(float(g("constraintTolerance", "1e-5")))
    integ.setIntegrationForceGroups(int(g("integrationForceGroups", "-1")))
    if g("randomSeed") is not None and not isinstance(integ, _NO_SEED):
        integ.setRandomNumberSeed(int(float(g("randomSeed"))))
    return integ


def _de_custom_integrator(el, step):
    integ = I.CustomIntegrator(step)
    integ.setKineticEnergyExpression(el.get("kineticEnergy", "m*v*v/2"))
    for a in _attrs(el, "GlobalVariables"):
        integ.addGlobalVariable(a["name"], float(a["value"]))
    for a in _attrs(el, "PerDofVariables"):
        integ.addPerDofVariable(a["name"], float(a.get("initial", "0")))
        values = _floats(a.get("values"))
        if values:
            integ.setPerDofVariableByName(
                a["name"], np.asarray(values).reshape(-1, 3))
    integ._steps.extend((int(a["type"]), a.get("variable", ""),
                         a.get("expression", ""))
                        for a in _attrs(el, "Computations"))
    return integ


# ---------------------------------------------------------------------------
# State (StateProxy.cpp fields)
# ---------------------------------------------------------------------------
def _ser_vectors(el, name, tag, arr) -> None:
    _rows(ET.SubElement(el, name), tag, ("x", "y", "z"),
          ((_r(x), _r(y), _r(z)) for x, y, z in
           np.asarray(arr, np.float64).tolist()))


def _ser_state(state):
    el = ET.Element("State")
    el.set("type", "State")
    el.set("version", "1")
    el.set("time", _fmt(state._time))
    el.set("stepCount", str(state.getStepCount()))
    types = state.getDataTypes()
    if state._box is not None:
        box = ET.SubElement(el, "PeriodicBoxVectors")
        for name, v in zip("ABC", np.asarray(state._box,
                                             np.float64).tolist()):
            ET.SubElement(box, name, x=_r(v[0]), y=_r(v[1]), z=_r(v[2]))
    if types & State.Parameters:
        params = ET.SubElement(el, "Parameters")
        for k, v in state.getParameters().items():
            params.set(k, _fmt(v))
    if types & State.Energy:
        ET.SubElement(el, "Energies", KineticEnergy=_fmt(state._ke),
                      PotentialEnergy=_fmt(state._pe))
    if types & State.IntegratorParameters:
        ip = ET.SubElement(el, "IntegratorParameters")
        for k, v in state.getIntegratorParameters().items():
            ip.set(k, _fmt(v))
    for name, tag, flag, arr in (
            ("Positions", "Position", State.Positions, state._positions),
            ("Velocities", "Velocity", State.Velocities, state._velocities),
            ("Forces", "Force", State.Forces, state._forces)):
        if types & flag:
            _ser_vectors(el, name, tag, arr)
    return el


def _de_vectors(el) -> np.ndarray:
    return np.asarray([(float(a["x"]), float(a["y"]), float(a["z"]))
                       for a in _attrs(el)], np.float64).reshape(-1, 3)


def _de_state(el):
    kw = {"time": float(el.get("time", "0")),
          "step": int(el.get("stepCount", "0"))}
    box = el.find("PeriodicBoxVectors")
    if box is not None:
        kw["box"] = np.asarray([[float(box.find(n).get(c)) for c in "xyz"]
                                for n in "ABC"])
    params = el.find("Parameters")
    if params is not None:
        kw["parameters"] = {k: float(v) for k, v in params.attrib.items()}
    energies = el.find("Energies")
    if energies is not None:
        kw["kinetic_energy"] = float(energies.get("KineticEnergy"))
        kw["potential_energy"] = float(energies.get("PotentialEnergy"))
    ip = el.find("IntegratorParameters")
    if ip is not None:
        kw["integrator_parameters"] = {k: float(v)
                                       for k, v in ip.attrib.items()}
    for name, key in (("Positions", "positions"), ("Velocities", "velocities"),
                      ("Forces", "forces")):
        sec = el.find(name)
        if sec is not None:
            kw[key] = _de_vectors(sec)
    return State(**kw)
