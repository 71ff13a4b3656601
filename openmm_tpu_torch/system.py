"""System: particles, masses, constraints, the periodic box, forces and
virtual sites.

Counterpart of openmm_tpu/system.py. This slice has no unit system: masses
in amu, distances in nm, angles in rad. `from_numpy` and `to_numpy` carry
the parameters of a System across as plain numpy arrays, which is how the
tests hand the same system to this package and to the JAX package.

A virtual site is a massless particle whose position follows from other
particles (VirtualSite.h): the weighted average of two or three, an
out-of-plane combination, or a point in a local frame. ops/vsites.py
computes the positions and spreads a site's force onto its parents.
"""
from __future__ import annotations

import copy

import numpy as np

from . import unit as u
from .forces.amoeba import AMOEBA_FORCES, AmoebaTorsionTorsionForce
from .forces.barostats import (MonteCarloAnisotropicBarostat,
                               MonteCarloBarostat, MonteCarloMembraneBarostat)
from .forces.bonded import (CMAPTorsionForce, HarmonicAngleForce,
                            HarmonicBondForce, PeriodicTorsionForce,
                            RBTorsionForce)
from .forces.cmmotion import CMMotionRemover
from .forces import MODULE_FORCES
from .forces.custom import (CustomCentroidBondForce, CustomCompoundBondForce,
                            CustomExternalForce, CustomNonbondedForce)
from .forces.customcv import CustomCVForce
from .forces.customgb import CustomGBForce
from .forces.customhbond import CustomHbondForce
from .forces.custommanyparticle import CustomManyParticleForce
from .forces.gayberne import GayBerneForce
from .forces.rmsd import RMSDForce
from .forces.gbsa import GBSAOBCForce
from .forces.hippo import HippoNonbondedForce
from .forces.nonbonded import NonbondedForce
from .forces.thermostats import AndersenThermostat
from .tabulated import TABULATED_FUNCTIONS
from .vec3 import Vec3

_METHODS = {"NoCutoff": NonbondedForce.NoCutoff,
            "CutoffNonPeriodic": NonbondedForce.CutoffNonPeriodic,
            "CutoffPeriodic": NonbondedForce.CutoffPeriodic,
            "Ewald": NonbondedForce.Ewald, "PME": NonbondedForce.PME,
            "LJPME": NonbondedForce.LJPME}
_GB_METHODS = {"NoCutoff": GBSAOBCForce.NoCutoff,
               "CutoffNonPeriodic": GBSAOBCForce.CutoffNonPeriodic,
               "CutoffPeriodic": GBSAOBCForce.CutoffPeriodic}


class VirtualSite:
    """A particle whose position is computed from other particles."""

    def getNumParticles(self) -> int:
        return len(self._particles)

    def getParticle(self, index: int) -> int:
        return self._particles[index]


class TwoParticleAverageSite(VirtualSite):
    """r = w1 r1 + w2 r2."""

    def __init__(self, particle1, particle2, weight1, weight2):
        self._particles = [int(particle1), int(particle2)]
        self.weights = [float(weight1), float(weight2)]

    def getWeight(self, index: int) -> float:
        return self.weights[index]


class ThreeParticleAverageSite(VirtualSite):
    """r = w1 r1 + w2 r2 + w3 r3."""

    def __init__(self, particle1, particle2, particle3, weight1, weight2,
                 weight3):
        self._particles = [int(particle1), int(particle2), int(particle3)]
        self.weights = [float(weight1), float(weight2), float(weight3)]

    def getWeight(self, index: int) -> float:
        return self.weights[index]


class OutOfPlaneSite(VirtualSite):
    """r = r1 + w12 r12 + w13 r13 + wcross (r12 x r13), rij = rj - ri."""

    def __init__(self, particle1, particle2, particle3, weight12, weight13,
                 weightCross):
        self._particles = [int(particle1), int(particle2), int(particle3)]
        self.weight12 = float(weight12)
        self.weight13 = float(weight13)
        self.weightCross = float(weightCross)

    def getWeight12(self) -> float:
        return self.weight12

    def getWeight13(self) -> float:
        return self.weight13

    def getWeightCross(self) -> float:
        return self.weightCross


class LocalCoordinatesSite(VirtualSite):
    """r = origin + p.x xhat + p.y yhat + p.z zhat: origin, x and y
    directions weighted sums of the particles, zhat along x cross y,
    yhat = zhat x xhat (VirtualSite.h LocalCoordinatesSite)."""

    def __init__(self, particles, originWeights, xWeights, yWeights,
                 localPosition):
        if not (len(particles) == len(originWeights) == len(xWeights)
                == len(yWeights)):
            raise ValueError("LocalCoordinatesSite: weight lists must match "
                             "particles")
        self._particles = [int(p) for p in particles]
        self.originWeights = [float(w) for w in originWeights]
        self.xWeights = [float(w) for w in xWeights]
        self.yWeights = [float(w) for w in yWeights]
        self.localPosition = Vec3(
            *(float(x) for x in u.strip(localPosition, u.nanometer)))

    def getOriginWeights(self):
        return self.originWeights

    def getXWeights(self):
        return self.xWeights

    def getYWeights(self):
        return self.yWeights

    def getLocalPosition(self):
        return self.localPosition


def reduced_box(a, b, c) -> np.ndarray:
    """The box vectors a, b, c as a (3, 3) float64 array, checked to be in
    the reduced form OpenMM requires."""
    box = np.asarray([a, b, c], np.float64)
    if box[0, 1] or box[0, 2] or box[1, 2]:
        raise ValueError("box vectors must be in reduced form: a along "
                         "x, b in the x-y plane")
    if min(box[0, 0], box[1, 1], box[2, 2]) <= 0:
        raise ValueError("box vectors must have positive diagonals")
    if (abs(box[1, 0]) > 0.5 * box[0, 0] + 1e-6
            or abs(box[2, 0]) > 0.5 * box[0, 0] + 1e-6
            or abs(box[2, 1]) > 0.5 * box[1, 1] + 1e-6):
        raise ValueError("box vectors must be in reduced form")
    return box


class System:
    def __init__(self):
        self._masses = []
        self._constraints = []      # (p1, p2, distance)
        self._forces = []
        self._vsites = {}           # particle -> VirtualSite
        self._box = np.diag([2.0, 2.0, 2.0])

    def getNumParticles(self) -> int:
        return len(self._masses)

    def addParticle(self, mass: float) -> int:
        self._masses.append(float(u.strip(mass, u.dalton)))
        return len(self._masses) - 1

    def getParticleMass(self, index: int):
        return u.Quantity(self._masses[index], u.dalton)

    def setParticleMass(self, index: int, mass: float) -> None:
        self._masses[index] = float(u.strip(mass, u.dalton))

    def setVirtualSite(self, index: int, virtualSite) -> None:
        self._vsites[int(index)] = virtualSite

    def isVirtualSite(self, index: int) -> bool:
        return index in self._vsites

    def getVirtualSite(self, index: int):
        if index not in self._vsites:
            raise ValueError("particle %d is not a virtual site" % index)
        return self._vsites[index]

    def getNumConstraints(self) -> int:
        return len(self._constraints)

    def addConstraint(self, particle1, particle2, distance) -> int:
        self._constraints.append((int(particle1), int(particle2),
                                  float(u.strip(distance, u.nanometer))))
        return len(self._constraints) - 1

    def getConstraintParameters(self, index: int):
        p1, p2, d = self._constraints[index]
        return p1, p2, u.Quantity(d, u.nanometer)

    def setConstraintParameters(self, index: int, particle1, particle2,
                                distance) -> None:
        self._constraints[index] = (int(particle1), int(particle2),
                                    float(u.strip(distance, u.nanometer)))

    def removeConstraint(self, index: int) -> None:
        """Remove a constraint; a Context built before keeps it (it copies
        the constraints when it is built)."""
        del self._constraints[index]

    def addForce(self, force) -> int:
        self._forces.append(force)
        return len(self._forces) - 1

    def getNumForces(self) -> int:
        return len(self._forces)

    def getForce(self, index: int):
        return self._forces[index]

    def getForces(self):
        return list(self._forces)

    def removeForce(self, index: int) -> None:
        """Remove a force; a Context built before keeps it (it takes the
        System's forces when it is built)."""
        del self._forces[index]

    def setDefaultPeriodicBoxVectors(self, a, b, c) -> None:
        self._box = reduced_box(*(u.strip(v, u.nanometer) for v in (a, b, c)))

    def getDefaultPeriodicBoxVectors(self):
        return tuple(u.Quantity(Vec3(*row), u.nanometer)
                     for row in self._box.tolist())

    def usesPeriodicBoundaryConditions(self) -> bool:
        return any(f.usesPeriodicBoundaryConditions() for f in self._forces)


# the forces from_numpy and to_numpy carry besides the NonbondedForce, at
# most one of each kind: (kind, class, the methods that count, add and
# read back its terms, its arrays' keys and widths: atoms and parameters
# a term)
_BONDED = (("bond", HarmonicBondForce,
            ("getNumBonds", "addBond", "getBondParameters"),
            "bond_pairs", 2, "bond_params", 2),
           ("angle", HarmonicAngleForce,
            ("getNumAngles", "addAngle", "getAngleParameters"),
            "angle_triples", 3, "angle_params", 2),
           ("torsion", PeriodicTorsionForce,
            ("getNumTorsions", "addTorsion", "getTorsionParameters"),
            "torsion_quads", 4, "torsion_params", 3),
           ("rb", RBTorsionForce,
            ("getNumTorsions", "addTorsion", "getTorsionParameters"),
            "rb_quads", 4, "rb_params", 6))


def from_numpy(params: dict) -> System:
    """A System from a dict of numpy arrays.

    Always: masses (n,; 0 for a fixed particle); with charges, sigma,
    epsilon (n,) a NonbondedForce of: exception_pairs (m, 2)
    and exception_params (m, 3) = (chargeProd, sigma, epsilon);
    constraint_pairs (k, 2) and constraint_distances (k,); box (3, 3);
    cutoff, method (a NonbondedForce method name), ewald_tolerance,
    dispersion_correction, switch_distance (negative: no switch), which
    make one NonbondedForce; optional rf_dielectric (the reaction field's,
    78.3 when absent) and exceptions_use_pbc (False when absent), which
    to_numpy writes only where they differ from those defaults.
    Each present key adds a force: bond_pairs (m, 2) with bond_params
    (length, k); angle_triples (m, 3) with angle_params (angle, k);
    torsion_quads (m, 4) with torsion_params (periodicity, phase, k);
    rb_quads (m, 4) with rb_params (c0..c5); cmap_sizes (maps,),
    cmap_energies (the maps' energies one after another) and
    cmap_torsions (m, 9) = (map, a1..a4, b1..b4); gb_charges, gb_radii
    and gb_scales (n,) with gb_method (a GBSAOBCForce method name),
    gb_cutoff, gb_solute_dielectric, gb_solvent_dielectric and
    gb_surface_energy (kJ/mol/nm^2), a GBSAOBCForce; cmm_frequency (a
    CMMotionRemover); barostat_kind ("iso", "aniso" or "membrane", a
    barostat) with barostat_pressure (bar; three for "aniso"),
    barostat_temperature (K), barostat_frequency, and for "aniso"
    barostat_scale (three flags), for "membrane" barostat_tension (bar
    nm), barostat_xymode and barostat_zmode; andersen_temperature (K),
    andersen_frequency (1/ps) and andersen_seed, an AndersenThermostat.
    The forces follow that order. force_groups maps a force's kind
    ("nonbonded", "gbsa", "bond", "angle", "torsion", "rb", "cmap", "cmm",
    "barostat", "andersen") to its group where that is not 0.
    Optional keys of the NonbondedForce, each written by to_numpy only
    where it differs from the default: pme_parameters and
    ljpme_parameters (alpha, nx, ny, nz), reciprocal_group,
    include_direct, global_parameters [(name, default)],
    particle_offsets [(parameter, particle, charge, sigma and epsilon
    scales)] and exception_offsets [(parameter, exception, chargeProd,
    sigma and epsilon scales)]. vsites: [(particle, kind, parents,
    weights)] with kind "average2", "average3" (weights w_i),
    "outofplane" (w12, w13, wcross) or "local" (the origin, x and y
    weights of each parent one list after another, then the local
    position). extra_nonbonded: a list of dicts with the NonbondedForce
    keys above (and "group"), one more NonbondedForce each, added after
    the first. custom_forces: a list of custom_spec dicts, one force of
    MODULE_FORCES each (the custom forces, the AMOEBA forces and
    HippoNonbondedForce), added last in their order."""
    system = System()
    for m in np.asarray(params["masses"], np.float64):
        system.addParticle(m)
    for (i, j), d in zip(np.asarray(params["constraint_pairs"]).reshape(-1, 2),
                         np.asarray(params["constraint_distances"])):
        system.addConstraint(i, j, d)
    system.setDefaultPeriodicBoxVectors(*np.asarray(params["box"]))
    groups = params.get("force_groups", {})
    for site in params.get("vsites", ()):
        system.setVirtualSite(site[0], _make_vsite(*site[1:]))
    if "charges" in params:
        system.addForce(_nonbonded(params, groups.get("nonbonded", 0)))
    for extra in params.get("extra_nonbonded", ()):
        system.addForce(_nonbonded(extra, extra.get("group", 0)))
    _add_other_forces(system, params, groups)
    for spec in params.get("custom_forces", ()):
        system.addForce(custom_force(spec))
    return system


def _nonbonded(params, group) -> NonbondedForce:
    """A NonbondedForce from from_numpy's NonbondedForce keys."""
    nb = NonbondedForce()
    nb.setNonbondedMethod(_METHODS[params["method"]])
    nb.setCutoffDistance(params["cutoff"])
    nb.setEwaldErrorTolerance(params["ewald_tolerance"])
    nb.setUseDispersionCorrection(params["dispersion_correction"])
    if params["switch_distance"] >= 0:
        nb.setUseSwitchingFunction(True)
        nb.setSwitchingDistance(params["switch_distance"])
    nb.setReactionFieldDielectric(params.get("rf_dielectric", 78.3))
    nb.setExceptionsUsePeriodicBoundaryConditions(
        bool(params.get("exceptions_use_pbc", False)))
    for q, s, e in zip(params["charges"], params["sigma"], params["epsilon"]):
        nb.addParticle(q, s, e)
    for (i, j), (cp, s, e) in zip(
            np.asarray(params["exception_pairs"]).reshape(-1, 2),
            np.asarray(params["exception_params"]).reshape(-1, 3)):
        nb.addException(i, j, cp, s, e)
    if "pme_parameters" in params:
        nb.setPMEParameters(*params["pme_parameters"])
    if "ljpme_parameters" in params:
        nb.setLJPMEParameters(*params["ljpme_parameters"])
    nb.setReciprocalSpaceForceGroup(params.get("reciprocal_group", -1))
    nb.setIncludeDirectSpace(params.get("include_direct", True))
    for name, default in params.get("global_parameters", ()):
        nb.addGlobalParameter(name, default)
    for offset in params.get("particle_offsets", ()):
        nb.addParticleParameterOffset(*offset)
    for offset in params.get("exception_offsets", ()):
        nb.addExceptionParameterOffset(*offset)
    nb.setForceGroup(group)
    return nb


def _add_other_forces(system, params, groups) -> None:
    """The forces of from_numpy's keys after the NonbondedForces, in its
    order."""
    if "gb_charges" in params:
        gb = GBSAOBCForce()
        gb.setNonbondedMethod(_GB_METHODS[str(params["gb_method"])])
        gb.setCutoffDistance(params["gb_cutoff"])
        gb.setSoluteDielectric(params["gb_solute_dielectric"])
        gb.setSolventDielectric(params["gb_solvent_dielectric"])
        gb.setSurfaceAreaEnergy(params["gb_surface_energy"])
        for q, r, s in zip(params["gb_charges"], params["gb_radii"],
                           params["gb_scales"]):
            gb.addParticle(q, r, s)
        gb.setForceGroup(groups.get("gbsa", 0))
        system.addForce(gb)
    for kind, cls, (_, add, _), atoms_key, n_atoms, par_key, n_par \
            in _BONDED:
        if atoms_key not in params:
            continue
        force = cls()
        atoms = np.asarray(params[atoms_key]).reshape(-1, n_atoms)
        par = np.asarray(params[par_key]).reshape(-1, n_par)
        for a, p in zip(atoms, par):
            getattr(force, add)(*(int(x) for x in a), *p)
        force.setForceGroup(groups.get(kind, 0))
        system.addForce(force)
    if "cmap_torsions" in params:
        cmap = CMAPTorsionForce()
        energies = np.asarray(params["cmap_energies"], np.float64)
        start = 0
        for size in np.asarray(params["cmap_sizes"], np.int64):
            cmap.addMap(int(size), energies[start:start + size * size])
            start += size * size
        for t in np.asarray(params["cmap_torsions"]).reshape(-1, 9):
            cmap.addTorsion(*(int(x) for x in t))
        cmap.setForceGroup(groups.get("cmap", 0))
        system.addForce(cmap)
    if "cmm_frequency" in params:
        cmm = CMMotionRemover(int(params["cmm_frequency"]))
        cmm.setForceGroup(groups.get("cmm", 0))
        system.addForce(cmm)
    if "barostat_kind" in params:
        baro = _barostat(params)
        baro.setForceGroup(groups.get("barostat", 0))
        system.addForce(baro)
    if "andersen_temperature" in params:
        thermostat = AndersenThermostat(float(params["andersen_temperature"]),
                                        float(params["andersen_frequency"]))
        thermostat.setRandomNumberSeed(int(params.get("andersen_seed", 0)))
        thermostat.setForceGroup(groups.get("andersen", 0))
        system.addForce(thermostat)


def _function_spec(name, fn) -> tuple:
    """(name, class name, constructor arguments, periodic) of a tabulated
    function."""
    args = fn.getFunctionParameters()
    kind = type(fn).__name__
    if kind == "Discrete1DFunction":
        args = (args,)
    return (name, kind, tuple(args), fn.getPeriodic())


def make_function(kind, args, periodic):
    """A tabulated function of this package from _function_spec's parts."""
    cls = TABULATED_FUNCTIONS[kind]
    return cls(*args, periodic) if kind.startswith("Continuous") \
        else cls(*args)


def custom_spec(force) -> dict:
    """A force of MODULE_FORCES as plain data: kind (the class name) and
    group; RMSDForce its reference and particles; GayBerneForce its
    particles, exceptions, method, cutoff and switch_distance (negative:
    none); every other kind energy, globals [(name, default)],
    derivatives, functions [(name, class name, constructor arguments,
    periodic)] and periodic, with the kind's own keys: parameters (the
    per-term or per-particle names) and terms [(atoms, parameters)]
    (atoms empty for the per-particle kinds), particles_per_bond,
    groups_per_bond and groups [(particles, weights or None)];
    CustomNonbondedForce's method, cutoff, switch_distance,
    long_range_correction, exclusions and interaction_groups;
    CustomGBForce's values [(name, expression, type)], energy_terms
    [(expression, type)], exclusions, method and cutoff; CustomHbondForce's
    donor_parameters, acceptor_parameters, donors and acceptors [(three
    particles, parameters)], exclusions, method and cutoff;
    CustomManyParticleForce's particles_per_set, parameters, particles
    [(parameters, type)], type_filters [(slot, types)],
    permutation_mode, exclusions, method and cutoff; CustomCVForce's
    variables [(name, force_spec of its force)]; the AMOEBA forces and
    HippoNonbondedForce their state (state_spec)."""
    kind = type(force).__name__
    spec = {"kind": kind, "group": force.getForceGroup()}
    if isinstance(force, STATE_FORCES):
        return state_spec(force)
    if isinstance(force, RMSDForce):
        spec.update(reference=u.plain(force.getReferencePositions()).tolist(),
                    particles=force.getParticles())
        return spec
    if isinstance(force, GayBerneForce):
        spec.update(particles=list(force._particles),
                    exceptions=list(force._exceptions),
                    method=force.getNonbondedMethod(),
                    cutoff=u.plain(force.getCutoffDistance()),
                    switch_distance=(u.plain(force.getSwitchingDistance())
                                     if force.getUseSwitchingFunction()
                                     else -1.0))
        return spec
    spec.update({"energy": force.getEnergyFunction(),
                 "globals": list(force._global_params),
                 "derivatives": list(force._deriv_requests),
                 "functions": [_function_spec(name, fn)
                               for name, fn in force._functions],
                 "periodic": force.usesPeriodicBoundaryConditions()})
    if isinstance(force, CustomCVForce):
        spec["variables"] = [(name, force_spec(f)) for name, f in force._cvs]
        return spec
    if isinstance(force, (CustomGBForce, CustomHbondForce,
                          CustomManyParticleForce)):
        spec.update(exclusions=list(force._exclusions),
                    method=force.getNonbondedMethod(),
                    cutoff=u.plain(force.getCutoffDistance()))
    if isinstance(force, CustomGBForce):
        spec.update(parameters=list(force._per_particle),
                    terms=[((), list(p)) for p in force._particles],
                    values=list(force._values),
                    energy_terms=list(force._energy_terms))
        return spec
    if isinstance(force, CustomHbondForce):
        spec.update(donor_parameters=list(force._per_donor),
                    acceptor_parameters=list(force._per_acceptor),
                    donors=[(tuple(a), list(p)) for a, p in force._donors],
                    acceptors=[(tuple(a), list(p))
                               for a, p in force._acceptors])
        return spec
    if isinstance(force, CustomManyParticleForce):
        spec.update(particles_per_set=force.getNumParticlesPerSet(),
                    parameters=list(force._per_particle),
                    particles=[(list(p), t) for p, t in force._particles],
                    type_filters=[(slot, sorted(types)) for slot, types
                                  in sorted(force._type_filters.items())],
                    permutation_mode=force.getPermutationMode())
        return spec
    if isinstance(force, CustomNonbondedForce):
        spec.update(parameters=list(force._per_particle),
                    terms=[((), list(p)) for p in force._particles],
                    method=force.getNonbondedMethod(),
                    cutoff=u.plain(force.getCutoffDistance()),
                    switch_distance=(u.plain(force.getSwitchingDistance())
                                     if force.getUseSwitchingFunction()
                                     else -1.0),
                    long_range_correction=force.getUseLongRangeCorrection(),
                    exclusions=list(force._exclusions),
                    interaction_groups=list(force._groups))
        return spec
    if isinstance(force, CustomExternalForce):
        spec.update(parameters=list(force._per_particle),
                    terms=[((t[0],), list(t[1])) for t in force._terms])
        return spec
    spec.update(parameters=list(force._per_term),
                terms=[(tuple(a), list(p)) for a, p in force._terms])
    if isinstance(force, CustomCompoundBondForce):
        spec["particles_per_bond"] = force._n_atoms
    elif isinstance(force, CustomCentroidBondForce):
        spec["groups_per_bond"] = force._n_groups
        spec["groups"] = [(tuple(p), None if w is None else list(w))
                          for p, w in force._groups]
    return spec


def _common_custom(force, spec) -> None:
    """The keys every expression-driven kind shares, onto `force`."""
    for name, default in spec.get("globals", ()):
        force.addGlobalParameter(name, default)
    for name in spec.get("derivatives", ()):
        force.addEnergyParameterDerivative(name)
    for name, fkind, args, periodic in spec.get("functions", ()):
        force.addTabulatedFunction(name, make_function(fkind, args,
                                                       periodic))


def _pair_method(force, spec) -> None:
    force.setNonbondedMethod(spec["method"])
    force.setCutoffDistance(spec["cutoff"])
    for i, j in spec.get("exclusions", ()):
        force.addExclusion(i, j)


STATE_FORCES = AMOEBA_FORCES + (HippoNonbondedForce,)


def state_spec(force) -> dict:
    """An AMOEBA force or a HippoNonbondedForce as plain data: kind,
    group and "state", its attributes (particles with their multipoles,
    frames and polarities, covalent maps and polarization groups,
    exclusions and exceptions, methods and settings), which the JAX
    package's class of that name keeps under the same names; a
    torsion-torsion force its grids as given ("grids")."""
    state = {k: copy.deepcopy(v) for k, v in vars(force).items()
             if k not in ("_force_group", "_name", "_grids")}
    spec = {"kind": type(force).__name__, "group": force.getForceGroup(),
            "state": state}
    if isinstance(force, AmoebaTorsionTorsionForce):
        spec["grids"] = [np.asarray(g["raw"], np.float64).tolist()
                         for g in force._grids]
    return spec


def _state_force(spec):
    force = {c.__name__: c for c in STATE_FORCES}[spec["kind"]]()
    force.__dict__.update(copy.deepcopy(spec["state"]))
    for index, grid in enumerate(spec.get("grids", ())):
        force.setTorsionTorsionGrid(index, grid)
    force.setForceGroup(spec["group"])
    return force


def custom_force(spec):
    """The force of a custom_spec dict."""
    kind = spec["kind"]
    if kind in {c.__name__ for c in STATE_FORCES}:
        return _state_force(spec)
    if kind == "RMSDForce":
        force = RMSDForce(spec["reference"], spec["particles"])
    elif kind == "GayBerneForce":
        force = GayBerneForce()
        for p in spec["particles"]:
            force.addParticle(*p)
        for e in spec["exceptions"]:
            force.addException(*e)
        force.setNonbondedMethod(spec["method"])
        force.setCutoffDistance(spec["cutoff"])
        if spec["switch_distance"] >= 0:
            force.setUseSwitchingFunction(True)
            force.setSwitchingDistance(spec["switch_distance"])
    elif kind == "CustomCVForce":
        force = CustomCVForce(spec["energy"])
        _common_custom(force, spec)
        for name, inner in spec["variables"]:
            force.addCollectiveVariable(name, make_force(inner))
    elif kind == "CustomGBForce":
        force = CustomGBForce()
        _common_custom(force, spec)
        for name in spec["parameters"]:
            force.addPerParticleParameter(name)
        for _, p in spec["terms"]:
            force.addParticle(p)
        for value in spec["values"]:
            force.addComputedValue(*value)
        for term in spec["energy_terms"]:
            force.addEnergyTerm(*term)
        _pair_method(force, spec)
    elif kind == "CustomHbondForce":
        force = CustomHbondForce(spec["energy"])
        _common_custom(force, spec)
        for name in spec["donor_parameters"]:
            force.addPerDonorParameter(name)
        for name in spec["acceptor_parameters"]:
            force.addPerAcceptorParameter(name)
        for atoms, p in spec["donors"]:
            force.addDonor(*atoms, p)
        for atoms, p in spec["acceptors"]:
            force.addAcceptor(*atoms, p)
        _pair_method(force, spec)
    elif kind == "CustomManyParticleForce":
        force = CustomManyParticleForce(spec["particles_per_set"],
                                        spec["energy"])
        _common_custom(force, spec)
        for name in spec["parameters"]:
            force.addPerParticleParameter(name)
        for p, t in spec["particles"]:
            force.addParticle(p, t)
        for slot, types in spec["type_filters"]:
            force.setTypeFilter(slot, types)
        force.setPermutationMode(spec["permutation_mode"])
        _pair_method(force, spec)
    else:
        force = _expression_force(spec)
    force.setForceGroup(spec.get("group", 0))
    return force


def _expression_force(spec):
    """The force of a custom_spec dict of forces/custom.py's kinds."""
    kind = spec["kind"]
    cls = {c.__name__: c for c in MODULE_FORCES}[kind]
    if kind == "CustomCompoundBondForce":
        force = cls(spec["particles_per_bond"], spec["energy"])
    elif kind == "CustomCentroidBondForce":
        force = cls(spec["groups_per_bond"], spec["energy"])
        for particles, weights in spec["groups"]:
            force.addGroup(particles, weights)
    else:
        force = cls(spec["energy"])
    _common_custom(force, spec)
    per = ("addPerParticleParameter"
           if kind in ("CustomNonbondedForce", "CustomExternalForce")
           else "addPerBondParameter" if kind in (
               "CustomBondForce", "CustomCompoundBondForce",
               "CustomCentroidBondForce")
           else "addPer%sParameter" % kind[len("Custom"):-len("Force")])
    for name in spec.get("parameters", ()):
        getattr(force, per)(name)
    add = {"CustomNonbondedForce": lambda a, p: force.addParticle(p),
           "CustomExternalForce": lambda a, p: force.addParticle(a[0], p),
           "CustomBondForce": lambda a, p: force.addBond(*a, p),
           "CustomAngleForce": lambda a, p: force.addAngle(*a, p),
           "CustomTorsionForce": lambda a, p: force.addTorsion(*a, p),
           "CustomCompoundBondForce": lambda a, p: force.addBond(a, p),
           "CustomCentroidBondForce": lambda a, p: force.addBond(a, p)}[kind]
    for atoms, p in spec["terms"]:
        add(atoms, p)
    if kind == "CustomNonbondedForce":
        force.setNonbondedMethod(spec["method"])
        force.setCutoffDistance(spec["cutoff"])
        if spec["switch_distance"] >= 0:
            force.setUseSwitchingFunction(True)
            force.setSwitchingDistance(spec["switch_distance"])
        force.setUseLongRangeCorrection(spec["long_range_correction"])
        for i, j in spec["exclusions"]:
            force.addExclusion(i, j)
        for set1, set2 in spec["interaction_groups"]:
            force.addInteractionGroup(set1, set2)
    elif kind != "CustomExternalForce":
        force.setUsesPeriodicBoundaryConditions(spec["periodic"])
    return force


def force_spec(force) -> dict:
    """Any force a CustomCVForce may take as a variable, as plain data:
    custom_spec for MODULE_FORCES; for a NonbondedForce, a GBSAOBCForce or
    a bonded force of from_numpy its kind, group and from_numpy's keys
    (without the group keys)."""
    if isinstance(force, MODULE_FORCES):
        return custom_spec(force)
    spec = {"kind": type(force).__name__, "group": force.getForceGroup()}
    if isinstance(force, NonbondedForce):
        spec.update(_nonbonded_params(force))
    elif isinstance(force, GBSAOBCForce):
        spec.update(_gb_params(force))
    else:
        out = {}
        _other_params([force], out, {})
        spec.update(out)
    return spec


def make_force(spec):
    """The force of a force_spec dict."""
    kind = spec["kind"]
    if kind in {c.__name__ for c in MODULE_FORCES}:
        return custom_force(spec)
    if kind == "NonbondedForce":
        return _nonbonded(spec, spec["group"])
    system = System()
    _add_other_forces(system, spec, {})
    (force,) = system.getForces()
    force.setForceGroup(spec["group"])
    return force


def _make_vsite(kind, parents, weights):
    if kind == "average2":
        return TwoParticleAverageSite(*parents, *weights)
    if kind == "average3":
        return ThreeParticleAverageSite(*parents, *weights)
    if kind == "outofplane":
        return OutOfPlaneSite(*parents, *weights)
    k = len(parents)
    return LocalCoordinatesSite(parents, weights[:k], weights[k:2 * k],
                                weights[2 * k:3 * k], weights[3 * k:])


def _vsite_entry(index, site) -> tuple:
    """from_numpy's vsites entry of one site."""
    parents = tuple(site._particles)
    if isinstance(site, TwoParticleAverageSite):
        return (index, "average2", parents, tuple(site.weights))
    if isinstance(site, ThreeParticleAverageSite):
        return (index, "average3", parents, tuple(site.weights))
    if isinstance(site, OutOfPlaneSite):
        return (index, "outofplane", parents,
                (site.weight12, site.weight13, site.weightCross))
    return (index, "local", parents,
            tuple(site.originWeights) + tuple(site.xWeights)
            + tuple(site.yWeights) + tuple(site.localPosition))


def _barostat(params):
    kind = str(params["barostat_kind"])
    pressure = np.asarray(params["barostat_pressure"], np.float64)
    temperature = float(params["barostat_temperature"])
    frequency = int(params["barostat_frequency"])
    if kind == "iso":
        return MonteCarloBarostat(float(pressure), temperature, frequency)
    if kind == "aniso":
        return MonteCarloAnisotropicBarostat(
            pressure, temperature,
            *(bool(f) for f in params["barostat_scale"]), frequency)
    return MonteCarloMembraneBarostat(
        float(pressure), float(params["barostat_tension"]), temperature,
        int(params["barostat_xymode"]), int(params["barostat_zmode"]),
        frequency)


def _barostat_params(force) -> dict:
    """from_numpy's barostat keys of a barostat."""
    out = {"barostat_pressure": np.asarray(u.plain(force.getDefaultPressure()),
                                           np.float64),
           "barostat_temperature": u.plain(force.getDefaultTemperature()),
           "barostat_frequency": force.getFrequency()}
    if isinstance(force, MonteCarloAnisotropicBarostat):
        out["barostat_kind"] = "aniso"
        out["barostat_scale"] = np.asarray(
            [force.getScaleX(), force.getScaleY(), force.getScaleZ()])
    elif isinstance(force, MonteCarloMembraneBarostat):
        out["barostat_kind"] = "membrane"
        out["barostat_tension"] = u.plain(force.getDefaultSurfaceTension())
        out["barostat_xymode"] = force.getXYMode()
        out["barostat_zmode"] = force.getZMode()
    else:
        out["barostat_kind"] = "iso"
    return out


def _gb_params(force) -> dict:
    """from_numpy's GBSAOBCForce keys of a GBSAOBCForce."""
    p = np.asarray([u.plain(force.getParticleParameters(i))
                    for i in range(force.getNumParticles())],
                   np.float64).reshape(-1, 3)
    return {"gb_charges": p[:, 0], "gb_radii": p[:, 1], "gb_scales": p[:, 2],
            "gb_method": {v: k for k, v in _GB_METHODS.items()}[
                force.getNonbondedMethod()],
            "gb_cutoff": u.plain(force.getCutoffDistance()),
            "gb_solute_dielectric": force.getSoluteDielectric(),
            "gb_solvent_dielectric": force.getSolventDielectric(),
            "gb_surface_energy": u.plain(force.getSurfaceAreaEnergy())}


def to_numpy(system: System) -> dict:
    """The inverse of from_numpy for a System with NonbondedForces, at
    most one force of each other standard kind (one barostat) and custom
    forces, which are in from_numpy's order where the order matters (the
    update hooks)."""
    forces = system.getForces()
    nb, *extra = [f for f in forces if isinstance(f, NonbondedForce)] \
        or [None]
    cons = [u.plain(system.getConstraintParameters(i))
            for i in range(system.getNumConstraints())]
    out = {
        "masses": np.asarray([u.plain(system.getParticleMass(i)) for i in
                              range(system.getNumParticles())], np.float64),
        "constraint_pairs": np.asarray([c[:2] for c in cons],
                                       np.int64).reshape(-1, 2),
        "constraint_distances": np.asarray([c[2] for c in cons], np.float64),
        "box": u.plain(system.getDefaultPeriodicBoxVectors()),
    }
    if nb is not None:
        out.update(_nonbonded_params(nb))
    if extra:
        out["extra_nonbonded"] = [dict(_nonbonded_params(f),
                                       group=f.getForceGroup())
                                  for f in extra]
    custom = [custom_spec(f) for f in forces if isinstance(f, MODULE_FORCES)]
    if custom:
        out["custom_forces"] = custom
    if system._vsites:
        out["vsites"] = [_vsite_entry(i, site)
                         for i, site in sorted(system._vsites.items())]
    groups = {"nonbonded": 0 if nb is None else nb.getForceGroup()}
    _other_params(forces, out, groups)
    groups = {k: g for k, g in groups.items() if g}
    if groups:
        out["force_groups"] = groups
    return out


def _nonbonded_params(nb) -> dict:
    """from_numpy's NonbondedForce keys of a NonbondedForce."""
    part = np.asarray([u.plain(nb.getParticleParameters(i))
                       for i in range(nb.getNumParticles())],
                      np.float64).reshape(-1, 3)
    exc = [u.plain(nb.getExceptionParameters(i)) for i in range(
        nb.getNumExceptions())]
    method = {v: k for k, v in _METHODS.items()}[nb.getNonbondedMethod()]
    out = {
        "charges": part[:, 0], "sigma": part[:, 1], "epsilon": part[:, 2],
        "exception_pairs": np.asarray([e[:2] for e in exc],
                                      np.int64).reshape(-1, 2),
        "exception_params": np.asarray([e[2:] for e in exc],
                                       np.float64).reshape(-1, 3),
        "cutoff": u.plain(nb.getCutoffDistance()), "method": method,
        "ewald_tolerance": nb.getEwaldErrorTolerance(),
        "dispersion_correction": nb.getUseDispersionCorrection(),
        "switch_distance": (u.plain(nb.getSwitchingDistance())
                            if nb.getUseSwitchingFunction() else -1.0),
    }
    if nb.getReactionFieldDielectric() != 78.3:
        out["rf_dielectric"] = nb.getReactionFieldDielectric()
    if nb.getExceptionsUsePeriodicBoundaryConditions():
        out["exceptions_use_pbc"] = True
    if nb.getPMEParameters()[0] != 0.0:
        out["pme_parameters"] = nb.getPMEParameters()
    if nb.getLJPMEParameters()[0] != 0.0:
        out["ljpme_parameters"] = nb.getLJPMEParameters()
    if nb.getReciprocalSpaceForceGroup() != -1:
        out["reciprocal_group"] = nb.getReciprocalSpaceForceGroup()
    if not nb.getIncludeDirectSpace():
        out["include_direct"] = False
    for key, items in (("global_parameters", nb._global_params),
                       ("particle_offsets", nb._particle_offsets),
                       ("exception_offsets", nb._exception_offsets)):
        if items:
            out[key] = list(items)
    return out


def _other_params(forces, out, groups) -> None:
    """from_numpy's keys of the forces other than the NonbondedForces and
    the custom forces, into `out`, their groups into `groups`."""
    for kind, cls, (count, _, get), atoms_key, n_atoms, par_key, n_par \
            in _BONDED:
        (force,) = [f for f in forces if type(f) is cls] or (None,)
        if force is None:
            continue
        terms = [u.plain(getattr(force, get)(i))
                 for i in range(getattr(force, count)())]
        out[atoms_key] = np.asarray([t[:n_atoms] for t in terms],
                                    np.int64).reshape(-1, n_atoms)
        out[par_key] = np.asarray([t[n_atoms:] for t in terms],
                                  np.float64).reshape(-1, n_par)
        groups[kind] = force.getForceGroup()
    for force in forces:
        if isinstance(force, CMAPTorsionForce):
            maps = [u.plain(force.getMapParameters(i))
                    for i in range(force.getNumMaps())]
            out["cmap_sizes"] = np.asarray([m[0] for m in maps], np.int64)
            out["cmap_energies"] = np.asarray(
                [e for m in maps for e in m[1]], np.float64)
            out["cmap_torsions"] = np.asarray(
                [u.plain(force.getTorsionParameters(i))
                 for i in range(force.getNumTorsions())],
                np.int64).reshape(-1, 9)
            groups["cmap"] = force.getForceGroup()
        elif isinstance(force, GBSAOBCForce):
            out.update(_gb_params(force))
            groups["gbsa"] = force.getForceGroup()
        elif isinstance(force, AndersenThermostat):
            out["andersen_temperature"] = u.plain(
                force.getDefaultTemperature())
            out["andersen_frequency"] = u.plain(
                force.getDefaultCollisionFrequency())
            out["andersen_seed"] = force.getRandomNumberSeed()
            groups["andersen"] = force.getForceGroup()
        elif isinstance(force, CMMotionRemover):
            out["cmm_frequency"] = force.getFrequency()
            groups["cmm"] = force.getForceGroup()
        elif isinstance(force, (MonteCarloBarostat,
                                MonteCarloAnisotropicBarostat,
                                MonteCarloMembraneBarostat)):
            out.update(_barostat_params(force))
            groups["barostat"] = force.getForceGroup()
