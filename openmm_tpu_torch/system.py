"""System: particles, masses, constraints, the periodic box and forces.

Counterpart of openmm_tpu/system.py. This slice has no unit system: masses
in amu, distances in nm, angles in rad. `from_numpy` and `to_numpy` carry
the parameters of a System across as plain numpy arrays, which is how the
tests hand the same system to this package and to the JAX package.
"""
from __future__ import annotations

import numpy as np

from .forces.barostats import (MonteCarloAnisotropicBarostat,
                               MonteCarloBarostat, MonteCarloMembraneBarostat)
from .forces.bonded import (CMAPTorsionForce, HarmonicAngleForce,
                            HarmonicBondForce, PeriodicTorsionForce,
                            RBTorsionForce)
from .forces.cmmotion import CMMotionRemover
from .forces.nonbonded import NonbondedForce

_METHODS = {"NoCutoff": NonbondedForce.NoCutoff,
            "CutoffNonPeriodic": NonbondedForce.CutoffNonPeriodic,
            "CutoffPeriodic": NonbondedForce.CutoffPeriodic,
            "Ewald": NonbondedForce.Ewald, "PME": NonbondedForce.PME,
            "LJPME": NonbondedForce.LJPME}


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
        self._box = np.diag([2.0, 2.0, 2.0])

    def getNumParticles(self) -> int:
        return len(self._masses)

    def addParticle(self, mass: float) -> int:
        self._masses.append(float(mass))
        return len(self._masses) - 1

    def getParticleMass(self, index: int) -> float:
        return self._masses[index]

    def getNumConstraints(self) -> int:
        return len(self._constraints)

    def addConstraint(self, particle1, particle2, distance) -> int:
        self._constraints.append((int(particle1), int(particle2),
                                  float(distance)))
        return len(self._constraints) - 1

    def getConstraintParameters(self, index: int):
        return self._constraints[index]

    def addForce(self, force) -> int:
        self._forces.append(force)
        return len(self._forces) - 1

    def getNumForces(self) -> int:
        return len(self._forces)

    def getForce(self, index: int):
        return self._forces[index]

    def getForces(self):
        return list(self._forces)

    def setDefaultPeriodicBoxVectors(self, a, b, c) -> None:
        self._box = reduced_box(a, b, c)

    def getDefaultPeriodicBoxVectors(self) -> np.ndarray:
        return self._box.copy()


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

    Always: masses, charges, sigma, epsilon (n,); exception_pairs (m, 2)
    and exception_params (m, 3) = (chargeProd, sigma, epsilon);
    constraint_pairs (k, 2) and constraint_distances (k,); box (3, 3);
    cutoff, method (a NonbondedForce method name), ewald_tolerance,
    dispersion_correction, switch_distance (negative: no switch), which
    make one NonbondedForce.
    Each present key adds a force: bond_pairs (m, 2) with bond_params
    (length, k); angle_triples (m, 3) with angle_params (angle, k);
    torsion_quads (m, 4) with torsion_params (periodicity, phase, k);
    rb_quads (m, 4) with rb_params (c0..c5); cmap_sizes (maps,),
    cmap_energies (the maps' energies one after another) and
    cmap_torsions (m, 9) = (map, a1..a4, b1..b4); cmm_frequency (a
    CMMotionRemover); barostat_kind ("iso", "aniso" or "membrane", a
    barostat) with barostat_pressure (bar; three for "aniso"),
    barostat_temperature (K), barostat_frequency, and for "aniso"
    barostat_scale (three flags), for "membrane" barostat_tension (bar
    nm), barostat_xymode and barostat_zmode. force_groups maps a force's
    kind ("nonbonded", "bond", "angle", "torsion", "rb", "cmap", "cmm",
    "barostat") to its group where that is not 0."""
    system = System()
    for m in np.asarray(params["masses"], np.float64):
        system.addParticle(m)
    for (i, j), d in zip(np.asarray(params["constraint_pairs"]).reshape(-1, 2),
                         np.asarray(params["constraint_distances"])):
        system.addConstraint(i, j, d)
    system.setDefaultPeriodicBoxVectors(*np.asarray(params["box"]))
    groups = params.get("force_groups", {})
    nb = NonbondedForce()
    nb.setNonbondedMethod(_METHODS[params["method"]])
    nb.setCutoffDistance(params["cutoff"])
    nb.setEwaldErrorTolerance(params["ewald_tolerance"])
    nb.setUseDispersionCorrection(params["dispersion_correction"])
    if params["switch_distance"] >= 0:
        nb.setUseSwitchingFunction(True)
        nb.setSwitchingDistance(params["switch_distance"])
    for q, s, e in zip(params["charges"], params["sigma"], params["epsilon"]):
        nb.addParticle(q, s, e)
    for (i, j), (cp, s, e) in zip(
            np.asarray(params["exception_pairs"]).reshape(-1, 2),
            np.asarray(params["exception_params"]).reshape(-1, 3)):
        nb.addException(i, j, cp, s, e)
    nb.setForceGroup(groups.get("nonbonded", 0))
    system.addForce(nb)
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
    return system


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
    out = {"barostat_pressure": np.asarray(force.getDefaultPressure(),
                                           np.float64),
           "barostat_temperature": force.getDefaultTemperature(),
           "barostat_frequency": force.getFrequency()}
    if isinstance(force, MonteCarloAnisotropicBarostat):
        out["barostat_kind"] = "aniso"
        out["barostat_scale"] = np.asarray(
            [force.getScaleX(), force.getScaleY(), force.getScaleZ()])
    elif isinstance(force, MonteCarloMembraneBarostat):
        out["barostat_kind"] = "membrane"
        out["barostat_tension"] = force.getDefaultSurfaceTension()
        out["barostat_xymode"] = force.getXYMode()
        out["barostat_zmode"] = force.getZMode()
    else:
        out["barostat_kind"] = "iso"
    return out


def to_numpy(system: System) -> dict:
    """The inverse of from_numpy for a System with one NonbondedForce and
    at most one force of each other kind (one barostat)."""
    forces = system.getForces()
    (nb,) = [f for f in forces if isinstance(f, NonbondedForce)]
    part = np.asarray([nb.getParticleParameters(i)
                       for i in range(nb.getNumParticles())],
                      np.float64).reshape(-1, 3)
    exc = [nb.getExceptionParameters(i) for i in range(nb.getNumExceptions())]
    cons = [system.getConstraintParameters(i)
            for i in range(system.getNumConstraints())]
    method = {v: k for k, v in _METHODS.items()}[nb.getNonbondedMethod()]
    out = {
        "masses": np.asarray([system.getParticleMass(i) for i in
                              range(system.getNumParticles())], np.float64),
        "charges": part[:, 0], "sigma": part[:, 1], "epsilon": part[:, 2],
        "exception_pairs": np.asarray([e[:2] for e in exc],
                                      np.int64).reshape(-1, 2),
        "exception_params": np.asarray([e[2:] for e in exc],
                                       np.float64).reshape(-1, 3),
        "constraint_pairs": np.asarray([c[:2] for c in cons],
                                       np.int64).reshape(-1, 2),
        "constraint_distances": np.asarray([c[2] for c in cons], np.float64),
        "box": system.getDefaultPeriodicBoxVectors(),
        "cutoff": nb.getCutoffDistance(), "method": method,
        "ewald_tolerance": nb.getEwaldErrorTolerance(),
        "dispersion_correction": nb.getUseDispersionCorrection(),
        "switch_distance": (nb.getSwitchingDistance()
                            if nb.getUseSwitchingFunction() else -1.0),
    }
    groups = {"nonbonded": nb.getForceGroup()}
    for kind, cls, (count, _, get), atoms_key, n_atoms, par_key, n_par \
            in _BONDED:
        (force,) = [f for f in forces if type(f) is cls] or (None,)
        if force is None:
            continue
        terms = [getattr(force, get)(i)
                 for i in range(getattr(force, count)())]
        out[atoms_key] = np.asarray([t[:n_atoms] for t in terms],
                                    np.int64).reshape(-1, n_atoms)
        out[par_key] = np.asarray([t[n_atoms:] for t in terms],
                                  np.float64).reshape(-1, n_par)
        groups[kind] = force.getForceGroup()
    for force in forces:
        if isinstance(force, CMAPTorsionForce):
            maps = [force.getMapParameters(i)
                    for i in range(force.getNumMaps())]
            out["cmap_sizes"] = np.asarray([m[0] for m in maps], np.int64)
            out["cmap_energies"] = np.asarray(
                [e for m in maps for e in m[1]], np.float64)
            out["cmap_torsions"] = np.asarray(
                [force.getTorsionParameters(i)
                 for i in range(force.getNumTorsions())],
                np.int64).reshape(-1, 9)
            groups["cmap"] = force.getForceGroup()
        elif isinstance(force, CMMotionRemover):
            out["cmm_frequency"] = force.getFrequency()
            groups["cmm"] = force.getForceGroup()
        elif isinstance(force, (MonteCarloBarostat,
                                MonteCarloAnisotropicBarostat,
                                MonteCarloMembraneBarostat)):
            out.update(_barostat_params(force))
            groups["barostat"] = force.getForceGroup()
    groups = {k: g for k, g in groups.items() if g}
    if groups:
        out["force_groups"] = groups
    return out
