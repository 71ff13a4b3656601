"""System: particles, masses, constraints, the periodic box and forces.

Counterpart of openmm_tpu/system.py. This slice has no unit system: masses
in amu, distances in nm. `from_numpy` and `to_numpy` carry the parameters of
a System with one NonbondedForce across as plain numpy arrays, which is how
the tests hand the same system to this package and to the JAX package.
"""
from __future__ import annotations

import numpy as np

from .forces.nonbonded import NonbondedForce

_METHODS = {"NoCutoff": NonbondedForce.NoCutoff,
            "CutoffNonPeriodic": NonbondedForce.CutoffNonPeriodic,
            "CutoffPeriodic": NonbondedForce.CutoffPeriodic,
            "Ewald": NonbondedForce.Ewald, "PME": NonbondedForce.PME,
            "LJPME": NonbondedForce.LJPME}


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
        self._box = box

    def getDefaultPeriodicBoxVectors(self) -> np.ndarray:
        return self._box.copy()


def from_numpy(params: dict) -> System:
    """A System with one NonbondedForce from a dict of numpy arrays:
    masses, charges, sigma, epsilon (n,); exception_pairs (m, 2) and
    exception_params (m, 3) = (chargeProd, sigma, epsilon);
    constraint_pairs (k, 2) and constraint_distances (k,); box (3, 3);
    cutoff, method (a NonbondedForce method name), ewald_tolerance,
    dispersion_correction, switch_distance (negative: no switch)."""
    system = System()
    for m in np.asarray(params["masses"], np.float64):
        system.addParticle(m)
    for (i, j), d in zip(np.asarray(params["constraint_pairs"]).reshape(-1, 2),
                         np.asarray(params["constraint_distances"])):
        system.addConstraint(i, j, d)
    system.setDefaultPeriodicBoxVectors(*np.asarray(params["box"]))
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
    system.addForce(nb)
    return system


def to_numpy(system: System) -> dict:
    """The inverse of from_numpy for a System with one NonbondedForce."""
    (nb,) = [f for f in system.getForces() if isinstance(f, NonbondedForce)]
    part = np.asarray([nb.getParticleParameters(i)
                       for i in range(nb.getNumParticles())],
                      np.float64).reshape(-1, 3)
    exc = [nb.getExceptionParameters(i) for i in range(nb.getNumExceptions())]
    cons = [system.getConstraintParameters(i)
            for i in range(system.getNumConstraints())]
    method = {v: k for k, v in _METHODS.items()}[nb.getNonbondedMethod()]
    return {
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
