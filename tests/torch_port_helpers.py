"""Helpers for the tests that hold openmm_tpu_torch against openmm_tpu.

The only place the two packages meet: system parameters cross from the JAX
package's System (read through its getters) into the port as the plain
numpy dict that openmm_tpu_torch.from_numpy takes.

Importing it caps torch at one intra-op thread: the test runner starts
several worker processes, and torch's default of a thread per core in each
of them oversubscribes the cores many times over.
"""
import numpy as np
import torch

from openmm_tpu import unit as u
from openmm_tpu.forces import NonbondedForce

torch.set_num_threads(1)

_METHOD_NAMES = {NonbondedForce.NoCutoff: "NoCutoff",
                 NonbondedForce.CutoffNonPeriodic: "CutoffNonPeriodic",
                 NonbondedForce.CutoffPeriodic: "CutoffPeriodic",
                 NonbondedForce.Ewald: "Ewald", NonbondedForce.PME: "PME",
                 NonbondedForce.LJPME: "LJPME"}


def system_params(system):
    """The from_numpy dict of a JAX-package System with one
    NonbondedForce."""
    (nb,) = [f for f in system.getForces() if isinstance(f, NonbondedForce)]
    n = system.getNumParticles()
    masses = np.array([u.strip(system.getParticleMass(i), u.dalton)
                       for i in range(n)], np.float64)
    part = np.array([[float(u.strip(x)) for x in nb.getParticleParameters(i)]
                     for i in range(nb.getNumParticles())], np.float64)
    exc = [nb.getExceptionParameters(i) for i in range(nb.getNumExceptions())]
    cons = [system.getConstraintParameters(i)
            for i in range(system.getNumConstraints())]
    box = np.array([u.strip(v, u.nanometer)
                    for v in system.getDefaultPeriodicBoxVectors()],
                   np.float64)
    return {
        "masses": masses,
        "charges": part[:, 0], "sigma": part[:, 1], "epsilon": part[:, 2],
        "exception_pairs": np.array([e[:2] for e in exc],
                                    np.int64).reshape(-1, 2),
        "exception_params": np.array(
            [[float(u.strip(x)) for x in e[2:]] for e in exc],
            np.float64).reshape(-1, 3),
        "constraint_pairs": np.array([c[:2] for c in cons],
                                     np.int64).reshape(-1, 2),
        "constraint_distances": np.array(
            [float(u.strip(c[2], u.nanometer)) for c in cons], np.float64),
        "box": box,
        "cutoff": float(u.strip(nb.getCutoffDistance(), u.nanometer)),
        "method": _METHOD_NAMES[nb.getNonbondedMethod()],
        "ewald_tolerance": nb.getEwaldErrorTolerance(),
        "dispersion_correction": nb.getUseDispersionCorrection(),
        "switch_distance": (float(u.strip(nb.getSwitchingDistance(),
                                          u.nanometer))
                            if nb.getUseSwitchingFunction() else -1.0),
    }


def median_relative_error(forces, reference):
    """Median over atoms of |f - f_ref| / |f_ref| (testInstallation)."""
    ref = np.asarray(reference, np.float64)
    norm = np.linalg.norm(ref, axis=1)
    norm = np.where(norm == 0.0, 1.0, norm)
    return float(np.median(np.linalg.norm(
        np.asarray(forces, np.float64) - ref, axis=1) / norm))
