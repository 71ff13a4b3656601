"""The system under test: a System, Topology, integrator and barostat of the
port (openmm_tpu_torch), built through its public API from the tables that
an inputs module made and the settings of a configuration and a traffic
mix. Nothing here computes a force or an energy."""
from __future__ import annotations

import numpy as np

import openmm_tpu_torch as omm
from openmm_tpu_torch import app

# element of an atom by its mass (amu, rounded)
_ELEMENTS = {1: "H", 12: "C", 14: "N", 16: "O", 31: "P"}


def build_system(tables: dict, barostat: dict | None):
    """(System, Topology) of the tables: the NonbondedForce (PME at the
    tables' cutoff and tolerance, the dispersion correction as stated, the
    exceptions), constraints, harmonic bonds and angles, periodic torsions,
    a CMMotionRemover and, when given, a barostat."""
    system = omm.System()
    for m in np.asarray(tables["masses"], float):
        system.addParticle(float(m))
    for (i, j), d in zip(tables["constraint_pairs"],
                         tables["constraint_distances"]):
        system.addConstraint(int(i), int(j), float(d))
    box = np.asarray(tables["box"], float)
    system.setDefaultPeriodicBoxVectors(*box)
    nb = omm.NonbondedForce()
    nb.setNonbondedMethod(omm.NonbondedForce.PME)
    nb.setCutoffDistance(tables["cutoff"])
    nb.setEwaldErrorTolerance(tables["ewald_tolerance"])
    nb.setUseDispersionCorrection(bool(tables["dispersion_correction"]))
    for q, s, e in zip(tables["charges"], tables["sigma"], tables["epsilon"]):
        nb.addParticle(float(q), float(s), float(e))
    for (i, j), (qq, s, e) in zip(tables["exception_pairs"],
                                  tables["exception_params"]):
        nb.addException(int(i), int(j), float(qq), float(s), float(e))
    system.addForce(nb)
    if len(tables.get("bond_atoms", ())):
        f = omm.HarmonicBondForce()
        for (i, j), (r0, k) in zip(tables["bond_atoms"],
                                   tables["bond_params"]):
            f.addBond(int(i), int(j), float(r0), float(k))
        system.addForce(f)
    if len(tables.get("angle_atoms", ())):
        f = omm.HarmonicAngleForce()
        for (i, j, k), (t0, kt) in zip(tables["angle_atoms"],
                                       tables["angle_params"]):
            f.addAngle(int(i), int(j), int(k), float(t0), float(kt))
        system.addForce(f)
    if len(tables.get("torsion_atoms", ())):
        f = omm.PeriodicTorsionForce()
        for (i, j, k, l), (n, phase, kt) in zip(tables["torsion_atoms"],
                                                tables["torsion_params"]):
            f.addTorsion(int(i), int(j), int(k), int(l), int(round(n)),
                         float(phase), float(kt))
        system.addForce(f)
    if tables["cmm_frequency"] > 0:
        system.addForce(omm.CMMotionRemover(int(tables["cmm_frequency"])))
    if barostat is not None:
        system.addForce(make_barostat(barostat))
    return system, make_topology(tables)


def make_barostat(spec: dict):
    kind = spec["kind"]
    if kind == "membrane":
        b = omm.MonteCarloMembraneBarostat
        return b(spec["pressure_bar"], spec["tension_bar_nm"],
                 spec["temperature_K"], getattr(b, spec["xymode"]),
                 getattr(b, spec["zmode"]), spec["frequency"])
    raise ValueError("unknown barostat kind %r" % kind)


def make_topology(tables: dict):
    """One chain of residues, one a molecule, as tables["molecules"] lists
    them: (residue name, atoms a residue, residues); elements by mass."""
    top = app.Topology()
    chain = top.addChain()
    masses = np.asarray(tables["masses"], float)
    elements = [app.Element.getBySymbol(_ELEMENTS[int(round(m))])
                for m in masses]
    atom = 0
    for name, size, count in tables["molecules"]:
        for _ in range(count):
            res = top.addResidue(name, chain)
            for k in range(size):
                top.addAtom("%s%d" % (elements[atom].symbol, k),
                            elements[atom], res)
                atom += 1
    top.setPeriodicBoxVectors(np.asarray(tables["box"], float))
    return top


def seeds(seed: int) -> dict:
    """The program's random seeds, all drawn from the run's seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF,
                                 (int(seed) >> 32) & 0xFFFFFFFF, 7])
    names = ("integrator", "velocities", "barostat")
    return {k: int(v) for k, v in zip(names, rng.integers(1, 2 ** 31 - 1,
                                                          len(names)))}
