"""Helpers for the tests that hold openmm_tpu_torch against openmm_tpu.

The only place the two packages meet: system parameters cross from the JAX
package's System (read through its getters) into the port as the plain
numpy dict that openmm_tpu_torch.from_numpy takes. The POPC bilayer's
templates (openmm_tpu_torch/models/data/popc_bilayer.npz) are made here
from the JAX package's ForceField:

    python tests/torch_port_helpers.py

writes that file anew.

The port's getters return Quantities, as the JAX package's do; the tests
read them in MD units through `plain` (openmm_tpu_torch.unit.plain: a
Quantity stripped to MD units, vectors as a float64 array).

Importing it caps torch at one intra-op thread: the test runner starts
several worker processes, and torch's default of a thread per core in each
of them oversubscribes the cores many times over.
"""
import os
import sys

import copy

import numpy as np
import torch

from openmm_tpu import unit as u
import openmm_tpu as mm
from openmm_tpu.forces import (AndersenThermostat, CMAPTorsionForce,
                               CMMotionRemover, GBSAOBCForce,
                               HarmonicAngleForce, HarmonicBondForce,
                               NonbondedForce, PeriodicTorsionForce,
                               RBTorsionForce)
from openmm_tpu.forces.barostats import (MonteCarloAnisotropicBarostat,
                                         MonteCarloBarostat,
                                         MonteCarloMembraneBarostat)

from openmm_tpu_torch.unit import plain

torch.set_num_threads(1)

_GB_METHOD_NAMES = {GBSAOBCForce.NoCutoff: "NoCutoff",
                    GBSAOBCForce.CutoffNonPeriodic: "CutoffNonPeriodic",
                    GBSAOBCForce.CutoffPeriodic: "CutoffPeriodic"}
_METHOD_NAMES = {NonbondedForce.NoCutoff: "NoCutoff",
                 NonbondedForce.CutoffNonPeriodic: "CutoffNonPeriodic",
                 NonbondedForce.CutoffPeriodic: "CutoffPeriodic",
                 NonbondedForce.Ewald: "Ewald", NonbondedForce.PME: "PME",
                 NonbondedForce.LJPME: "LJPME"}


# (kind, JAX class, its term list, atoms a term, from_numpy's keys)
_BONDED = (("bond", HarmonicBondForce, "_bonds", 2, "bond_pairs",
            "bond_params"),
           ("angle", HarmonicAngleForce, "_angles", 3, "angle_triples",
            "angle_params"),
           ("torsion", PeriodicTorsionForce, "_torsions", 4, "torsion_quads",
            "torsion_params"),
           ("rb", RBTorsionForce, "_torsions", 4, "rb_quads", "rb_params"))


def system_params(system):
    """The from_numpy dict of a JAX-package System with NonbondedForces (or
    none), at most one force of each bonded kind, one GBSAOBCForce, one
    CMMotionRemover, one Monte Carlo barostat, one AndersenThermostat and
    custom forces (the term lists hold plain floats in nm, rad and kJ/mol;
    the barostat's settings in bar, bar nm and K)."""
    forces = system.getForces()
    nb, *extra = [f for f in forces if isinstance(f, NonbondedForce)] \
        or [None]
    n = system.getNumParticles()
    masses = np.array([u.strip(system.getParticleMass(i), u.dalton)
                       for i in range(n)], np.float64)
    cons = [system.getConstraintParameters(i)
            for i in range(system.getNumConstraints())]
    box = np.array([u.strip(v, u.nanometer)
                    for v in system.getDefaultPeriodicBoxVectors()],
                   np.float64)
    out = {
        "masses": masses,
        "constraint_pairs": np.array([c[:2] for c in cons],
                                     np.int64).reshape(-1, 2),
        "constraint_distances": np.array(
            [float(u.strip(c[2], u.nanometer)) for c in cons], np.float64),
        "box": box,
    }
    if nb is not None:
        out.update(_nonbonded_params(nb))
    if extra:
        out["extra_nonbonded"] = [dict(_nonbonded_params(f),
                                       group=f.getForceGroup())
                                  for f in extra]
    custom = [custom_spec(f) for f in forces
              if type(f).__name__ in CUSTOM_KINDS]
    if custom:
        out["custom_forces"] = custom
    if system._vsites:
        out["vsites"] = [vsite_entry(i, site)
                         for i, site in sorted(system._vsites.items())]
    groups = {"nonbonded": 0 if nb is None else nb.getForceGroup()}
    _other_params(forces, out, groups)
    groups = {kind: g for kind, g in groups.items() if g}
    if groups:
        out["force_groups"] = groups
    return out


def _nonbonded_params(nb):
    """from_numpy's NonbondedForce keys of a JAX-package NonbondedForce."""
    # the term lists the getters wrap in Quantities (e, nm, kJ/mol), read
    # as they are: stripping each Quantity costs seconds on a protein
    part = np.array(nb._particles, np.float64).reshape(-1, 3)
    exc = nb._exceptions
    out = {
        "charges": part[:, 0], "sigma": part[:, 1], "epsilon": part[:, 2],
        "exception_pairs": np.array([e[:2] for e in exc],
                                    np.int64).reshape(-1, 2),
        "exception_params": np.array([e[2:] for e in exc],
                                     np.float64).reshape(-1, 3),
        "cutoff": float(u.strip(nb.getCutoffDistance(), u.nanometer)),
        "method": _METHOD_NAMES[nb.getNonbondedMethod()],
        "ewald_tolerance": nb.getEwaldErrorTolerance(),
        "dispersion_correction": nb.getUseDispersionCorrection(),
        "switch_distance": (float(u.strip(nb.getSwitchingDistance(),
                                          u.nanometer))
                            if nb.getUseSwitchingFunction() else -1.0),
    }
    # the keys from_numpy reads only where they differ from its defaults
    if nb.getReactionFieldDielectric() != 78.3:
        out["rf_dielectric"] = nb.getReactionFieldDielectric()
    if nb.getExceptionsUsePeriodicBoundaryConditions():
        out["exceptions_use_pbc"] = True
    if nb.getPMEParameters()[0] != 0.0:
        out["pme_parameters"] = tuple(nb.getPMEParameters())
    if nb.getLJPMEParameters()[0] != 0.0:
        out["ljpme_parameters"] = tuple(nb.getLJPMEParameters())
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


def _other_params(forces, out, groups):
    """from_numpy's keys of the standard forces besides the
    NonbondedForces, into `out`, their groups into `groups`."""
    for kind, cls, terms, k, atoms_key, par_key in _BONDED:
        (force,) = [f for f in forces if type(f) is cls] or (None,)
        if force is None:
            continue
        rows = getattr(force, terms)
        out[atoms_key] = np.array([t[:k] for t in rows],
                                  np.int64).reshape(len(rows), k)
        n_par = {"bond": 2, "angle": 2, "torsion": 3, "rb": 6}[kind]
        out[par_key] = np.array([t[k:] for t in rows],
                                np.float64).reshape(len(rows), n_par)
        groups[kind] = force.getForceGroup()
    for force in forces:
        if isinstance(force, CMAPTorsionForce):
            out["cmap_sizes"] = np.array([m[0] for m in force._maps],
                                         np.int64)
            out["cmap_energies"] = np.array(
                [e for m in force._maps for e in m[1]], np.float64)
            out["cmap_torsions"] = np.array(force._torsions,
                                            np.int64).reshape(-1, 9)
            groups["cmap"] = force.getForceGroup()
        elif isinstance(force, CMMotionRemover):
            out["cmm_frequency"] = force.getFrequency()
            groups["cmm"] = force.getForceGroup()
        elif isinstance(force, GBSAOBCForce):
            out.update(gb_params(force))
            groups["gbsa"] = force.getForceGroup()
        elif isinstance(force, AndersenThermostat):
            out["andersen_temperature"] = float(u.strip(
                force.getDefaultTemperature(), u.kelvin))
            out["andersen_frequency"] = float(u.strip(
                force.getDefaultCollisionFrequency(), u.picosecond ** -1))
            out["andersen_seed"] = force.getRandomNumberSeed()
            groups["andersen"] = force.getForceGroup()
        elif isinstance(force, (MonteCarloBarostat,
                                MonteCarloAnisotropicBarostat,
                                MonteCarloMembraneBarostat)):
            out.update(barostat_params(force))
            groups["barostat"] = force.getForceGroup()


# forces that travel as their attributes (openmm_tpu_torch.system
# state_spec): the AMOEBA forces and HippoNonbondedForce
STATE_KINDS = ("AmoebaVdwForce", "AmoebaMultipoleForce",
               "AmoebaTorsionTorsionForce", "AmoebaGeneralizedKirkwoodForce",
               "AmoebaWcaDispersionForce", "HippoNonbondedForce")
CUSTOM_KINDS = ("CustomExternalForce", "CustomBondForce", "CustomAngleForce",
                "CustomTorsionForce", "CustomNonbondedForce",
                "CustomCompoundBondForce", "CustomCentroidBondForce",
                "CustomGBForce", "CustomCVForce", "RMSDForce",
                "CustomHbondForce", "CustomManyParticleForce",
                "GayBerneForce") + STATE_KINDS


def _functions(force):
    functions = []
    for name, fn in force._functions:
        args = fn.getFunctionParameters()
        fkind = type(fn).__name__
        functions.append((name, fkind, (args,) if fkind ==
                          "Discrete1DFunction" else tuple(args),
                          fn.getPeriodic()))
    return functions


def custom_spec(force):
    """The from_numpy custom_forces entry (openmm_tpu_torch.system
    custom_spec) of a JAX-package force of CUSTOM_KINDS."""
    kind = type(force).__name__
    spec = {"kind": kind, "group": force.getForceGroup()}
    if kind in STATE_KINDS:
        spec["state"] = {k: copy.deepcopy(v) for k, v in vars(force).items()
                         if k not in ("_force_group", "_name", "_grids")}
        if kind == "AmoebaTorsionTorsionForce":
            spec["grids"] = [np.asarray(g["raw"], np.float64).tolist()
                             for g in force._grids]
        return spec
    if kind == "RMSDForce":
        spec.update(reference=np.asarray(force._ref).tolist(),
                    particles=list(force._particles))
        return spec
    if kind == "GayBerneForce":
        spec.update(particles=list(force._particles),
                    exceptions=list(force._exceptions),
                    method=force._method, cutoff=force._cutoff,
                    switch_distance=(force._switch_dist if force._switching
                                     else -1.0))
        return spec
    spec.update({"energy": force.getEnergyFunction(),
                 "globals": list(force._global_params),
                 "derivatives": list(force._deriv_requests),
                 "functions": _functions(force),
                 "periodic": bool(force.usesPeriodicBoundaryConditions())})
    if kind == "CustomCVForce":
        spec["variables"] = [(name, force_spec(f)) for name, f in force._cvs]
    elif kind == "CustomGBForce":
        spec.update(parameters=list(force._per_particle),
                    terms=[((), list(p)) for p in force._particles],
                    values=list(force._values),
                    energy_terms=list(force._energy_terms),
                    exclusions=list(force._exclusions),
                    method=force._method, cutoff=force._cutoff)
    elif kind == "CustomHbondForce":
        spec.update(donor_parameters=list(force._per_donor),
                    acceptor_parameters=list(force._per_acceptor),
                    donors=[(tuple(a), list(p)) for a, p in force._donors],
                    acceptors=[(tuple(a), list(p))
                               for a, p in force._acceptors],
                    exclusions=list(force._exclusions),
                    method=force._method, cutoff=force._cutoff)
    elif kind == "CustomManyParticleForce":
        spec.update(particles_per_set=force._n_per_set,
                    parameters=list(force._per_particle),
                    particles=[(list(p), t) for p, t in force._particles],
                    type_filters=[(slot, sorted(types)) for slot, types
                                  in sorted(force._type_filters.items())],
                    permutation_mode=force._mode,
                    exclusions=list(force._exclusions),
                    method=force._method, cutoff=force._cutoff)
    elif kind == "CustomNonbondedForce":
        spec.update(parameters=list(force._per_particle),
                    terms=[((), list(p)) for p in force._particles],
                    method=force._method, cutoff=force._cutoff,
                    switch_distance=(force._switch_dist if force._switching
                                     else -1.0),
                    long_range_correction=force._lrc,
                    exclusions=list(force._exclusions),
                    interaction_groups=list(force._groups))
    elif kind == "CustomExternalForce":
        spec.update(parameters=list(force._per_particle),
                    terms=[((t[0],), list(t[1])) for t in force._terms])
    else:
        spec.update(parameters=list(force._per_term),
                    terms=[(tuple(a), list(p)) for a, p in force._terms])
        if kind == "CustomCompoundBondForce":
            spec["particles_per_bond"] = force._n_atoms
        elif kind == "CustomCentroidBondForce":
            spec["groups_per_bond"] = force._n_groups
            spec["groups"] = [(tuple(p), None if w is None else list(w))
                              for p, w in force._groups]
    return spec


def force_spec(force):
    """openmm_tpu_torch.system.force_spec of a JAX-package force: a CV's
    variable."""
    kind = type(force).__name__
    if kind in CUSTOM_KINDS:
        return custom_spec(force)
    spec = {"kind": kind, "group": force.getForceGroup()}
    if isinstance(force, NonbondedForce):
        spec.update(_nonbonded_params(force))
    elif isinstance(force, GBSAOBCForce):
        spec.update(gb_params(force))
    else:
        out = {}
        _other_params([force], out, {})
        spec.update(out)
    return spec


def jax_force(spec):
    """The JAX-package force of a force_spec dict."""
    kind = spec["kind"]
    if kind in CUSTOM_KINDS:
        return jax_custom_force(spec)
    if kind == "NonbondedForce":
        return _jax_nonbonded(spec, spec["group"])
    system = mm.System()
    _jax_other_forces(system, spec, {})
    (force,) = system.getForces()
    force.setForceGroup(spec["group"])
    return force


def _jax_common(force, spec):
    from openmm_tpu import tabulated
    for name, default in spec.get("globals", ()):
        force.addGlobalParameter(name, default)
    for name in spec.get("derivatives", ()):
        force.addEnergyParameterDerivative(name)
    for name, fkind, args, periodic in spec.get("functions", ()):
        fcls = getattr(tabulated, fkind)
        force.addTabulatedFunction(name, fcls(*args, periodic)
                                   if fkind.startswith("Continuous")
                                   else fcls(*args))


def _jax_pair_method(force, spec):
    force.setNonbondedMethod(spec["method"])
    force.setCutoffDistance(spec["cutoff"])
    for i, j in spec.get("exclusions", ()):
        force.addExclusion(i, j)


def jax_custom_force(spec):
    """The JAX-package force of a custom_spec dict."""
    from openmm_tpu import forces
    from openmm_tpu.forces import custom
    kind = spec["kind"]
    if kind in STATE_KINDS:
        force = getattr(forces, kind)()
        force.__dict__.update(copy.deepcopy(spec["state"]))
        for index, grid in enumerate(spec.get("grids", ())):
            force.setTorsionTorsionGrid(index, grid)
        force.setForceGroup(spec["group"])
        return force
    if kind == "RMSDForce":
        force = forces.RMSDForce(np.asarray(spec["reference"]),
                                 spec["particles"])
    elif kind == "GayBerneForce":
        force = forces.GayBerneForce()
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
        force = forces.CustomCVForce(spec["energy"])
        _jax_common(force, spec)
        for name, inner in spec["variables"]:
            force.addCollectiveVariable(name, jax_force(inner))
    elif kind == "CustomGBForce":
        force = forces.CustomGBForce()
        _jax_common(force, spec)
        for name in spec["parameters"]:
            force.addPerParticleParameter(name)
        for _, p in spec["terms"]:
            force.addParticle(p)
        for value in spec["values"]:
            force.addComputedValue(*value)
        for term in spec["energy_terms"]:
            force.addEnergyTerm(*term)
        _jax_pair_method(force, spec)
    elif kind == "CustomHbondForce":
        force = forces.CustomHbondForce(spec["energy"])
        _jax_common(force, spec)
        for name in spec["donor_parameters"]:
            force.addPerDonorParameter(name)
        for name in spec["acceptor_parameters"]:
            force.addPerAcceptorParameter(name)
        for atoms, p in spec["donors"]:
            force.addDonor(*atoms, p)
        for atoms, p in spec["acceptors"]:
            force.addAcceptor(*atoms, p)
        _jax_pair_method(force, spec)
    elif kind == "CustomManyParticleForce":
        force = forces.CustomManyParticleForce(spec["particles_per_set"],
                                               spec["energy"])
        _jax_common(force, spec)
        for name in spec["parameters"]:
            force.addPerParticleParameter(name)
        for p, t in spec["particles"]:
            force.addParticle(p, t)
        for slot, types in spec["type_filters"]:
            force.setTypeFilter(slot, types)
        force.setPermutationMode(spec["permutation_mode"])
        _jax_pair_method(force, spec)
    else:
        cls = getattr(custom, kind)
        if kind == "CustomCompoundBondForce":
            force = cls(spec["particles_per_bond"], spec["energy"])
        elif kind == "CustomCentroidBondForce":
            force = cls(spec["groups_per_bond"], spec["energy"])
            for particles, weights in spec["groups"]:
                force.addGroup(list(particles), weights)
        else:
            force = cls(spec["energy"])
        _jax_common(force, spec)
        for name in spec.get("parameters", ()):
            if kind in ("CustomNonbondedForce", "CustomExternalForce"):
                force.addPerParticleParameter(name)
            elif kind == "CustomAngleForce":
                force.addPerAngleParameter(name)
            elif kind == "CustomTorsionForce":
                force.addPerTorsionParameter(name)
            else:
                force.addPerBondParameter(name)
        for atoms, p in spec["terms"]:
            if kind == "CustomNonbondedForce":
                force.addParticle(p)
            elif kind == "CustomExternalForce":
                force.addParticle(atoms[0], p)
            elif kind == "CustomBondForce":
                force.addBond(*atoms, p)
            elif kind == "CustomAngleForce":
                force.addAngle(*atoms, p)
            elif kind == "CustomTorsionForce":
                force.addTorsion(*atoms, p)
            else:
                force.addBond(list(atoms), p)
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
    force.setForceGroup(spec.get("group", 0))
    return force


def vsite_entry(index, site):
    """from_numpy's vsites entry of a JAX-package virtual site."""
    from openmm_tpu.system import (OutOfPlaneSite, ThreeParticleAverageSite,
                                   TwoParticleAverageSite)
    parents = tuple(int(p) for p in site._particles)
    if isinstance(site, TwoParticleAverageSite):
        return (index, "average2", parents, tuple(site.weights))
    if isinstance(site, ThreeParticleAverageSite):
        return (index, "average3", parents, tuple(site.weights))
    if isinstance(site, OutOfPlaneSite):
        return (index, "outofplane", parents,
                (site.weight12, site.weight13, site.weightCross))
    return (index, "local", parents,
            tuple(site.originWeights) + tuple(site.xWeights)
            + tuple(site.yWeights) + tuple(float(x)
                                           for x in site.localPosition))


def jax_vsite(kind, parents, weights):
    """The JAX-package virtual site of a from_numpy vsites entry."""
    from openmm_tpu.system import (LocalCoordinatesSite, OutOfPlaneSite,
                                   ThreeParticleAverageSite,
                                   TwoParticleAverageSite)
    parents = [int(p) for p in parents]
    if kind == "average2":
        return TwoParticleAverageSite(*parents, *weights)
    if kind == "average3":
        return ThreeParticleAverageSite(*parents, *weights)
    if kind == "outofplane":
        return OutOfPlaneSite(*parents, *weights)
    k = len(parents)
    return LocalCoordinatesSite(parents, weights[:k], weights[k:2 * k],
                                weights[2 * k:3 * k],
                                mm.Vec3(*weights[3 * k:]))


def gb_params(force):
    """from_numpy's GBSAOBCForce keys of a JAX-package GBSAOBCForce."""
    p = np.array([[float(u.strip(x)) for x in
                   force.getParticleParameters(i)]
                  for i in range(force.getNumParticles())],
                 np.float64).reshape(-1, 3)
    return {"gb_charges": p[:, 0], "gb_radii": p[:, 1], "gb_scales": p[:, 2],
            "gb_method": _GB_METHOD_NAMES[force.getNonbondedMethod()],
            "gb_cutoff": float(u.strip(force.getCutoffDistance(),
                                       u.nanometer)),
            "gb_solute_dielectric": force.getSoluteDielectric(),
            "gb_solvent_dielectric": force.getSolventDielectric(),
            "gb_surface_energy": float(u.strip(
                force.getSurfaceAreaEnergy(),
                u.kilojoule_per_mole / u.nanometer ** 2))}


def jax_system(params):
    """The JAX-package System of a from_numpy dict with the keys of a
    NonbondedForce (with its optional keys: PME and LJPME parameters, the
    reciprocal group, include_direct, global parameters and offsets),
    virtual sites, the bonded forces but CMAP, a GBSAOBCForce, a
    CMMotionRemover and an AndersenThermostat, its forces in from_numpy's
    order."""
    system = mm.System()
    for m in params["masses"]:
        system.addParticle(float(m))
    for (i, j), d in zip(np.asarray(params["constraint_pairs"]).reshape(
            -1, 2), params["constraint_distances"]):
        system.addConstraint(int(i), int(j), float(d))
    box = np.asarray(params["box"], np.float64)
    system.setDefaultPeriodicBoxVectors(*(mm.Vec3(*row) for row in box))
    groups = params.get("force_groups", {})
    for index, kind, parents, weights in params.get("vsites", ()):
        system.setVirtualSite(int(index), jax_vsite(kind, parents, weights))
    if "charges" in params:
        system.addForce(_jax_nonbonded(params, groups.get("nonbonded", 0)))
    for extra in params.get("extra_nonbonded", ()):
        system.addForce(_jax_nonbonded(extra, extra.get("group", 0)))
    _jax_other_forces(system, params, groups)
    for spec in params.get("custom_forces", ()):
        system.addForce(jax_custom_force(spec))
    return system


def _jax_nonbonded(params, group):
    """The JAX-package NonbondedForce of from_numpy's NonbondedForce
    keys."""
    nb = mm.NonbondedForce()
    nb.setNonbondedMethod(getattr(mm.NonbondedForce, params["method"]))
    nb.setCutoffDistance(params["cutoff"])
    nb.setEwaldErrorTolerance(params["ewald_tolerance"])
    nb.setUseDispersionCorrection(params["dispersion_correction"])
    if params["switch_distance"] >= 0:
        nb.setUseSwitchingFunction(True)
        nb.setSwitchingDistance(params["switch_distance"])
    nb.setReactionFieldDielectric(params.get("rf_dielectric", 78.3))
    for q, s, e in zip(params["charges"], params["sigma"],
                       params["epsilon"]):
        nb.addParticle(float(q), float(s), float(e))
    for (i, j), (cp, s, e) in zip(
            np.asarray(params["exception_pairs"]).reshape(-1, 2),
            np.asarray(params["exception_params"]).reshape(-1, 3)):
        nb.addException(int(i), int(j), float(cp), float(s), float(e))
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


def _jax_other_forces(system, params, groups):
    """The JAX-package forces of the keys after the NonbondedForces."""
    if "gb_charges" in params:
        gb = mm.GBSAOBCForce()
        gb.setNonbondedMethod(getattr(mm.GBSAOBCForce, params["gb_method"]))
        gb.setCutoffDistance(params["gb_cutoff"])
        gb.setSoluteDielectric(params["gb_solute_dielectric"])
        gb.setSolventDielectric(params["gb_solvent_dielectric"])
        gb.setSurfaceAreaEnergy(params["gb_surface_energy"])
        for q, r, s in zip(params["gb_charges"], params["gb_radii"],
                           params["gb_scales"]):
            gb.addParticle(float(q), float(r), float(s))
        gb.setForceGroup(groups.get("gbsa", 0))
        system.addForce(gb)
    for kind, cls, terms, k, atoms_key, par_key in _BONDED:
        if atoms_key not in params:
            continue
        force = cls()
        add = force.addBond if cls is HarmonicBondForce else (
            force.addAngle if cls is HarmonicAngleForce else force.addTorsion)
        for atoms, p in zip(params[atoms_key], params[par_key]):
            add(*(int(a) for a in atoms), *(
                int(x) if cls is PeriodicTorsionForce and c == 0
                else float(x) for c, x in enumerate(p)))
        force.setForceGroup(groups.get(kind, 0))
        system.addForce(force)
    if "cmm_frequency" in params:
        cmm = mm.CMMotionRemover(int(params["cmm_frequency"]))
        cmm.setForceGroup(groups.get("cmm", 0))
        system.addForce(cmm)
    if "andersen_temperature" in params:
        thermostat = mm.AndersenThermostat(
            float(params["andersen_temperature"]),
            float(params["andersen_frequency"]))
        thermostat.setForceGroup(groups.get("andersen", 0))
        system.addForce(thermostat)


def barostat_params(force):
    """from_numpy's barostat keys of a JAX-package barostat."""
    out = {"barostat_pressure": np.asarray(
               u.strip(force.getDefaultPressure(), u.bar), np.float64),
           "barostat_temperature": float(u.strip(
               force.getDefaultTemperature(), u.kelvin)),
           "barostat_frequency": force.getFrequency()}
    if isinstance(force, MonteCarloAnisotropicBarostat):
        out["barostat_kind"] = "aniso"
        out["barostat_scale"] = np.array(
            [force.getScaleX(), force.getScaleY(), force.getScaleZ()])
    elif isinstance(force, MonteCarloMembraneBarostat):
        out["barostat_kind"] = "membrane"
        out["barostat_tension"] = float(u.strip(
            force.getDefaultSurfaceTension(), u.bar * u.nanometer))
        out["barostat_xymode"] = force.getXYMode()
        out["barostat_zmode"] = force.getZMode()
    else:
        out["barostat_kind"] = "iso"
    return out


def median_relative_error(forces, reference):
    """Median over atoms of |f - f_ref| / |f_ref| (testInstallation)."""
    ref = np.asarray(reference, np.float64)
    norm = np.linalg.norm(ref, axis=1)
    norm = np.where(norm == 0.0, 1.0, norm)
    return float(np.median(np.linalg.norm(
        np.asarray(forces, np.float64) - ref, axis=1) / norm))


# -- the POPC bilayer ---------------------------------------------------
BILAYER_FORCEFIELD = ("amber14-lipid.json", "amber14-tip3p.json")
BILAYER_DATA = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "openmm_tpu_torch", "models", "data",
    "popc_bilayer.npz")


def jax_bilayer_system(topology):
    """The JAX ForceField's System for a topology cut from the POPC patch,
    with bench.py's settings: PME at 0.9 nm, HBonds constraints."""
    from openmm_tpu import app
    ff = app.ForceField(*BILAYER_FORCEFIELD)
    return ff.createSystem(topology, nonbondedMethod=app.PME,
                           nonbondedCutoff=0.9 * u.nanometer,
                           constraints=app.HBonds)


def _sub_topology(top, pos, residues, box):
    """A Topology of `residues` of `top` (bonds inside them kept) in a
    box of widths `box`, and their positions (an (n, 3) array in nm)."""
    from openmm_tpu import app
    from openmm_tpu.vec3 import Vec3
    new = app.Topology()
    new.setPeriodicBoxVectors(u.Quantity(
        (Vec3(box[0], 0, 0), Vec3(0, box[1], 0), Vec3(0, 0, box[2])),
        u.nanometer))
    chain = new.addChain("A")
    amap, out = {}, []
    for res in residues:
        nr = new.addResidue(res.name, chain, res.id)
        for a in res.atoms():
            amap[a] = new.addAtom(a.name, a.element, nr)
            out.append(pos[a.index])
    for b in top.bonds():
        if b[0] in amap and b[1] in amap:
            new.addBond(amap[b[0]], amap[b[1]])
    return new, np.asarray(out, np.float64)


def bilayer_templates():
    """The per-molecule templates of the POPC patch
    (openmm_tpu/app/data/POPC.npz), from the JAX ForceField on a topology
    of its first lipid and its first water: {"<template>_<key>": array}
    with the template "lipid" or "water" and the keys of from_numpy's
    per-atom arrays and term lists (term atoms counted from the
    template's first atom), the lipid's OBC2 radii and screening factors
    ("lipid_gb_radius", "lipid_gb_screen": mbondi2 radii and the OBC
    screens, app/gbforces.py standard_gb_parameters), and
    "nonbonded_<key>" for the settings of the NonbondedForce and the
    CMMotionRemover's frequency."""
    from openmm_tpu.app.gbforces import standard_gb_parameters
    from openmm_tpu.app.modeller import _load_membrane_patch
    top, pos, box = _load_membrane_patch("POPC")
    residues = list(top.residues())
    lipid = next(r for r in residues if r.name != "HOH")
    water = next(r for r in residues if r.name == "HOH")
    sub, _ = _sub_topology(top, pos, (lipid, water), box)
    params = system_params(jax_bilayer_system(sub))
    n_lipid = len(list(lipid.atoms()))
    spans = {"lipid": (0, n_lipid), "water": (n_lipid,
                                              len(params["masses"]))}
    out = {}
    for name, (lo, hi) in spans.items():
        for key in ("masses", "charges", "sigma", "epsilon"):
            out["%s_%s" % (name, key)] = params[key][lo:hi]
        for atoms_key, par_key in (
                ("exception_pairs", "exception_params"),
                ("constraint_pairs", "constraint_distances"),
                ("bond_pairs", "bond_params"),
                ("angle_triples", "angle_params"),
                ("torsion_quads", "torsion_params")):
            atoms = params[atoms_key]
            inside = (atoms >= lo).all(axis=1) & (atoms < hi).all(axis=1)
            assert (inside | (atoms < lo).all(axis=1)
                    | (atoms >= hi).all(axis=1)).all(), atoms_key
            out["%s_%s" % (name, atoms_key)] = atoms[inside] - lo
            out["%s_%s" % (name, par_key)] = params[par_key][inside]
    gb = np.asarray(standard_gb_parameters("OBC2", sub),
                    np.float64)[:n_lipid]
    out["lipid_gb_radius"], out["lipid_gb_screen"] = gb[:, 0], gb[:, 1]
    for key in ("cutoff", "method", "ewald_tolerance",
                "dispersion_correction", "switch_distance", "cmm_frequency"):
        out["nonbonded_" + key] = np.asarray(params[key])
    return out


def write_bilayer_data(path=BILAYER_DATA):
    """popc_bilayer.npz: bilayer_templates(), the patch's coordinates and
    box (a copy of openmm_tpu/app/data/POPC.npz's) and the template of
    each residue in order (0 lipid, 1 water)."""
    from openmm_tpu.app.modeller import _load_membrane_patch
    patch = np.load(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "openmm_tpu", "app", "data",
        "POPC.npz"))
    top, _, _ = _load_membrane_patch("POPC")
    layout = np.array([r.name == "HOH" for r in top.residues()], np.int8)
    np.savez_compressed(path, positions=patch["positions"],
                        box=patch["box_nm"], residue_template=layout,
                        **bilayer_templates())


if __name__ == "__main__":
    write_bilayer_data(sys.argv[1] if len(sys.argv) > 1 else BILAYER_DATA)


_CROPPED = {}
# closest approach of two atoms of different residues that the cropped
# bilayer keeps: a pair with a hydrogen (a water's hydrogen bond is ~0.18
# nm), a pair of heavy atoms (a hydrogen-bonded O-O is ~0.27 nm)
_CLASH_H, _CLASH_HEAVY = 0.15, 0.25


def _cropped_patch(fraction):
    """(Topology, positions (n, 3) nm, layout (0 lipid, 1 water)) of the
    POPC patch's residues whose centre lies in the first `fraction` of x
    and y, in a box of those widths (z kept). Cropping breaks the patch's
    periodicity, so residues that clash through the new box are dropped
    (the dynamics must start from a sane configuration): two residues
    clash when two of their atoms come closer than _CLASH_H (with a
    hydrogen) or _CLASH_HEAVY (heavy atoms); of a clashing pair with a
    water the water goes, then the lipid with the most clashes left, until
    none is left."""
    from openmm_tpu.app.modeller import _load_membrane_patch
    top, pos, box = _load_membrane_patch("POPC")
    pos = np.asarray(pos, np.float64)
    nbox = np.array([box[0] * fraction, box[1] * fraction, box[2]])
    keep = []
    for res in top.residues():
        com = pos[[a.index for a in res.atoms()]].mean(axis=0)
        if com[0] < nbox[0] and com[1] < nbox[1]:
            keep.append(res)
    atoms = [a for r in keep for a in r.atoms()]
    owner = np.array([k for k, r in enumerate(keep) for _ in r.atoms()])
    heavy = np.array([a.element.symbol != "H" for a in atoms])
    p = pos[[a.index for a in atoms]]
    d = p[:, None, :] - p[None]
    d -= np.round(d / nbox) * nbox
    limit = np.where(heavy[:, None] & heavy[None], _CLASH_HEAVY, _CLASH_H)
    bad = ((d * d).sum(axis=-1) < limit * limit) & (owner[:, None]
                                                     != owner[None])
    i, j = np.nonzero(bad)
    pairs = {(a, b) for a, b in zip(owner[i], owner[j]) if a < b}
    water = [r.name == "HOH" for r in keep]
    dropped = {b if water[b] else a for a, b in pairs if water[a] or water[b]}
    pairs = {(a, b) for a, b in pairs if not {a, b} & dropped}
    while pairs:
        degree = {}
        for a, b in pairs:
            degree[a] = degree.get(a, 0) + 1
            degree[b] = degree.get(b, 0) + 1
        worst = max(sorted(degree), key=degree.get)
        dropped.add(worst)
        pairs = {(a, b) for a, b in pairs if worst not in (a, b)}
    keep = [r for k, r in enumerate(keep) if k not in dropped]
    sub, sub_pos = _sub_topology(top, pos, keep, nbox)
    layout = np.array([r.name == "HOH" for r in keep], np.int8)
    return sub, sub_pos, layout


def cropped_bilayer(fraction=0.33):
    """A corner of the POPC patch (_cropped_patch) built by the JAX
    ForceField: (JAX System, positions (n, 3) in nm, the residues'
    templates (0 lipid, 1 water)). Cached per process."""
    if fraction not in _CROPPED:
        top, positions, layout = _cropped_patch(fraction)
        _CROPPED[fraction] = (jax_bilayer_system(top), positions, layout)
    return _CROPPED[fraction]


ANCHORS = 4


def anchored_droplet():
    """(from_numpy dict, positions, velocities) of the droplet of
    tests/test_torch_integrators.py: the waters of a 64-water box within
    0.6 nm of its centre (SETTLE, the reaction field over every pair at
    CutoffNonPeriodic 1.0 nm), and ANCHORS massless particles 0.05 nm from
    the first oxygens, each tied to its oxygen by a bond of 0.05 nm;
    Maxwell-Boltzmann velocities at 300 K from a numpy seed, 0 for the
    anchors."""
    import openmm_tpu_torch as omm
    from openmm_tpu_torch.models import tip3p_water_box, water_droplet

    box_sys, box_pos = tip3p_water_box(64)
    system, pos = water_droplet(
        box_pos, plain(box_sys.getDefaultPeriodicBoxVectors()), radius=0.6,
        cutoff=1.0)
    params = omm.to_numpy(system)
    n = len(params["masses"])
    oxygens = 3 * np.arange(ANCHORS)
    params["masses"] = np.concatenate([params["masses"], np.zeros(ANCHORS)])
    for key, fill in (("charges", 0.0), ("sigma", 1.0), ("epsilon", 0.0)):
        params[key] = np.concatenate([params[key], np.full(ANCHORS, fill)])
    params["bond_pairs"] = np.stack([oxygens, n + np.arange(ANCHORS)], 1)
    params["bond_params"] = np.tile([[0.05, 5000.0]], (ANCHORS, 1))
    pos = np.concatenate([pos, pos[oxygens] + [0.05, 0.0, 0.0]])
    rng = np.random.RandomState(5)
    m = params["masses"]
    sigma = np.sqrt(omm.BOLTZ * 300.0 / np.where(m == 0, 1.0, m))
    vel = rng.randn(*pos.shape) * np.where(m == 0, 0.0, sigma)[:, None]
    return params, pos, vel


# -- the app layer ------------------------------------------------------
def port_topology(top):
    """The port's Topology of a JAX-package Topology: the same chains,
    residues, atoms (names, elements, ids) and bonds in the same order,
    and the same box."""
    from openmm_tpu_torch import app as papp
    from openmm_tpu_torch import unit as pu
    from openmm_tpu_torch.vec3 import Vec3 as PVec3
    new = papp.Topology()
    atoms = {}
    for chain in top.chains():
        c = new.addChain(chain.id)
        for res in chain.residues():
            r = new.addResidue(res.name, c, res.id, res.insertionCode)
            for a in res.atoms():
                el = (papp.Element.getBySymbol(a.element.symbol)
                      if a.element is not None else None)
                atoms[a] = new.addAtom(a.name, el, r, a.id)
    for b in top.bonds():
        new.addBond(atoms[b[0]], atoms[b[1]])
    box = top.getPeriodicBoxVectors()
    if box is not None:
        new.setPeriodicBoxVectors(pu.Quantity(
            tuple(PVec3(*v) for v in box.value_in_unit(u.nanometer)),
            pu.nanometer))
    return new


def template_topology(ff, chains, box=None):
    """A JAX-package Topology of residues copied from the templates of the
    JAX ForceField `ff`: `chains` is a list of chains, each a list of
    template names; within a chain an atom C of a residue is bonded to the
    atom N of the next where both templates have an external bond there
    (a peptide). No coordinates are needed to build a System. `box`: a
    cubic box width in nm, or None."""
    from openmm_tpu import app
    from openmm_tpu.vec3 import Vec3
    top = app.Topology()
    for names in chains:
        chain = top.addChain()
        prev = None
        for name in names:
            t = ff._templates[name]
            res = top.addResidue(name, chain)
            added = [top.addAtom(a.name, a.element, res) for a in t.atoms]
            for i, j in t.bonds:
                top.addBond(added[i], added[j])
            ext = {t.atoms[i].name: added[i] for i in t.externalBonds}
            if prev is not None and "N" in ext:
                top.addBond(prev, ext["N"])
            prev = ext.get("C")
    if box is not None:
        top.setPeriodicBoxVectors(u.Quantity(
            (Vec3(box, 0, 0), Vec3(0, box, 0), Vec3(0, 0, box)),
            u.nanometer))
    return top


def assert_same_params(got, want, path="system"):
    """Exact equality of two from_numpy dicts (arrays, numbers, strings,
    and the lists and dicts of custom forces), naming the first key that
    differs."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), \
            (path, sorted(got), sorted(want))
        for key in want:
            assert_same_params(got[key], want[key], "%s[%r]" % (path, key))
    elif isinstance(want, (list, tuple)) and not all(
            isinstance(w, (int, float, np.number)) for w in want):
        assert len(got) == len(want), (path, len(got), len(want))
        for k, (g, w) in enumerate(zip(got, want)):
            assert_same_params(g, w, "%s[%d]" % (path, k))
    elif isinstance(want, (np.ndarray, list, tuple)):
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape and np.array_equal(g, w), path
    else:
        assert got == want, (path, got, want)


def jax_openmm_vdw(system):
    """The JAX-package System `system` with the sigmas of each
    AmoebaVdwForce under the CUBIC-MEAN rule doubled, in place: the JAX
    force's cubic mean (s_i^3 + s_j^3) / (s_i^2 + s_j^2) leaves out
    OpenMM's factor 2 (AmoebaReferenceVdwForce.cpp
    cubicMeanSigmaCombiningRule), which the port keeps, so with doubled
    sigmas the JAX force computes the port's (and OpenMM's) energy.
    Returns the System."""
    for f in system.getForces():
        if type(f).__name__ == "AmoebaVdwForce" \
                and f.getSigmaCombiningRule().upper() == "CUBIC-MEAN":
            f._particles = [(p, 2.0 * s, e, r) for p, s, e, r in f._particles]
    return system


def port_against_jax(system, positions, groups=-1, jax_system_=None):
    """(port energy, JAX energy, port forces, JAX forces) of the JAX-package
    System `system` (with jax_openmm_vdw applied to the JAX side: pass
    the JAX twin as `jax_system_` to override) at `positions`: the port's
    from_numpy System on a float64 CPU Context, the JAX twin on a
    "Reference" Context."""
    import openmm_tpu_torch as omm
    port = omm.from_numpy(system_params(system))
    twin = jax_system_ if jax_system_ is not None else \
        jax_openmm_vdw(jax_system(system_params(system)))
    ctx = omm.Context(port, omm.VerletIntegrator(0.001),
                      omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(np.asarray(positions, np.float64))
    st = ctx.getState(getEnergy=True, getForces=True, groups=groups)
    jctx = mm.Context(twin, mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions([mm.Vec3(*p) for p in np.asarray(positions)])
    jst = jctx.getState(getEnergy=True, getForces=True, groups=groups)
    return (plain(st.getPotentialEnergy()),
            float(jst.getPotentialEnergy()._value),
            plain(st.getForces(asNumpy=True)),
            np.asarray(jst.getForces(asNumpy=True)._value, np.float64))


def assert_close_to_jax(result, e_tol=1e-9, f_tol=1e-8, what=""):
    """Energy within e_tol (relative) and every force component within
    f_tol of the largest JAX force."""
    e, je, f, jf = result
    assert abs(e - je) <= e_tol * max(abs(je), 1e-12), (what, e, je)
    scale = np.abs(jf).max()
    assert np.abs(f - jf).max() <= f_tol * scale, \
        (what, np.abs(f - jf).max(), scale)


def jax_topology(top):
    """The JAX-package Topology of a port Topology (port_topology the
    other way): the same chains, residues, atoms and bonds in the same
    order, and the same box."""
    from openmm_tpu import app as japp
    from openmm_tpu.vec3 import Vec3
    new = japp.Topology()
    atoms = {}
    for chain in top.chains():
        c = new.addChain(chain.id)
        for res in chain.residues():
            r = new.addResidue(res.name, c, res.id, res.insertionCode)
            for a in res.atoms():
                el = (japp.Element.getBySymbol(a.element.symbol)
                      if a.element is not None else None)
                atoms[a] = new.addAtom(a.name, el, r, a.id)
    for b in top.bonds():
        new.addBond(atoms[b[0]], atoms[b[1]])
    box = top.getPeriodicBoxVectors()
    if box is not None:
        new.setPeriodicBoxVectors(u.Quantity(
            tuple(Vec3(*v) for v in plain(box)), u.nanometer))
    return new


def drude_twin(system, coulomb14, lj14, forcefield=None, topology=None):
    """The JAX-package System `system`, built by its ForceField with a
    DrudeForce, made right by hand, in place: the JAX createSystem never
    excludes a Drude particle from anything (its generator's
    excludeAtomWith is never read), so each exception (a, b) of the
    NonbondedForce is repeated for every Drude particle of a and of b (an
    exclusion as an exclusion, a 1-4 pair scaled by coulomb14 and lj14
    with the Drude particle's own parameters), and each Drude particle is
    excluded from its parent. Given the JAX ForceField and Topology, each
    new exclusion between two Drude particles also becomes a screened pair
    with the sum of their types' tholes, as the generator makes them from
    the exclusions (OpenMM's DrudeGenerator.postprocessSystem). Returns
    the System."""
    drude = [f for f in system.getForces()
             if type(f).__name__ == "DrudeForce"][0]
    nb = [f for f in system.getForces() if isinstance(f, NonbondedForce)][0]
    children = {}
    for i in range(drude.getNumParticles()):
        d, p = drude.getParticleParameters(i)[:2]
        children.setdefault(p, []).append(d)
    params = nb._particles
    for a, b, qq, _, eps in list(nb._exceptions):
        for x in [a] + children.get(a, []):
            for y in [b] + children.get(b, []):
                if (x, y) == (a, b):
                    continue
                if qq == 0 and eps == 0:
                    nb.addException(x, y, 0.0, 1.0, 0.0, True)
                else:
                    (qx, sx, ex), (qy, sy, ey) = params[x], params[y]
                    nb.addException(x, y, coulomb14 * qx * qy,
                                    0.5 * (sx + sy),
                                    lj14 * np.sqrt(ex * ey), True)
    for p, ds in children.items():
        for d in ds:
            nb.addException(d, p, 0.0, 1.0, 0.0, True)
    if forcefield is None:
        return system
    from openmm_tpu.app.ffgenerators import DrudeGenerator
    tholes = [g for g in forcefield._forces
              if isinstance(g, DrudeGenerator)][0].typeMap
    types = []
    for res, template in zip(topology.residues(),
                             forcefield.getMatchingTemplates(topology)):
        by_name = {a.name: a.type for a in template.atoms}
        types += [by_name[a.name] for a in res.atoms()]
    index = {drude.getParticleParameters(i)[0]: i
             for i in range(drude.getNumParticles())}
    screened = {tuple(sorted(drude.getScreenedPairParameters(i)[:2]))
                for i in range(drude.getNumScreenedPairs())}
    for a, b, qq, _, eps in nb._exceptions:
        if qq == 0 and eps == 0 and a in index and b in index:
            pair = tuple(sorted((index[a], index[b])))
            if pair not in screened:
                screened.add(pair)
                drude.addScreenedPair(*pair, tholes[types[a]][8]
                                      + tholes[types[b]][8])
    return system
