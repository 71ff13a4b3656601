"""Programmatic system builders.

tip3p_water_box is the counterpart of openmm_tpu/models/builders.py: the
same TIP3P water box, built with numpy from the same
np.random.RandomState(jitter_seed) stream, so that the arrays are
identical to the JAX builder's for the same seed. water_droplet carves a
non-periodic droplet out of such a box. tip4pew_water_box is the same
lattice and stream with TIP4P-Ew waters (the JAX package's
ForceField("tip4pew.json") after Modeller.convertWater("tip4pew"): the HOH
geometry is TIP3P's, the M site a ThreeParticleAverageSite).

popc_bilayer is the pre-equilibrated POPC membrane patch that the JAX
package's Modeller.addMembrane places (openmm_tpu/app/data/POPC.npz: 128
POPC lipids and 5,120 TIP3P waters, 32,512 atoms) with the parameters of
ForceField("amber14-lipid.json", "amber14-tip3p.json") at bench.py's
settings (PME at 0.9 nm, HBonds constraints, a CMMotionRemover).
data/popc_bilayer.npz holds the port's own copy of the coordinates and
box, the template of each residue, and one template a molecule (a lipid,
a water: masses, nonbonded parameters, bonds, angles, torsions,
exceptions and constraints), which tests/torch_port_helpers.py made from
the JAX ForceField and tests/test_torch_bilayer.py holds to it. No term
crosses a residue, so the System is the templates replicated over the
residues.

popc_obc_cluster is the in-repo stand-in for the reference suite's
implicit-solvent configuration (tools/bench_suite.py dhfr_gbsa: 2,489
atoms of DHFR, amber99sb + OBC, CutoffNonPeriodic at 2.0 nm, HBonds,
LangevinMiddle at 300 K, 1/ps, 2 fs), whose structure is not in the
repository: 19 lipids of the patch's upper leaflet (2,546 atoms) with the
lipid template's amber14-lipid parameters, its OBC2 radii and screens
(data/popc_bilayer.npz, from the JAX package's
app/gbforces.py:standard_gb_parameters), and the suite's settings.
popc_gb_cluster is the same cluster under an Amber GB recipe
(CustomGBForce; GBn2 by default, the model Amber recommends).

alchemical_water_box is the water box with its first waters as the
solute of an alchemical free-energy run, in the form that OpenMM's
alchemy tools (openmmtools.alchemy) give such a system: the solute's
charges follow a global parameter lambda_electrostatics through particle
offsets of the NonbondedForce, its Lennard-Jones interactions with the
solvent a soft-core CustomNonbondedForce of lambda_sterics (one
interaction group, solute against solvent, with the derivative dE/dlambda
requested), the solute's own Lennard-Jones pairs a CustomBondForce, and
two restraints: a flat-bottom CustomExternalForce on the solute's oxygens
and a harmonic CustomCentroidBondForce between the centroids of the
solute's two halves. custom_twins rewrites a System's bonds, angles and
torsions as custom forces of the same terms (the bilayer's twins).
"""
from __future__ import annotations

import math
import os

import numpy as np

from ..forces.custom import (CustomAngleForce, CustomBondForce,
                             CustomCentroidBondForce,
                             CustomCompoundBondForce, CustomExternalForce,
                             CustomNonbondedForce, CustomTorsionForce)
from ..forces.gbsa import GBSAOBCForce
from ..forces.nonbonded import NonbondedForce
from ..system import System, ThreeParticleAverageSite, from_numpy

BILAYER_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "data", "popc_bilayer.npz")
TEMPLATES = ("lipid", "water")
_ATOM_KEYS = ("masses", "charges", "sigma", "epsilon")
# (atoms key, parameters key) of each term list of a template
TERM_KEYS = (("exception_pairs", "exception_params"),
              ("constraint_pairs", "constraint_distances"),
              ("bond_pairs", "bond_params"),
              ("angle_triples", "angle_params"),
              ("torsion_quads", "torsion_params"))

# TIP3P parameters (tip3p.xml)
TIP3P_O_CHARGE = -0.834
TIP3P_H_CHARGE = 0.417
TIP3P_O_SIGMA = 0.31507524065751241
TIP3P_O_EPSILON = 0.635968
TIP3P_OH_DISTANCE = 0.09572
TIP3P_ANGLE = 104.52 * math.pi / 180.0
WATER_NUMBER_DENSITY = 33.37  # molecules / nm^3 at ~300 K
O_MASS, H_MASS = 15.99943, 1.007947

# TIP4P-Ew parameters (tip4pew.xml): the charge sits on the massless M
# site, the weighted average of O, H1 and H2
TIP4PEW_O_SIGMA = 0.316435
TIP4PEW_O_EPSILON = 0.680946
TIP4PEW_H_CHARGE = 0.52422
TIP4PEW_M_CHARGE = -1.04844
TIP4PEW_M_WEIGHTS = (0.786646558, 0.106676721, 0.106676721)
TIP4PEW_ANGLE = 1.82421813418     # rad, tip4pew.xml's (TIP3P's to 2e-12)


def _add_tip3p_water(system, nb, constraints):
    """One TIP3P water's particles, parameters, exclusions and (when
    `constraints`) its three rigid-water constraints."""
    d_oh, theta = TIP3P_OH_DISTANCE, TIP3P_ANGLE
    o = system.addParticle(O_MASS)
    h1 = system.addParticle(H_MASS)
    h2 = system.addParticle(H_MASS)
    nb.addParticle(TIP3P_O_CHARGE, TIP3P_O_SIGMA, TIP3P_O_EPSILON)
    nb.addParticle(TIP3P_H_CHARGE, 1.0, 0.0)
    nb.addParticle(TIP3P_H_CHARGE, 1.0, 0.0)
    nb.addException(o, h1, 0.0, 1.0, 0.0)
    nb.addException(o, h2, 0.0, 1.0, 0.0)
    nb.addException(h1, h2, 0.0, 1.0, 0.0)
    if constraints:
        system.addConstraint(o, h1, d_oh)
        system.addConstraint(o, h2, d_oh)
        system.addConstraint(h1, h2, 2.0 * d_oh * math.sin(0.5 * theta))


def tip3p_water_box(n_waters=216, nonbonded_method=NonbondedForce.PME,
                    cutoff=0.9, constraints=True, jitter_seed=1234):
    """A cubic TIP3P box on a jittered lattice with random molecule
    orientations at liquid density, its NonbondedForce of
    `nonbonded_method` (PME by default). The count is rounded up to a
    cube. Returns (system, positions as an (n, 3) float64 array in nm)."""
    n_side = int(round(n_waters ** (1.0 / 3.0)))
    while n_side ** 3 < n_waters:
        n_side += 1
    n_waters = n_side ** 3
    box_l = (n_waters / WATER_NUMBER_DENSITY) ** (1.0 / 3.0)
    spacing = box_l / n_side

    system = System()
    system.setDefaultPeriodicBoxVectors([box_l, 0, 0], [0, box_l, 0],
                                        [0, 0, box_l])
    nb = NonbondedForce()
    nb.setNonbondedMethod(nonbonded_method)
    nb.setCutoffDistance(min(cutoff, 0.49 * box_l))
    nb.setUseDispersionCorrection(True)
    system.addForce(nb)

    d_oh, theta = TIP3P_OH_DISTANCE, TIP3P_ANGLE
    ref = np.array([[0.0, 0.0, 0.0], [d_oh, 0.0, 0.0],
                    [d_oh * math.cos(theta), d_oh * math.sin(theta), 0.0]])
    rng = np.random.RandomState(jitter_seed)
    positions = []
    for ix in range(n_side):
        for iy in range(n_side):
            for iz in range(n_side):
                _add_tip3p_water(system, nb, constraints)
                base = (np.array([ix, iy, iz], float) + 0.5) * spacing \
                    + (rng.rand(3) - 0.5) * 0.02
                axis = rng.randn(3)
                axis /= np.linalg.norm(axis)
                ang = rng.rand() * 2 * math.pi
                c, s = math.cos(ang), math.sin(ang)
                k = np.array([[0, -axis[2], axis[1]],
                              [axis[2], 0, -axis[0]],
                              [-axis[1], axis[0], 0]])
                rot = np.eye(3) + s * k + (1 - c) * (k @ k)
                positions.append(ref @ rot.T + base)
    return system, np.concatenate(positions)


def _add_tip4pew_water(system, nb, constraints):
    """One TIP4P-Ew water (O, H1, H2, M): its particles, parameters, M
    site, the exclusions of every pair of its four particles (in the JAX
    ForceField's order) and, when `constraints`, its three rigid-water
    constraints."""
    o = system.addParticle(O_MASS)
    h1 = system.addParticle(H_MASS)
    h2 = system.addParticle(H_MASS)
    m = system.addParticle(0.0)
    nb.addParticle(0.0, TIP4PEW_O_SIGMA, TIP4PEW_O_EPSILON)
    nb.addParticle(TIP4PEW_H_CHARGE, 1.0, 0.0)
    nb.addParticle(TIP4PEW_H_CHARGE, 1.0, 0.0)
    nb.addParticle(TIP4PEW_M_CHARGE, 1.0, 0.0)
    system.setVirtualSite(m, ThreeParticleAverageSite(o, h1, h2,
                                                      *TIP4PEW_M_WEIGHTS))
    for a, b in ((o, h1), (o, h2), (o, m), (h1, h2), (h1, m), (h2, m)):
        nb.addException(a, b, 0.0, 1.0, 0.0)
    if constraints:
        d_oh, theta = TIP3P_OH_DISTANCE, TIP4PEW_ANGLE
        system.addConstraint(o, h1, d_oh)
        system.addConstraint(o, h2, d_oh)
        system.addConstraint(h1, h2, 2.0 * d_oh * math.sin(0.5 * theta))


def tip4pew_water_box(n_waters=216, nonbonded_method=NonbondedForce.PME,
                      cutoff=0.9, constraints=True, jitter_seed=1234):
    """tip3p_water_box's lattice, orientations and RandomState stream with
    TIP4P-Ew waters: four particles a water (O, H1, H2 and the massless M
    site at the weighted average TIP4PEW_M_WEIGHTS of O, H1 and H2).
    Returns (system, positions as an (n, 3) float64 array in nm, the M
    sites computed from their waters)."""
    tip3p, pos3 = tip3p_water_box(n_waters, nonbonded_method, cutoff,
                                  constraints, jitter_seed)
    (nb3,) = tip3p.getForces()
    count = tip3p.getNumParticles() // 3
    system = System()
    system.setDefaultPeriodicBoxVectors(
        *tip3p.getDefaultPeriodicBoxVectors())
    nb = NonbondedForce()
    nb.setNonbondedMethod(nonbonded_method)
    nb.setCutoffDistance(nb3.getCutoffDistance())
    nb.setUseDispersionCorrection(True)
    system.addForce(nb)
    for _ in range(count):
        _add_tip4pew_water(system, nb, constraints)
    water = pos3.reshape(count, 3, 3)
    site = np.einsum("k,wkd->wd", np.asarray(TIP4PEW_M_WEIGHTS), water)
    return system, np.concatenate([water, site[:, None]], axis=1).reshape(
        -1, 3)


def water_droplet(positions, box, radius=2.5,
                  nonbonded_method=NonbondedForce.CutoffNonPeriodic,
                  cutoff=2.0):
    """The waters of a TIP3P box (positions (n, 3) in O, H, H order, box
    (3, 3) with a diagonal box) whose oxygens lie within `radius` nm of
    the box's centre, each taken whole at the image of its oxygen nearest
    the centre, as a non-periodic System of `nonbonded_method` (NoCutoff
    or CutoffNonPeriodic at `cutoff`). Returns (system, positions)."""
    pos = np.asarray(positions, np.float64).reshape(-1, 3, 3)
    widths = np.diag(np.asarray(box, np.float64))
    d = pos[:, 0] - 0.5 * widths
    shift = widths * np.round(d / widths)
    keep = np.linalg.norm(d - shift, axis=1) < radius
    system = System()
    nb = NonbondedForce()
    nb.setNonbondedMethod(nonbonded_method)
    nb.setCutoffDistance(cutoff)
    system.addForce(nb)
    for _ in range(int(keep.sum())):
        _add_tip3p_water(system, nb, constraints=True)
    return system, (pos[keep] - shift[keep, None]).reshape(-1, 3)


def replicate_templates(data, residue_template) -> dict:
    """The from_numpy dict of the residues whose templates (indices into
    TEMPLATES) `residue_template` lists in order, from the template arrays
    of `data` (the keys of popc_bilayer.npz): each residue's atoms follow
    the last residue's, and its terms are its template's, moved to its
    first atom, in the order of the residues."""
    layout = np.asarray(residue_template, np.int64)
    sizes = np.asarray([len(data[t + "_masses"]) for t in TEMPLATES])
    offsets = np.concatenate([[0], np.cumsum(sizes[layout])[:-1]])
    out = {key: np.concatenate([data[TEMPLATES[t] + "_" + key]
                                for t in layout])
           for key in _ATOM_KEYS}
    for atoms_key, par_key in TERM_KEYS:
        atoms, pars, owner = [], [], []
        for t, name in enumerate(TEMPLATES):
            res = np.nonzero(layout == t)[0]
            tmpl = data[name + "_" + atoms_key]
            atoms.append((tmpl[None] + offsets[res, None, None])
                         .reshape(-1, tmpl.shape[1]))
            pars.append(np.tile(data[name + "_" + par_key],
                                (len(res),) + (1,) * (data[
                                    name + "_" + par_key].ndim - 1)))
            owner.append(np.repeat(res, len(tmpl)))
        order = np.argsort(np.concatenate(owner), kind="stable")
        out[atoms_key] = np.concatenate(atoms)[order]
        out[par_key] = np.concatenate(pars)[order]
    for key in ("cutoff", "method", "ewald_tolerance",
                "dispersion_correction", "switch_distance", "cmm_frequency"):
        out[key] = data["nonbonded_" + key][()]
    out["method"] = str(out["method"])
    return out


# the implicit-solvent cluster: lipids, the cutoff of both direct spaces
# (nm), and the dielectrics of GBSAOBCForce (ForceField.createSystem's
# defaults)
OBC_CLUSTER_LIPIDS = 19
OBC_CUTOFF = 2.0
OBC_SOLUTE_DIELECTRIC = 1.0
OBC_SOLVENT_DIELECTRIC = 78.5


def _cluster(lipids):
    """(from_numpy dict without a GB force, positions, the template data)
    of popc_obc_cluster's lipids."""
    with np.load(BILAYER_DATA) as f:
        data = {k: f[k] for k in f.files}
    size = len(data["lipid_masses"])
    count = int(np.count_nonzero(data["residue_template"] == 0))
    if data["residue_template"][:count].any():
        raise ValueError("the patch's lipids must come first")
    pos = data["positions"].astype(np.float64)
    mol = pos[:count * size].reshape(count, size, 3)
    m = data["lipid_masses"]
    com = (m[None, :, None] * mol).sum(axis=1) / m.sum()
    upper = np.nonzero(com[:, 2] > com[:, 2].mean())[0]
    dist = np.linalg.norm(com[upper, :2] - com[upper, :2].mean(axis=0),
                          axis=1)
    chosen = np.sort(upper[np.lexsort((upper, dist))[:lipids]])
    params = replicate_templates(data, np.zeros(chosen.size, np.int64))
    n = chosen.size * size
    params.update({"method": "CutoffNonPeriodic", "cutoff": OBC_CUTOFF,
                   "rf_dielectric": 1.0, "box": np.diag([2.0, 2.0, 2.0])})
    return params, mol[chosen].reshape(n, 3), data


def popc_obc_cluster(lipids=OBC_CLUSTER_LIPIDS):
    """A cluster of the POPC patch's lipids in implicit solvent: (system,
    positions as an (n, 3) float64 array in nm).

    The lipids: of the upper leaflet (the centre of mass's z above the
    mean over all lipids), the `lipids` (19 by default) whose xy centres
    of mass lie nearest the leaflet's mean xy (ties by index), whole, in
    index order, at the patch's unwrapped positions. The forces: the
    lipid template's bonds, angles, torsions and 1-4 exceptions; a
    NonbondedForce at CutoffNonPeriodic OBC_CUTOFF nm whose reaction
    field is off (dielectric 1.0: OpenMM's GB generators turn it off,
    the GB term carries the solvent); a GBSAOBCForce at
    CutoffNonPeriodic OBC_CUTOFF nm with the nonbonded charges, the
    template's OBC2 radii and screens, solute 1.0, solvent 78.5 and the
    default ACE surface energy; the template's HBonds constraints and
    its CMMotionRemover. No box."""
    params, pos, data = _cluster(lipids)
    copies = len(pos) // len(data["lipid_masses"])
    params.update({
        "gb_charges": params["charges"],
        "gb_radii": np.tile(data["lipid_gb_radius"], copies),
        "gb_scales": np.tile(data["lipid_gb_screen"], copies),
        "gb_method": "CutoffNonPeriodic", "gb_cutoff": OBC_CUTOFF,
        "gb_solute_dielectric": OBC_SOLUTE_DIELECTRIC,
        "gb_solvent_dielectric": OBC_SOLVENT_DIELECTRIC,
        "gb_surface_energy": GBSAOBCForce().getSurfaceAreaEnergy()})
    return from_numpy(params), pos


# element symbols by rounded mass (amu) in the lipid template
_ELEMENTS = {1: "H", 12: "C", 14: "N", 16: "O", 31: "P"}


def lipid_elements(data) -> tuple[list, list]:
    """(element symbol of each lipid template atom, that of its first
    bonded partner or None), elements from the masses and partners from
    the template's bonds and its constraints (the bonds to hydrogens)."""
    elements = [_ELEMENTS[int(round(m))] for m in data["lipid_masses"]]
    partners = [None] * len(elements)
    for a, b in np.concatenate([data["lipid_bond_pairs"],
                                data["lipid_constraint_pairs"]]):
        for i, j in ((a, b), (b, a)):
            if partners[i] is None:
                partners[i] = elements[j]
    return elements, partners


def popc_gb_cluster(model="GBn2", lipids=OBC_CLUSTER_LIPIDS):
    """popc_obc_cluster's lipids, forces and settings with the GBSAOBCForce
    replaced by the CustomGBForce of an Amber GB recipe
    (app/gbforces.py build_gb_force: "HCT", "OBC1", "OBC2", "GBn" or
    "GBn2"): the recipe's radii, screens and (GBn2) alpha, beta and gamma
    from each atom's element and its hydrogen's bonded partner, solute
    1.0, solvent 78.5, the ACE surface term, CutoffNonPeriodic at
    OBC_CUTOFF nm."""
    from ..app.gbforces import build_gb_force, gb_parameters
    from ..forces.customgb import CustomGBForce
    params, pos, data = _cluster(lipids)
    copies = len(pos) // len(data["lipid_masses"])
    elements, partners = lipid_elements(data)
    system = from_numpy(params)
    gb = build_gb_force(model, params["charges"],
                        gb_parameters(model, elements * copies,
                                      partners * copies),
                        OBC_SOLVENT_DIELECTRIC, OBC_SOLUTE_DIELECTRIC,
                        SA="ACE", cutoff=OBC_CUTOFF)
    gb.setNonbondedMethod(CustomGBForce.CutoffNonPeriodic)
    gb.setCutoffDistance(OBC_CUTOFF)
    system.addForce(gb)
    return system, pos


def popc_bilayer():
    """The 32,512-atom POPC bilayer: (system, positions as an (n, 3)
    float64 array in nm). The molecules are whole (positions unwrapped),
    as the exceptions, computed without periodic images, need."""
    with np.load(BILAYER_DATA) as f:
        data = {k: f[k] for k in f.files}
    params = replicate_templates(data, data["residue_template"])
    params["box"] = np.diag(data["box"].astype(np.float64))
    return from_numpy(params), data["positions"].astype(np.float64)


SOFTCORE = ("4*epsilon*lambda_sterics*(1/x^2-1/x); "
            "x=(r/sigma)^6+0.5*(1-lambda_sterics); sigma=0.5*(sigma1+sigma2); "
            "epsilon=sqrt(epsilon1*epsilon2)")
# the alchemical box's force groups: the NonbondedForce in 0
ALCHEMICAL_GROUPS = {"CustomNonbondedForce": 1, "CustomBondForce": 2,
                     "CustomExternalForce": 3, "CustomCentroidBondForce": 4}
RESTRAINT_K = 1000.0        # kJ/mol/nm^2, the flat bottom's
RESTRAINT_D0 = 0.3          # nm, the flat bottom's radius
CENTROID_K = 100.0          # kJ/mol/nm^2


def alchemical_water_box(n_waters=8000, n_solute=64, cutoff=0.9):
    """tip3p_water_box(n_waters) (PME at `cutoff`) with its first n_solute
    waters as an alchemical solute (the module's docstring): the
    NonbondedForce keeps the solute's charges through offsets of
    lambda_electrostatics (base charge 0) and its epsilon at 0; the
    soft-core SOFTCORE at CutoffPeriodic `cutoff` over (solute, solvent),
    with the NonbondedForce's exclusions, requesting dE/dlambda_sterics
    and dE/dlambda_electrostatics; the solute's oxygen pairs by
    plain Lennard-Jones (periodic); k max(0, d - d0)^2 on each solute
    oxygen's distance from its start; (k/2)(d - d0)^2 on the distance of
    the centroids (mass weights) of the solute's two halves from its
    start. Each custom force in its group of ALCHEMICAL_GROUPS. Returns
    (system, positions)."""
    system, positions = tip3p_water_box(n_waters, cutoff=cutoff)
    (nb,) = system.getForces()
    n = system.getNumParticles()
    solute = list(range(3 * n_solute))
    solvent = list(range(3 * n_solute, n))
    base = [nb.getParticleParameters(i) for i in range(n)]
    nb.addGlobalParameter("lambda_electrostatics", 1.0)
    for i in solute:
        q, sigma, _ = base[i]
        nb.setParticleParameters(i, 0.0, sigma, 0.0)
        nb.addParticleParameterOffset("lambda_electrostatics", i, q, 0.0,
                                      0.0)
    box = system.getDefaultPeriodicBoxVectors()

    soft = CustomNonbondedForce(SOFTCORE)
    soft.addGlobalParameter("lambda_sterics", 1.0)
    soft.addEnergyParameterDerivative("lambda_sterics")
    # the alchemical region's force requests the electrostatic derivative
    # too, which the NonbondedForce's offsets give (Context
    # _parameter_derivatives)
    soft.addGlobalParameter("lambda_electrostatics", 1.0)
    soft.addEnergyParameterDerivative("lambda_electrostatics")
    soft.addPerParticleParameter("sigma")
    soft.addPerParticleParameter("epsilon")
    for _, sigma, eps in base:
        soft.addParticle([sigma, eps])
    soft.setNonbondedMethod(CustomNonbondedForce.CutoffPeriodic)
    soft.setCutoffDistance(nb.getCutoffDistance())
    for k in range(nb.getNumExceptions()):
        soft.addExclusion(*nb.getExceptionParameters(k)[:2])
    soft.addInteractionGroup(solute, solvent)

    oxygens = solute[::3]
    lj = CustomBondForce("4*epsilon*((sigma/r)^12-(sigma/r)^6)")
    lj.addPerBondParameter("sigma")
    lj.addPerBondParameter("epsilon")
    for a, i in enumerate(oxygens):
        for j in oxygens[a + 1:]:
            lj.addBond(i, j, [0.5 * (base[i][1] + base[j][1]),
                              math.sqrt(base[i][2] * base[j][2])])
    lj.setUsesPeriodicBoundaryConditions(True)

    restraint = CustomExternalForce(
        "k_restraint*max(0, periodicdistance(x,y,z,x0,y0,z0)-d0_restraint)^2")
    restraint.addGlobalParameter("k_restraint", RESTRAINT_K)
    restraint.addGlobalParameter("d0_restraint", RESTRAINT_D0)
    for name in ("x0", "y0", "z0"):
        restraint.addPerParticleParameter(name)
    for i in oxygens:
        restraint.addParticle(i, list(positions[i]))

    centroid = CustomCentroidBondForce(
        2, "0.5*k_centroid*(distance(g1,g2)-r0)^2")
    centroid.addGlobalParameter("k_centroid", CENTROID_K)
    centroid.addPerBondParameter("r0")
    half = len(solute) // 2 // 3 * 3
    halves = (solute[:half], solute[half:])
    masses = np.asarray([system.getParticleMass(i) for i in range(n)])
    for atoms in halves:
        centroid.addGroup(atoms)
    d = np.subtract(*(np.average(positions[list(a)], axis=0,
                                 weights=masses[list(a)]) for a in halves))
    widths = np.diag(box)
    d -= widths * np.round(d / widths)
    centroid.addBond([0, 1], [float(np.linalg.norm(d))])
    centroid.setUsesPeriodicBoundaryConditions(True)

    for force in (soft, lj, restraint, centroid):
        force.setForceGroup(ALCHEMICAL_GROUPS[type(force).__name__])
        system.addForce(force)
    return system, positions


# the twins' force groups; the torsions' compound twin is read, not
# integrated
TWIN_GROUPS = {"CustomBondForce": 1, "CustomAngleForce": 2,
               "CustomTorsionForce": 3, "CustomCompoundBondForce": 5}
TWIN_INTEGRATION_GROUPS = (0, 1, 2, 3)


def custom_twins(system):
    """A System of `system`'s particles, constraints and box with its
    other forces (the same objects) and each of its HarmonicBond,
    HarmonicAngle and PeriodicTorsion forces replaced by a custom twin of
    the same terms, plus the torsions once more as a
    CustomCompoundBondForce over dihedral(p1,p2,p3,p4); the twins in
    TWIN_GROUPS (integrate TWIN_INTEGRATION_GROUPS, or the torsions count
    twice). Returns (twin system, {twin kind: (standard force, twin)})."""
    twin = System()
    for i in range(system.getNumParticles()):
        twin.addParticle(system.getParticleMass(i))
    for i in range(system.getNumConstraints()):
        twin.addConstraint(*system.getConstraintParameters(i))
    twin.setDefaultPeriodicBoxVectors(*system.getDefaultPeriodicBoxVectors())
    for index, site in system._vsites.items():
        twin.setVirtualSite(index, site)
    pairs = {}
    for force in system.getForces():
        kind = type(force).__name__
        if kind == "HarmonicBondForce":
            t = CustomBondForce("0.5*k*(r-r0)^2")
            for name in ("r0", "k"):
                t.addPerBondParameter(name)
            for i in range(force.getNumBonds()):
                a, b, r0, k = force.getBondParameters(i)
                t.addBond(a, b, [r0, k])
        elif kind == "HarmonicAngleForce":
            t = CustomAngleForce("0.5*k*(theta-theta0)^2")
            for name in ("theta0", "k"):
                t.addPerAngleParameter(name)
            for i in range(force.getNumAngles()):
                a, b, c, theta0, k = force.getAngleParameters(i)
                t.addAngle(a, b, c, [theta0, k])
        elif kind == "PeriodicTorsionForce":
            t = CustomTorsionForce("k*(1+cos(n*theta-phase))")
            compound = CustomCompoundBondForce(
                4, "k*(1+cos(n*dihedral(p1,p2,p3,p4)-phase))")
            for name in ("n", "phase", "k"):
                t.addPerTorsionParameter(name)
                compound.addPerBondParameter(name)
            for i in range(force.getNumTorsions()):
                a, b, c, d, n, phase, k = force.getTorsionParameters(i)
                t.addTorsion(a, b, c, d, [n, phase, k])
                compound.addBond([a, b, c, d], [n, phase, k])
            compound.setForceGroup(TWIN_GROUPS["CustomCompoundBondForce"])
            pairs["CustomCompoundBondForce"] = (force, compound)
        else:
            twin.addForce(force)
            continue
        periodic = force.usesPeriodicBoundaryConditions()
        t.setUsesPeriodicBoundaryConditions(periodic)
        if kind == "PeriodicTorsionForce":
            compound.setUsesPeriodicBoundaryConditions(periodic)
        t.setForceGroup(TWIN_GROUPS[type(t).__name__])
        pairs[type(t).__name__] = (force, t)
        twin.addForce(t)
    twin.addForce(pairs["CustomCompoundBondForce"][1])
    return twin, pairs
