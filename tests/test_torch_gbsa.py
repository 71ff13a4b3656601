"""Implicit solvent (GBSAOBCForce) in openmm_tpu_torch against openmm_tpu.

Cases:
- one ion: the closed form of tests/test_gb_and_misc.py (Born radius
  R - 0.009, the self term and the ACE term);
- 12 particles from a numpy seed at NoCutoff, CutoffNonPeriodic and
  CutoffPeriodic, with three close pairs placed so that every region of
  the HCT integral occurs (a sphere that does not reach the atom, L =
  rho, L = r - sr, and a sphere that holds the atom): the port's
  float64 path against the JAX "Reference" platform (the same formulas:
  energy 1e-10 relative, forces 1e-9 kJ/mol/nm), its float32 path
  against the JAX "CPU" platform (median relative force error <= 1e-5,
  the port's accuracy bar), and its analytic forces against autograd of
  its own energy (1e-10 of the largest force, float64);
- models.popc_obc_cluster: its GB radii and screens against the JAX
  package's standard_gb_parameters("OBC2") on the topology of a 3-lipid
  cut of the patch, and on a 3-lipid cluster (402 atoms: NonbondedForce
  and GBSAOBCForce at CutoffNonPeriodic 2.0 nm, bonded forces, HBonds,
  a CMMotionRemover) 10 LangevinMiddle steps at zero friction against
  the JAX "Reference" Context (1e-9 nm, both float64), the step
  program's bits against the eager loop, and a rehearsal of
  chip_smoke.phase_gbsa.
"""
import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu.app.gbforces import standard_gb_parameters
from openmm_tpu.app.modeller import _load_membrane_patch
from openmm_tpu.constants import ONE_4PI_EPS0

import chip_smoke
import openmm_tpu_torch as omm
from openmm_tpu_torch.models import popc_obc_cluster
from openmm_tpu_torch.ops import gbsa as gb_ops
from torch_port_helpers import (_sub_topology, jax_system,
                                median_relative_error)
from openmm_tpu_torch.unit import plain

GB = omm.GBSAOBCForce
# method: (cutoff nm, box widths nm)
METHODS = {"NoCutoff": (None, None),
           "CutoffNonPeriodic": (0.9, None),
           "CutoffPeriodic": (0.7, 1.5)}


def _random_case():
    """(positions, charge, radius, scale) of 12 particles: random ones in
    a 1.4 nm cube, and three close pairs whose radii and scales give the
    HCT integral's special regions."""
    rng = np.random.RandomState(21)
    n = 12
    pos = rng.uniform(0.0, 1.4, (n, 3))
    charge = rng.uniform(-0.8, 0.8, n)
    radius = rng.uniform(0.11, 0.25, n)
    scale = rng.uniform(0.5, 1.6, n)
    for (a, b, r), (ra, sa, rb, sb) in zip(
            ((0, 1, 0.10), (2, 3, 0.14), (4, 5, 0.19)),
            ((0.25, 0.6, 0.11, 0.5), (0.12, 0.5, 0.25, 1.6),
             (0.2, 1.2, 0.15, 0.9))):
        u = rng.randn(3)
        pos[b] = pos[a] + r * u / np.linalg.norm(u)
        radius[[a, b]], scale[[a, b]] = (ra, rb), (sa, sb)
    return pos, charge, radius, scale


def _regions(pos, radius, scale):
    """Counts of the ordered pairs in each region of the HCT integral:
    (no contribution, L = rho, L = r - sr, L = sr - r)."""
    rho = radius - gb_ops.DIELECTRIC_OFFSET
    sr = rho * scale
    r = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    off = ~np.eye(len(pos), dtype=bool)
    rho_i, sr_j = rho[:, None], sr[None, :]
    none = off & (rho_i >= r + sr_j)
    some = off & ~none
    return (none.sum(), (some & (np.abs(r - sr_j) <= rho_i)).sum(),
            (some & (r - sr_j > rho_i)).sum(),
            (some & (sr_j - r > rho_i)).sum())


def test_random_case_reaches_every_region():
    pos, _, radius, scale = _random_case()
    assert min(_regions(pos, radius, scale)) >= 1


def _jax_gb_state(method, pos, charge, radius, scale, platform):
    cutoff, width = METHODS[method]
    system = mm.System()
    gb = mm.GBSAOBCForce()
    for q, r, s in zip(charge, radius, scale):
        system.addParticle(12.0)
        gb.addParticle(float(q), float(r), float(s))
    gb.setNonbondedMethod(getattr(mm.GBSAOBCForce, method))
    if cutoff is not None:
        gb.setCutoffDistance(cutoff)
    if width is not None:
        system.setDefaultPeriodicBoxVectors(
            mm.Vec3(width, 0, 0), mm.Vec3(0, width, 0), mm.Vec3(0, 0, width))
    system.addForce(gb)
    ctx = mm.Context(system, mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName(platform))
    ctx.setPositions(pos)
    st = ctx.getState(getEnergy=True, getForces=True)
    return st.getPotentialEnergy()._value, \
        np.asarray(st.getForces(asNumpy=True)._value)


def _port_gb_context(method, pos, charge, radius, scale, precision):
    cutoff, width = METHODS[method]
    system = omm.System()
    gb = GB()
    for q, r, s in zip(charge, radius, scale):
        system.addParticle(12.0)
        gb.addParticle(q, r, s)
    gb.setNonbondedMethod(getattr(GB, method))
    if cutoff is not None:
        gb.setCutoffDistance(cutoff)
    if width is not None:
        system.setDefaultPeriodicBoxVectors([width, 0, 0], [0, width, 0],
                                            [0, 0, width])
    system.addForce(gb)
    assert system.usesPeriodicBoundaryConditions() == (width is not None)
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": precision})
    ctx.setPositions(pos)
    return ctx


@pytest.mark.parametrize("precision", ["double", "mixed"])
def test_single_ion_closed_form(precision):
    q, r, s = 1.0, 0.15, 0.8
    ctx = _port_gb_context("NoCutoff", np.zeros((1, 3)), [q], [r], [s],
                           precision)
    e = plain(ctx.getState(getEnergy=True).getPotentialEnergy())
    born = r - 0.009
    pre = -ONE_4PI_EPS0 * (1.0 / 1.0 - 1.0 / 78.3)
    want = 0.5 * pre * q * q / born + 28.3919551 * (r + 0.14) ** 2 \
        * (r / born) ** 6
    assert abs(e - want) < 1e-12 * abs(want)


@pytest.mark.parametrize("method", sorted(METHODS))
def test_random_case_matches_jax_platforms(method):
    case = _random_case()
    e_ref, f_ref = _jax_gb_state(method, *case, "Reference")
    ctx = _port_gb_context(method, *case, "double")
    st = ctx.getState(getEnergy=True, getForces=True)
    assert abs(plain(st.getPotentialEnergy()) - e_ref) < 1e-10 * abs(e_ref)
    assert np.abs(plain(st.getForces(asNumpy=True)) - f_ref).max() < 1e-9
    e_cpu, f_cpu = _jax_gb_state(method, *case, "CPU")
    st32 = _port_gb_context(method, *case, "mixed").getState(
        getEnergy=True, getForces=True)
    assert median_relative_error(plain(st32.getForces(asNumpy=True)),
                                 f_cpu) <= 1e-5
    assert median_relative_error(plain(st32.getForces(asNumpy=True)),
                                 f_ref) <= 1e-5
    assert abs(plain(st32.getPotentialEnergy()) - e_ref) < 1e-5 * abs(e_ref)


def _autograd_against_analytic(module, pos, box):
    x = torch.as_tensor(pos, dtype=torch.float64).requires_grad_()
    energy = module.energy(x, box)
    (grad,) = torch.autograd.grad(energy, x)
    e, f = module.ef(torch.as_tensor(pos, dtype=torch.float64), box)
    assert abs(float(energy.detach()) - float(e)) < 1e-12 * abs(float(e))
    assert float((-grad - f).abs().max()) < 1e-10 * float(f.abs().max())


@pytest.mark.parametrize("method", sorted(METHODS))
def test_analytic_forces_match_autograd(method):
    case = _random_case()
    ctx = _port_gb_context(method, *case, "double")
    (module,) = ctx._gb
    _autograd_against_analytic(module, case[0], ctx._box)


@pytest.fixture(scope="module")
def cluster3():
    """The 3-lipid cluster: (from_numpy dict, positions)."""
    system, pos = popc_obc_cluster(3)
    return omm.to_numpy(system), pos


def test_cluster_gb_parameters_are_standard_obc2(cluster3):
    """The cluster's radii and screens are those of
    standard_gb_parameters("OBC2") on the topology of three of the
    patch's lipids, its GB charges the nonbonded ones."""
    top, pos, box = _load_membrane_patch("POPC")
    lipids = [r for r in top.residues() if r.name != "HOH"][:3]
    sub, _ = _sub_topology(top, pos, lipids, box)
    want = np.asarray(standard_gb_parameters("OBC2", sub), np.float64)
    params, _ = cluster3
    np.testing.assert_array_equal(params["gb_radii"], want[:, 0])
    np.testing.assert_array_equal(params["gb_scales"], want[:, 1])
    np.testing.assert_array_equal(params["gb_charges"], params["charges"])
    assert params["gb_method"] == "CutoffNonPeriodic"
    assert params["gb_cutoff"] == 2.0 and params["cutoff"] == 2.0
    assert params["rf_dielectric"] == 1.0
    assert params["gb_solvent_dielectric"] == 78.5


def test_full_cluster_is_the_upper_leaflets_centre():
    """19 whole lipids (2,546 atoms) of one leaflet, each template's
    constraints (82 a lipid), no periodic boundaries."""
    system, pos = popc_obc_cluster()
    assert system.getNumParticles() == pos.shape[0] == 2546
    assert system.getNumConstraints() == 19 * 82
    assert not system.usesPeriodicBoundaryConditions()
    kinds = [type(f).__name__ for f in system.getForces()]
    assert kinds == ["NonbondedForce", "GBSAOBCForce", "HarmonicBondForce",
                     "HarmonicAngleForce", "PeriodicTorsionForce",
                     "CMMotionRemover"]
    com = pos.reshape(19, 134, 3).mean(axis=1)
    # one leaflet: the lipids' centres within a slab thinner than the
    # bilayer's 4 nm
    assert np.ptp(com[:, 2]) < 2.0
    bonds = omm.to_numpy(system)["bond_pairs"]
    assert np.linalg.norm(pos[bonds[:, 0]] - pos[bonds[:, 1]],
                          axis=1).max() < 0.2


def test_cluster_matches_jax_reference_and_autograd(cluster3):
    params, pos = cluster3
    jctx = mm.Context(jax_system(params), mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    st = jctx.getState(getEnergy=True, getForces=True)
    e_ref = st.getPotentialEnergy()._value
    f_ref = np.asarray(st.getForces(asNumpy=True)._value)
    ctx = omm.Context(omm.from_numpy(params),
                      omm.LangevinMiddleIntegrator(300, 1, 0.002), "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    got = ctx.getState(getEnergy=True, getForces=True)
    assert abs(plain(got.getPotentialEnergy()) - e_ref) < 1e-10 * abs(e_ref)
    assert np.abs(plain(got.getForces(asNumpy=True)) - f_ref).max() \
        < 1e-9 * np.abs(f_ref).max()
    (module,) = ctx._gb
    _autograd_against_analytic(module, pos, ctx._box)


def test_zero_friction_steps_match_jax_reference(cluster3):
    params, pos = cluster3
    rng = np.random.RandomState(5)
    vel = rng.randn(*pos.shape) * np.sqrt(
        omm.BOLTZ * 300.0 / params["masses"])[:, None]
    jint = mm.LangevinMiddleIntegrator(300.0, 0.0, 0.002)
    jctx = mm.Context(jax_system(params), jint,
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    jctx.applyConstraints()
    start = np.asarray(jctx.getState(getPositions=True)
                       .getPositions(asNumpy=True)._value)
    jctx.setVelocities(vel)
    jint.step(10)
    want = np.asarray(jctx.getState(getPositions=True)
                      .getPositions(asNumpy=True)._value)
    integ = omm.LangevinMiddleIntegrator(300.0, 0.0, 0.002)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": "double"})
    ctx.setPositions(start)
    ctx.setVelocities(vel)
    integ.step(10)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.abs(want - start).max() > 1e-3       # the atoms did move
    assert np.abs(got - want).max() < 1e-9


def test_program_matches_eager_loop_bitwise(cluster3):
    params, pos = cluster3
    runs = []
    for eager in (False, True):
        integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
        integ.setRandomNumberSeed(11)
        ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
        ctx.setPositions(pos)
        ctx.applyConstraints()
        ctx.setVelocitiesToTemperature(300.0, randomSeed=3)
        (ctx._step_eager if eager else integ.step)(8)
        runs.append((ctx._state["positions"], ctx._state["velocities"]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_numpy_round_trip_keeps_gb(cluster3):
    params, _ = cluster3
    back = omm.to_numpy(omm.from_numpy(params))
    for key in ("gb_charges", "gb_radii", "gb_scales", "gb_method",
                "gb_cutoff", "gb_solute_dielectric", "gb_solvent_dielectric",
                "gb_surface_energy"):
        np.testing.assert_array_equal(back[key], params[key], err_msg=key)
    with pytest.raises(ValueError, match="same number"):
        bad = omm.from_numpy(dict(params, gb_charges=params["gb_charges"][1:],
                                  gb_radii=params["gb_radii"][1:],
                                  gb_scales=params["gb_scales"][1:]))
        omm.Context(bad, omm.VerletIntegrator(0.001), "CPU")


def test_chip_smoke_gbsa_phase_on_cpu():
    """chip_smoke.phase_gbsa at 3 lipids and a few steps: the float32
    forces and group energies against float64, a minimize call, steps
    through the step program and the eager loop's bits."""
    out = chip_smoke.phase_gbsa(torch.device("cpu"), lipids=3, steps=6,
                                replay=4, energy_every=2,
                                minimize_iterations=3)
    assert out["force_err"] <= chip_smoke.FORCE_ERR_BAR
    assert out["atoms"] == 402
    assert out["sweeps_ms"] is None
