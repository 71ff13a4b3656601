"""The integrators (Verlet, leapfrog Langevin, Brownian, LangevinMiddle),
the Andersen thermostat, integration force groups, the shifted kinetic
energy and fixed (massless) particles in openmm_tpu_torch against
openmm_tpu.

The trajectory cases run a droplet of TIP3P waters (SETTLE, the
reaction field over every pair at CutoffNonPeriodic) with four massless
anchors tied to oxygens by harmonic bonds, from the same positions and
velocities (numpy seed) on both sides, float64: Verlet, Langevin at zero
friction and at zero temperature, and Brownian at zero temperature (no
noise) follow the JAX "Reference" Context to 1e-9 nm after 25 steps, the
anchors never move, and the reported kinetic energy (shifted by half a
step for the leapfrog integrators) agrees to 1e-9 relative. The
statistical cases are those of tests/test_integrators.py (harmonic
particles on massless anchors; the mean kinetic energy within 12 % of
its equipartition value) on the port's own random stream."""
import numpy as np
import pytest
import torch

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box, water_droplet
from torch_port_helpers import jax_system
from openmm_tpu_torch.unit import plain

NB = omm.NonbondedForce
ANCHORS = 4
STEPS = 25
# name: (port class, JAX class, (temperature K, friction 1/ps) or None,
#        step size ps)
INTEGRATORS = {
    "verlet": (omm.VerletIntegrator, mm.VerletIntegrator, None, 0.001),
    "langevin_frictionless": (omm.LangevinIntegrator, mm.LangevinIntegrator,
                              (300.0, 0.0), 0.001),
    "langevin_cold": (omm.LangevinIntegrator, mm.LangevinIntegrator,
                      (0.0, 5.0), 0.001),
    "brownian_cold": (omm.BrownianIntegrator, mm.BrownianIntegrator,
                      (0.0, 100.0), 0.0005),
    "langevin_middle_frictionless": (omm.LangevinMiddleIntegrator,
                                     mm.LangevinMiddleIntegrator,
                                     (300.0, 0.0), 0.001),
}


def _make(cls, setting, dt):
    return cls(dt) if setting is None else cls(*setting, dt)


@pytest.fixture(scope="module")
def droplet():
    """(from_numpy dict, positions, velocities): the waters of a 64-water
    box within 0.6 nm of its centre, at CutoffNonPeriodic 1.0 nm, and
    ANCHORS massless particles 0.05 nm from the first oxygens, each tied
    to its oxygen by a bond of 0.05 nm; Maxwell-Boltzmann velocities at
    300 K, 0 for the anchors."""
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


def _port_run(params, pos, vel, integ, steps, precision="double",
              eager=False):
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": precision})
    ctx.setPositions(pos)
    ctx.setVelocities(vel)
    (ctx._step_eager if eager else integ.step)(steps)
    return ctx


@pytest.mark.parametrize("name", sorted(INTEGRATORS))
def test_trajectory_matches_jax_reference(droplet, name):
    params, pos, vel = droplet
    port_cls, jax_cls, setting, dt = INTEGRATORS[name]
    jint = _make(jax_cls, setting, dt)
    jctx = mm.Context(jax_system(params), jint,
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    jctx.applyConstraints()
    start = np.asarray(jctx.getState(getPositions=True)
                       .getPositions(asNumpy=True)._value)
    jctx.setVelocities(vel)
    jint.step(STEPS)
    jst = jctx.getState(getPositions=True, getEnergy=True)
    want = np.asarray(jst.getPositions(asNumpy=True)._value)
    ctx = _port_run(params, start, vel, _make(port_cls, setting, dt), STEPS)
    st = ctx.getState(getPositions=True, getEnergy=True)
    got = plain(st.getPositions(asNumpy=True))
    assert np.abs(want - start).max() > 1e-3       # the atoms did move
    assert np.abs(got - want).max() < 1e-9
    # the anchors stay where they were put
    assert np.array_equal(got[-ANCHORS:], start[-ANCHORS:])
    ke = jst.getKineticEnergy()._value
    assert abs(plain(st.getKineticEnergy()) - ke) < 1e-9 * abs(ke)


def test_shifted_kinetic_energy(droplet):
    """Verlet reports 0.5 sum m (v + dt f / (2 m))^2 with the forces of
    the groups getState evaluates (the JAX Context's choice);
    LangevinMiddle and Brownian the plain 0.5 sum m v^2."""
    params, pos, vel = droplet
    params = dict(params, force_groups={"bond": 1})
    m = params["masses"]
    inv_m = np.where(m == 0, 0.0, 1.0 / np.where(m == 0, 1.0, m))
    for integ, shift in ((omm.VerletIntegrator(0.001), 0.5),
                         (omm.LangevinMiddleIntegrator(300.0, 1.0, 0.001),
                          0.0),
                         (omm.BrownianIntegrator(300.0, 100.0, 0.001), 0.0)):
        ctx = _port_run(params, pos, vel, integ, 3)
        v = plain(ctx.getState(getVelocities=True).getVelocities(asNumpy=True))
        for groups in (-1, {0}):
            st = ctx.getState(getEnergy=True, getForces=True, groups=groups)
            f = plain(st.getForces(asNumpy=True))
            w = v + shift * 0.001 * f * inv_m[:, None]
            want = 0.5 * np.sum(m[:, None] * w * w)
            assert abs(plain(st.getKineticEnergy()) - want) < 1e-12 * want
        assert ctx.kinetic_energy() == pytest.approx(
            plain(ctx.getState(getEnergy=True).getKineticEnergy()), rel=1e-15)


def test_time_and_step_count(droplet):
    params, pos, vel = droplet
    integ = omm.VerletIntegrator(0.002)
    ctx = _port_run(params, pos, vel, integ, 25, precision="mixed")
    assert abs(plain(ctx.getTime()) - 0.05) < 1e-10
    assert ctx.getState().getStepCount() == 25
    integ.setStepSize(0.001)
    integ.step(10)
    assert abs(plain(ctx.getTime()) - 0.06) < 1e-10
    assert ctx.getStepCount() == 35


def _pair_with_bond(group):
    system = omm.System()
    system.addParticle(1.0)
    system.addParticle(1.0)
    bond = omm.HarmonicBondForce()
    bond.addBond(0, 1, 1.0, 100.0)
    bond.setForceGroup(group)
    system.addForce(bond)
    return system


def test_integration_force_groups():
    """tests/test_integrators.py:test_integration_force_groups: a bond in
    group 1 left out of the integration leaves the particles at rest;
    integrating every group again moves them, through a second program,
    and getState still sees the bond."""
    integ = omm.VerletIntegrator(0.001)
    integ.setIntegrationForceGroups({0})
    assert integ.getIntegrationForceGroups() == 1
    ctx = omm.Context(_pair_with_bond(1), integ, "CPU")
    ctx.setPositions([[0, 0, 0], [2, 0, 0]])
    integ.step(10)
    st = ctx.getState(getVelocities=True, getEnergy=True)
    assert np.abs(plain(st.getVelocities(asNumpy=True))).max() < 1e-12
    assert plain(st.getPotentialEnergy()) == pytest.approx(50.0)
    integ.setIntegrationForceGroups(-1)
    integ.step(10)
    assert np.abs(plain(ctx.getState(getVelocities=True)
                  .getVelocities(asNumpy=True))).max() > 0.1
    assert len(ctx._programs) == 2
    eager = omm.VerletIntegrator(0.001)
    eager.setIntegrationForceGroups({0})
    ectx = omm.Context(_pair_with_bond(1), eager, "CPU")
    ectx.setPositions([[0, 0, 0], [2, 0, 0]])
    ectx._step_eager(10)
    assert np.abs(plain(ectx.getState(getVelocities=True)
                  .getVelocities(asNumpy=True))).max() < 1e-12


def test_andersen_at_zero_frequency_is_verlet(droplet):
    """With no collisions the thermostat changes nothing, although it
    draws its numbers every step."""
    params, pos, vel = droplet
    plain = _port_run(params, pos, vel, omm.VerletIntegrator(0.001), 15,
                      precision="mixed")
    thermo = _port_run(dict(params, andersen_temperature=300.0,
                            andersen_frequency=0.0),
                       pos, vel, omm.VerletIntegrator(0.001), 15,
                       precision="mixed")
    assert thermo.getParameter("AndersenCollisionFrequency") == 0.0
    for key in ("positions", "velocities"):
        assert torch.equal(plain._state[key], thermo._state[key])


# name: (integrator, Andersen frequency 1/ps or None)
PROGRAM_CASES = {
    "verlet": (lambda: omm.VerletIntegrator(0.001), None),
    "langevin": (lambda: omm.LangevinIntegrator(300.0, 5.0, 0.001), None),
    "brownian": (lambda: omm.BrownianIntegrator(300.0, 100.0, 0.0005),
                 None),
    "andersen": (lambda: omm.VerletIntegrator(0.001), 50.0),
}


@pytest.mark.parametrize("name", sorted(PROGRAM_CASES))
def test_program_matches_eager_loop_bitwise(droplet, name):
    params, pos, vel = droplet
    make, frequency = PROGRAM_CASES[name]
    if frequency is not None:
        params = dict(params, andersen_temperature=300.0,
                      andersen_frequency=frequency)
    runs = []
    for eager in (False, True):
        integ = make()
        integ.setRandomNumberSeed(17)
        ctx = _port_run(params, pos, vel, integ, 12, precision="mixed",
                        eager=eager)
        runs.append((ctx._state["positions"], ctx._state["velocities"]))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    if frequency is not None:
        # the thermostat did collide: not Verlet's velocities
        ref = _port_run(params | {"andersen_frequency": 0.0}, pos, vel,
                        make(), 12, precision="mixed")
        assert not torch.equal(ref._state["velocities"], runs[0][1])


def _anchored_oscillators(n, mass, k):
    """n particles of `mass` each tied by a bond of stiffness k to its own
    massless anchor (tests/test_integrators.py:68, :126)."""
    system = omm.System()
    bond = omm.HarmonicBondForce()
    for _ in range(n):
        system.addParticle(mass)
    for i in range(n):
        system.addParticle(0.0)
        bond.addBond(i, n + i, 0.0, k)
    system.addForce(bond)
    pos = np.zeros((2 * n, 3))
    pos[:n, 0] = pos[n:, 0] = 0.5 * np.arange(n)
    return system, pos


def _mean_kinetic_energy(integ, system, pos, temperature):
    integ.setRandomNumberSeed(4)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(temperature, randomSeed=3)
    integ.step(500)
    kes = []
    for _ in range(60):
        integ.step(20)
        kes.append(plain(ctx.getState(getEnergy=True).getKineticEnergy()))
    return np.mean(kes), ctx


@pytest.mark.parametrize("cls", [omm.LangevinIntegrator,
                                 omm.LangevinMiddleIntegrator])
def test_langevin_temperature_with_anchors(cls):
    n, temperature = 64, 300.0
    system, pos = _anchored_oscillators(n, 10.0, 100.0)
    mean_ke, ctx = _mean_kinetic_energy(cls(temperature, 10.0, 0.002),
                                        system, pos, temperature)
    expected = 0.5 * 3 * n * omm.BOLTZ * temperature
    assert abs(mean_ke - expected) / expected < 0.12, (mean_ke, expected)
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.array_equal(got[n:], pos[n:])


def test_andersen_temperature_with_anchors():
    n, temperature = 32, 250.0
    system, pos = _anchored_oscillators(n, 5.0, 50.0)
    system.addForce(omm.AndersenThermostat(temperature, 50.0))
    mean_ke, ctx = _mean_kinetic_energy(omm.VerletIntegrator(0.002),
                                        system, pos, temperature)
    expected = 0.5 * 3 * n * omm.BOLTZ * temperature
    assert abs(mean_ke - expected) / expected < 0.12, (mean_ke, expected)
    # massless particles never collide
    assert np.abs(plain(ctx.getState(getVelocities=True)
                  .getVelocities(asNumpy=True))[n:]).max() == 0.0
    ctx.setParameter(omm.AndersenThermostat.Temperature(), 100.0)
    assert ctx.getParameters() == {"AndersenTemperature": 100.0,
                                   "AndersenCollisionFrequency": 50.0}


def test_particle_collisions_cool_rigid_water():
    """Why the thermostat collides by constraint cluster: a fresh velocity
    for one atom of a rigid water, mixed with its partners' old ones and
    projected onto the constraints (P, in mass-weighted velocities),
    brings less than its share of heat. If the water's velocities are at
    temperature T, a collision of atom a keeps their mean energy when
    T / T_bath = tr(P E_a) / (2 tr(P E_a) - tr(P E_a P E_a)), E_a the
    projector onto atom a's coordinates; summed over the atoms that is
    0.886 for TIP3P. Redrawing the whole water gives T_bath."""
    d, theta = 0.09572, np.radians(104.52)
    x = np.array([[0, 0, 0], [d, 0, 0],
                  [d * np.cos(theta), d * np.sin(theta), 0]])
    m = np.array([15.99943, 1.007947, 1.007947])
    rows = []
    for i, j in ((0, 1), (0, 2), (1, 2)):
        g = np.zeros(9)
        g[3 * i:3 * i + 3] = (x[i] - x[j]) / np.sqrt(m[i])
        g[3 * j:3 * j + 3] = -(x[i] - x[j]) / np.sqrt(m[j])
        rows.append(g)
    q, _ = np.linalg.qr(np.asarray(rows).T)
    proj = np.eye(9) - q @ q.T
    gain = loss = 0.0
    for a in range(3):
        pe = proj[:, 3 * a:3 * a + 3] @ np.eye(9)[3 * a:3 * a + 3]
        gain += np.trace(pe)
        loss += 2.0 * np.trace(pe) - np.trace(pe @ pe)
    assert gain / loss == pytest.approx(0.886, abs=5e-4)
    # the whole cluster redrawn: E_a the identity
    assert np.trace(proj) / (2 * np.trace(proj) - np.trace(proj @ proj)) \
        == pytest.approx(1.0)


def test_massless_particles_and_degrees_of_freedom(droplet):
    """A massless particle gets no velocity at a temperature and adds no
    degrees of freedom; a constraint on one is refused; a negative mass
    is refused."""
    params, pos, _ = droplet
    ctx = omm.Context(omm.from_numpy(params), omm.VerletIntegrator(0.001),
                      "CPU")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, randomSeed=2)
    v = plain(ctx.getState(getVelocities=True).getVelocities(asNumpy=True))
    assert np.all(v[-ANCHORS:] == 0.0) and np.all(v[:-ANCHORS] != 0.0)
    n_massive = len(params["masses"]) - ANCHORS
    dof = 3 * n_massive - len(params["constraint_distances"])
    assert ctx.temperature() == pytest.approx(
        2.0 * ctx.kinetic_energy() / (dof * omm.BOLTZ), rel=1e-15)
    bad = dict(params, constraint_pairs=np.concatenate(
        [params["constraint_pairs"], [[0, len(params["masses"]) - 1]]]),
        constraint_distances=np.concatenate(
            [params["constraint_distances"], [0.05]]))
    with pytest.raises(NotImplementedError, match="massless"):
        omm.Context(omm.from_numpy(bad), omm.VerletIntegrator(0.001), "CPU")
    negative = dict(params, masses=np.where(params["masses"] == 0, -1.0,
                                            params["masses"]))
    with pytest.raises(ValueError, match="negative"):
        omm.Context(omm.from_numpy(negative), omm.VerletIntegrator(0.001),
                    "CPU")


def test_numpy_round_trip_keeps_andersen(droplet):
    params, _, _ = droplet
    params = dict(params, andersen_temperature=310.0, andersen_frequency=2.0,
                  andersen_seed=7, force_groups={"andersen": 3})
    back = omm.to_numpy(omm.from_numpy(params))
    for key in ("andersen_temperature", "andersen_frequency",
                "andersen_seed", "force_groups"):
        assert back[key] == params[key], key
