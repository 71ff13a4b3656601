"""RPMDIntegrator and RPMDMonteCarloBarostat of openmm_tpu_torch against
openmm_tpu.

On 64 flexible TIP3P waters at PME 0.6 nm with the reciprocal space in
force group 1, four copies of distinct positions and velocities from a
numpy seed, without the thermostat (deterministic), the port follows the
JAX "Reference" Context to 1e-9 nm over 25 float64 steps with the
reciprocal space contracted to M = 1, 2 and K = 4 copies; each copy's
direct space goes through a candidate state of its own. On the port's own
random stream (the patterns of tests/test_rpmd.py) the copies spread
out, the centroid thermalizes, the total energy is finite, and the
barostat changes the box; an attempt moves every copy by its centroid's
offset, which numpy computes apart. The step program gives the eager
loop's bits with contraction and the barostat; constraints raise."""
import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import app as japp
from openmm_tpu import unit as ju

import openmm_tpu_torch as omm
from openmm_tpu_torch.unit import plain
from torch_port_helpers import system_params

STEPS = 25
COPIES = 4


@pytest.fixture(scope="module")
def water():
    """(the JAX System, its from_numpy params, positions) of 64 flexible
    TIP3P waters, PME 0.6 nm, the reciprocal space in group 1."""
    ff = japp.ForceField("amber14-tip3p.json")
    modeller = japp.Modeller(japp.Topology(), [])
    modeller.addSolvent(ff, boxSize=mm.Vec3(1.25, 1.25, 1.25) * ju.nanometer)
    system = ff.createSystem(modeller.topology, nonbondedMethod=japp.PME,
                             nonbondedCutoff=0.6 * ju.nanometer,
                             rigidWater=False, removeCMMotion=False)
    for f in system.getForces():
        if isinstance(f, mm.NonbondedForce):
            f.setReciprocalSpaceForceGroup(1)
    pos = np.asarray(modeller.positions.value_in_unit(ju.nanometer))
    return system, system_params(system), pos


def _start(integ, pos, masses, vec=None):
    """Each copy's positions and velocities from a numpy seed (vec wraps
    rows for the JAX package)."""
    rng = np.random.RandomState(5)
    wrap = (lambda a: [vec(*x) for x in a]) if vec else (lambda a: a)
    for c in range(integ.getNumCopies()):
        integ.setPositions(c, wrap(pos + 0.003 * rng.standard_normal(
            pos.shape)))
        integ.setVelocities(c, wrap(rng.standard_normal(pos.shape) * np.sqrt(
            omm.BOLTZ * 300.0 / masses)[:, None]))


@pytest.mark.parametrize("m", [1, 2, COPIES])
def test_trajectory_matches_jax_reference(water, m):
    jsys, params, pos = water
    jint = mm.RPMDIntegrator(COPIES, 300.0, 1.0, 0.0005, contractions={1: m})
    jint.setApplyThermostat(False)
    mm.Context(jsys, jint, mm.Platform.getPlatformByName("Reference"))
    _start(jint, pos, params["masses"], mm.Vec3)
    jint.step(STEPS)
    integ = omm.RPMDIntegrator(COPIES, 300.0, 1.0, 0.0005,
                               contractions={1: m})
    integ.setApplyThermostat(False)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": "double"})
    _start(integ, pos, params["masses"])
    integ.step(STEPS)
    for copy in (0, COPIES - 1):
        want = jint.getState(copy, getPositions=True, getEnergy=True)
        got = integ.getState(copy, getPositions=True, getEnergy=True)
        wx = np.asarray(want.getPositions(asNumpy=True)._value)
        assert np.abs(wx - pos).max() > 1e-2
        assert np.abs(plain(got.getPositions(asNumpy=True)) - wx).max() \
            < 1e-9
        we = want.getPotentialEnergy()._value
        assert abs(plain(got.getPotentialEnergy()) - we) < 1e-9 * abs(we)
    assert ctx.rebuild_count > 0


def harmonic_system(n=8, k_spring=100.0):
    system = omm.System()
    f = omm.CustomExternalForce("0.5*k*(x*x+y*y+z*z)")
    f.addGlobalParameter("k", k_spring)
    positions = []
    for i in range(n):
        system.addParticle(2.0)
        f.addParticle(i, [])
        positions.append([0.05 * i, 0.0, 0.0])
    system.addForce(f)
    return system, np.asarray(positions)


def test_runs_spreads_and_total_energy():
    system, positions = harmonic_system()
    integ = omm.RPMDIntegrator(8, 300.0, 10.0, 0.0005)
    integ.setRandomNumberSeed(3)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(positions)
    integ.step(200)
    st = integ.getState(0, getPositions=True, getEnergy=True)
    assert np.isfinite(plain(st.getPotentialEnergy()))
    p0 = plain(st.getPositions(asNumpy=True))
    p4 = plain(integ.getState(4, getPositions=True).getPositions(
        asNumpy=True))
    assert np.max(np.abs(p0 - p4)) > 1e-4
    assert np.array_equal(p0, plain(ctx.getState(getPositions=True)
                                    .getPositions(asNumpy=True)))
    assert np.isfinite(plain(integ.getTotalEnergy()))


def test_centroid_temperature():
    """The centroid is classical: its kinetic energy is (3N/2) kT."""
    n, k = 16, 4
    system, positions = harmonic_system(n=n, k_spring=50.0)
    integ = omm.RPMDIntegrator(k, 300.0, 10.0, 0.001)
    integ.setRandomNumberSeed(5)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(positions)
    integ.step(500)
    kes = []
    for _ in range(40):
        integ.step(25)
        v = integ._rp[1].cpu().numpy().mean(axis=0)
        kes.append(0.5 * 2.0 * np.sum(v ** 2))
    expected = 0.5 * 3 * n * omm.BOLTZ * 300.0
    assert abs(np.mean(kes) - expected) / expected < 0.25


def test_barostat_moves_every_copy_by_its_centroid_offset(water):
    """One accepted attempt (the Metropolis uniform 0): each copy moves by
    the centroid's molecule offsets, which numpy computes from the
    molecules' centres of mass."""
    _, params, pos = water
    system = omm.from_numpy(params)
    system.addForce(omm.RPMDMonteCarloBarostat(1.0, 1))
    integ = omm.RPMDIntegrator(COPIES, 300.0, 1.0, 0.0005)
    ctx = omm.Context(system, integ, "CPU", {"Precision": "double"})
    _start(integ, pos, params["masses"])
    baro = ctx._barostats[0]
    pos_all = integ._rp[0].clone()
    u = torch.tensor([0.9, 0.0], dtype=torch.float64)
    out = baro.attempt(pos_all, ctx._box, u, ctx._gp, ctx._trial_energy)
    assert bool(out["accept"])
    new = out["positions"].numpy()
    old = pos_all.numpy()
    scale = out["box"][0, 0].item() / ctx._box[0, 0].item()
    assert scale > 1.0
    centroid = old.mean(axis=0)
    masses = params["masses"]
    mol = np.arange(len(masses)) // 3
    com = np.zeros((mol.max() + 1, 3))
    np.add.at(com, mol, masses[:, None] * centroid)
    com /= np.bincount(mol, masses)[:, None]
    offset = (com * (scale - 1.0))[mol]
    for c in range(COPIES):
        assert np.abs(new[c] - old[c] - offset).max() < 1e-12
    with pytest.raises(ValueError, match="RPMDIntegrator"):
        omm.Context(system, omm.LangevinMiddleIntegrator(300, 1, 0.001),
                    "CPU")


def test_barostat_changes_the_box(water):
    _, params, pos = water
    system = omm.from_numpy(params)
    system.addForce(omm.RPMDMonteCarloBarostat(1000.0, 2))
    integ = omm.RPMDIntegrator(COPIES, 300.0, 10.0, 0.0005)
    integ.setRandomNumberSeed(2)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, randomSeed=1)
    box0 = plain(ctx.getState().getPeriodicBoxVectors(asNumpy=True))
    integ.step(20)
    st = ctx.getState(getPositions=True)
    assert np.isfinite(plain(st.getPositions(asNumpy=True))).all()
    assert abs(plain(st.getPeriodicBoxVectors(asNumpy=True))[0, 0]
               - box0[0, 0]) > 1e-6


def test_program_matches_eager_loop_bitwise(water):
    """Thermostat, contraction and the barostat, from one start: the
    step program and the eager loop give the same bits and rebuilds."""
    _, params, pos = water
    runs = []
    for eager in (False, True):
        system = omm.from_numpy(params)
        system.addForce(omm.RPMDMonteCarloBarostat(1.0, 3))
        integ = omm.RPMDIntegrator(COPIES, 300.0, 1.0, 0.0005,
                                   contractions={1: 2})
        integ.setRandomNumberSeed(9)
        ctx = omm.Context(system, integ, "CPU")
        ctx.setPositions(pos)
        ctx.setVelocitiesToTemperature(300.0, randomSeed=4)
        for _ in range(2):
            (ctx._step_eager if eager else integ.step)(4)
        runs.append([t.cpu().numpy().copy() for t in integ._rp]
                    + [ctx._box.cpu().numpy().copy(), ctx.rebuild_count])
    for got, want in zip(runs[0][:-1], runs[1][:-1]):
        assert np.array_equal(got, want)
    assert runs[0][-1] == runs[1][-1]


def test_constraints_raise(water):
    _, params, pos = water
    system = omm.from_numpy(params)
    system.addConstraint(0, 1, 0.09572)
    integ = omm.RPMDIntegrator(COPIES, 300.0, 1.0, 0.0005)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    with pytest.raises(NotImplementedError, match="constraints"):
        integ.step(1)


def test_getters():
    integ = omm.RPMDIntegrator(6, 310.0, 2.0, 0.0005, contractions={1: 3})
    jint = mm.RPMDIntegrator(6, 310.0, 2.0, 0.0005, contractions={1: 3})
    assert integ.getNumCopies() == jint.getNumCopies() == 6
    assert integ.getContractions() == jint.getContractions()
    assert plain(integ.getTemperature()) == jint.getTemperature()._value
    assert plain(integ.getFriction()) == jint.getFriction()._value
    integ.setApplyThermostat(False)
    assert not integ.getApplyThermostat()
    baro = omm.RPMDMonteCarloBarostat(2.0, 10)
    assert plain(baro.getDefaultPressure()) == 2.0
    assert baro.getFrequency() == 10
    assert baro.Pressure() == mm.RPMDMonteCarloBarostat.Pressure()
    assert isinstance(baro, omm.RPMDUpdater)


def test_contraction_to_every_copy_is_the_identity():
    """A group contracted to K copies follows the uncontracted run, and to
    one copy a different one (tests/test_rpmd.py:test_contraction_identity
    _and_centroid, on a quartic well)."""
    def run(contractions):
        system = omm.System()
        f = omm.CustomExternalForce("25*(x^4+y^4+z^4) + 50*(x*x+y*y+z*z)")
        for _ in range(4):
            system.addParticle(2.0)
        for i in range(4):
            f.addParticle(i, [])
        system.addForce(f)
        integ = omm.RPMDIntegrator(4, 300.0, 1.0, 0.0005,
                                   contractions=contractions)
        integ.setApplyThermostat(False)
        omm.Context(system, integ, "CPU", {"Precision": "double"})
        base = np.array([[0.05 * (i + 1), 0.02, -0.03] for i in range(4)])
        _start(integ, base, np.full(4, 2.0))
        integ.step(5)
        return integ._rp[0].numpy().copy()

    none, full, one = run(None), run({0: 4}), run({0: 1})
    assert np.abs(none - full).max() < 1e-12
    assert np.isfinite(one).all() and np.abs(none - one).max() > 0.0
