"""The Drude integrators of openmm_tpu_torch against openmm_tpu.

On eight polarizable molecules (a parent, a bonded hydrogen-like atom
and a Drude particle each; a NonbondedForce with every pair inside a
molecule excluded, two anisotropic springs and two Thole-screened pairs)
each integrator follows the JAX "Reference" Context to 1e-9 nm over 25
float64 steps from the same start: DrudeLangevinIntegrator at T =
T_drude = 0 (deterministic, friction only), DrudeSCFIntegrator and
DrudeNoseHooverIntegrator (its chains too). On the port's own random
stream (the patterns of tests/test_drude.py) the pairs' centres of mass
thermalize at T and their relative motion stays cold, and the SCF moves
each Drude particle to E q / k in a field. The step program gives the
eager loop's bits on a PME water box of SWM4-NDP molecules."""
import numpy as np
import pytest

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.unit import plain

STEPS = 25
N_MOLECULES = 8


def polar_system(mod):
    """(System, positions, velocities) of N_MOLECULES polarizable
    molecules in `mod` (either package), from a numpy seed."""
    rng = np.random.RandomState(4)
    system = mod.System()
    nb = mod.NonbondedForce()
    bond = mod.HarmonicBondForce()
    drude = mod.DrudeForce()
    pos, atoms = [], []
    for i in range(N_MOLECULES):
        p = system.addParticle(15.6)
        h = system.addParticle(1.008)
        d = system.addParticle(0.4)
        for q, sig, eps in ((1.3, 0.31, 0.6), (0.4, 0.1, 0.0),
                            (-1.7, 0.1, 0.0)):
            nb.addParticle(q, sig, eps)
        for a, b in ((p, h), (p, d), (h, d)):
            nb.addException(a, b, 0.0, 1.0, 0.0)
        bond.addBond(p, h, 0.1, 3.0e5)
        aniso = i % 2 == 1
        drude.addParticle(d, p, h if aniso else -1, -1, -1, -1.7, 0.0011,
                          1.25 if aniso else 1.0, 1.0)
        base = np.array([0.45 * (i % 2), 0.45 * ((i // 2) % 2),
                         0.45 * (i // 4)])
        pos += [base, base + [0.1, 0.0, 0.0],
                base + 0.004 * rng.standard_normal(3)]
        atoms.append((p, d))
    for k, (a, b) in enumerate(((0, 1), (2, 3))):
        drude.addScreenedPair(a, b, 2.1 + 0.3 * k)
        for x in atoms[a]:
            for y in atoms[b]:
                nb.addException(x, y, 0.0, 1.0, 0.0)
    for force in (nb, bond, drude):
        system.addForce(force)
    masses = np.tile([15.6, 1.008, 0.4], N_MOLECULES)
    vel = rng.standard_normal((3 * N_MOLECULES, 3)) \
        * np.sqrt(omm.BOLTZ * 300.0 / masses)[:, None]
    return system, np.asarray(pos), vel


INTEGRATORS = {
    "langevin": lambda mod: mod.DrudeLangevinIntegrator(0.0, 10.0, 0.0,
                                                        50.0, 0.0005),
    "scf": lambda mod: mod.DrudeSCFIntegrator(0.0005),
    "nose-hoover": lambda mod: mod.DrudeNoseHooverIntegrator(
        300.0, 10.0, 1.0, 50.0, 0.0005),
}


@pytest.mark.parametrize("kind", sorted(INTEGRATORS))
def test_trajectory_matches_jax_reference(kind):
    jsys, pos, vel = polar_system(mm)
    jint = INTEGRATORS[kind](mm)
    jctx = mm.Context(jsys, jint, mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions([mm.Vec3(*p) for p in pos])
    jctx.setVelocities([mm.Vec3(*v) for v in vel])
    jint.step(STEPS)
    jst = jctx.getState(getPositions=True, getVelocities=True)
    want = np.asarray(jst.getPositions(asNumpy=True)._value)
    integ = INTEGRATORS[kind](omm)
    ctx = omm.Context(polar_system(omm)[0], integ, "CPU",
                      {"Precision": "double"})
    ctx.setPositions(pos)
    ctx.setVelocities(vel)
    integ.step(STEPS)
    st = ctx.getState(getPositions=True, getVelocities=True)
    got = plain(st.getPositions(asNumpy=True))
    assert np.abs(want - pos).max() > 1e-3
    assert np.abs(got - want).max() < 1e-9, np.abs(got - want).max()
    jv = np.asarray(jst.getVelocities(asNumpy=True)._value)
    assert np.abs(plain(st.getVelocities(asNumpy=True)) - jv).max() \
        < 1e-7 * np.abs(jv).max()
    if kind == "nose-hoover":
        aux = jctx._state["aux"]
        for relative, key in ((False, ""), (True, "_d")):
            cp, cv = integ.getChainState(relative)
            assert np.abs(cp - np.asarray(aux["nh_pos" + key])).max() < 1e-9
            assert np.abs(cv - np.asarray(aux["nh_vel" + key])).max() < 1e-9


def test_getters_and_setters():
    integ = omm.DrudeLangevinIntegrator(300.0, 1.0, 1.0, 20.0, 0.001)
    assert [plain(x) for x in (integ.getTemperature(), integ.getFriction(),
                               integ.getDrudeTemperature(),
                               integ.getDrudeFriction(),
                               integ.getStepSize())] == \
        [300.0, 1.0, 1.0, 20.0, 0.001]
    integ.setDrudeTemperature(2.0)
    integ.setMaxDrudeDistance(0.02)
    assert plain(integ.getDrudeTemperature()) == 2.0
    assert plain(integ.getMaxDrudeDistance()) == 0.02
    scf = omm.DrudeSCFIntegrator(0.001)
    scf.setMinimizationErrorTolerance(0.5)
    assert plain(scf.getMinimizationErrorTolerance()) == 0.5
    nh = omm.DrudeNoseHooverIntegrator(300.0, 10.0, 1.0, 50.0, 0.001)
    assert (plain(nh.getCollisionFrequency()),
            plain(nh.getDrudeCollisionFrequency())) == (10.0, 50.0)
    jint = mm.DrudeLangevinIntegrator(300.0, 1.0, 1.0, 20.0, 0.001)
    assert type(integ.getTemperature()).__name__ == \
        type(jint.getTemperature()).__name__
    system = omm.System()
    system.addParticle(1.0)
    ctx = omm.Context(system, omm.DrudeSCFIntegrator(0.001), "CPU")
    ctx.setPositions(np.zeros((1, 3)))
    with pytest.raises(ValueError, match="DrudeForce"):
        ctx.getIntegrator().step(1)


def _drude_water_like(n_pairs):
    """Parent + Drude pairs on a lattice with springs only
    (tests/test_drude.py)."""
    system = omm.System()
    f = omm.DrudeForce()
    positions = []
    for i in range(n_pairs):
        p = system.addParticle(15.0)
        d = system.addParticle(0.4)
        f.addParticle(d, p, -1, -1, -1, 1.0, 0.001, 1, 1)
        base = np.array([0.5 * (i % 4), 0.5 * ((i // 4) % 4),
                         0.5 * (i // 16)])
        positions += [base, base + [0.001, 0.0, 0.0]]
    system.addForce(f)
    return system, np.asarray(positions)


def test_langevin_dual_temperature():
    """Centres of mass near T, relative motion cold, on the port's own
    random stream (tests/test_drude.py:test_drude_langevin_dual_
    temperature)."""
    n = 32
    system, positions = _drude_water_like(n)
    integ = omm.DrudeLangevinIntegrator(300.0, 10.0, 1.0, 100.0, 0.001)
    integ.setRandomNumberSeed(7)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(positions)
    integ.step(1000)
    t_com, t_rel = [], []
    m_p, m_d = 15.0, 0.4
    for _ in range(50):
        integ.step(20)
        v = plain(ctx.getState(getVelocities=True).getVelocities(
            asNumpy=True))
        vp, vd = v[0::2], v[1::2]
        v_com = (m_p * vp + m_d * vd) / (m_p + m_d)
        v_rel = vd - vp
        mu = m_p * m_d / (m_p + m_d)
        t_com.append(0.5 * (m_p + m_d) * np.sum(v_com ** 2))
        t_rel.append(0.5 * mu * np.sum(v_rel ** 2))
    dof = 0.5 * 3 * n * omm.BOLTZ
    assert abs(np.mean(t_com) / dof - 300.0) / 300.0 < 0.15
    assert np.mean(t_rel) / dof < 60.0


def test_scf_relaxes_in_a_field():
    """Each Drude particle moves to E0 q / k along the field
    (tests/test_drude.py:test_drude_scf)."""
    system, positions = _drude_water_like(8)
    ext = omm.CustomExternalForce("-E0*x*q")
    ext.addGlobalParameter("E0", 50.0)
    ext.addPerParticleParameter("q")
    for i in range(8):
        ext.addParticle(2 * i + 1, [1.0])
    system.addForce(ext)
    integ = omm.DrudeSCFIntegrator(0.0005)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(positions)
    integ.step(5)
    pos = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    expected = 50.0 / (omm.ONE_4PI_EPS0 / 0.001)
    assert np.allclose(pos[1::2, 0] - pos[0::2, 0], expected, rtol=0.1)


@pytest.fixture(scope="module")
def swm4_box():
    """64 SWM4-NDP waters (Modeller.addSolvent + addExtraParticles), PME
    0.9 nm, rigid: (System, positions), the Drudes 2e-3 nm off their
    oxygens."""
    from openmm_tpu_torch import app
    from openmm_tpu_torch import unit as pu
    ff = app.ForceField("swm4ndp.json")
    modeller = app.Modeller(app.Topology(), [])
    modeller.addSolvent(ff, model="tip3p",
                        boxSize=omm.Vec3(1.9, 1.9, 1.9) * pu.nanometer)
    modeller.addExtraParticles(ff)
    system = ff.createSystem(modeller.topology, nonbondedMethod=app.PME,
                             nonbondedCutoff=0.9 * pu.nanometer,
                             rigidWater=True)
    pos = plain(modeller.positions)
    drude = [f for f in system.getForces()
             if isinstance(f, omm.DrudeForce)][0]
    rng = np.random.RandomState(2)
    for i in range(drude.getNumParticles()):
        pos[drude.getParticleParameters(i)[0]] += \
            0.002 * rng.standard_normal(3)
    return system, pos


@pytest.mark.parametrize("kind", sorted(INTEGRATORS))
def test_program_matches_eager_loop_bitwise(swm4_box, kind):
    system, pos = swm4_box
    runs = []
    for eager in (False, True):
        integ = INTEGRATORS[kind](omm)
        if kind == "langevin":
            integ.setTemperature(300.0)
            integ.setDrudeTemperature(1.0)
        integ.setRandomNumberSeed(5)
        ctx = omm.Context(system, integ, "CPU")
        ctx.setPositions(pos)
        ctx.setVelocitiesToTemperature(300.0, randomSeed=3)
        (ctx._step_eager if eager else integ.step)(4)
        st = ctx.getState(getPositions=True, getVelocities=True,
                          getEnergy=True)
        runs.append((plain(st.getPositions(asNumpy=True)),
                     plain(st.getVelocities(asNumpy=True)),
                     plain(st.getPotentialEnergy()), ctx.rebuild_count))
        assert np.isfinite(runs[-1][2])
    for got, want in zip(runs[0][:2], runs[1][:2]):
        assert np.array_equal(got, want)
    assert runs[0][2:] == runs[1][2:]
