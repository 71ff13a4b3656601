"""NoseHooverIntegrator in openmm_tpu_torch against openmm_tpu.

On the droplet of tests/test_torch_integrators.py (float64, 25 steps,
the same start on both sides) a full-system chain and a chain over a
subsystem of atoms follow the JAX "Reference" Context to 1e-9 nm; on the
bonded pairs of tests/test_integrators.py:186-233 (an oxygen-like and a
hydrogen-like mass on a stiff bond) a thermostat over the pairs'
centres of mass with a relative chain at another temperature does. The
reported kinetic energy, computeHeatBathEnergy and every chain's positions
and velocities agree to 1e-9 (relative for the energies). The JAX
package's NoseHooverIntegrator(stepSize, None) adds a full-system
thermostat at 298 K and 50/ps before any subsystem one, so the port's
side of that case adds it by hand. On anchored oscillators (the pattern
of tests/test_custom_integrator.py:131-156) the mean kinetic energy lies
within 12 % of equipartition on the port's own stream, and the step
program gives the eager loop's bits, chains included, across an undone
chunk."""
import numpy as np
import pytest
import torch

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import ANCHORS, anchored_droplet, jax_system
from openmm_tpu_torch.unit import plain

STEPS = 25


@pytest.fixture(scope="module")
def droplet():
    return anchored_droplet()


def _pairs(mod):
    """24 pairs of masses 16 and 1 on bonds of 0.1 nm (k 20000), the
    pairs' list, positions, and velocities at 200 K from a numpy seed."""
    system = mod.System()
    bond = mod.HarmonicBondForce()
    pos, pairs = [], []
    for i in range(24):
        a = system.addParticle(16.0)
        b = system.addParticle(1.0)
        bond.addBond(a, b, 0.1, 20000.0)
        base = np.array([0.5 * (i % 5), 0.5 * ((i // 5) % 5), 0.5 * (i // 25)])
        pos += [base, base + [0.1, 0.0, 0.0]]
        pairs.append((a, b))
    system.addForce(bond)
    masses = np.tile([16.0, 1.0], 24)
    rng = np.random.RandomState(9)
    vel = rng.randn(48, 3) * np.sqrt(omm.BOLTZ * 200.0 / masses)[:, None]
    return system, pairs, np.asarray(pos), vel


def _full(mod, n):
    return mod.NoseHooverIntegrator(300.0, 20.0, 0.001)


def _subsystem(mod, n):
    integ = mod.NoseHooverIntegrator(0.001, None)
    if mod is omm:
        integ.addThermostat(298.0, 50.0)
    integ.addSubsystemThermostat(list(range(0, n - ANCHORS, 2)), [], 250.0,
                                 30.0, 250.0, 30.0)
    return integ


def _paired(mod, pairs):
    integ = mod.NoseHooverIntegrator(0.0005, None)
    if mod is omm:
        integ.addThermostat(298.0, 50.0)
    integ.addSubsystemThermostat([], pairs, 300.0, 100.0, 100.0, 100.0,
                                 chainLength=3, numMTS=3, numYoshidaSuzuki=7)
    return integ


def _jax_chains(jint, jctx):
    aux = jctx._state["aux"]
    out = []
    for i in range(jint.getNumThermostats()):
        for tag in ("", "r"):
            key = "nh%s%d_pos" % (tag, i)
            if key in aux:
                out.append((np.asarray(aux[key]),
                            np.asarray(aux["nh%s%d_vel" % (tag, i)])))
    return out


def _port_chains(integ):
    out = []
    for i in range(integ.getNumThermostats()):
        out.append(integ.getChainState(i))
        if integ._thermostats[i]["pairs"]:
            out.append(integ.getChainState(i, relative=True))
    return out


@pytest.mark.parametrize("case", ["full", "subsystem", "pairs"])
def test_trajectory_matches_jax_reference(droplet, case):
    if case == "pairs":
        jsys, pairs, pos, vel = _pairs(mm)
        psys = _pairs(omm)[0]
        make = lambda mod: _paired(mod, pairs)              # noqa: E731
    else:
        params, pos, vel = droplet
        jsys, psys = jax_system(params), omm.from_numpy(params)
        n = len(params["masses"])
        make = ((lambda mod: _full(mod, n)) if case == "full"
                else (lambda mod: _subsystem(mod, n)))
    jint = make(mm)
    jctx = mm.Context(jsys, jint, mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    jctx.applyConstraints()
    start = np.asarray(jctx.getState(getPositions=True)
                       .getPositions(asNumpy=True)._value)
    jctx.setVelocities(vel)
    jint.step(STEPS)
    jst = jctx.getState(getPositions=True, getEnergy=True)
    want = np.asarray(jst.getPositions(asNumpy=True)._value)
    integ = make(omm)
    assert integ.getNumThermostats() == jint.getNumThermostats()
    ctx = omm.Context(psys, integ, "CPU", {"Precision": "double"})
    ctx.setPositions(start)
    ctx.setVelocities(vel)
    integ.step(STEPS)
    st = ctx.getState(getPositions=True, getEnergy=True)
    got = plain(st.getPositions(asNumpy=True))
    assert np.abs(want - start).max() > 1e-3
    assert np.abs(got - want).max() < 1e-9
    ke = jst.getKineticEnergy()._value
    assert abs(plain(st.getKineticEnergy()) - ke) < 1e-9 * abs(ke)
    bath = jint.computeHeatBathEnergy()._value
    assert abs(bath) > 1e-6
    assert abs(integ.computeHeatBathEnergy() - bath) < 1e-9 * abs(bath)
    for (jp, jv), (pp, pv) in zip(_jax_chains(jint, jctx),
                                  _port_chains(integ)):
        assert np.abs(pp - jp).max() < 1e-9
        assert np.abs(pv - jv).max() < 1e-9
    for i in range(integ.getNumThermostats()):
        assert integ.getThermostat(i).getNumDegreesOfFreedom() == \
            jint.getThermostat(i).getNumDegreesOfFreedom()


def test_chain_object_and_setters():
    integ = omm.NoseHooverIntegrator(310.0, 40.0, 0.001, chainLength=4,
                                     numMTS=2, numYoshidaSuzuki=5)
    chain = integ.getThermostat()
    assert (plain(chain.getTemperature()),
            plain(chain.getCollisionFrequency()),
            chain.getChainLength(), chain.getNumMultiTimeSteps(),
            chain.getNumYoshidaSuzukiTimeSteps()) == (310.0, 40.0, 4, 2, 5)
    chain.setTemperature(290.0)
    assert plain(integ.getTemperature()) == 290.0
    assert not integ.hasSubsystemThermostats()
    with pytest.raises(ValueError):
        integ.addThermostat(300.0, 1.0, numYoshidaSuzuki=4)
    assert integ.computeHeatBathEnergy() == 0.0


def test_temperature_with_anchors():
    """Harmonic particles on massless anchors (no constraints, dof 3 a
    particle) thermalize to 300 K."""
    n, temperature = 64, 300.0
    system = omm.System()
    bond = omm.HarmonicBondForce()
    for _ in range(n):
        system.addParticle(10.0)
    for i in range(n):
        system.addParticle(0.0)
        bond.addBond(i, n + i, 0.05, 100.0)
    system.addForce(bond)
    pos = np.zeros((2 * n, 3))
    pos[:n, 0] = pos[n:, 0] = 0.5 * np.arange(n)
    integ = omm.NoseHooverIntegrator(temperature, 20.0, 0.002)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(temperature, randomSeed=8)
    integ.step(400)
    kes = []
    for _ in range(50):
        integ.step(20)
        kes.append(plain(ctx.getState(getEnergy=True).getKineticEnergy()))
    expected = 0.5 * 3 * n * omm.BOLTZ * temperature
    assert abs(np.mean(kes) - expected) / expected < 0.12
    assert integ.getThermostat().getNumDegreesOfFreedom() == 3 * n
    got = plain(ctx.getState(getPositions=True).getPositions(asNumpy=True))
    assert np.array_equal(got[n:], pos[n:])


@pytest.mark.parametrize("subsystem", [False, True])
def test_program_matches_eager_loop_bitwise(subsystem):
    """A 216-water PME box whose candidate state starts too small: the
    first chunk overflows and is undone, the chains with it."""
    runs = []
    for eager in (False, True):
        system, positions = tip3p_water_box(216)
        integ = omm.NoseHooverIntegrator(300.0, 10.0, 0.001)
        if subsystem:
            integ.addSubsystemThermostat(
                [], [(3 * i, 3 * i + 1) for i in range(20)], 310.0, 20.0,
                200.0, 40.0)
        ctx = omm.Context(system, integ, "CPU")
        ctx._nonbonded.capacity_scale = 0.3
        ctx.setPositions(positions)
        ctx.applyConstraints()
        ctx.setVelocitiesToTemperature(250.0, randomSeed=3)
        (ctx._step_eager if eager else integ.step)(12)
        runs.append(ctx)
    graph, eager = runs
    assert graph.escalation_count >= 1
    assert graph.escalation_count == eager.escalation_count
    for key in ("positions", "velocities"):
        assert torch.equal(graph._state[key], eager._state[key])
    for a, b in zip(graph._step_tensors(), eager._step_tensors()):
        assert torch.equal(a, b)
    assert graph.getIntegrator().computeHeatBathEnergy() == \
        eager.getIntegrator().computeHeatBathEnergy() != 0.0
