"""The variable-step integrators, CompoundIntegrator and the device clock
in openmm_tpu_torch against openmm_tpu.

On the droplet of tests/test_torch_integrators.py (float64, the same
start on both sides): VariableVerletIntegrator, and
VariableLangevinIntegrator at 0 K, pick the JAX "Reference" Context's
sequence of step sizes (1e-12 relative), reach its time and follow its
trajectory to 1e-9 nm over 25 steps; a CompoundIntegrator of Verlet and a
frictionless LangevinMiddle follows it across two switches, with its
time. The clock is a float64 device scalar: under a fixed step size it
holds the bits of the host's float64 sum of the step sizes. On a 216-water
PME box whose candidate state starts too small, the step program gives
the eager loop's bits, the device step size and the clock included,
across an undone chunk and, for the compound, across switches, each
member with a program of its own."""
import numpy as np
import pytest
import torch

import openmm_tpu as mm

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box
from torch_port_helpers import anchored_droplet, jax_system

STEPS = 25


@pytest.fixture(scope="module")
def droplet():
    return anchored_droplet()


def _contexts(params, pos, vel, jint, integ):
    jctx = mm.Context(jax_system(params), jint,
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    jctx.applyConstraints()
    start = np.asarray(jctx.getState(getPositions=True)
                       .getPositions(asNumpy=True)._value)
    jctx.setVelocities(vel)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU",
                      {"Precision": "double"})
    ctx.setPositions(start)
    ctx.setVelocities(vel)
    return jctx, ctx, start


def _positions(jctx):
    return np.asarray(jctx.getState(getPositions=True)
                      .getPositions(asNumpy=True)._value)


VARIABLE = {
    "verlet": lambda mod: mod.VariableVerletIntegrator(1e-3),
    "langevin_cold": lambda mod: mod.VariableLangevinIntegrator(0.0, 5.0,
                                                                1e-3),
}


@pytest.mark.parametrize("name", sorted(VARIABLE))
def test_variable_matches_jax_reference(droplet, name):
    params, pos, vel = droplet
    jint, integ = VARIABLE[name](mm), VARIABLE[name](omm)
    jctx, ctx, start = _contexts(params, pos, vel, jint, integ)
    want, got = [], []
    for _ in range(STEPS):
        jint.step(1)
        want.append(float(jctx._state["iparams"]["dt"]))
        integ.step(1)
        got.append(integ.getStepSize())
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert 0.0 < min(got) and len(set(got)) > 1
    assert ctx.getTime() == pytest.approx(jctx.getTime()._value, rel=1e-12)
    t = 0.0
    for dt in got:
        t = t + dt
    assert ctx.getTime() == t
    assert np.abs(ctx.getState(getPositions=True).getPositions()
                  - _positions(jctx)).max() < 1e-9
    jst = jctx.getState(getEnergy=True)
    ke = jst.getKineticEnergy()._value
    assert ctx.getState(getEnergy=True).getKineticEnergy() == \
        pytest.approx(ke, rel=1e-9)


def _compound(mod):
    integ = mod.CompoundIntegrator()
    integ.addIntegrator(mod.VerletIntegrator(0.001))
    integ.addIntegrator(mod.LangevinMiddleIntegrator(300.0, 0.0, 0.002))
    return integ


def test_compound_matches_jax_reference(droplet):
    params, pos, vel = droplet
    jint, integ = _compound(mm), _compound(omm)
    jctx, ctx, start = _contexts(params, pos, vel, jint, integ)
    for member, steps in ((0, 10), (1, 10), (0, 5)):
        for i in (jint, integ):
            i.setCurrentIntegrator(member)
            i.step(steps)
        assert integ.getStepSize() == (0.001, 0.002)[member]
    assert np.abs(ctx.getState(getPositions=True).getPositions()
                  - _positions(jctx)).max() < 1e-9
    assert ctx.getTime() == pytest.approx(0.035, abs=1e-12)
    assert ctx.getTime() == pytest.approx(jctx.getTime()._value, rel=1e-12)
    ke = jctx.getState(getEnergy=True).getKineticEnergy()._value
    assert ctx.getState(getEnergy=True).getKineticEnergy() == \
        pytest.approx(ke, rel=1e-9)
    # one program a member
    assert sorted(key[2] for key in ctx._programs) == [0, 1]


def test_fixed_step_time_keeps_its_bits(droplet):
    params, pos, vel = droplet
    integ = omm.VerletIntegrator(0.002)
    ctx = omm.Context(omm.from_numpy(params), integ, "CPU")
    ctx.setPositions(pos)
    ctx.setVelocities(vel)
    t = 0.0
    for dt, steps in ((0.002, 25), (0.001, 10), (0.0007, 33)):
        integ.setStepSize(dt)
        integ.step(steps)
        for _ in range(steps):
            t = t + dt
    assert ctx.getTime() == t
    assert ctx.getState().getTime() == t
    ctx.setTime(1.25)
    assert ctx.getTime() == 1.25


def _box(make, eager, calls):
    system, positions = tip3p_water_box(216)
    integ = make()
    integ.setRandomNumberSeed(17)
    ctx = omm.Context(system, integ, "CPU")
    ctx._nonbonded.capacity_scale = 0.3
    ctx.setPositions(positions)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=3)
    for member, steps in calls:
        if member is not None:
            integ.setCurrentIntegrator(member)
        (ctx._step_eager if eager else integ.step)(steps)
    return ctx


PROGRAMS = {
    "variable_langevin": (lambda: omm.VariableLangevinIntegrator(
        300.0, 1.0, 1e-3), [(None, 12)]),
    "variable_verlet": (lambda: omm.VariableVerletIntegrator(1e-3),
                        [(None, 12)]),
    "compound": (lambda: _compound_box(), [(0, 6), (1, 6), (0, 4)]),
}


def _compound_box():
    integ = omm.CompoundIntegrator()
    integ.addIntegrator(omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002))
    integ.addIntegrator(omm.VerletIntegrator(0.001))
    return integ


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_matches_eager_loop_bitwise(name):
    make, calls = PROGRAMS[name]
    graph, eager = (_box(make, e, calls) for e in (False, True))
    assert graph.escalation_count >= 1
    assert graph.escalation_count == eager.escalation_count
    for key in ("positions", "velocities"):
        assert torch.equal(graph._state[key], eager._state[key])
    for a, b in zip(graph._step_tensors(), eager._step_tensors()):
        assert torch.equal(a, b)
    assert graph.getTime() == eager.getTime() > 0.0
    if name == "compound":
        assert graph.getTime() == pytest.approx(6 * 0.002 + 6 * 0.001
                                                + 4 * 0.002, abs=1e-15)
