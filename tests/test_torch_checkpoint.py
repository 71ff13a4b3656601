"""Context checkpoints, reinitialize and applyVelocityConstraints in
openmm_tpu_torch: a run reloaded from createCheckpoint continues bit for
bit (positions, velocities, clock, step count, box, the integrator's and
the barostat's state), in its own Context and in a second Context of the
same System; a checkpoint of another particle count or of no checkpoint
at all raises; reinitialize keeps the state only when asked;
applyVelocityConstraints against the JAX package (1e-12 nm/ps)."""
import numpy as np
import pytest

import openmm_tpu as mm
from openmm_tpu import unit as u

import openmm_tpu_torch as omm
from openmm_tpu_torch.models import tip3p_water_box, tip4pew_water_box
from torch_port_helpers import jax_system
from openmm_tpu_torch.unit import plain

STEPS = 20


def _integrator(kind):
    if kind == "nose_hoover":
        integ = omm.NoseHooverIntegrator(300.0, 10.0, 0.001)
    else:
        integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    integ.setRandomNumberSeed(17)
    return integ


def _system(kind):
    builder = tip4pew_water_box if kind == "tip4pew" else tip3p_water_box
    system, pos = builder(64)
    if kind == "barostat":
        system.addForce(omm.MonteCarloBarostat(1.0, 300.0, 5))
    return system, pos


def _context(system, pos, kind):
    ctx = omm.Context(system, _integrator(kind), "CPU")
    ctx.setPositions(pos)
    ctx.applyConstraints()
    ctx.setVelocitiesToTemperature(300.0, randomSeed=6)
    return ctx


def _bits(ctx):
    st = ctx.getState(getPositions=True, getVelocities=True)
    return (plain(st.getPositions(asNumpy=True)),
            plain(st.getVelocities(asNumpy=True)), plain(ctx.getTime()),
            ctx.getStepCount(), ctx._box.numpy().copy(),
            [t.numpy().copy() for t in ctx._step_tensors()])


def _same(a, b):
    assert np.array_equal(a[0], b[0])
    assert np.array_equal(a[1], b[1])
    assert a[2] == b[2] and a[3] == b[3]
    assert np.array_equal(a[4], b[4])
    assert all(np.array_equal(x, y) for x, y in zip(a[5], b[5]))


@pytest.mark.parametrize("kind", ["langevin", "nose_hoover", "barostat",
                                  "tip4pew"])
def test_checkpoint_continues_bit_for_bit(kind):
    system, pos = _system(kind)
    ctx = _context(system, pos, kind)
    ctx.getIntegrator().step(7)
    checkpoint = ctx.createCheckpoint()
    assert isinstance(checkpoint, bytes)
    ctx.getIntegrator().step(STEPS)
    want = _bits(ctx)
    ctx.loadCheckpoint(checkpoint)
    ctx.getIntegrator().step(STEPS)
    _same(_bits(ctx), want)
    # a second Context of the same System, its own integrator alike
    other = omm.Context(system, _integrator(kind), "CPU")
    other.loadCheckpoint(checkpoint)
    other.getIntegrator().step(STEPS)
    _same(_bits(other), want)


def test_checkpoint_refuses_other_systems_and_other_bytes():
    system, pos = _system("langevin")
    ctx = _context(system, pos, "langevin")
    checkpoint = ctx.createCheckpoint()
    small, small_pos = tip3p_water_box(27)
    other = omm.Context(small, _integrator("langevin"), "CPU")
    with pytest.raises(ValueError, match="number of particles"):
        other.loadCheckpoint(checkpoint)
    with pytest.raises(ValueError, match="Invalid checkpoint"):
        ctx.loadCheckpoint(b"not a checkpoint")
    npt, _ = _system("barostat")
    with pytest.raises(ValueError, match="structure"):
        omm.Context(npt, _integrator("langevin"), "CPU").loadCheckpoint(
            checkpoint)


def test_reinitialize_keeps_the_state_only_when_asked():
    system, pos = _system("langevin")
    ctx = _context(system, pos, "langevin")
    ctx.getIntegrator().step(5)
    before = _bits(ctx)
    ctx.reinitialize(preserveState=True)
    _same(_bits(ctx), before)
    ctx.getIntegrator().step(3)
    ctx.reinitialize()
    assert ctx.getStepCount() == 0 and plain(ctx.getTime()) == 0.0
    with pytest.raises(RuntimeError, match="not been set"):
        ctx.getState(getEnergy=True)


def test_reinitialize_takes_up_a_changed_system():
    """A force added after the Context was built reaches it through
    reinitialize, which keeps positions and velocities (the checkpoint no
    longer fits: a barostat adds shared tensors)."""
    system, pos = _system("langevin")
    ctx = _context(system, pos, "langevin")
    ctx.getIntegrator().step(3)
    before = ctx.getState(getPositions=True, getVelocities=True)
    system.addForce(omm.MonteCarloBarostat(1.0, 300.0, 5))
    ctx.reinitialize(preserveState=True)
    assert len(ctx._barostats) == 1
    after = ctx.getState(getPositions=True, getVelocities=True)
    assert np.array_equal(plain(after.getPositions(asNumpy=True)),
                          plain(before.getPositions(asNumpy=True)))
    assert np.array_equal(plain(after.getVelocities(asNumpy=True)),
                          plain(before.getVelocities(asNumpy=True)))


def test_apply_velocity_constraints_matches_jax():
    system, pos = tip3p_water_box(27)
    params = omm.to_numpy(system)
    vel = np.random.RandomState(8).randn(*pos.shape)
    jctx = mm.Context(jax_system(params), mm.VerletIntegrator(0.001),
                      mm.Platform.getPlatformByName("Reference"))
    jctx.setPositions(pos)
    jctx.applyConstraints()
    jpos = np.asarray(u.strip(jctx.getState(getPositions=True)
                              .getPositions(asNumpy=True)))
    jctx.setVelocities(vel)
    jctx.applyVelocityConstraints()
    want = np.asarray(u.strip(jctx.getState(getVelocities=True)
                              .getVelocities(asNumpy=True)))
    ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                      {"Precision": "double"})
    ctx.setPositions(jpos)
    ctx.setVelocities(vel)
    ctx.applyVelocityConstraints()
    got = plain(ctx.getState(getVelocities=True).getVelocities(asNumpy=True))
    assert np.abs(got - want).max() <= 1e-12
    assert np.abs(got - vel).max() > 1e-3
