"""Metadynamics and SimulatedTempering of openmm_tpu_torch against
openmm_tpu's.

Metadynamics runs under VerletIntegrator, so that no random draws differ:
a dimer bound by a harmonic bond, its distance the collective variable
(a CustomBondForce), the port in float64 on "CPU" against the JAX
"Reference" platform; after ten depositions the bias grids agree within
1e-9 kJ/mol and the bias energy (force group 31) equals the table at the
current CV. The JAX CustomCVForce.updateParametersInContext repacks its
variables' parameters but keeps the tables compiled into its program
(openmm_tpu/forces/customcv.py:51-76), so the JAX Metadynamics' bias
never reaches its Context; the test reinitializes the JAX Context after
each deposition (_jax_refresh) so that its bias acts, as OpenMM's and the
port's does in place. SimulatedTempering runs a frictionless LangevinIntegrator
(deterministic in both packages) with np.random.seed set the same before
each: the same rung sequence and weights, and the integrator's
temperature is the current rung after every attempt. A last test holds
the step after setTemperature to a fresh Context at the new temperature:
the same noise at the same seed, so a step that kept the old temperature
fails it.
"""
import math

import numpy as np
import pytest

import openmm_tpu as mm
from openmm_tpu import app as japp
from openmm_tpu import unit as ju

import openmm_tpu_torch as omm
from openmm_tpu_torch import app as papp
from openmm_tpu_torch import unit as pu
from openmm_tpu_torch.unit import plain

import torch_port_helpers  # noqa: F401  (one torch thread)

POSITIONS = [[0.0, 0.0, 0.0], [0.42, 0.05, -0.03]]
VELOCITIES = [[0.1, -0.2, 0.05], [-0.1, 0.2, -0.05]]


def dimer(pkg, app):
    """(System, Topology, the CV's force) of two argon-like atoms bound by
    a harmonic bond, with Lennard-Jones at NoCutoff."""
    system = pkg.System()
    nb = pkg.NonbondedForce()
    for _ in range(2):
        system.addParticle(39.95)
        nb.addParticle(0.0, 0.34, 0.99)
    bond = pkg.HarmonicBondForce()
    bond.addBond(0, 1, 0.40, 800.0)
    system.addForce(nb)
    system.addForce(bond)
    top = app.Topology()
    res = top.addResidue("AR", top.addChain())
    for name in ("AR1", "AR2"):
        top.addAtom(name, app.Element.getBySymbol("Ar"), res)
    cv = pkg.CustomBondForce("r")
    cv.addBond(0, 1, [])
    return system, top, cv


def _simulation(pkg, app, integrator, extra=None):
    system, top, cv = dimer(pkg, app)
    if extra is not None:
        extra(system, cv)
    if pkg is mm:
        sim = app.Simulation(top, system, integrator,
                             mm.Platform.getPlatformByName("Reference"))
    else:
        sim = app.Simulation(top, system, integrator,
                             omm.Platform.getPlatformByName("CPU"),
                             {"Precision": "double"})
    sim.context.setPositions(POSITIONS)
    sim.context.setVelocities(VELOCITIES)
    return sim


def _jax_refresh(meta):
    """A JAX Metadynamics whose table reaches its Context: the Context is
    rebuilt, its state kept, after each table update."""
    update = meta._updateTable

    def refreshed(context):
        update(context)
        context.reinitialize(preserveState=True)

    meta._updateTable = refreshed


def test_metadynamics_bias_matches_jax():
    runs = {}
    for pkg, app in ((omm, papp), (mm, japp)):
        made = {}

        def add_meta(system, cv, pkg=pkg, app=app, made=made):
            var = app.BiasVariable(cv, 0.30, 0.55, 0.02, gridWidth=60)
            made["meta"] = app.Metadynamics(system, [var], 300.0, 5.0, 1.5,
                                            10)

        sim = _simulation(pkg, app, pkg.VerletIntegrator(0.002), add_meta)
        meta = made["meta"]
        if pkg is mm:
            _jax_refresh(meta)
        meta.step(sim, 100)
        runs[pkg] = (sim, meta)
    (psim, pmeta), (jsim, jmeta) = runs[omm], runs[mm]
    assert np.abs(pmeta._totalBias).max() > 0.1     # ten depositions
    np.testing.assert_allclose(pmeta._totalBias, jmeta._totalBias, rtol=0,
                               atol=1e-9)
    np.testing.assert_allclose(plain(pmeta.getFreeEnergy()),
                               jmeta.getFreeEnergy()._value, rtol=0,
                               atol=1e-9)
    cv_p = pmeta.getCollectiveVariables(psim)
    cv_j = jmeta.getCollectiveVariables(jsim)
    assert abs(cv_p[0] - cv_j[0]) < 1e-9
    # the bias energy (group 31) is the table's spline at the current CV
    e31 = plain(psim.context.getState(getEnergy=True, groups={31})
                .getPotentialEnergy())
    e31_j = jsim.context.getState(getEnergy=True, groups={31}) \
        .getPotentialEnergy()._value
    assert abs(e31 - e31_j) <= 1e-9 * max(1.0, abs(e31_j))
    grid = np.linspace(0.30, 0.55, 60)
    table = np.interp(cv_p[0], grid, pmeta._totalBias)
    assert abs(e31 - table) < 0.05 * np.abs(pmeta._totalBias).max()


def test_metadynamics_table_reaches_the_context_in_place():
    """updateParametersInContext writes the new table into the compiled
    function's tensors: no new step program, and the energy follows."""
    made = {}

    def add_meta(system, cv):
        var = papp.BiasVariable(cv, 0.30, 0.55, 0.02, gridWidth=60)
        made["meta"] = papp.Metadynamics(system, [var], 300.0, 5.0, 1.5, 10)

    sim = _simulation(omm, papp, omm.VerletIntegrator(0.002), add_meta)
    meta = made["meta"]
    meta.step(sim, 10)
    programs = len(sim.context._programs)
    before = plain(sim.context.getState(getEnergy=True, groups={31})
                   .getPotentialEnergy())
    meta._addGaussian(meta.getCollectiveVariables(sim), 2.0, sim.context)
    after = plain(sim.context.getState(getEnergy=True, groups={31})
                  .getPotentialEnergy())
    assert after > before + 1.0
    meta.step(sim, 10)
    assert len(sim.context._programs) == programs


def _tempering(pkg, app, seed):
    integ = pkg.LangevinIntegrator(300.0, 0.0, 0.002)
    sim = _simulation(pkg, app, integ)
    np.random.seed(seed)
    st = app.SimulatedTempering(sim, numTemperatures=4,
                                minTemperature=300.0, maxTemperature=330.0,
                                tempChangeInterval=25)
    rungs = []
    for _ in range(12):
        st.step(25)
        rungs.append(st.currentTemperature)
        want = st.temperatures[st.currentTemperature]
        got = integ.getTemperature()
        assert abs(got.value_in_unit(got.unit) - want.value_in_unit(
            want.unit)) < 1e-12
    return rungs, st.weights, sim


@pytest.mark.parametrize("seed", [3, 11])
def test_simulated_tempering_matches_jax(seed):
    prungs, pweights, psim = _tempering(omm, papp, seed)
    jrungs, jweights, jsim = _tempering(mm, japp, seed)
    assert prungs == jrungs
    assert len(set(prungs)) > 1             # it moved between rungs
    np.testing.assert_allclose(pweights, jweights, rtol=0, atol=1e-12)
    p = plain(psim.context.getState(getPositions=True)
              .getPositions(asNumpy=True))
    j = jsim.context.getState(getPositions=True).getPositions(
        asNumpy=True)._value
    assert np.abs(p - j).max() < 1e-9


def _langevin_context(temperature):
    system, _, _ = dimer(omm, papp)
    integ = omm.LangevinMiddleIntegrator(temperature, 5.0, 0.002)
    ctx = omm.Context(system, integ, omm.Platform.getPlatformByName("CPU"),
                      {"Precision": "double"})
    ctx.setPositions(POSITIONS)
    ctx.setVelocities(VELOCITIES)
    return ctx


def _one_step(ctx, state, generator):
    """The velocities after one step from `state` with the generator's
    state `generator`."""
    ctx.setPositions(state.getPositions(asNumpy=True))
    ctx.setVelocities(state.getVelocities(asNumpy=True))
    ctx._generator.set_state(generator)
    ctx.getIntegrator().step(1)
    return plain(ctx.getState(getVelocities=True).getVelocities(
        asNumpy=True))


def test_set_temperature_reaches_the_next_step():
    """After three steps at 300 K and setTemperature(330 K), a step gives
    the velocities of a Context built at 330 K from the same state and
    generator state, and not those of one at 300 K."""
    changed = _langevin_context(300.0)
    changed.getIntegrator().step(3)
    changed.getIntegrator().setTemperature(330.0 * pu.kelvin)
    state = changed.getState(getPositions=True, getVelocities=True)
    generator = changed._generator.get_state()
    got = _one_step(changed, state, generator)
    at_new = _one_step(_langevin_context(330.0), state, generator)
    at_old = _one_step(_langevin_context(300.0), state, generator)
    assert np.array_equal(got, at_new)
    assert not np.allclose(got, at_old, rtol=0, atol=1e-12)


def test_bias_in_the_step_body_reads_nothing_from_the_device():
    """The step body of a Metadynamics System on fake tensors: the CV's
    table is read at device indices, with no host read that a CUDA graph's
    capture would refuse (a 0-d index tensor is read as a Python int)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    made = {}

    def add_meta(system, cv):
        var = papp.BiasVariable(cv, 0.30, 0.55, 0.02, gridWidth=60)
        made["meta"] = papp.Metadynamics(system, [var], 300.0, 5.0, 1.5, 10)

    sim = _simulation(omm, papp, omm.VerletIntegrator(0.002), add_meta)
    made["meta"].step(sim, 10)          # a deposition: the table is not 0
    program = sim.context._program()
    with FakeTensorMode(allow_non_fake_inputs=True):
        program.body(program.gate_always)
