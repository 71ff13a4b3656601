"""A periodic NonbondedForce as a CustomCVForce's collective variable in
openmm_tpu_torch (Context._cv_nonbondeds: the variable's candidate state
built and rebuilt under the Context's one gate) against the JAX package.

The System: the 216-water TIP3P box of both packages' builders (648
atoms, a 1.87 nm cube, cutoff 0.9 nm) at PME, LJPME, CutoffPeriodic or
Ewald, its NonbondedForce taken out and made the variable E of
CustomCVForce("s*E") with a global parameter s = 1. The JAX package
builds it and writes it as XML; the port reads that XML (the bridge of
openmm_tpu_torch.serialization).

Bars, those of tests/test_torch_nonbonded_methods.py: the port's float64
path against the JAX "Reference" platform within 1e-10 relative in
energy and 1e-10 of the largest force; its float32 path within 1e-5
relative in energy and a median relative force error <= 1e-5 against the
"Reference" and "CPU" platforms; s = 0.5 (setParameter) halves the
energy and the forces in both packages. Through the step program on the
CPU (PME): 40 steps with rebuilds of the variable's candidate state,
replayed from a snapshot through the eager loop for the same bits; a
forced capacity overflow (capacity scale 0.1, no candidate state),
escalated and redone, gives the bits of the same steps without one; at
s = 1 the steps give the bits of the plain NonbondedForce's Context.
"""
import numpy as np
import pytest
import torch

import openmm_tpu as mm
from openmm_tpu import unit as u
from openmm_tpu.models import tip3p_water_box as jax_water_box
from openmm_tpu.serialization import XmlSerializer as JaxXml

import openmm_tpu_torch as omm
from torch_port_helpers import median_relative_error
from openmm_tpu_torch.unit import plain

WATERS = 216
METHODS = ("PME", "LJPME", "CutoffPeriodic", "Ewald")
TOL64 = 1e-10
TOL32 = 1e-5
STEPS = 40
ESCALATION_SCALE = 0.1


def jax_cv_system(method):
    """(JAX System with the box's NonbondedForce as the variable E of
    CustomCVForce("s*E"), positions (n, 3) float64)."""
    system, pos = jax_water_box(
        WATERS, nonbonded_method=getattr(mm.NonbondedForce, method))
    (index,) = [i for i, f in enumerate(system.getForces())
                if isinstance(f, mm.NonbondedForce)]
    nb = system.getForce(index)
    system.removeForce(index)
    cv = mm.CustomCVForce("s*E")
    cv.addGlobalParameter("s", 1.0)
    cv.addCollectiveVariable("E", nb)
    system.addForce(cv)
    return system, np.asarray(pos, np.float64)


def _jax_reading(system, pos, platform, s=1.0):
    ctx = mm.Context(system, mm.VerletIntegrator(0.001),
                     mm.Platform.getPlatformByName(platform))
    ctx.setPositions(pos)
    ctx.setParameter("s", s)
    st = ctx.getState(getEnergy=True, getForces=True)
    return (float(u.strip(st.getPotentialEnergy())),
            np.asarray(u.strip(st.getForces(asNumpy=True))))


def _port_reading(ctx):
    st = ctx.getState(getEnergy=True, getForces=True)
    return (plain(st.getPotentialEnergy()),
            plain(st.getForces(asNumpy=True)))


@pytest.fixture(scope="module", params=METHODS)
def case(request):
    jsys, pos = jax_cv_system(request.param)
    system = omm.XmlSerializer.deserialize(JaxXml.serialize(jsys))
    return request.param, jsys, system, pos


def test_cv_against_jax(case):
    method, jsys, system, pos = case
    ref = _jax_reading(jsys, pos, "Reference")
    cpu = _jax_reading(jsys, pos, "CPU")
    half = _jax_reading(jsys, pos, "Reference", s=0.5)
    assert abs(half[0] - 0.5 * ref[0]) <= TOL64 * abs(ref[0])
    for precision in ("double", "mixed"):
        ctx = omm.Context(system, omm.VerletIntegrator(0.001), "CPU",
                          {"Precision": precision})
        ctx.setPositions(pos)
        (module,) = ctx._cv_nonbondeds
        assert ctx._candidates is module and ctx._nonbondeds == []
        readings = {}
        for s in (1.0, 0.5):
            ctx.setParameter("s", s)
            readings[s] = _port_reading(ctx)
        (e, f), (e_half, f_half) = readings[1.0], readings[0.5]
        if precision == "double":
            for want, got in ((ref, (e, f)), (half, (e_half, f_half))):
                assert abs(got[0] - want[0]) <= TOL64 * abs(want[0])
                assert np.abs(got[1] - want[1]).max() <= TOL64 * np.abs(
                    want[1]).max()
        else:
            for want in (ref, cpu):
                assert abs(e - want[0]) <= TOL32 * abs(want[0]), method
                assert median_relative_error(f, want[1]) <= TOL32, method
        # s multiplies the variable's float64 energy and its forces
        assert e_half == 0.5 * e
        np.testing.assert_array_equal(f_half, 0.5 * f)
        assert ctx.rebuild_count == 1


def test_xml_bridge_gives_the_jax_parameters(case):
    method, jsys, system, _ = case
    (cv,) = system.getForces()
    (jcv,) = [f for f in jsys.getForces()
              if isinstance(f, mm.CustomCVForce)]
    nb, jnb = cv.getCollectiveVariable(0), jcv.getCollectiveVariable(0)
    assert nb.getNonbondedMethod() == jnb.getNonbondedMethod()
    assert nb._particles == [tuple(float(u.strip(x)) for x in
                                   jnb.getParticleParameters(i))
                             for i in range(jnb.getNumParticles())]
    assert nb._exceptions == [
        tuple(int(x) for x in jnb.getExceptionParameters(i)[:2])
        + tuple(float(u.strip(x)) for x in jnb.getExceptionParameters(i)[2:])
        for i in range(jnb.getNumExceptions())]
    assert system.getNumConstraints() == jsys.getNumConstraints()


def _pme_context(cv=True):
    """A CPU Context (float32) of the PME box with its NonbondedForce as
    the CV's variable, or as it is."""
    if cv:
        jsys, pos = jax_cv_system("PME")
    else:
        jsys, pos = jax_water_box(WATERS)
        pos = np.asarray(pos, np.float64)
    system = omm.XmlSerializer.deserialize(JaxXml.serialize(jsys))
    integ = omm.LangevinMiddleIntegrator(300.0, 1.0, 0.002)
    integ.setRandomNumberSeed(3)
    ctx = omm.Context(system, integ, "CPU")
    ctx.setPositions(pos)
    ctx.setVelocitiesToTemperature(300.0, randomSeed=5)
    return ctx, integ


def test_steps_rebuild_and_escalate_like_the_eager_loop():
    ctx, integ = _pme_context()
    start = ctx._snapshot()
    r0 = ctx.rebuild_count
    integ.step(STEPS)
    assert ctx.rebuild_count - r0 >= 2
    graph = [ctx._state[k].clone() for k in ("positions", "velocities")]
    ctx._restore(start)
    ctx._step_eager(STEPS)
    for got, want in zip(graph, (ctx._state["positions"],
                                 ctx._state["velocities"])):
        assert torch.equal(got, want)
    # the same steps from no candidate state, without and with a forced
    # overflow of the variable's capacity
    runs = {}
    for scale in (1.0, ESCALATION_SCALE):
        ctx._restore(start)
        ctx._tiles = ctx._ref_pos = None
        ctx._candidates.capacity_scale = scale
        e0 = ctx.escalation_count
        integ.step(STEPS)
        runs[scale] = (ctx.escalation_count - e0,
                       ctx._state["positions"].clone(),
                       ctx._state["velocities"].clone())
    assert runs[1.0][0] == 0 and runs[ESCALATION_SCALE][0] >= 1
    assert ctx._candidates.capacity_scale > ESCALATION_SCALE
    for got, want in zip(runs[ESCALATION_SCALE][1:], runs[1.0][1:]):
        assert torch.equal(got, want)
    # at s = 1 the CV's steps are the plain NonbondedForce's, bit for bit
    plain_ctx, plain_integ = _pme_context(cv=False)
    ctx._restore(start)
    plain_integ.step(STEPS)
    integ.step(STEPS)
    for key in ("positions", "velocities"):
        assert torch.equal(plain_ctx._state[key], ctx._state[key])
